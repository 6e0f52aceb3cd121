"""The port's per-rank input ownership and padding
(``vad_tpu_torch/parallel/multihost.py``, ``sharding.py``'s batch sizing,
``data/loader.DistributedLoader`` on a mesh) against the JAX package's
``vad_tpu/parallel/multihost.py`` for the same spoofed topologies
(``tests/test_multihost.py``), the interleaved cross-process-tp layout
against JAX's mesh-aware branch, and the port's own microbatch
interleave under ``accum_steps``."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from vad_tpu.data.loader import DistributedLoader as JaxLoader
from vad_tpu.parallel import multihost as jmh
from vad_tpu.parallel.sharding import get_mesh as jax_get_mesh
from vad_tpu.parallel.sharding import pad_batch_for_devices as jax_pad
from vad_tpu.parallel.sharding import padded_batch_size as jax_padded
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.parallel import multihost as tmh
from vad_tpu_torch.parallel.sharding import get_mesh, pad_batch_for_devices, padded_batch_size

TOPOLOGIES = [(16, 2), (32, 4), (24, 3), (8, 8), (12, 1)]  # (global batch, processes)


@pytest.mark.parametrize("batch,procs", TOPOLOGIES)
def test_local_ranges_and_owned_positions_match_jax(batch, procs):
    for p in range(procs):
        assert tmh.local_sample_range(batch, procs, p) == \
            jmh.local_sample_range(batch, process_count=procs, process_index=p)
        np.testing.assert_array_equal(
            tmh.owned_batch_positions(None, batch, procs, p),
            jmh.owned_batch_positions(None, batch, process_count=procs, process_index=p))
    with pytest.raises(ValueError, match="not divisible"):
        tmh.local_sample_range(batch + 1, procs if procs > 1 else 2, 0)
    with pytest.raises(ValueError, match="not divisible"):
        jmh.local_sample_range(batch + 1, process_count=procs if procs > 1 else 2,
                               process_index=0)


@pytest.mark.parametrize("batch,procs", TOPOLOGIES)
def test_host_batch_indices_match_jax(batch, procs):
    order = np.random.default_rng(0).permutation(batch * 3)
    for step in range(3):
        parts = []
        for p in range(procs):
            got = tmh.host_batch_indices(order, step, batch, procs, p)
            np.testing.assert_array_equal(got, jmh.host_batch_indices(
                order, step, batch, process_count=procs, process_index=p))
            parts.append(got)
        assert sorted(np.concatenate(parts)) == sorted(order[step * batch:(step + 1) * batch])


class _FakeDevice:
    def __init__(self, process_index: int) -> None:
        self.process_index = process_index


@pytest.mark.parametrize("rows,mp", [(1, 2), (2, 2), (3, 2), (2, 4)])
def test_interleaved_cross_process_tp_layout_matches_jax(rows, mp, monkeypatch):
    """The layout of ``multiprocess_check --model-parallel``: column j of
    every data row on process j, so a model group spans all processes.
    JAX's mesh-aware branch (a mesh of devices with their process index)
    against the port's (a grid of ranks, one rank a process): each process
    loads every row block of the rows it sits in."""
    batch = 8 * rows
    grid = np.array([[_FakeDevice(j) for j in range(mp)] for _ in range(rows)], dtype=object)
    jmesh = SimpleNamespace(devices=grid)
    ranks = np.arange(rows * mp).reshape(rows, mp)
    for rank in range(rows * mp):
        # JAX: process j owns column j, so every data row
        monkeypatch.setattr(jax, "process_index", lambda j=rank % mp: j)
        want = jmh.owned_batch_positions(jmesh, batch)
        assert len(want) == batch
        # the port: one rank a process, in data row rank // mp
        tmesh = SimpleNamespace(distributed=True, shape={"data": rows, "model": mp},
                                ranks=ranks, rank=rank)
        got = tmh.owned_batch_positions(tmesh, batch)
        r = rank // mp
        np.testing.assert_array_equal(got, want[r * (batch // rows):(r + 1) * (batch // rows)])


@pytest.mark.parametrize("rows,mp,accum", [(2, 1, 2), (2, 2, 2), (3, 1, 2), (2, 1, 4)])
def test_accum_interleave_gives_each_rank_its_slice_of_every_microbatch(rows, mp, accum):
    """With ``accum_steps`` > 1 a rank's local rows, cut into ``accum``
    equal microbatches, are its slice of each of the global batch's
    microbatches (rows ``[k*B/a, (k+1)*B/a)``): the data-axis sharding of
    JAX's ``make_train_step(accum_steps=a)``.  The union over the data
    axis is each microbatch, in order; a model group's ranks agree."""
    batch = 4 * rows * accum
    ranks = np.arange(rows * mp).reshape(rows, mp)
    micro = batch // accum
    owned = {}
    for rank in range(rows * mp):
        mesh = SimpleNamespace(distributed=True, shape={"data": rows, "model": mp},
                               ranks=ranks, rank=rank)
        owned[rank] = tmh.owned_batch_positions(mesh, batch, accum_steps=accum)
    for row in range(rows):
        for col in range(1, mp):
            np.testing.assert_array_equal(owned[ranks[row, col]], owned[ranks[row, 0]])
    for k in range(accum):
        shards = [owned[ranks[row, 0]].reshape(accum, -1)[k] for row in range(rows)]
        np.testing.assert_array_equal(np.concatenate(shards),
                                      np.arange(k * micro, (k + 1) * micro))
    with pytest.raises(ValueError, match="microbatches"):
        tmh.owned_batch_positions(mesh, batch + rows, accum_steps=accum)


@pytest.mark.parametrize("devices,mp", [(1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (8, 4)])
def test_padded_batch_size_matches_jax(devices, mp):
    jmesh = jax_get_mesh(jax.devices()[:devices], model_parallel=mp)
    tmesh = get_mesh(["cpu"] * devices, model_parallel=mp)
    assert tmesh.shape == dict(jmesh.shape)
    for batch in (1, 3, 7, 8, 13):
        for accum in (1, 2, 3):
            assert padded_batch_size(batch, tmesh, accum) == jax_padded(batch, jmesh, accum)
    assert padded_batch_size(5, None) == 5


def test_pad_batch_for_devices_matches_jax():
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (5, 4, 4, 3), dtype=np.uint8),
             "label": np.arange(5), "meta": "passthrough"}
    for size in (5, 8):
        got, n = pad_batch_for_devices(batch, size)
        want, jn = jax_pad(batch, size)
        assert n == jn == 5 and got["meta"] == "passthrough"
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="exceeds"):
        pad_batch_for_devices(batch, 4)


class _Numbers:
    def __init__(self, n: int) -> None:
        self.x = np.arange(n * 4, dtype=np.uint8).reshape(n, 2, 2, 1)

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.x[i], "label": i}


@pytest.mark.parametrize("n,batch,procs", [(13, 4, 2), (10, 6, 3), (5, 8, 2)])
def test_distributed_loader_slices_match_jax(n, batch, procs):
    """Spoofed processes: each process's rows of every global batch (the
    padded tail cycled) over two shuffled epochs, the port's
    ``DistributedLoader`` against JAX's (``assemble=False``)."""
    jmesh = jax_get_mesh(jax.devices()[:procs])
    tmesh = get_mesh(["cpu"] * procs)
    for p in range(procs):
        ours = DistributedLoader(_Numbers(n), batch, mesh=tmesh, shuffle=True, seed=4,
                                 num_workers=0, device="cpu", process_count=procs,
                                 process_index=p)
        theirs = JaxLoader(_Numbers(n), batch, jmesh, shuffle=True, seed=4, num_workers=0,
                           process_count=procs, process_index=p, assemble=False)
        assert ours.pad_to == theirs.pad_to and len(ours) == len(theirs)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want)
            for (gb, gn), (wb, wn) in zip(got, want):
                assert gn == wn
                assert isinstance(gb["image"], torch.Tensor)
                np.testing.assert_array_equal(gb["image"].numpy(), wb["image"])
                np.testing.assert_array_equal(gb["label"], wb["label"])


def test_one_process_forms_own_every_row_inside_a_process_group(monkeypatch):
    """No mesh, or a one-process mesh (the evaluators' replicas), owns the
    whole batch even where a process group is up (a trainer's rank);
    ``local_sample_range`` without a topology follows the group, as JAX's
    follows ``jax.process_count()``."""
    monkeypatch.setattr(tmh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(tmh.dist, "get_rank", lambda: 1)
    assert tmh.local_sample_range(8) == (4, 4)
    for mesh in (None, get_mesh(["cpu", "cpu"])):
        for accum in (1, 2):
            np.testing.assert_array_equal(
                tmh.owned_batch_positions(mesh, 8, accum_steps=accum), np.arange(8))


def test_to_host_and_put_global_batch_in_one_process():
    x = torch.arange(6.0)
    np.testing.assert_array_equal(tmh.to_host(x), np.arange(6.0))
    arr = np.arange(4)
    assert tmh.to_host(arr) is arr
    mesh = get_mesh(["cpu"])
    out = tmh.put_global_batch(mesh, {"image": np.ones((2, 3), np.uint8), "label": arr,
                                      "path": ["a", "b"]}, keys=("image",))
    assert isinstance(out["image"], torch.Tensor) and out["label"] is arr
    assert out["path"] == ["a", "b"]
    with pytest.raises(ValueError, match="owns"):
        tmh.put_global_batch(mesh, {"image": np.ones((2, 3))}, global_batch_size=4)
