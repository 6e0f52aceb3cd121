"""The rest of the port's ``data/``, ``utils/checkpoint`` and ``ops/losses``
against the JAX package's.

``Loader`` batch for batch against JAX's ``Loader`` (in line and with
decode threads, the partial tail kept or dropped, the shuffle over two
epochs, an empty dataset); ``device_prefetch`` onto the CPU (order,
tensors on the device, metadata untouched, a producer's error raised in
the consumer); ``latest_checkpoint`` and ``make_loss_fn`` against JAX's.

Bar: f32 rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.data.loader import Loader as JaxLoader
from vad_tpu.ops import losses as jlosses
from vad_tpu.utils.checkpoint import latest_checkpoint as jax_latest_checkpoint
from vad_tpu_torch.data.loader import Loader, device_prefetch
from vad_tpu_torch.ops import losses as tlosses
from vad_tpu_torch.utils.checkpoint import latest_checkpoint

F32 = dict(rtol=1e-4, atol=1e-5)


class Indexed:
    """n samples: a frames array, a label and per-sample metadata."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"frames": np.full((2, 3, 3), i, np.float32), "label": np.int64(i % 2),
                "path": f"p{i}.png", "video": f"v{i}"}


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(b[key], list):
                assert a[key] == b[key]
            else:
                assert type(a[key]) is np.ndarray and a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("n,batch,shuffle,workers,drop", [
    (10, 4, False, 0, False), (10, 4, True, 0, False), (10, 4, True, 2, False),
    (10, 4, True, 2, True), (11, 3, False, 2, True), (3, 8, True, 0, False),
    (3, 8, True, 2, True), (0, 4, True, 2, False), (0, 4, False, 0, True),
])
def test_loader_matches_jax(n, batch, shuffle, workers, drop):
    """Two epochs each: the epoch-seeded shuffle, the tail kept or dropped."""
    ds = Indexed(n)
    tl = Loader(ds, batch, shuffle=shuffle, num_workers=workers, seed=5, drop_remainder=drop)
    jl = JaxLoader(ds, batch, shuffle=shuffle, num_workers=workers, seed=5,
                   drop_remainder=drop)
    assert len(tl) == len(jl)
    epochs = []
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert_same_batches(got, want)
        assert len(got) == len(tl)
        epochs.append([b["label"].tolist() for b in got] + [b["path"] for b in got])
    if shuffle and n > batch:
        assert epochs[0] != epochs[1]  # a new permutation each epoch
    if drop:
        assert all(len(b["path"]) == batch for b in got)
    elif n:
        assert sum(len(b["path"]) for b in got) == n


def test_loader_decodes_ahead_only_when_consumed():
    """With workers, decodes run at most two batches ahead of the consumer."""
    seen = []

    class Recording(Indexed):
        def __getitem__(self, i):
            seen.append(i)
            return super().__getitem__(i)

    it = iter(Loader(Recording(40), 4, num_workers=2))
    first = next(it)
    assert first["path"] == [f"p{i}.png" for i in range(4)]
    assert len(seen) <= 3 * 4  # the batch taken and two in flight
    assert len(list(it)) == 9 and len(seen) == 40


def test_device_prefetch_moves_arrays_in_order():
    batches = list(Loader(Indexed(7), 3))
    moved = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(moved) == 3
    for got, want in zip(moved, batches):
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert isinstance(got[key], torch.Tensor) and got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), value)
            else:
                assert got[key] is value  # metadata passes through untouched


def test_device_prefetch_raises_the_producers_error():
    def failing():
        yield {"frames": np.zeros(2, np.float32)}
        raise OSError("decode failed")

    it = device_prefetch(failing(), device="cpu")
    assert torch.equal(next(it)["frames"], torch.zeros(2))
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_device_prefetch_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([]), device=None))


@pytest.mark.parametrize("names", [[], ["best_model.ckpt", "final_model.ckpt"],
                                   ["checkpoint_epoch_2.ckpt", "checkpoint_epoch_10.ckpt",
                                    "checkpoint_epoch_9.ckpt", "checkpoint_epoch_11.ckpt.tmp",
                                    "best_model.ckpt"]])
def test_latest_checkpoint_matches_jax(names, tmp_path):
    for name in names:
        (tmp_path / name).write_bytes(b"")
    got = latest_checkpoint(tmp_path)
    assert got == jax_latest_checkpoint(tmp_path)
    assert got == (tmp_path / "checkpoint_epoch_10.ckpt" if len(names) > 2 else None)
    assert latest_checkpoint(tmp_path / "missing") is None


@pytest.mark.parametrize("name,weight", [("mse", 0.5), ("ssim", 0.5), ("combined", 0.3)])
@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (2, 3, 24, 24, 3)])
def test_make_loss_fn_matches_jax(name, weight, shape):
    rng = np.random.default_rng(1)
    pred, target = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    got = tlosses.make_loss_fn(name, weight)(torch.from_numpy(pred), torch.from_numpy(target))
    want = jlosses.make_loss_fn(name, weight)(jnp.asarray(pred), jnp.asarray(target))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **F32)


def test_make_loss_fn_refuses_an_unknown_name():
    for make in (tlosses.make_loss_fn, jlosses.make_loss_fn):
        with pytest.raises(ValueError, match="unknown loss 'l1'"):
            make("l1")
