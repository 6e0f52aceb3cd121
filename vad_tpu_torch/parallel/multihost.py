"""Per-rank input ownership and the global view of batch-sharded outputs
(the JAX package's ``vad_tpu/parallel/multihost.py``).

Every rank runs the same program over the same global batch order; each
loads ONLY the rows that land on it.  JAX assembles a global array from
the per-process shards; the port keeps each rank's rows as its own tensor
and gathers explicitly where the host needs the global view (``to_host``:
metrics, labels, the multi-process check).

One deliberate difference: with ``accum_steps`` > 1 a rank owns, for each
microbatch k of the global batch (rows ``[k*B/a, (k+1)*B/a)``), its slice
of that microbatch, so its local rows split into the same microbatches JAX
shards over 'data' and BatchNorm normalizes each by its own (global)
statistics.  JAX loads contiguous rows and lets XLA move them.

Everything degenerates to one process when no group is up (``mesh`` None
or a one-process mesh), so trainers call it unconditionally.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vad_tpu_torch.parallel.sharding import DATA_AXIS, Mesh


def _process_topology(process_count, process_index) -> Tuple[int, int]:
    up = dist.is_initialized()
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    return pc, pi


def local_sample_range(global_batch_size: int, process_count: Optional[int] = None,
                       process_index: Optional[int] = None) -> Tuple[int, int]:
    """(start, count) of this process's contiguous slice of a global batch:
    process p owns samples ``[p*B/P, (p+1)*B/P)``."""
    pc, pi = _process_topology(process_count, process_index)
    if global_batch_size % pc != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pc} hosts")
    per = global_batch_size // pc
    return pi * per, per


def host_batch_indices(order: np.ndarray, step: int, global_batch_size: int,
                       process_count: Optional[int] = None,
                       process_index: Optional[int] = None) -> np.ndarray:
    """Dataset indices this process loads for global step ``step`` of the
    epoch permutation ``order`` (the same on every process)."""
    start, count = local_sample_range(global_batch_size, process_count, process_index)
    lo = step * global_batch_size + start
    return order[lo:lo + count]


def _row_positions(rows: Iterable[int], nrows: int, global_batch_size: int,
                   accum_steps: int) -> np.ndarray:
    micro = global_batch_size // accum_steps
    per = micro // nrows
    return np.concatenate([np.arange(k * micro + r * per, k * micro + (r + 1) * per)
                           for r in rows for k in range(accum_steps)])


def owned_batch_positions(mesh: Optional[Mesh], global_batch_size: int,
                          process_count: Optional[int] = None,
                          process_index: Optional[int] = None,
                          accum_steps: int = 1) -> np.ndarray:
    """Positions within a global batch this rank must load, mesh-aware.

    A rank owns the row block of the data-axis row it sits in; under
    tensor parallelism every rank of a model group (a data row) holds
    those rows, so in the interleaved cross-process layout
    (``multiprocess_check --model-parallel 2``, the model group spanning
    both processes) both processes load the same rows.  Spoofed
    topologies (``process_count``/``process_index`` given) keep the
    contiguous contract of ``local_sample_range``; with no mesh or a
    one-process mesh (the evaluators' form) this process owns every row,
    whatever process group is up.  ``accum_steps`` > 1 takes this rank's
    slice of each microbatch instead (module docstring)."""
    spoofed = process_count is not None or process_index is not None
    accum_steps = max(1, accum_steps)
    if spoofed or mesh is None or not mesh.distributed:
        pc, pi = _process_topology(process_count, process_index) if spoofed else (1, 0)
        if accum_steps == 1:
            start, count = local_sample_range(global_batch_size, pc, pi)
            return np.arange(start, start + count)
        nrows, rows = pc, [pi]
    else:
        nrows = mesh.shape[DATA_AXIS]
        rows = [i for i in range(nrows) if mesh.rank in mesh.ranks[i]]
    if global_batch_size % (nrows * accum_steps) != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by data axis "
                         f"{nrows}" + (f" x {accum_steps} microbatches" if accum_steps > 1
                                       else ""))
    return _row_positions(rows, nrows, global_batch_size, accum_steps)


def to_host(x, mesh: Optional[Mesh] = None, accum_steps: int = 1) -> np.ndarray:
    """The full GLOBAL array as host numpy, on every rank.

    ``x`` holds this rank's rows (a tensor or a numpy array, as
    ``owned_batch_positions`` laid them out).  One process: a plain copy.
    Several: an ``all_gather`` over the data group, each row block put
    back at its global positions (the rows a model group duplicates are
    taken once)."""
    if mesh is None or not mesh.distributed:
        if isinstance(x, np.ndarray):
            return x
        return x.detach().cpu().numpy()
    t = torch.as_tensor(x)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    t = t.contiguous()
    d = mesh.shape[DATA_AXIS]
    parts = [torch.empty_like(t) for _ in range(d)]
    dist.all_gather(parts, t, group=mesh.data_group)
    local = t.shape[0]
    out = torch.empty((local * d, *t.shape[1:]), dtype=t.dtype)
    for row, part in enumerate(parts):
        out[torch.as_tensor(_row_positions([row], d, local * d, max(1, accum_steps)))] = \
            part.cpu()
    return out.numpy()


def put_global_batch(mesh: Optional[Mesh], arrays: Dict, global_batch_size: Optional[int] = None,
                     keys: Optional[Iterable[str]] = None, device=None) -> Dict:
    """This rank's rows of a batch (``arrays``, host numpy, as
    ``owned_batch_positions`` chose them) onto its device: each numpy
    array of ``keys`` (default all) through pinned memory with a
    non-blocking copy; other values pass through.  ``device`` defaults to
    the mesh's.  ``global_batch_size`` is checked against the rows."""
    device = torch.device(device) if device is not None else (
        mesh.device if mesh is not None else torch.device("cpu"))
    keys = set(arrays) if keys is None else set(keys)
    out = {}
    for k, v in arrays.items():
        if k in keys and isinstance(v, np.ndarray):
            if global_batch_size is not None and mesh is not None:
                want = global_batch_size // mesh.shape[DATA_AXIS] if mesh.distributed \
                    else global_batch_size
                if v.shape[0] != want:
                    raise ValueError(f"{k}: {v.shape[0]} rows, this rank owns {want}")
            host = torch.from_numpy(v)
            if device.type == "cuda":
                host = host.pin_memory()
            v = host.to(device, non_blocking=True)
        out[k] = v
    return out
