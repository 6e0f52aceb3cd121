"""Device mesh and sharding layout, from one card to many processes (the
JAX package's ``vad_tpu/parallel/sharding.py``, in PyTorch's idiom).

JAX runs one SPMD program over a ``('data', 'model')`` mesh and lets XLA
insert every collective.  The port reaches the same numbers, those of the
single-device program on the global batch, with one process per rank,
``torch.distributed`` process groups for each data row and model column of
the grid, and explicit collectives:

- the batch is split over 'data'; each rank backpropagates its masked loss
  sum over the GLOBAL ``n_real`` and the gradients are summed (in f32)
  over the data group (``reduce_gradients``);
- train-mode BatchNorm sums its statistics over the data group
  (``models/norms.py``), so it normalizes by the global batch's;
- 'model' splits the ConvLSTM gate weights over their 4H output channels
  (``convlstm_param_shardings``, JAX's ``4H % mp`` rule): each rank holds
  its contiguous slice as the parameter, with Adam's moments sliced the
  same way; before the layer ``gather_slices`` all-gathers the full
  weights over the model group, so kernels 2/3 (1 in the eval step) run on
  whole operands, and its backward keeps this rank's slice of the full
  gradient.  Nothing else is sharded: the image model's ``--model-parallel``
  is data parallelism with mp-fold duplicated rows, as in JAX.

A mesh of one process (``ranks`` None) is the evaluators', the scorer's and
the daemon's form: one model replica per local device along 'data', the
batch split in rows, no collectives (``data_parallel``, JAX's
``data_parallel_jit``).  Under the spatial row split (``parallel/spatial.py``)
'model' splits each frame's rows: one model copy per grid cell, cell
``(i, j)`` holding row range j of replica i's slots
(``spatial_frame_sharding``, ``spatial_state_sharding``).

The process group comes from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
``init_distributed``.  The backend follows the topology: NCCL when each
rank has a card of its own, gloo otherwise (several ranks on one card, or
the CPU).  Only collectives that gloo has on both CPU and CUDA tensors are
used: ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_RANK_DEVICE: List[torch.device] = []  # this process's device once the group is up


class Mesh:
    """A ``('data', 'model')`` grid, data-major with the model axis trailing
    (JAX's ``get_mesh`` order).

    Multi-process (``ranks`` given: one rank a process, the process group
    up): ``ranks`` is the ``[data, model]`` grid of ranks and ``devices``
    holds each cell's device as this process sees it.  ``data_group`` is
    this rank's model column, the ranks whose rows together make the
    global batch (gradients and BatchNorm statistics are summed over it);
    ``model_group`` is its data row, the ranks that split the gate weights
    and hold the same rows.  ``device`` is this rank's device.

    One process (``ranks`` None): ``devices`` is the grid of local devices
    and there are no groups."""

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None) -> None:
        self.devices = devices
        self.ranks = ranks
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}
        self.distributed = ranks is not None
        self.data_group = self.model_group = self.backend = None
        if ranks is None:
            self.rank, self.process_count = 0, 1
            self.data_index = self.model_index = 0
        else:
            self.rank, self.process_count = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
            (i, j), = np.argwhere(ranks == self.rank)
            self.data_index, self.model_index = int(i), int(j)
            # new_group is collective: every rank makes every group, in order
            columns = [dist.new_group(ranks[:, c].tolist()) for c in range(ranks.shape[1])]
            rows = [dist.new_group(ranks[r, :].tolist()) for r in range(ranks.shape[0])]
            self.data_group, self.model_group = columns[j], rows[i]
        self.device = devices[self.data_index, self.model_index]

    def __deepcopy__(self, memo) -> "Mesh":
        return self  # process groups are process-wide; a copied module shares them

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def replica_devices(self) -> List[torch.device]:
        """The devices along 'data' (one model replica each, one process)."""
        return [self.devices[i, 0] for i in range(self.shape[DATA_AXIS])]


def _backend_for(device: torch.device, local_world: int) -> tuple:
    """(backend, this rank's device) for a rank on ``device``'s type."""
    if device.type != "cuda":
        return "gloo", torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None
                     ) -> Optional[torch.device]:
    """Join the process group and return this rank's device, or None when
    there is no group to join (one process).

    Without arguments the group is the one torchrun's environment
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), PyTorch's counterpart of JAX's multi-controller
    start; ``init_method``/``rank``/``world_size`` name one explicitly (a
    ``file://`` store, as ``multiprocess_check`` uses).  ``device`` is the
    type of device the ranks run on (``None`` means CUDA, which raises
    without a card); NCCL when every local rank has a card of its own,
    gloo otherwise.  The chosen backend is printed."""
    from vad_tpu_torch.core.device import resolve_device

    if dist.is_initialized():
        return _RANK_DEVICE[0]
    if init_method is None and not all(k in os.environ for k in (
            "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return None
    device = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if init_method is not None:
        os.environ.setdefault("LOCAL_RANK", str(rank))
    backend, rank_device = _backend_for(device, local_world)
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _RANK_DEVICE[:] = [rank_device]
    print(f"Process group: {backend}, rank {rank} of {world_size} on {rank_device}",
          flush=True)
    return rank_device


def get_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> Mesh:
    """Mesh over the given devices, else over the process group's ranks
    when one is up, else over this process's device.

    ``model_parallel`` splits off a trailing 'model' axis; the rest is
    'data'.  ``devices`` (torch devices or their names) makes a
    one-process mesh, the evaluators' and the daemon's form: one replica
    per device along 'data' (a device may repeat)."""
    if devices is None and dist.is_initialized():
        n = dist.get_world_size()
        if n % model_parallel != 0:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        ranks = np.arange(n).reshape(n // model_parallel, model_parallel)
        grid = np.empty(ranks.shape, dtype=object)
        grid.flat[:] = [_RANK_DEVICE[0] if r == dist.get_rank() else None for r in ranks.flat]
        return Mesh(grid, ranks)
    if devices is None:
        devices = [_RANK_DEVICE[0] if _RANK_DEVICE else torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty((n // model_parallel, model_parallel), dtype=object)
    grid.flat[:] = devices
    return Mesh(grid)


def local_devices(device) -> List[torch.device]:
    """Every local device of ``device``'s type: each card, or the one CPU
    (what ``--data-parallel`` spans)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def padded_batch_size(batch_size: int, mesh: Optional[Mesh], accum_steps: int = 1) -> int:
    """Smallest multiple of the data-axis size (times ``accum_steps``) >=
    ``batch_size``: every rank takes an equal slice of every microbatch."""
    n = (mesh.shape[DATA_AXIS] if mesh is not None else 1) * max(1, accum_steps)
    return ((batch_size + n - 1) // n) * n


def pad_batch_for_devices(arrays: Dict, batch_size: int) -> tuple:
    """Pad every array's leading dim up to ``batch_size`` by repeating the
    final sample.  Returns (padded, n_real); callers mask the tail."""
    first = next(v for v in arrays.values() if isinstance(v, np.ndarray))
    n_real = first.shape[0]
    if n_real == batch_size:
        return arrays, n_real
    if n_real > batch_size:
        raise ValueError(f"batch of {n_real} exceeds configured size {batch_size}")
    out = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_real:
            pad = np.repeat(v[-1:], batch_size - n_real, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        else:
            out[k] = v
    return out, n_real


def _spatial_ranges(mesh: Mesh, height: int, rows: int) -> List[slice]:
    model_n = mesh.shape[MODEL_AXIS]
    if height % (16 * model_n):
        raise ValueError(f"H={height} and H/16 must divide by the "
                         f"'{MODEL_AXIS}' axis of size {model_n}")
    per = rows // model_n
    return [slice(j * per, (j + 1) * per) for j in range(model_n)]


def spatial_frame_sharding(mesh: Mesh, height: int) -> List[slice]:
    """Frames ``[S, T, H, W, 3]`` under the spatial row split (JAX's layout
    ``P('data', None, 'model')``): the rows of H each model index holds,
    in order (slots split over 'data' as ``data_parallel`` splits them).
    Raises JAX's error unless H and H/16 divide by the 'model' axis."""
    return _spatial_ranges(mesh, height, height)


def spatial_state_sharding(mesh: Mesh, height: int) -> List[slice]:
    """The carried ConvLSTM ``(h, c)`` ``[S, H/16, W/16, C]`` under the
    spatial row split (JAX's ``P('data', 'model')``): the latent rows each
    model index holds, where the rows of its frames' activations live.
    ``height`` is the frame's H; the same rule as
    ``spatial_frame_sharding``."""
    return _spatial_ranges(mesh, height, height // 16)


# ------------------------------------------------------- tensor parallelism

# The gate parameters of each ConvLSTM layer and the dim that holds their
# 4H output channels: w_x [4H,I,3,3], w_h [3,3,H,4H], bias [4H].
GATE_DIMS = {"w_x": 0, "w_h": 3, "bias": 0}


def convlstm_param_shardings(model: torch.nn.Module, mesh: Optional[Mesh]) -> Dict[str, int]:
    """``{parameter name: sharded dim}`` for the ConvLSTM gate parameters
    split over 'model': only when the axis is > 1 and ``4H % mp == 0``
    (JAX's rule); everything else is replicated (absent)."""
    model_n = mesh.shape[MODEL_AXIS] if mesh is not None else 1
    out = {}
    if model_n <= 1:
        return out
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "convlstm" in parts and parts[-1] in GATE_DIMS:
            dim = GATE_DIMS[parts[-1]]
            if p.shape[dim] % model_n == 0:
                out[name] = dim
    return out


class _GatherSlices(torch.autograd.Function):
    """Forward: all-gather each tensor's slice over ``group`` and
    concatenate along its dim (f32 on the wire).  Backward: this rank's
    slice of each full gradient; not summed over the group, since every
    rank of a model group holds the same rows."""

    @staticmethod
    def forward(ctx, group, size, index, dims, *slices):
        ctx.dims, ctx.index = dims, index
        ctx.lengths = [s.shape[d] for s, d in zip(slices, dims)]
        flat = torch.cat([s.detach().float().reshape(-1) for s in slices])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        out, offset = [], 0
        for s, d in zip(slices, dims):
            n = s.numel()
            pieces = [p[offset:offset + n].view(s.shape) for p in parts]
            out.append(torch.cat(pieces, dim=d).to(s.dtype))
            offset += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None) + tuple(
            g.narrow(d, ctx.index * n, n).contiguous()
            for g, d, n in zip(grads, ctx.dims, ctx.lengths))


def gather_slices(slices: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh):
    """The full tensors whose contiguous slices along ``dims`` this rank's
    model group holds, in model-index order (one ``all_gather``)."""
    return _GatherSlices.apply(mesh.model_group, mesh.shape[MODEL_AXIS], mesh.model_index,
                               tuple(dims), *slices)


def _gather_full(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    with torch.no_grad():
        return gather_slices((t,), (dim,), mesh)[0]


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.shape[MODEL_AXIS]
    return t.narrow(dim, mesh.model_index * n, n).contiguous()


def distribute(model: torch.nn.Module, mesh: Optional[Mesh],
               optimizer: Optional[torch.optim.Optimizer] = None) -> Dict[str, int]:
    """Put ``model`` (full weights, the same on every rank) on the mesh:
    its BatchNorm layers sum their train-mode statistics over the data
    group, and under tensor parallelism each gate parameter is cut to this
    rank's slice in place (the parameter objects stay, so ``optimizer``
    keeps them), with ``optimizer``'s moments for it cut the same way
    (a resumed Adam state).  Returns ``convlstm_param_shardings``."""
    from vad_tpu_torch.models.norms import BatchNorm
    from vad_tpu_torch.models.video_autoencoder import ConvLSTMLayer

    if mesh is None or not mesh.distributed:
        return {}
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    shardings = convlstm_param_shardings(model, mesh)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in shardings.items():
            p = params[name]
            p.data = _slice(p.data, dim, mesh)
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = _slice(state[key], dim, mesh)
    for name, m in model.named_modules():
        if isinstance(m, ConvLSTMLayer) and f"{name}.w_h" in shardings:
            m.tp_mesh = mesh
    model.shardings = shardings
    return shardings


@contextlib.contextmanager
def gathered(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
             mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block ``model``'s sliced gate parameters and
    ``optimizer``'s moments for them are the full tensors (all-gathered
    over the model group, a collective: every rank enters), so
    ``state_dict_to_flax`` and ``optimizer.state_dict()`` give the JAX
    layout; on exit each is cut back to this rank's slice."""
    shardings = getattr(model, "shardings", None) or {}
    if mesh is None or not shardings:
        yield
        return
    params = dict(model.named_parameters())
    saved = []
    with torch.no_grad():
        for name, dim in shardings.items():
            p = params[name]
            saved.append((p, "param", p.data))
            p.data = _gather_full(p.data, dim, mesh)
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    saved.append((p, key, state[key]))
                    state[key] = _gather_full(state[key], dim, mesh)
    try:
        yield
    finally:
        for p, key, value in saved:
            if key == "param":
                p.data = value
            else:
                optimizer.state[p][key] = value


def reduce_gradients(model: torch.nn.Module, loss_sum: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum every parameter's gradient (f32) and ``loss_sum`` over the ranks
    whose rows make the global batch; returns the summed loss.

    Replicated parameters: one ``all_reduce`` over all ranks, divided by
    the model axis (each model group holds the same rows, so this is the
    data-group sum, and it leaves the replicas bit-equal on every rank).
    Sliced gate parameters: one ``all_reduce`` over the data group."""
    shardings = getattr(model, "shardings", None) or {}
    named = list(model.named_parameters())
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    groups = [([p for n, p in named if n not in shardings], True),
              ([p for n, p in named if n in shardings], False)]
    mp = mesh.shape[MODEL_AXIS]
    total = loss_sum
    for params, replicated in groups:
        if not params and not replicated:
            continue
        flat = [p.grad.float().reshape(-1) for p in params]
        if replicated:
            flat.append(loss_sum.float().reshape(1))
        buf = torch.cat(flat)
        dist.all_reduce(buf, group=None if (replicated and mp > 1) else mesh.data_group)
        if replicated and mp > 1:
            buf /= mp
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(buf[offset:offset + n].view_as(p.grad))
            offset += n
        if replicated:
            total = buf[-1]
    return total


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank (a path, a decision)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier()


# ---------------------------------------------- data parallelism, one process


def replicate(model: torch.nn.Module, mesh: Optional[Mesh]) -> List[torch.nn.Module]:
    """One replica of ``model`` per device along 'data' (the first is
    ``model`` itself when it already lives on the first device)."""
    import copy

    if mesh is None:
        return [model]
    out = []
    for i, dev in enumerate(mesh.replica_devices):
        same = next(model.parameters()).device == dev
        out.append(model if i == 0 and same else copy.deepcopy(model).to(dev))
    return out


def _to(x, device):
    """``x`` (a tensor, or a dict, list or tuple of them) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def concat_rows(outs: List, device):
    """The replicas' outputs (tensors, ``None`` or tuples of them, nested,
    batch-leading) concatenated in order on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if first is None:
        return None
    return type(first)(concat_rows([o[k] for o in outs], device) for k in range(len(first)))


def _device_of(replica) -> torch.device:
    """A replica's device: its own ``device``, else its parameters'."""
    return getattr(replica, "device", None) or next(replica.parameters()).device


def data_parallel(fn: Callable, mesh: Optional[Mesh]) -> Callable:
    """``run(replicas, x, *args)``: ``fn(replica, rows, *args)`` on each
    replica's share of ``x``'s rows (the leading dim must divide by the
    data axis; ``args`` go whole to every replica), every replica's
    launches issued before any result is read, then the outputs
    concatenated in order on ``x``'s device (``concat_rows``).
    Batch-elementwise computations give the unsplit result.  ``mesh=None``
    calls ``fn`` once: callers never special-case device counts."""
    if mesh is None:
        return lambda replicas, x, *args: fn(replicas[0], x, *args)

    def run(replicas, x, *args):
        d = len(replicas)
        if x.shape[0] % d:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over {d} replicas")
        n = x.shape[0] // d
        outs = []
        for i, replica in enumerate(replicas):
            dev = _device_of(replica)
            with (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                outs.append(fn(replica, _to(x[i * n:(i + 1) * n], dev),
                               *(_to(a, dev) for a in args)))
        return concat_rows(outs, x.device)

    return run
