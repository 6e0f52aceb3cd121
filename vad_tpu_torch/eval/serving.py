"""Multi-stream video scoring (the port's serving path).

Batches S independent camera/video streams through one state-carrying
scoring step: uint8 frames in, per-frame anomaly scores out, ConvLSTM
(h, c) tracked per stream slot.  Streams attach and detach at any time
(their slot's state resets to zeros); slot count and chunk length are
fixed at construction.

With a ``mesh`` (one process, ``parallel.sharding.get_mesh``) the slots
split over its 'data' axis: one model replica per device there, each with
``num_slots / d`` slots, its own carried (h, c) and its own folded
weights (refolded on reload).  Streams never mix, so there are no
collectives; every replica's launches are issued before any result is
read.

With ``spatial=True`` each frame's rows also split over the mesh's 'model'
axis (JAX's spatial partitioning, the scaling axis for few high-resolution
streams): each data replica holds one model copy per model index, on
``mesh.devices[i, j]`` (a device may repeat), each with its rows of the
carried (h, c) in f32, and ``parallel/spatial.py`` runs the forward over
the row shards with every halo exchange written out, kernel 1 in its row
form.  As in JAX, the fused u8 input block (kernel 4) is off there.

A clip model (``models/memae.py`` ``MemAutoencoder``) carries no state:
each stream's chunk is one clip of the model's ``sequence_length``
frames, scored alone (``states`` is empty).  It runs on one device,
without the fused input block, with inference BatchNorm3d folded into its
convolutions once at construction (``models/memae.fold_for_scoring``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.eval.staging import StagedCopy
from vad_tpu_torch.models import memae
from vad_tpu_torch.models.memae import MemAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, fold_for_scoring
from vad_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    concat_rows,
    data_parallel,
    replicate,
    spatial_frame_sharding,
    spatial_state_sharding,
)
from vad_tpu_torch.parallel.spatial import RowSplit, replicate_grid
from vad_tpu_torch.utils.precision import STATE_DTYPE, checked_cast_like
from vad_tpu_torch.utils.profiling import span
from vad_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables


class _Replica:
    """One model copy on one device serving the slots ``[lo, hi)``: its
    carried (h, c) and, with the fused input block, its folded weights."""

    def __init__(self, model: VideoAutoencoder, device: torch.device, lo: int, hi: int,
                 hw, fused_input: bool, dtype: torch.dtype, return_maps: bool) -> None:
        self.model, self.device, self.lo, self.hi = model, device, lo, hi
        self.models = [model]
        self.fused_input, self.dtype, self.return_maps = fused_input, dtype, return_maps
        self.states = model.zero_state(hi - lo, *hw)

    def zero_slot(self, k: int) -> None:
        """Zero the carried (h, c) of this replica's slot ``k``."""
        for h, c in self.states:
            h[k] = 0
            c[k] = 0

    def fold(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """(Re)fold inference BatchNorm from a model state dict taken before
        the serving cast (``fold_for_scoring``): the first block's weights
        for kernel 4 and every later block's, which then end in one
        epilogue pass each.  The eager step reads them on every call, so a
        reload applies to them too."""
        if self.fused_input:
            self.folded = fold_for_scoring(state_dict, self.dtype, self.device)

    @torch.no_grad()
    def forward(self, u8: torch.Tensor):
        """One chunk ``[s,T,H,W,3]`` of this replica's slots from the
        carried state, which is left as it is: ``(recon [s,T,H,W,3], error
        maps or None, frame scores, new per-layer states)``."""
        s, t, h, w, _ = u8.shape
        if self.fused_input:
            recon, err, scores, new_states = self.model.stream_step_u8(
                u8.reshape(s, t, h, w * 3), self.states, self.folded, self.return_maps)
            return recon.reshape(u8.shape), err, scores, new_states
        x = u8.to(self.dtype) / 127.5 - 1.0
        return self.model.stream_step(x, self.states)

    @torch.no_grad()
    def step(self, u8: torch.Tensor, submitted: torch.Tensor):
        """Score this replica's slots ``u8`` and advance the carried (h, c)
        of those that ``submitted`` (the mask over every slot) marks:
        ``(frame scores, error maps or None)``."""
        _, err, scores, new_states = self.forward(u8)
        # only slots that submitted frames advance their carried (h, c);
        # the other rows of the batch are padding
        keep = submitted[self.lo:self.hi].reshape(-1, 1, 1, 1)
        self.states = tuple(
            (torch.where(keep, h_new, h_old).to(STATE_DTYPE),
             torch.where(keep, c_new, c_old).to(STATE_DTYPE))
            for (h_new, c_new), (h_old, c_old) in zip(new_states, self.states)
        )
        return scores.float(), (err.float() if self.return_maps else None)


class _ClipReplica:
    """A clip model serving every slot: no state across chunks, so every
    slot's chunk is scored alone and ``submitted`` changes nothing."""

    def __init__(self, model: MemAutoencoder, device: torch.device, num_slots: int,
                 return_maps: bool, dtype: torch.dtype) -> None:
        self.model, self.device, self.lo, self.hi = model, device, 0, num_slots
        self.models = [model]
        self.return_maps, self.dtype = return_maps, dtype
        self.states = ()
        self.folded = None

    def zero_slot(self, k: int) -> None:
        """Nothing is carried."""

    def fold(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Fold inference BatchNorm3d from a model state dict taken before
        the serving cast (``memae.fold_for_scoring``): each folded layer
        then ends in one epilogue pass."""
        self.folded = memae.fold_for_scoring(state_dict, self.dtype, self.device)

    @torch.no_grad()
    def forward(self, u8: torch.Tensor):
        """``_Replica.forward``'s contract; the reconstruction is gray
        ``[s,T,H,W]`` and the new states empty."""
        recon, err, scores = self.model.score_clips(u8, self.return_maps, self.folded)
        return recon, err, scores, ()

    @torch.no_grad()
    def step(self, u8: torch.Tensor, submitted: torch.Tensor):
        _, err, scores = self.model.score_clips(u8, self.return_maps, self.folded)
        return scores, err


class _RowReplica:
    """One data replica under the spatial row split, serving the slots
    ``[lo, hi)``: a model copy per model index (``models[j]`` on its own
    device, holding frame rows ``frame_rows[j]`` and latent rows
    ``state_rows[j]``) with its rows of the carried (h, c)."""

    def __init__(self, models, lo: int, hi: int, hw, frame_rows, state_rows,
                 dtype: torch.dtype, return_maps: bool) -> None:
        self.models, self.lo, self.hi = list(models), lo, hi
        self.split = RowSplit(self.models)
        self.devices, self.device = self.split.devices, self.split.device
        self.frame_rows, self.dtype, self.return_maps = frame_rows, dtype, return_maps
        self.shard_states = [
            tuple((h[:, r].contiguous(), c[:, r].contiguous())
                  for h, c in m.zero_state(hi - lo, *hw))
            for m, r in zip(self.models, state_rows)]

    @property
    def states(self):
        """Every layer's (h, c) of these slots, the rows joined on the
        first device."""
        return tuple(
            (torch.cat([st[k][0].to(self.device) for st in self.shard_states], dim=1),
             torch.cat([st[k][1].to(self.device) for st in self.shard_states], dim=1))
            for k in range(len(self.shard_states[0])))

    @states.setter
    def states(self, states) -> None:
        rows = [0] + list(np.cumsum([st[0][0].shape[1] for st in self.shard_states]))
        self.shard_states = [
            tuple((h[:, rows[j]:rows[j + 1]].to(dev).contiguous(),
                   c[:, rows[j]:rows[j + 1]].to(dev).contiguous()) for h, c in states)
            for j, dev in enumerate(self.devices)]

    def zero_slot(self, k: int) -> None:
        for st in self.shard_states:
            for h, c in st:
                h[k] = 0
                c[k] = 0

    def fold(self, state_dict) -> None:
        """No fused input block under the row split."""

    def _run(self, u8: torch.Tensor):
        xs = [(u8[:, :, r].to(dev).to(self.dtype) / 127.5 - 1.0)
              for r, dev in zip(self.frame_rows, self.devices)]
        return self.split.stream_step(xs, self.shard_states)

    @torch.no_grad()
    def forward(self, u8: torch.Tensor):
        """``_Replica.forward``'s contract, the shards joined on the first
        device; the carried state is left as it is."""
        recon, errs, scores, new = self._run(u8)

        def join(parts, dim):
            return torch.cat([p.to(self.device) for p in parts], dim=dim)

        states = tuple((join([st[k][0] for st in new], 1), join([st[k][1] for st in new], 1))
                       for k in range(len(new[0])))
        return join(recon, 2), join(errs, 2), scores, states

    @torch.no_grad()
    def step(self, u8: torch.Tensor, submitted: torch.Tensor):
        """``_Replica.step``'s contract: each shard's rows of the submitting
        slots' (h, c) advance on its own device."""
        _, errs, scores, new = self._run(u8)
        shard_states = []
        for dev, old_st, new_st in zip(self.devices, self.shard_states, new):
            keep = submitted[self.lo:self.hi].to(dev).reshape(-1, 1, 1, 1)
            shard_states.append(tuple(
                (torch.where(keep, h_new, h_old).to(STATE_DTYPE),
                 torch.where(keep, c_new, c_old).to(STATE_DTYPE))
                for (h_new, c_new), (h_old, c_old) in zip(new_st, old_st)))
        self.shard_states = shard_states
        err = None
        if self.return_maps:
            err = torch.cat([e.to(self.device) for e in errs], dim=2).float()
        return scores.float(), err


def _image_hw(image_size):
    """``image_size`` (an int, square, or ``(H, W)``) as ``(H, W)``, each
    divisible by 16 (either model halves a frame four times)."""
    hw = (tuple(image_size) if isinstance(image_size, (tuple, list))
          else (image_size, image_size))
    if hw[0] % 16 or hw[1] % 16:
        raise ValueError(f"image size {hw} must be divisible by 16 (4 pool stages)")
    return hw


class MultiStreamScorer:
    """Fixed-slot batched scorer over independent video streams.

    Args:
        model: a ``VideoAutoencoder`` or a ``MemAutoencoder`` (a clip
            model: module docstring); moved to ``device`` and cast to
            ``dtype`` (the scorer owns it from here on).
        variables: optional JAX-package variables tree to load into it;
            ``None`` keeps the model's own weights.
        num_slots: parallel stream capacity (the batch dimension).
        chunk: frames consumed per step per stream (a clip model's
            ``sequence_length``).
        image_size: int (square) or ``(H, W)``, each divisible by 16.
        return_maps: also return per-pixel error maps.
        dtype: compute type (``torch.bfloat16`` is the serving policy);
            the carried (h, c), and a clip model's memory read, stay f32
            whatever it is.
        fused_input: run normalize + conv1 + BN + max-pool + LeakyReLU as
            the fused u8 input block, and encoder blocks 2-4 and the
            decoder with inference BatchNorm folded into their
            convolutions, each ending in one epilogue pass
            (``ops/block_epilogue.py``).  ``None`` means on when the device
            is CUDA and the model has ``norm='batch'`` and ``stem='pool'``.
        device: ``None`` means CUDA (raises when there is none); with a
            ``mesh``, its first device along 'data'.
        mesh: a one-process ``parallel.sharding.Mesh``: the slots split
            over its 'data' axis, one replica per device there (module
            docstring); ``num_slots`` must divide by the axis.
        spatial: also split each frame's rows over the mesh's 'model' axis
            (module docstring); needs a mesh, ``fused_input`` off (``None``
            means off here) and H, H/16 divisible by the axis.
    """

    def __init__(
        self,
        model: Union[VideoAutoencoder, MemAutoencoder],
        variables: Optional[Mapping] = None,
        num_slots: int = 8,
        chunk: int = 16,
        image_size=256,
        return_maps: bool = False,
        dtype: torch.dtype = torch.float32,
        fused_input: Optional[bool] = None,
        device=None,
        mesh=None,
        spatial: bool = False,
    ) -> None:
        if isinstance(model, MemAutoencoder):
            if variables is not None:
                raise ValueError("a MemAE model takes its weights as a state dict "
                                 "(load_state_dict), not a JAX variables tree")
            self._init_clip(model, num_slots, chunk, image_size, return_maps, dtype,
                            fused_input, device, mesh, spatial)
            return
        if spatial and mesh is None:
            raise ValueError("spatial=True requires a mesh")
        if mesh is not None:
            device = mesh.replica_devices[0]
            data_n = mesh.shape[DATA_AXIS]
            if num_slots % data_n != 0:
                raise ValueError(f"num_slots={num_slots} must divide evenly over the "
                                 f"'{DATA_AXIS}' mesh axis of size {data_n}")
        self.device = resolve_device(device)
        hw = _image_hw(image_size)
        if spatial:
            if fused_input:
                raise ValueError("spatial=True is incompatible with fused_input")
            fused_input = False
            frame_rows = spatial_frame_sharding(mesh, hw[0])
            state_rows = spatial_state_sharding(mesh, hw[0])
        foldable = model.norm == "batch" and model.stem == "pool"
        if fused_input is None:
            fused_input = self.device.type == "cuda" and foldable
        elif fused_input and not foldable:
            raise ValueError(
                "fused_input folds inference BatchNorm into conv1 and ends in a "
                f"max-pool; this model has norm={model.norm!r}, stem={model.stem!r}"
            )
        if variables is not None:
            load_flax_variables(model, variables)
        self.num_slots, self.chunk = num_slots, chunk
        self.image_size, self.image_hw = image_size, hw  # as given; (H, W)
        self.return_maps, self.dtype, self.fused_input = return_maps, dtype, fused_input
        self.mesh, self.spatial = mesh, spatial
        weights = model.state_dict()  # the fold reads the weights before the serving cast
        model = model.to(device=self.device, dtype=dtype).eval()
        copies = replicate_grid(model, mesh) if spatial else replicate(model, mesh)
        per = num_slots // len(copies)
        self._replicas = []
        for i, copy in enumerate(copies):
            lo, hi = i * per, (i + 1) * per
            if spatial:
                replica = _RowReplica(copy, lo, hi, hw, frame_rows, state_rows, dtype,
                                      return_maps)
            else:
                replica = _Replica(copy, next(copy.parameters()).device, lo, hi, hw,
                                   fused_input, dtype, return_maps)
            replica.fold(weights)
            self._replicas.append(replica)
        kind = _RowReplica if spatial else _Replica
        self._forward_rows = data_parallel(kind.forward, mesh)
        self._step_rows = data_parallel(kind.step, mesh)
        self._active = np.zeros(num_slots, dtype=bool)
        self._staging = None  # the staged copy's buffers, from the first host chunk

    def _init_clip(self, model: MemAutoencoder, num_slots: int, chunk: int, image_size,
                   return_maps: bool, dtype: torch.dtype, fused_input: Optional[bool], device,
                   mesh, spatial: bool) -> None:
        """The scorer of a clip model (module docstring)."""
        for name, value in (("fused_input", fused_input), ("mesh", mesh),
                            ("spatial", spatial)):
            if value:
                raise ValueError(f"{name} is not supported for a clip model (MemAE): "
                                 "it runs on one device from the uint8 frames")
        if chunk != model.sequence_length:
            raise ValueError(f"a MemAE chunk is one clip of sequence_length="
                             f"{model.sequence_length} frames, got chunk={chunk}")
        self.device = resolve_device(device)
        hw = _image_hw(image_size)
        self.num_slots, self.chunk = num_slots, chunk
        self.image_size, self.image_hw = image_size, hw
        self.return_maps, self.dtype, self.fused_input = return_maps, dtype, False
        self.mesh, self.spatial = None, False
        weights = model.state_dict()  # the fold reads the weights before the serving cast
        model = model.to(self.device).eval().cast_for_scoring(dtype)
        replica = _ClipReplica(model, self.device, num_slots, return_maps, dtype)
        replica.fold(weights)
        self._replicas = [replica]
        self._forward_rows = data_parallel(_ClipReplica.forward, None)
        self._step_rows = data_parallel(_ClipReplica.step, None)
        self._active = np.zeros(num_slots, dtype=bool)
        self._staging = None

    @property
    def model(self) -> VideoAutoencoder:
        """The first replica's (first) model (the only one without a mesh)."""
        return self._replicas[0].models[0]

    @property
    def states(self):
        """Every layer's carried (h, c) over all slots ``[num_slots, h, w,
        C]`` f32 (a copy: the replicas' concatenated on the first device)."""
        return concat_rows([r.states for r in self._replicas], self.device)

    @states.setter
    def states(self, states) -> None:
        for r in self._replicas:
            r.states = tuple((h[r.lo:r.hi].to(r.device), c[r.lo:r.hi].to(r.device))
                             for h, c in states)

    # ------------------------------------------------------------ reload

    def reload_variables(self, variables: Mapping) -> None:
        """Hot-swap the model weights in place from a JAX-package variables
        tree, in every replica.  They must match the served architecture
        exactly (structure, shapes, dtypes after the serving cast); raises
        ValueError (or KeyError for a missing key) otherwise.  Attached
        slots keep their carried (h, c).  A clip model (MemAE) has no hot
        reload: it raises ValueError."""
        if isinstance(self.model, MemAutoencoder):
            raise ValueError("hot reload of a MemAE model is not supported: "
                             "restart the server with the new checkpoint")
        fresh = flax_to_state_dict(self.model, variables)
        new = checked_cast_like(fresh, self.model.state_dict(), self.dtype)
        for r in self._replicas:
            for m in r.models:
                m.load_state_dict(new, strict=True)
            r.fold(fresh)

    # ------------------------------------------------------------- slots

    def attach(self, slot: Optional[int] = None) -> int:
        """Claim a stream slot (state zeroed); returns the slot id."""
        if slot is None:
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                raise RuntimeError(f"all {self.num_slots} stream slots busy")
            slot = int(free[0])
        if self._active[slot]:
            raise RuntimeError(f"slot {slot} already attached")
        self._reset_slot(slot)
        self._active[slot] = True
        return slot

    def detach(self, slot: int) -> None:
        self._active[slot] = False

    def _reset_slot(self, slot: int) -> None:
        for r in self._replicas:
            if r.lo <= slot < r.hi:
                r.zero_slot(slot - r.lo)

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    # ------------------------------------------------------------- score

    @torch.no_grad()
    def _forward(self, u8: torch.Tensor):
        """One chunk ``[S,T,H,W,3]`` from the carried state, which is left
        as it is: ``(recon [S,T,H,W,3], error maps or None, frame scores,
        new per-layer states)``."""
        return self._forward_rows(self._replicas, u8)

    @torch.no_grad()
    def _step(self, u8: torch.Tensor, submitted: torch.Tensor):
        return self._step_rows(self._replicas, u8, submitted)

    def _stages(self, frames: torch.Tensor) -> bool:
        """Whether ``frames`` go in through the staged copy: host memory
        bound for a CUDA device."""
        return frames.device.type == "cpu" and self.device.type == "cuda"

    def score_chunk(self, frames_u8, submitted: Optional[np.ndarray] = None):
        """Score one chunk across all slots.

        Args:
            frames_u8: ``[num_slots, chunk, H, W, 3]`` uint8 (RGB), a numpy
                array or a uint8 tensor (on the scorer's device, no copy is
                made).  Inactive slots may carry arbitrary data.  Host
                frames bound for a CUDA device are copied afresh through
                the scorer's pinned buffer (``eval/staging.py``).
            submitted: optional ``[num_slots]`` bool mask of slots whose
                rows are real frames this tick — only those slots' carried
                (h, c) advance.  Defaults to the active-slot mask.

        Returns:
            scores ``[num_slots, chunk]`` float32 numpy (NaN for inactive
            slots), and error maps ``[num_slots, chunk, H, W]`` when
            ``return_maps`` is set.
        """
        with span("vad.scorer.chunk"):
            expected = (self.num_slots, self.chunk) + self.image_hw + (3,)
            if tuple(frames_u8.shape) != expected:
                raise ValueError(f"expected {expected}, got {tuple(frames_u8.shape)}")
            frames = torch.as_tensor(frames_u8)  # a numpy array's own memory
            if frames.dtype != torch.uint8:
                raise TypeError(f"frames must be uint8, got {frames.dtype}")
            if submitted is None:
                submitted = self._active
            mask = torch.as_tensor(np.asarray(submitted, bool))
            staged = self._stages(frames)
            with span("vad.scorer.h2d"):
                if staged:
                    with span("vad.scorer.stage"):
                        if self._staging is None:
                            self._staging = StagedCopy(
                                [(expected, torch.uint8), ((self.num_slots,), torch.bool)],
                                self.device)
                        u8, mask = self._staging.copy(frames, mask)
                else:
                    u8, mask = frames.to(self.device), mask.to(self.device)
            try:
                with span("vad.scorer.step"):
                    scores, maps = self._step(u8.contiguous(), mask)
            finally:  # a step that raised may still have work in flight
                if staged:
                    self._staging.release()
            scores = scores.cpu().numpy()
            scores[~self._active] = np.nan
            if self.return_maps:
                return scores, maps.cpu().numpy()
            return scores

    def score_streams(self, streams: Dict[int, Sequence[np.ndarray]]) -> Dict[int, np.ndarray]:
        """Feed per-slot frame lists (each a chunk of frames).  Only the
        submitting slots' carried state advances."""
        batch = np.zeros((self.num_slots, self.chunk) + self.image_hw + (3,), np.uint8)
        submitted = np.zeros(self.num_slots, bool)
        for slot, frames in streams.items():
            if not self._active[slot]:
                raise RuntimeError(f"slot {slot} is not attached")
            arr = np.stack(list(frames))
            if arr.shape[0] != self.chunk:
                raise ValueError(f"slot {slot}: expected {self.chunk} frames, got {arr.shape[0]}")
            batch[slot] = arr
            submitted[slot] = True
        scores = self.score_chunk(batch, submitted=submitted)
        return {slot: scores[slot] for slot in streams}
