"""Multi-stream video scoring (the port's serving path).

Batches S independent camera/video streams through one state-carrying
scoring step: uint8 frames in, per-frame anomaly scores out, ConvLSTM
(h, c) tracked per stream slot.  Streams attach and detach at any time
(their slot's state resets to zeros); slot count and chunk length are
fixed at construction.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.ops.encoder_fused import fold_first_block
from vad_tpu_torch.utils.precision import STATE_DTYPE, checked_cast_like
from vad_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables


class MultiStreamScorer:
    """Fixed-slot batched scorer over independent video streams.

    Args:
        model: a ``VideoAutoencoder``; moved to ``device`` and cast to
            ``dtype`` (the scorer owns it from here on).
        variables: optional JAX-package variables tree to load into it;
            ``None`` keeps the model's own weights.
        num_slots: parallel stream capacity (the batch dimension).
        chunk: frames consumed per step per stream.
        image_size: int (square) or ``(H, W)``, each divisible by 16.
        return_maps: also return per-pixel error maps.
        dtype: compute type (``torch.bfloat16`` is the serving policy);
            the carried (h, c) stay f32 whatever it is.
        fused_input: run normalize + conv1 + BN + max-pool + LeakyReLU as
            the fused u8 input block.  ``None`` means on when the device is
            CUDA and the model has ``norm='batch'`` and ``stem='pool'``.
        device: ``None`` means CUDA (raises when there is none).
    """

    def __init__(
        self,
        model: VideoAutoencoder,
        variables: Optional[Mapping] = None,
        num_slots: int = 8,
        chunk: int = 16,
        image_size=256,
        return_maps: bool = False,
        dtype: torch.dtype = torch.float32,
        fused_input: Optional[bool] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        hw = (tuple(image_size) if isinstance(image_size, (tuple, list))
              else (image_size, image_size))
        if hw[0] % 16 or hw[1] % 16:
            raise ValueError(f"image size {hw} must be divisible by 16 (4 pool stages)")
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
        self.image_hw = hw
        self.return_maps, self.dtype, self.fused_input = return_maps, dtype, fused_input
        self._fold(model.state_dict())  # from the weights before the serving cast
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.states = model.zero_state(num_slots, *hw)
        self._active = np.zeros(num_slots, dtype=bool)

    def _fold(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """(Re)fold the first block's weights (kept f32) from a model state
        dict: the eager step reads them on every call, so a reload applies
        to them too."""
        if not self.fused_input:
            return
        w, b = fold_first_block(
            *(state_dict[f"encoder.{k}"] for k in (
                "convs.0.weight", "convs.0.bias", "norms.0.running_mean",
                "norms.0.running_var", "norms.0.weight", "norms.0.bias")),
        )
        self._w_folded, self._b_folded = w.to(self.device), b.to(self.device)

    # ------------------------------------------------------------ reload

    def reload_variables(self, variables: Mapping) -> None:
        """Hot-swap the model weights in place from a JAX-package variables
        tree.  They must match the served architecture exactly (structure,
        shapes, dtypes after the serving cast); raises ValueError (or
        KeyError for a missing key) otherwise.  Attached slots keep their
        carried (h, c)."""
        fresh = flax_to_state_dict(self.model, variables)
        new = checked_cast_like(fresh, self.model.state_dict(), self.dtype)
        self.model.load_state_dict(new, strict=True)
        self._fold(fresh)

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
        for h, c in self.states:
            h[slot] = 0
            c[slot] = 0

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    # ------------------------------------------------------------- score

    @torch.no_grad()
    def _forward(self, u8: torch.Tensor):
        """One chunk ``[S,T,H,W,3]`` from the carried state, which is left
        as it is: ``(recon [S,T,H,W,3], error maps or None, frame scores,
        new per-layer states)``."""
        s, t, h, w, _ = u8.shape
        if self.fused_input:
            recon, err, scores, new_states = self.model.stream_step_u8(
                u8.reshape(s, t, h, w * 3), self.states, self._w_folded, self._b_folded,
                self.return_maps, out_dtype=self.dtype,
            )
            return recon.reshape(u8.shape), err, scores, new_states
        x = u8.to(self.dtype) / 127.5 - 1.0
        return self.model.stream_step(x, self.states)

    @torch.no_grad()
    def _step(self, u8: torch.Tensor, submitted: torch.Tensor):
        _, err, scores, new_states = self._forward(u8)
        # only slots that submitted frames advance their carried (h, c);
        # the other rows of the batch are padding
        keep = submitted.reshape(-1, 1, 1, 1)
        self.states = tuple(
            (torch.where(keep, h_new, h_old).to(STATE_DTYPE),
             torch.where(keep, c_new, c_old).to(STATE_DTYPE))
            for (h_new, c_new), (h_old, c_old) in zip(new_states, self.states)
        )
        return scores.float(), (err.float() if self.return_maps else None)

    def score_chunk(self, frames_u8, submitted: Optional[np.ndarray] = None):
        """Score one chunk across all slots.

        Args:
            frames_u8: ``[num_slots, chunk, H, W, 3]`` uint8 (RGB), a numpy
                array or a uint8 tensor (on the scorer's device, no copy is
                made).  Inactive slots may carry arbitrary data.
            submitted: optional ``[num_slots]`` bool mask of slots whose
                rows are real frames this tick — only those slots' carried
                (h, c) advance.  Defaults to the active-slot mask.

        Returns:
            scores ``[num_slots, chunk]`` float32 numpy (NaN for inactive
            slots), and error maps ``[num_slots, chunk, H, W]`` when
            ``return_maps`` is set.
        """
        expected = (self.num_slots, self.chunk) + self.image_hw + (3,)
        if tuple(frames_u8.shape) != expected:
            raise ValueError(f"expected {expected}, got {tuple(frames_u8.shape)}")
        if submitted is None:
            submitted = self._active
        u8 = torch.as_tensor(frames_u8, device=self.device)
        if u8.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {u8.dtype}")
        mask = torch.as_tensor(np.asarray(submitted, bool), device=self.device)
        scores, maps = self._step(u8.contiguous(), mask)
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
