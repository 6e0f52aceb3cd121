"""Precision policy helpers.

Serving runs in bfloat16 (half the bytes, tensor-core rate) with scores
within ~1% of f32; the ConvLSTM cell state stays f32 even under a bf16
policy, because it integrates across the whole stream.  Only the hidden
conv's input and the emitted hidden sequence are cast down.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Mapping

import torch

STATE_DTYPE = torch.float32  # (h, c) carried across chunks


@contextmanager
def tf32_off(enabled: bool = True):
    """f32 means f32: with ``enabled``, cuDNN's convolutions and cuBLAS's
    matrix products run without TF32 inside the block (cuDNN's default is
    TF32), and the flags are restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if enabled:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a nested dict to ``dtype`` (integer
    tensors untouched)."""
    if isinstance(tree, Mapping):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _signature(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _signature(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype)


def checked_cast_like(variables: Any, reference: Any, dtype: torch.dtype) -> Any:
    """Cast ``variables`` to the serving ``dtype`` and verify that they
    match ``reference``'s structure, shapes and dtypes exactly.

    The hot-reload contract (``MultiStreamScorer.reload_variables``): an
    architecture change needs a new scorer.  Raises ValueError on any
    mismatch."""
    new = cast_floating(variables, dtype) if dtype != torch.float32 else variables
    if _signature(new) != _signature(reference):
        raise ValueError(
            "checkpoint does not match the served architecture "
            "(structure/shape/dtype mismatch); restart the server to "
            "change architectures"
        )
    return new


def check_served_image_size(ckpt_args: dict, served) -> None:
    """Reject a hot reload of a checkpoint trained at another resolution:
    fully convolutional weights pass the structural check at any
    image_size, so a retrain at a new resolution would otherwise swap in
    silently and score frames of the old size meaninglessly.  ``served``
    is an int or (H, W)."""
    ck = ckpt_args.get("image_size")
    if ck is None:
        return  # checkpoints without args (imported weights): allow
    hw = tuple(served) if isinstance(served, (tuple, list)) else (served, served)
    if (int(ck), int(ck)) != (int(hw[0]), int(hw[1])):
        raise ValueError(
            f"checkpoint was trained at image_size={ck} but the server "
            f"is compiled for {hw}; restart the server to change resolutions"
        )


def check_served_stem(ckpt_args: dict, served_stem: str) -> None:
    """Reject a hot reload across encoder stems: 'pool' and 'stride2'
    checkpoints have identical parameter shapes (the pool has none), so
    the structural check cannot tell them apart, but they are different
    functions."""
    ck = str(ckpt_args.get("stem", "pool"))
    if ck != str(served_stem or "pool"):
        raise ValueError(
            f"checkpoint was trained with --stem {ck} but the server is "
            f"compiled for the '{served_stem}' stem (identical parameter "
            "shapes, different function); restart the server to change stems"
        )
