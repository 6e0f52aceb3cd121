"""The serving path on the kernels' plain PyTorch versions.

``plain_versions()`` routes the recurrence (kernel 1) and the fused input
block (kernel 4) through ``convlstm_recurrence_ref`` and
``fused_first_block_ref`` inside the block, on any device, and restores
the kernels' entry points when the block ends, an exception included.  It
patches the two modules' attributes, which the models call through, so
it holds for the whole process while the block runs: the bench's plain
lines (the JAX bench's ``backend='xla'`` lines) and ``chip_smoke.py``'s
comparisons with the plain versions select it explicitly.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

from vad_tpu_torch.ops import convlstm, encoder_fused


@contextmanager
def plain_versions() -> Iterator[None]:
    """Route the serving path through the kernels' plain PyTorch versions."""
    saved = convlstm.convlstm_recurrence, encoder_fused.fused_first_block
    convlstm.convlstm_recurrence = convlstm.convlstm_recurrence_ref
    encoder_fused.fused_first_block = encoder_fused.fused_first_block_ref
    try:
        yield
    finally:
        convlstm.convlstm_recurrence, encoder_fused.fused_first_block = saved
