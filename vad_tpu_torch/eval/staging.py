"""Host-to-device copies through one pinned buffer.

CUDA copies pageable host memory through pinned staging buffers of its
own, on the calling thread: 5.7-5.9 GB/s on an H100's 8-core host, where a
copy from pinned memory runs at 42-44 GB/s.  ``StagedCopy`` owns one host
buffer (pinned when the device is CUDA) and one device buffer for a fixed
set of arrays, and copies every call's bytes afresh through them: torch's
intra-op threads fill the host buffer (``copy_``), and its DMA is issued
at once, to run while the caller issues the work that reads it.  The
caller's memory is never registered or pinned, and nothing is kept from
one call to the next but the buffers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class StagedCopy:
    """Copies host arrays of fixed shapes and dtypes to ``device``.

    ``specs``: one ``(shape, dtype)`` an array.  ``copy(*arrays)`` returns
    the device buffers, which hold the arrays' bytes until the next
    ``copy``.  ``release()`` marks, on the device's current stream, the
    point after the last work that reads them; the next ``copy`` waits for
    that point before it writes either buffer.
    """

    def __init__(self, specs: Sequence[Tuple[tuple, torch.dtype]], device) -> None:
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.host = [torch.empty(tuple(shape), dtype=dtype, pin_memory=pin)
                     for shape, dtype in specs]
        self.dest = [torch.empty(tuple(shape), dtype=dtype, device=self.device)
                     for shape, dtype in specs]
        self._refill = torch.cuda.Event() if pin else None

    def copy(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """Copy host tensors (or numpy arrays), each of its spec's shape
        and dtype, any strides; raises ``ValueError`` before writing
        anything if one does not fit."""
        arrays = tuple(torch.as_tensor(a) for a in arrays)
        if len(arrays) != len(self.host):
            raise ValueError(f"expected {len(self.host)} arrays, got {len(arrays)}")
        for a, h in zip(arrays, self.host):
            if a.device.type != "cpu" or a.shape != h.shape or a.dtype != h.dtype:
                raise ValueError(f"expected a host {h.dtype} array of shape {tuple(h.shape)}, "
                                 f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        if self._refill is not None:
            self._refill.synchronize()
        for src, host, dest in zip(arrays, self.host, self.dest):
            host.copy_(src)
            dest.copy_(host, non_blocking=True)
        return tuple(self.dest)

    def release(self) -> None:
        """Mark the end of the work that reads the device buffers (call it
        after that work is issued): the next ``copy`` waits for it."""
        if self._refill is not None:
            self._refill.record(torch.cuda.current_stream(self.device))
