"""Host-side batch loading with threaded decode (the JAX package's
``DistributedLoader`` for one process, without a mesh).

Decode runs on a thread pool (PIL and numpy release the GIL) two batches
ahead of the consumer; the ``frames`` (video) or ``image`` array goes to
the device through pinned memory with a non-blocking copy, so the
transfer overlaps the step that is running.  Sharding over several processes or cards waits for
the scaling item of the port.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device

# Keys that hold per-sample str metadata rather than stackable arrays.
_META_KEYS = ("path", "defect_type", "video")
# Array keys moved to the device; the rest stay host numpy.
DEVICE_KEYS = ("frames", "image")


def collate(samples: List[Dict]) -> Dict[str, Any]:
    """Stack a list of sample dicts into one batch dict."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        batch[key] = vals if key in _META_KEYS else np.stack(vals)
    return batch


class DistributedLoader:
    """Batched iterator over an indexable dataset, yielding ``(batch,
    n_real)``.

    Each batch's index list is padded to ``pad_to`` (default
    ``batch_size``) by CYCLING its real indices (``np.resize``), so a
    padded tail batch's train-mode BatchNorm statistics equal the
    unpadded batch's whenever ``pad_to % n_real == 0``; ``n_real`` counts
    the real samples for the loss mask.  The shuffle is a permutation
    seeded with ``seed + epoch``.

    Args:
        dataset: object with ``__len__`` and ``__getitem__`` -> dict.
        batch_size: real samples consumed per step.
        pad_to: static batch shape (>= batch_size).
        shuffle/seed: epoch-seeded permutation.
        num_workers: decode threads (0 = synchronous).
        device: where ``frames`` or ``image`` goes (``None`` means CUDA).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        pad_to: int | None = None,
        shuffle: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        device=None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to = batch_size if pad_to is None else pad_to
        if self.pad_to < batch_size:
            raise ValueError(f"pad_to {self.pad_to} is below batch_size {batch_size}")
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.device = resolve_device(device)
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _epoch_plan(self) -> List[Tuple[np.ndarray, int]]:
        """[(indices, n_real)] for every batch this epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        plan = []
        for step in range(len(self)):
            lo = step * self.batch_size
            real = min(self.batch_size, n - lo)
            idx = order[lo : lo + real]
            if real < self.pad_to:
                idx = np.resize(idx, self.pad_to)  # cycle, not repeat-last
            plan.append((idx, real))
        return plan

    def _finish(self, samples: List[Dict], n_real: int):
        batch = collate(samples)
        for key in DEVICE_KEYS:
            if key in batch:
                host = torch.from_numpy(batch[key])
                if self.device.type == "cuda":
                    host = host.pin_memory()
                batch[key] = host.to(self.device, non_blocking=True)
        return batch, n_real

    def __iter__(self) -> Iterator:
        plan = self._epoch_plan()
        self._epoch += 1
        if not plan:
            return
        if self.num_workers == 0:
            for idx, n_real in plan:
                yield self._finish([self.dataset[int(i)] for i in idx], n_real)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # decode futures for up to 2 batches stay in flight while the
            # caller consumes batch N
            pending = []
            ahead = 2
            it = iter(plan)

            def submit(item):
                idx, n_real = item
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in idx], n_real

            for item in it:
                pending.append(submit(item))
                if len(pending) == ahead:
                    break
            for item in it:
                futures, n_real = pending.pop(0)
                pending.append(submit(item))
                yield self._finish([f.result() for f in futures], n_real)
            for futures, n_real in pending:
                yield self._finish([f.result() for f in futures], n_real)
