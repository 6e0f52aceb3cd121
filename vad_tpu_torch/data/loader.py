"""Host-side batch loading with threaded decode (the JAX package's
``vad_tpu/data/loader.py``).

- ``Loader``: batches of host numpy dicts, the partial tail kept (or
  dropped with ``drop_remainder``), a shuffle seeded with ``seed + epoch``.
- ``device_prefetch``: moves a loader's batches to a device from a
  producer thread, ``size`` batches ahead.
- ``DistributedLoader``: the trainers' input path, the JAX package's
  ``DistributedLoader`` for one process without a mesh: ``(batch,
  n_real)`` with the tail padded by cycling.

Decode runs on a thread pool (PIL and numpy release the GIL) two batches
ahead of the consumer; arrays go to the device through pinned memory with
a non-blocking copy, so the transfer overlaps the step that is running.
Sharding over several processes or cards waits for the scaling item of
the port.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Sequence, Tuple

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


def _pipelined(getitem: Callable, items: Sequence, indices: Callable, finish: Callable,
               num_workers: int, ahead: int = 2) -> Iterator:
    """``finish(item, [getitem(i) for i in indices(item)])`` for each item in
    order.  With workers, the decodes of up to ``ahead`` items stay in
    flight and are collected only when the consumer takes their batch."""
    if num_workers == 0:
        for item in items:
            yield finish(item, [getitem(int(i)) for i in indices(item)])
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: List = []
        for item in items:
            if len(pending) == ahead:
                done, futures = pending.pop(0)
                pending.append((item, [pool.submit(getitem, int(i)) for i in indices(item)]))
                yield finish(done, [f.result() for f in futures])
            else:
                pending.append((item, [pool.submit(getitem, int(i)) for i in indices(item)]))
        for done, futures in pending:
            yield finish(done, [f.result() for f in futures])


class Loader:
    """Batched iterator over an indexable dataset, yielding host numpy
    dicts (``collate``).

    Args:
        dataset: object with ``__len__`` and ``__getitem__`` -> dict.
        batch_size: samples per batch (the final partial batch is kept).
        shuffle: a new permutation each epoch, seeded with ``seed + epoch``.
        num_workers: decode threads (0 = in line).
        drop_remainder: drop the final partial batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 4,
                 seed: int = 0, drop_remainder: bool = False) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        chunks = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(len(self))]
        yield from _pipelined(self.dataset.__getitem__, chunks, lambda chunk: chunk,
                              lambda _, samples: collate(samples), self.num_workers)


def device_prefetch(iterable: Iterable[Dict], size: int = 2, device=None) -> Iterator[Dict]:
    """``iterable``'s batches with every numpy array moved to ``device``
    (``None`` means CUDA), ``size`` batches ahead.

    A producer thread (on ``device``, when it is a card) copies each array
    into pinned host memory and on with a non-blocking copy; other values
    (metadata lists) pass through untouched.  A bounded queue of ``size``
    holds the moved batches; an exception in the producer is raised in the
    consumer."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:  # the thread sets it by index
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []

    def put(batch: Dict) -> Dict:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                host = torch.from_numpy(v)
                if device.type == "cuda":
                    host = host.pin_memory()
                v = host.to(device, non_blocking=True)
            out[k] = v
        return out

    def producer() -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for batch in iterable:
                q.put(put(batch))
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


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
        yield from _pipelined(self.dataset.__getitem__, plan, lambda item: item[0],
                              lambda item, samples: self._finish(samples, item[1]),
                              self.num_workers)
