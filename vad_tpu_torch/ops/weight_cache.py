"""Derived forms of weight tensors, made once and reused while the weight
is unchanged.

Kernels 1-3's stepwise_tc design reads Wh as shared-memory stage images
(``ops/convlstm.py``: a TF32 split in f32, a bf16 layout in bf16) and
kernel 4 reads its folded conv weight as bf16 terms
(``ops/encoder_fused.py``).  Each form is a chain of small device ops that
a weight needs once per update, not once per call: f32 kernel 1 at B=1 is a
0.30 ms call, and making Wh's split again each call would add a tenth to
it.

A cached form is reused while all of these hold:

- the weight is the same tensor object (a weak reference to it);
- it sits on the same storage (a weak reference to the storage: ``p.data
  = x`` swaps it, and a freed storage whose address comes back to a new
  one is not taken for the old);
- at the same version, offset, shape and strides (every in-place op on the
  tensor bumps its version: ``torch.no_grad()`` ``copy_``,
  ``load_state_dict``, a foreach or single-tensor optimizer step);
- no ``torch.optim`` optimizer has stepped since it was made: a hook
  registered once, when this module is imported, with
  ``torch.optim.optimizer.register_optimizer_step_post_hook`` drops every
  cache after each step of every optimizer (``Adam(fused=True)`` updates
  its parameters without bumping their version).

What it cannot see: writes through ``p.data`` (``p.data.copy_(x)``,
``p.data.mul_(2)``: ``.data`` is a tensor with a version counter of its
own) and writes to the storage from outside PyTorch.  Call
``drop_weight_caches()`` after such a write.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.optim.optimizer import register_optimizer_step_post_hook

_CACHES: List["WeightCache"] = []


def drop_weight_caches(*_args) -> None:
    """Forget every cached form: the next call makes each anew.  (Also the
    optimizer step hook, whose arguments it ignores.)"""
    for cache in _CACHES:
        cache.clear()


class WeightCache:
    """``cache(weight, *key)`` is ``make(weight.detach(), *key)``, made once
    per weight state (see the module docstring) and ``key``; at most
    ``size`` entries, emptied whole when full."""

    def __init__(self, make: Callable[..., torch.Tensor], size: int = 16):
        self._make, self._size = make, size
        self._entries: Dict[tuple, tuple] = {}
        _CACHES.append(self)

    def __call__(self, weight: torch.Tensor, *key) -> torch.Tensor:
        storage = weight.untyped_storage()
        state = (weight._version, weight.storage_offset(), tuple(weight.shape),
                 tuple(weight.stride()))
        hit = self._entries.get((id(weight), *key))
        if (hit is not None and hit[0]() is weight and not hit[1].expired()
                and hit[1].cdata == storage._cdata and hit[2] == state):
            return hit[3]
        value = self._make(weight.detach(), *key)
        for k in [k for k, v in self._entries.items() if v[0]() is None or v[1].expired()]:
            del self._entries[k]
        if len(self._entries) >= self._size:
            self._entries.clear()
        self._entries[(id(weight), *key)] = (weakref.ref(weight), StorageWeakRef(storage),
                                             state, value)
        return value

    def clear(self) -> None:
        self._entries.clear()


register_optimizer_step_post_hook(drop_weight_caches)
