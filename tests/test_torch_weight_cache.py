"""The weight caches see every weight update (``vad_tpu_torch/ops/weight_cache.py``).

stepwise_tc's stage images of Wh (``ops/convlstm._tc_weights``) and kernel
4's bf16 weight terms (``ops/encoder_fused._cached_terms``) are made once
per weight state and reused.  After each way the port's code updates a
weight (a step of every optimizer ``train/state.make_optimizer`` can build,
``Adam(fused=True)`` included, whose step leaves a parameter's version as
it was; ``torch.no_grad()`` ``copy_``; ``load_state_dict``; ``p.data = x``,
as ``parallel/sharding.py`` assigns gathered weights) the next call must
return the new weights' forms.  A write through ``p.data`` is the one the
caches cannot see: ``drop_weight_caches()`` is its remedy.
"""

import numpy as np
import pytest
import torch

from vad_tpu_torch.ops import convlstm, encoder_fused
from vad_tpu_torch.ops.weight_cache import drop_weight_caches
from vad_tpu_torch.train.state import make_optimizer

C = 8


class Weights(torch.nn.Module):
    """A recurrence's Wh (f32 and bf16) and kernel 4's folded weight."""

    def __init__(self, seed: int):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.wh = torch.nn.Parameter(torch.from_numpy(
            rng.normal(size=(3, 3, C, 4 * C)).astype(np.float32)))
        self.wh16 = torch.nn.Parameter(torch.from_numpy(
            rng.normal(size=(3, 3, C, 4 * C)).astype(np.float32)).to(torch.bfloat16))
        self.w1 = torch.nn.Parameter(torch.from_numpy(
            rng.normal(size=(32, 3, 3, 3)).astype(np.float32) * 0.1))


def forms(m: Weights):
    """Every cached form of ``m``'s weights, through the caches."""
    return (convlstm._tc_weights(m.wh, "fwd"), convlstm._tc_weights(m.wh, "bwd"),
            convlstm._tc_weights(m.wh16, "fwd"), convlstm._tc_weights(m.wh, "fwd", "cpu"),
            encoder_fused._cached_terms(m.w1, 2), encoder_fused._cached_terms(m.w1, 3))


def fresh(m: Weights):
    """The same forms made anew from the weights' present values."""
    return (convlstm.tc_stage_images(m.wh.detach(), "fwd"),
            convlstm.tc_stage_images(m.wh.detach(), "bwd"),
            convlstm.tc_stage_images(m.wh16.detach(), "fwd"),
            convlstm.tc_stage_images(m.wh.detach(), "fwd"),
            encoder_fused.weight_terms(m.w1, 2), encoder_fused.weight_terms(m.w1, 3))


def assert_current(m: Weights):
    for got, want in zip(forms(m), fresh(m)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def step(optimizer_of):
    def update(m: Weights):
        opt = optimizer_of([m.wh, m.w1])
        m.wh.grad = torch.ones_like(m.wh)
        m.w1.grad = torch.ones_like(m.w1)
        opt.step()
    return update


def load_state(m: Weights):
    m.load_state_dict(Weights(seed=9).state_dict())


def no_grad_copy(m: Weights):
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(p * 3.0)


def data_assign(m: Weights):  # parallel/sharding.py's gathered weights
    for p in m.parameters():
        p.data = p.detach().clone() * 0.5


UPDATES = {
    "adam_fused": step(lambda ps: torch.optim.Adam(ps, lr=0.1, fused=True)),
    "adam_foreach": step(lambda ps: torch.optim.Adam(ps, lr=0.1, foreach=True)),
    "make_optimizer": step(lambda ps: make_optimizer(ps, 0.1)),
    "no_grad_copy": no_grad_copy,
    "load_state_dict": load_state,
    "data_assign": data_assign,
}


@pytest.mark.parametrize("update", list(UPDATES))
def test_next_call_sees_the_update(update):
    m = Weights(seed=1)
    before = forms(m)
    assert all(a is b for a, b in zip(forms(m), before))  # unchanged: the cache hits
    UPDATES[update](m)
    assert_current(m)
    after = forms(m)
    assert all(a is b for a, b in zip(forms(m), after))  # and hits again after


def test_fused_adam_leaves_the_version_but_the_hook_drops():
    """Why the caches need the optimizer hook: a fused Adam step moves the
    weights and not their version."""
    m = Weights(seed=2)
    version = m.wh._version
    before = forms(m)
    UPDATES["adam_fused"](m)
    assert m.wh._version == version
    assert not torch.equal(forms(m)[0], before[0])


def test_writes_through_data_need_drop_weight_caches():
    """``p.data.copy_`` bumps no version the caches can read: the cached
    forms stay as they were until ``drop_weight_caches()``."""
    m = Weights(seed=3)
    stale = forms(m)
    for p in m.parameters():
        p.data.copy_(p.data * 2.0)
    assert all(a is b for a, b in zip(forms(m), stale))
    drop_weight_caches()
    assert_current(m)


def test_per_device_entries_and_other_tensors():
    """The row form's stage images are kept per weight and device (the
    weight's own device when none is named); another tensor with equal
    values gets its own entry."""
    m = Weights(seed=4)
    own = convlstm._tc_weights(m.wh, "fwd")
    assert convlstm._tc_weights(m.wh, "fwd", torch.device("cpu")) is own
    twin = m.wh.detach().clone()
    assert convlstm._tc_weights(twin, "fwd") is not own
    torch.testing.assert_close(convlstm._tc_weights(twin, "fwd"), own, rtol=0, atol=0)
