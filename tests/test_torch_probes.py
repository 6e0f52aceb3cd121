"""The port's kernel probes against the JAX package's probe kernels.

Kernel 5 (``ops/pool_bwd.py``) and kernel 6 (``ops/encoder_fused.py``
``first_block_ablate``) run their plain PyTorch versions on the CPU (the
CUDA kernels run only on the card, where chip_smoke.py holds them against
these same plain versions).  The JAX kernels are the two tools' Pallas
kernels, in interpreter mode: ``make_pool_bwd`` is compiled alone from
``tools/probe_pool_bwd.py`` (the module runs its TPU benchmark when
imported), ``make_kernel`` is imported from ``tools/ablate_block1.py``.
Inputs come from a numpy seed.

Tolerances: kernel 5 is exact (max |delta| = 0): both sides take the same
max, the same equality test and one IEEE f32 division per window, cast
once.  Kernel 6 at the f32 bar, rtol 1e-4 / atol 1e-5
(tests/test_pallas_convlstm.py's): its conv sums 27 products in another
order than XLA's dot; the modes without a conv (``no-dot``, ``dma-only``)
are exact.
"""

import ast
import functools
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vad_tpu.ops.encoder_pallas import GROUP, KLANES, fold_first_block_params
from vad_tpu_torch.ops import encoder_fused, pool_bwd
from vad_tpu_torch.ops.encoder_fused import (
    ABLATION_MODES,
    first_block_ablate,
    first_block_ablate_ref,
    fold_first_block,
    fused_first_block_ref,
)
from vad_tpu_torch.ops.pool_bwd import max_pool2x2_backward, max_pool2x2_backward_ref
from vad_tpu_torch.tools import ablate_block1, probe_kinks, probe_pool_bwd
from vad_tpu_torch.utils.profiling import device_peaks, time_ms

ROOT = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-4, atol=1e-5)
CNT_MODES = {"full": True, "nocnt": False}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- kernel 5


@functools.lru_cache(maxsize=None)
def _jax_make_pool_bwd():
    """``make_pool_bwd`` compiled alone from the JAX probe, its
    ``pl.pallas_call`` in interpreter mode."""
    path = ROOT / "tools" / "probe_pool_bwd.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_pool_bwd")
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    namespace = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), namespace)
    return namespace["make_pool_bwd"]


def pool_inputs(kind, c, seed=0, n=2, h=8, w=16):
    """x [n,h,w,c], g [n,h/2,w/2,c]: ``ties`` draws x from {0, 1, 2}, so
    most windows hold ties (also of 3 and 4 entries)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(0, 3, size=(n, h, w, c)).astype(np.float32)
    else:
        x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    g = rng.standard_normal((n, h // 2, w // 2, c)).astype(np.float32)
    return x, g


def _port_pool_bwd(x, g, torch_dtype, count):
    xt, gt = (torch.from_numpy(a).to(torch_dtype) for a in (x, g))
    dx = max_pool2x2_backward(xt, gt, count=count)
    assert dx.dtype == torch_dtype and dx.shape == xt.shape
    return _np(dx)


@pytest.mark.parametrize("kind", ["ties", "normal"])
@pytest.mark.parametrize("cnt_mode", ["full", "nocnt"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 128])
def test_pool_bwd_matches_pallas_probe(c, dtype, cnt_mode, kind):
    x, g = pool_inputs(kind, c, seed=c)
    torch_dtype, jax_dtype = DTYPES[dtype]
    kernel = _jax_make_pool_bwd()(8, cnt_mode=cnt_mode)
    want = np.asarray(kernel(jnp.asarray(x, jax_dtype), jnp.asarray(g, jax_dtype)), np.float32)
    got = _port_pool_bwd(x, g, torch_dtype, CNT_MODES[cnt_mode])
    assert np.abs(got - want).max() == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 128])
def test_pool_bwd_matches_jax_grad(c, dtype):
    """The JAX probe's own oracle: ``jax.grad`` of a reshape-and-max,
    which splits ties evenly."""
    x, g = pool_inputs("ties", c, seed=10 + c)
    torch_dtype, jax_dtype = DTYPES[dtype]
    n, h, w, _ = x.shape
    xj, gj = jnp.asarray(x, jax_dtype), jnp.asarray(g, jax_dtype)
    _, vjp = jax.vjp(lambda v: v.reshape(n, h // 2, 2, w // 2, 2, c).max(axis=(2, 4)), xj)
    want = np.asarray(vjp(gj)[0], np.float32)
    got = _port_pool_bwd(x, g, torch_dtype, True)
    assert np.abs(got - want).max() == 0.0


def test_pool_bwd_matches_amax_autograd():
    """torch autograd of ``amax`` splits ties the same way (f32)."""
    x, g = pool_inputs("ties", 32, seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    xt.reshape(2, 4, 2, 8, 2, 32).amax(dim=(2, 4)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_port_pool_bwd(x, g, torch.float32, True), _np(xt.grad))


def test_pool_bwd_tie_semantics():
    """Every tied entry of a window gets g / ties (``count``) or all of g;
    the others get 0."""
    x = np.zeros((1, 2, 4, 1), np.float32)
    x[0, :, 2:, 0] = [[5.0, 5.0], [5.0, 1.0]]  # window 0: four ties; window 1: three
    g = np.array([[[[4.0], [3.0]]]], np.float32)
    split = _port_pool_bwd(x, g, torch.float32, True)[0, :, :, 0]
    np.testing.assert_array_equal(split, [[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0]])
    whole = _port_pool_bwd(x, g, torch.float32, False)[0, :, :, 0]
    np.testing.assert_array_equal(whole, [[4.0, 4.0, 3.0, 3.0], [4.0, 4.0, 3.0, 0.0]])


def test_pool_bwd_takes_channels_last_views():
    """A channels-last NCHW view of the same memory gives dx as the same
    view."""
    x, g = (torch.from_numpy(a) for a in pool_inputs("ties", 32, seed=4))
    want = max_pool2x2_backward(x, g)
    dx = max_pool2x2_backward(x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2))
    assert dx.shape == (2, 32, 8, 16) and dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx.permute(0, 2, 3, 1), want)


def test_pool_bwd_refuses_bad_shapes():
    x = torch.zeros((1, 3, 4, 8))
    with pytest.raises(ValueError, match="even H and W"):
        max_pool2x2_backward(x, torch.zeros((1, 1, 2, 8)))
    with pytest.raises(ValueError, match=r"\[N,H/2,W/2,C\]"):
        max_pool2x2_backward(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 2, 2, 4)))
    with pytest.raises(TypeError, match="share a dtype"):
        max_pool2x2_backward(torch.zeros((1, 4, 4, 8)),
                             torch.zeros((1, 2, 2, 8), dtype=torch.bfloat16))


def test_pool_bwd_counts_only_kernel_launches():
    before = max_pool2x2_backward.launches
    x, g = (torch.from_numpy(a) for a in pool_inputs("normal", 32))
    assert torch.equal(max_pool2x2_backward(x, g), max_pool2x2_backward_ref(x, g))
    assert pool_bwd.max_pool2x2_backward.launches == before


def test_pool_bwd_refuses_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        max_pool2x2_backward(x, torch.empty((1, 2, 2, 8), device="meta"))


# ------------------------------------------------------------- kernel 6


def _load_ablate_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ablate_block1", ROOT / "tools" / "ablate_block1.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_ablate(mode, u8, params):
    """The JAX tool's ``make_kernel(mode, ...)`` with the block specs of
    its ``build()``, interpreted, in f32; out as NHWC ``[F,H/2,W/2,32]``."""
    tool = _load_ablate_tool()
    f, h, w, _ = u8.shape
    hh, g, n = h // 2, w * 3 // 96, GROUP * 32
    w_band, bias_folded = fold_first_block_params(*params)
    call = pl.pallas_call(
        tool.make_kernel(mode, hh, g, 32, 0.2, 127.5),
        grid=(f,),
        in_specs=[
            pl.BlockSpec((1, hh, 1, g, 96), lambda i: (i, 0, 0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, hh, 1, g, 96), lambda i: (i, 0, 1, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((3 * KLANES, n), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, n), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, hh, g, n // 2), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((f, hh, g, n // 2), jnp.float32),
        interpret=True,
    )
    x5 = jnp.asarray(u8.reshape(f, hh, 2, g, 96))
    out = call(x5, x5, jnp.asarray(w_band.reshape(3 * KLANES, n)),
               jnp.asarray(bias_folded.reshape(1, n)))
    return np.asarray(out).reshape(f, hh, g * (GROUP // 2), 32)


def block_params(rng, c1=32):
    """Conv [3,3,3,C1] HWIO, bias and inference BatchNorm of a first block."""
    kernel = rng.normal(size=(3, 3, 3, c1)).astype(np.float32) * 0.2
    bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    mean = rng.normal(size=(c1,)).astype(np.float32) * 0.05
    var = rng.uniform(0.5, 2.0, size=(c1,)).astype(np.float32)
    scale = rng.normal(size=(c1,)).astype(np.float32)
    bn_bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    return kernel, bias, mean, var, scale, bn_bias


def block_inputs(seed=0, f=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    params = block_params(rng)
    u8 = rng.integers(0, 256, size=(f, h, w, 3), dtype=np.uint8)
    kernel, *rest = (torch.from_numpy(p) for p in params)
    wt, bt = fold_first_block(kernel.permute(3, 2, 0, 1), *rest)
    return u8, params, wt, bt


@pytest.mark.parametrize("mode", ["full", "no-epilogue"])
def test_ablate_matches_pallas_tool(mode):
    u8, params, wt, bt = block_inputs()
    want = _jax_ablate(mode, u8, params)
    got = first_block_ablate_ref(torch.from_numpy(u8), wt, bt, mode)
    assert got.shape == (2, 32, 32, 32) and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, **F32)


def _leaky(v):
    return np.where(v >= 0, v, 0.2 * v)


def _np_conv(xpad, w_oihw, b):
    """conv3x3 VALID of padded NHWC frames, float64."""
    h, w = xpad.shape[1] - 2, xpad.shape[2] - 2
    w_hwio = w_oihw.double().permute(2, 3, 1, 0).numpy()
    out = sum(np.einsum("fhwc,co->fhwo", xpad[:, dy:dy + h, dx:dx + w], w_hwio[dy, dx])
              for dy in range(3) for dx in range(3))
    return out + b.double().numpy()


def _np_pool(y):
    f, h, w, c = y.shape
    return y.reshape(f, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


@pytest.mark.parametrize("mode", ["no-dot", "no-band", "dma-only"])
def test_ablate_modes_follow_their_definitions(mode):
    """The three modes whose TPU outputs depend on the band layout, against
    a numpy formula of their written definition."""
    u8, _, wt, bt = block_inputs(seed=1, h=16, w=24)
    x = u8.astype(np.float64)
    if mode == "no-dot":
        xpad = np.pad(x[..., 0], ((0, 0), (1, 1), (1, 1)), constant_values=127.5)
        m = _np_pool(xpad[:, :16, :24, None])
        want = _leaky(m + bt.double().numpy())
    elif mode == "no-band":
        xpad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        want = _leaky(_np_pool(_np_conv(xpad, wt, bt)))
    else:
        want = x[:, ::2, ::2][..., np.arange(32) % 3]
    got = first_block_ablate_ref(torch.from_numpy(u8), wt, bt, mode)
    assert got.shape == (2, 8, 12, 32)
    if mode == "no-band":
        np.testing.assert_allclose(_np(got), want, **F32)
    else:
        np.testing.assert_array_equal(_np(got), want.astype(np.float32))


def test_ablate_no_epilogue_and_full_from_the_conv():
    """``no-epilogue`` is conv tap 0 plus the bias, and ``full`` is the
    fused block, on the frame padded with 127.5."""
    u8, _, wt, bt = block_inputs(seed=2, h=16, w=24)
    xpad = np.pad(u8.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                  constant_values=127.5)
    y = _np_conv(xpad, wt, bt)
    u8t = torch.from_numpy(u8)
    np.testing.assert_allclose(_np(first_block_ablate_ref(u8t, wt, bt, "no-epilogue")),
                               y[:, ::2, ::2], **F32)
    np.testing.assert_allclose(_np(first_block_ablate_ref(u8t, wt, bt, "full")),
                               _leaky(_np_pool(y)), **F32)
    assert torch.equal(first_block_ablate_ref(u8t, wt, bt, "full"),
                       fused_first_block_ref(u8t, wt, bt))


def test_ablate_bf16_casts_once():
    u8, _, wt, bt = block_inputs(seed=3, h=16, w=16)
    u8t = torch.from_numpy(u8)
    for mode in ABLATION_MODES:
        got = first_block_ablate_ref(u8t, wt, bt, mode, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, first_block_ablate_ref(u8t, wt, bt, mode).to(torch.bfloat16))


def test_ablate_counts_only_kernel_launches_and_checks_mode():
    before = encoder_fused.first_block_ablate.launches
    u8, _, wt, bt = block_inputs(seed=4, h=8, w=8)
    u8t = torch.from_numpy(u8)
    for mode in ABLATION_MODES:
        assert torch.equal(first_block_ablate(u8t, wt, bt, mode),
                           first_block_ablate_ref(u8t, wt, bt, mode))
    assert encoder_fused.first_block_ablate.launches == before
    with pytest.raises(ValueError, match="mode must be one of"):
        first_block_ablate(u8t, wt, bt, "no-dma")


def test_ablate_refuses_other_devices():
    u8 = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        first_block_ablate(u8, torch.empty(32, 3, 3, 3), torch.empty(32), "no-dot")
    weight = torch.empty(32, 3, 3, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        first_block_ablate(u8, weight, torch.empty(32), "full")


# ------------------------------------------------------------- the tools


def _json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines()]


def test_probe_pool_bwd_tool_on_cpu(capsys):
    records = probe_pool_bwd.main(["--device", "cpu", "--frames", "2", "--image", "16"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == records and len(lines) == 4 * 2 * 2
    assert [r["shape"] for r in lines[::4]] == [[2, 16, 16, 32], [2, 8, 8, 64], [2, 4, 4, 128],
                                               [2, 2, 2, 128]]
    assert all(r["device"] == "cpu" and r["max_abs_err"] == 0.0 and r["bound_ms"] is None
               and r["ms"] > 0 and r["library_ms"] > 0 for r in lines)
    assert lines[0]["bytes"] == (2 * 2 * 16 * 16 * 32 + 2 * 8 * 8 * 32) * 4


def test_ablate_tool_on_cpu(capsys):
    records = ablate_block1.main(["--device", "cpu", "--frames", "2", "--image", "32"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == records
    assert [r["mode"] for r in lines] == list(ABLATION_MODES)
    assert all(r["shape"] == [2, 32, 32, 3] and r["out_dtype"] == "bfloat16"
               and r["max_abs_err"] == 0.0 and r["us_per_frame"] > 0 for r in lines)


def test_kinks_tool_on_cpu(capsys):
    """The image model's f32 step on the CPU sits at rounding distance from
    float64 with no kink flipped, while one flipped kink moves the
    gradients a hundred times further (the cause ``ROADMAP.md`` Queue 3
    (e) records for the card)."""
    probe_kinks.main(["--device", "cpu"])
    first, half, one_kink = _json_lines(capsys.readouterr().out)
    assert (first["rows"], half["rows"]) == (16, 8)
    for r in (first, half):
        assert r["device"] == "cpu" and r["kinks_flipped"] == 0
        assert r["grad_rel_l2"]["max"] < 1e-4
        assert set(r["kinks"]) >= {"encoder.blocks.0.norm1", "decoder.norm"}
    assert one_kink["one_kink"]["median"] > 100 * first["grad_rel_l2"]["median"]


@pytest.mark.parametrize("tool", [probe_pool_bwd, ablate_block1, probe_kinks])
def test_tools_default_to_cuda(tool, monkeypatch):
    """Without --device a tool asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_block_cost_and_peaks():
    flops, nbytes = ablate_block1.block_cost(256, 256, 256, 2)
    assert flops == 2 * 256 * 256 * 256 * 32 * 27
    assert nbytes == 256 * 256 * 256 * 3 + 256 * 128 * 128 * 32 * 2 + 896 * 4
    assert ablate_block1.block_cost(256, 256, 256, 2, "dma-only") == (0, nbytes)
    assert device_peaks("NVIDIA H100 80GB HBM3") == ("H100", 989e12, 67e12, 3.35e12)
    assert device_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert time_ms(lambda: None, "cpu", iters=2, warmup=0) >= 0.0
