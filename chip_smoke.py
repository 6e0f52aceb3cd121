#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vad_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vad_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (f32 with TF32 off, and
bf16), then drives three paths at the default video model's full width:

- serving: ``MultiStreamScorer`` (S=16 streams, T=16 frames per chunk,
  256x256, bf16 with f32 cell state, random weights from a seed), checked
  to go through kernels 1 and 4 and to agree with the plain versions,
  then timed (frames/s) and profiled (device time by kernel, device-busy
  share) with ``fused_input`` on and off;
- training: one ``make_train_step`` step (B=8 windows of T=16 frames,
  256x256) through kernels 2 and 3, compared in f32 and bf16 with the same
  step on the plain versions (loss, every gradient, BatchNorm statistics);
  then ``fit`` for 2 epochs over in-memory orbit windows, its best
  checkpoint scored by ``MultiStreamScorer``; then the train step timed
  (frames/s) and profiled in both precisions;
- the kernel probes: kernel 5 (the tie-splitting 2x2 max-pool backward)
  held exactly against its plain version at the encoder's four pool
  inputs, kernel 6's five ablation modes against theirs (``full`` equal
  to kernel 4 bit for bit), then ``python -m vad_tpu_torch.tools.
  probe_pool_bwd`` and ``... ablate_block1`` at their defaults.

Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no such line,
when there is no CUDA device, outside a checkout of the repository, or
when any check fails.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

S, T, IMAGE = 16, 16, 256  # streams, frames per chunk, frame size
CHUNKS = 3  # chunks driven through the main path
B_TRAIN = 8  # training windows per step (T frames each)
SEED = 0
F32_BAR = dict(rtol=1e-4, atol=1e-5)  # the repo's f32 parity bar
BF16_BAR = dict(rtol=0.05, atol=0.02)  # bf16 policy with f32 cell state
# A full-width f32 train step's gradients, kernels vs plain versions: each
# is a sum over B*T*H*W terms taken in another order (read <= 8.1e-4 rel
# L2 on the H100), so rel L2 <= 2e-3 and allclose with the atol a fraction
# of the tensor's largest entry.
TRAIN_F32_BAR = dict(rtol=2e-3, atol=2e-3)
# bf16 gradients whose plain step lies at least this far (rel L2) from the
# plain f32 step are judged against that noise floor (read 0.20-0.28 on
# the first encoder layers), and kernel vs plain must stay within the
# second limit there (read <= 0.098).
BF16_NOISY, BF16_NOISY_VS_PLAIN = 0.1, 0.15

# Device-side names of the port's kernels (csrc/*.cu), for the profiles.
PORT_KERNELS = ("convlstm_step_kernel", "first_block_kernel", "gate_step_kernel",
                "dh_step_kernel", "dw_kernel")
PROBE_FRAMES = 128  # kernel 5's pool inputs: B*T of the training step (8 x 16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, warmed up)."""
    from vad_tpu_torch.utils.profiling import time_ms as timed

    return timed(fn, "cuda", iters, warmup)


def close(got, ref, bar) -> tuple:
    """(max |got - ref|, whether allclose at ``bar``) over float32 views."""
    import torch

    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()), bool(torch.allclose(got, ref, **bar))


@contextmanager
def plain_versions():
    """Route the serving path through the kernels' plain PyTorch versions."""
    from vad_tpu_torch.ops import convlstm, encoder_fused

    saved = convlstm.convlstm_recurrence, encoder_fused.fused_first_block
    convlstm.convlstm_recurrence = convlstm.convlstm_recurrence_ref
    encoder_fused.fused_first_block = encoder_fused.fused_first_block_ref
    try:
        yield
    finally:
        convlstm.convlstm_recurrence, encoder_fused.fused_first_block = saved


@contextmanager
def no_tf32():
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from vad_tpu_torch.utils.profiling import device_peaks

    name = torch.cuda.get_device_name(0)
    card, flops, f32_flops, bw = device_peaks(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "peaks_from": card, "peak_bf16_flops": flops, "peak_f32_flops": f32_flops,
          "peak_bytes_per_s": bw})
    return name, flops, bw, f32_flops


def phase_build():
    from vad_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.build(["convlstm_serving", "first_block", "convlstm_backward", "pool_bwd",
                  "first_block_ablate"])
    ptxas = {
        name: [ln.strip() for ln in rec["log"].splitlines() if "registers" in ln or "spill" in ln]
        for name, rec in _build.build_log.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "per_source_seconds": {k: v["seconds"] for k, v in _build.build_log.items()},
          "ptxas": ptxas})


def phase_convlstm(peak_flops: float, peak_bw: float) -> dict:
    """Kernel 1 against its plain version at the serving shape."""
    import torch

    from vad_tpu_torch.ops.convlstm import convlstm_recurrence, convlstm_recurrence_ref

    lat, c = IMAGE // 16, 128
    g = torch.Generator(device="cuda").manual_seed(SEED)
    gates_x = torch.randn((S, T, lat, lat, 4 * c), generator=g, device="cuda") * 0.5
    w_h = torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05
    h0 = torch.randn((S, lat, lat, c), generator=g, device="cuda") * 0.1
    c0 = torch.randn((S, lat, lat, c), generator=g, device="cuda") * 0.1
    out = {}
    for label, dtype, bar in (("f32", torch.float32, F32_BAR), ("bf16", torch.bfloat16, BF16_BAR)):
        gx, wh = gates_x.to(dtype), w_h.to(dtype)
        with no_tf32():
            seq, (hf, cf) = convlstm_recurrence(gx, wh, h0, c0)
            rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh, h0, c0)
            torch.cuda.synchronize()
        require(seq.dtype == dtype and hf.dtype == cf.dtype == torch.float32, "output dtypes")
        errs = [close(a, b, bar) for a, b in ((seq, rseq), (hf, rhf), (cf, rcf))]
        ok = all(e[1] for e in errs)
        rec = {"phase": "kernel_check", "kernel": "convlstm_serving", "dtype": label,
               "shape": list(gx.shape), "max_abs_err": max(e[0] for e in errs), "bar": bar,
               "ok": ok}
        if label == "bf16":
            rec["ms"] = time_ms(lambda: convlstm_recurrence(gx, wh, h0, c0))
            rec["plain_ms"] = time_ms(lambda: convlstm_recurrence_ref(gx, wh, h0, c0), iters=5)
            hw = lat * lat
            flops = 2 * S * T * hw * 9 * c * 4 * c
            nbytes = (S * T * hw * 4 * c * 2 + S * T * hw * c * 2  # gates_x in, h_seq out
                      + 4 * S * hw * c * 4 + 9 * c * 4 * c * 2)  # h0, c0, h_T, c_T, Wh
            rec["bound_ms"] = max(flops / peak_flops, nbytes / peak_bw) * 1e3
            rec["bound_by"] = "operations" if flops / peak_flops > nbytes / peak_bw else "bytes"
            out = rec
        emit(rec)
        require(ok, f"convlstm_serving {label} kernel vs plain version within {bar}")
    return out


def phase_first_block(peak_flops: float, peak_bw: float) -> dict:
    """Kernel 4 against its plain version at the serving shape, plus the
    unfused cuDNN block as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from vad_tpu_torch.ops.encoder_fused import (
        fold_first_block, fused_first_block, fused_first_block_ref,
    )
    from vad_tpu_torch.tools.ablate_block1 import block_cost

    n = S * T
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    u8 = torch.randint(0, 256, (n, IMAGE, IMAGE, 3), generator=g, device="cuda",
                       dtype=torch.uint8)
    kernel = torch.randn((32, 3, 3, 3), generator=g, device="cuda") * 0.2
    bias = torch.randn(32, generator=g, device="cuda") * 0.1
    mean = torch.randn(32, generator=g, device="cuda") * 0.05
    var = torch.rand(32, generator=g, device="cuda") * 1.5 + 0.5
    scale = torch.randn(32, generator=g, device="cuda")
    bn_bias = torch.randn(32, generator=g, device="cuda") * 0.1
    w, b = fold_first_block(kernel, bias, mean, var, scale, bn_bias)
    out = {}
    for label, dtype, bar in (("f32", torch.float32, F32_BAR), ("bf16", torch.bfloat16, BF16_BAR)):
        with no_tf32():
            got = fused_first_block(u8, w, b, out_dtype=dtype)
            ref = fused_first_block_ref(u8, w, b, out_dtype=dtype)
            torch.cuda.synchronize()
        require(got.shape == (n, IMAGE // 2, IMAGE // 2, 32) and got.dtype == dtype, "shape")
        err, ok = close(got, ref, bar)
        rec = {"phase": "kernel_check", "kernel": "first_block", "dtype": label,
               "shape": list(u8.shape), "max_abs_err": err, "bar": bar, "ok": ok}
        if label == "bf16":
            # the hand-off to block 2 must be a free view, not a copy
            nchw = got.permute(0, 3, 1, 2)
            require(nchw.is_contiguous(memory_format=torch.channels_last)
                    and nchw.data_ptr() == got.data_ptr(), "NHWC output views as channels-last")
            rec["ms"] = time_ms(lambda: fused_first_block(u8, w, b, out_dtype=dtype))
            rec["plain_ms"] = time_ms(lambda: fused_first_block_ref(u8, w, b, out_dtype=dtype),
                                      iters=5)
            wk, bk = kernel.to(dtype), bias.to(dtype)
            stats = [t.to(dtype) for t in (mean, var, scale, bn_bias)]

            def library():  # normalize + cuDNN conv + BN + max-pool + LeakyReLU
                x = u8.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0
                y = F.batch_norm(F.conv2d(x, wk, bk, padding=1), stats[0], stats[1],
                                 stats[2], stats[3], False, 0.0, 1e-5)
                return F.leaky_relu(F.max_pool2d(y, 2), 0.2)

            rec["library_ms"] = time_ms(library, iters=5)
            flops, nbytes = block_cost(n, IMAGE, IMAGE, got.element_size())
            rec["bound_ms"] = max(flops / peak_flops, nbytes / peak_bw) * 1e3
            rec["bound_by"] = "operations" if flops / peak_flops > nbytes / peak_bw else "bytes"
            out = rec
        emit(rec)
        require(ok, f"first_block {label} kernel vs plain version within {bar}")
    return out


def phase_edge_shapes() -> None:
    """The kernels at ragged shapes: partial tiles, frame borders, hidden
    widths that are not multiples of the tile (C=48) or of 8 (C=20, the
    plain-load path); kernel 6's modes at the ragged frame; kernel 5 at
    channel counts that need narrower vectors."""
    import torch

    from vad_tpu_torch.ops.convlstm import convlstm_recurrence, convlstm_recurrence_ref
    from vad_tpu_torch.ops.encoder_fused import (
        ABLATION_MODES, first_block_ablate, first_block_ablate_ref, fused_first_block,
        fused_first_block_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    for b, t, hgt, wid, c in ((3, 3, 5, 7, 48), (2, 4, 3, 9, 20)):
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            gx = (torch.randn((b, t, hgt, wid, 4 * c), generator=g, device="cuda") * 0.5).to(dtype)
            wh = (torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.1).to(dtype)
            h0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.3
            c0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.3
            with no_tf32():
                seq, (hf, cf) = convlstm_recurrence(gx, wh, h0, c0)
                rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh, h0, c0)
            errs = [close(a, r, bar) for a, r in ((seq, rseq), (hf, rhf), (cf, rcf))]
            cases.append({"kernel": "convlstm_serving", "shape": [b, t, hgt, wid, c],
                          "dtype": str(dtype), "max_abs_err": max(e[0] for e in errs),
                          "ok": all(e[1] for e in errs)})
    for b, t, hgt, wid, c in ((3, 3, 5, 7, 48), (2, 4, 3, 9, 20)):
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            rec, ok, _ = check_train_kernels(g, (b, t, hgt, wid, c), dtype, bar)
            cases.append({"kernel": "convlstm_train_forward+convlstm_backward",
                          "shape": [b, t, hgt, wid, c], "dtype": str(dtype),
                          "max_abs_err": rec["max_abs_err"], "ok": ok})
    u8 = torch.randint(0, 256, (3, 34, 50, 3), generator=g, device="cuda", dtype=torch.uint8)
    w = torch.randn((32, 3, 3, 3), generator=g, device="cuda") * 0.01
    bias = torch.randn(32, generator=g, device="cuda")
    with no_tf32():
        err, ok = close(fused_first_block(u8, w, bias), fused_first_block_ref(u8, w, bias), F32_BAR)
    cases.append({"kernel": "first_block", "shape": list(u8.shape), "dtype": "torch.float32",
                  "max_abs_err": err, "ok": ok})
    for mode in ABLATION_MODES:
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            with no_tf32():
                err, ok = close(first_block_ablate(u8, w, bias, mode, dtype),
                                first_block_ablate_ref(u8, w, bias, mode, dtype), bar)
            cases.append({"kernel": f"first_block_ablate {mode}", "shape": list(u8.shape),
                          "dtype": str(dtype), "max_abs_err": err, "ok": ok})
    # C=20 is not a multiple of bf16's 8-per-16-byte vector (8-byte vectors
    # run), C=7 runs one element per thread; one case as a channels-last
    # NCHW view
    for shape, nchw in (((3, 6, 10, 20), False), ((2, 4, 6, 7), False), ((3, 6, 10, 20), True)):
        cases += check_pool_bwd(g, shape, "ties", nchw=nchw)
    emit({"phase": "edge_shapes", "cases": cases})
    require(all(c["ok"] for c in cases), "kernels at ragged shapes")


def check_pool_bwd(g, shape, kind: str, nchw: bool = False) -> list:
    """Kernel 5 against its plain version at NHWC ``shape``, f32 and bf16,
    both count modes: ``ties`` draws x from {0, 1, 2} (most windows tie),
    ``normal`` from N(0, 1).  Each case must be exact (max |delta| = 0)."""
    import torch

    from vad_tpu_torch.ops.pool_bwd import max_pool2x2_backward, max_pool2x2_backward_ref

    n, h, w, c = shape
    if kind == "ties":
        x32 = torch.randint(0, 3, shape, generator=g, device="cuda").float()
    else:
        x32 = torch.randn(shape, generator=g, device="cuda")
    g32 = torch.randn((n, h // 2, w // 2, c), generator=g, device="cuda")
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x, gr = x32.to(dtype), g32.to(dtype)
        if nchw:  # channels-last NCHW views of the same memory
            x, gr = x.permute(0, 3, 1, 2), gr.permute(0, 3, 1, 2)
        for count in (True, False):
            got = max_pool2x2_backward(x, gr, count=count)
            ref = max_pool2x2_backward_ref(x, gr, count=count)
            err = float((got.float() - ref.float()).abs().max())
            cases.append({"kernel": "max_pool2x2_backward", "shape": list(shape),
                          "inputs": kind, "nchw_view": nchw, "dtype": str(dtype),
                          "cnt_mode": "full" if count else "nocnt", "max_abs_err": err,
                          "ok": err == 0.0 and got.stride() == ref.stride()})
    return cases


def phase_probes() -> dict:
    """Kernels 5 and 6, then their two probe entry points.

    Kernel 5 against its plain version at the encoder's four pool inputs
    (B*T = 128 frames), f32 and bf16, both count modes, on tie-heavy and
    normal inputs: exact.  Kernel 6's five modes against their plain
    versions at the serving chunk (256 frames of 256x256), f32 at
    ``F32_BAR`` and bf16 at ``BF16_BAR``, and ``full`` equal to kernel 4
    bit for bit.  Then ``probe_pool_bwd.main`` and ``ablate_block1.main``
    at their defaults, with the launch counts zeroed just before and read
    just after; they print their own lines."""
    import torch

    from vad_tpu_torch.ops import encoder_fused, pool_bwd
    from vad_tpu_torch.ops.encoder_fused import (
        ABLATION_MODES, first_block_ablate, first_block_ablate_ref, fused_first_block,
    )
    from vad_tpu_torch.tools import ablate_block1, probe_pool_bwd

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = []
    for shape in probe_pool_bwd.pool_shapes(PROBE_FRAMES, IMAGE):
        for kind in ("ties", "normal"):
            cases += check_pool_bwd(g, shape, kind)
    pool_err = max(c["max_abs_err"] for c in cases)
    emit({"phase": "kernel_check", "kernel": "max_pool2x2_backward", "bar": "exact",
          "max_abs_err": pool_err, "ok": all(c["ok"] for c in cases), "cases": cases})
    require(all(c["ok"] for c in cases), "kernel 5 equals its plain version at every case")

    u8 = torch.randint(0, 256, (S * T, IMAGE, IMAGE, 3), generator=g, device="cuda",
                       dtype=torch.uint8)
    w, b = ablate_block1.block_weights(g, "cuda")
    modes, full_err = [], None
    with torch.no_grad(), no_tf32():
        for mode in ABLATION_MODES:
            for label, dtype, bar in (("f32", torch.float32, F32_BAR),
                                      ("bf16", torch.bfloat16, BF16_BAR)):
                got = first_block_ablate(u8, w, b, mode, dtype)
                err, ok = close(got, first_block_ablate_ref(u8, w, b, mode, dtype), bar)
                rec = {"mode": mode, "dtype": label, "max_abs_err": err, "bar": bar, "ok": ok}
                if mode == "full":
                    rec["equals_kernel_4"] = torch.equal(got, fused_first_block(u8, w, b, dtype))
                    rec["ok"] = ok and rec["equals_kernel_4"]
                    full_err = err if label == "bf16" else full_err
                modes.append(rec)
                del got
    emit({"phase": "kernel_check", "kernel": "first_block_ablate", "shape": list(u8.shape),
          "modes": modes})
    require(all(m["ok"] for m in modes),
            "kernel 6's modes vs plain versions within their bars, full == kernel 4")
    del u8

    pool_bwd.max_pool2x2_backward.launches = 0
    encoder_fused.first_block_ablate.launches = 0
    pool_records = probe_pool_bwd.main([])
    ablate_records = ablate_block1.main([])
    launches = {"max_pool2x2_backward": pool_bwd.max_pool2x2_backward.launches,
                "first_block_ablate": encoder_fused.first_block_ablate.launches}
    emit({"phase": "probes", "launches": launches})
    require(all(v > 0 for v in launches.values()), f"both probes launched their kernel: {launches}")
    require(all(r["max_abs_err"] == 0.0 for r in pool_records), "pool probe: kernel 5 exact")
    block1 = next(r for r in pool_records if r["shape"] == [PROBE_FRAMES, IMAGE, IMAGE, 32]
                  and r["dtype"] == "bf16" and r["cnt_mode"] == "full")
    full = next(r for r in ablate_records if r["mode"] == "full")
    return {"launches": launches,
            "max_pool2x2_backward": {**block1, "max_abs_err": pool_err},
            "first_block_ablate": {**full, "max_abs_err": full_err, "library_ms": None}}


def agree(got, ref, bar=BF16_BAR, is_sum: bool = False, atol_of_max: bool = False) -> dict:
    """Max |got - ref|, its relative L2 size and the reference's scale; ok
    when allclose at ``bar`` (the bf16 bar unless given) and the relative
    L2 error is within its rtol (so a near-zero or rescaled result cannot
    hide under the atol).  ``is_sum``: ``got`` is a long sum (dWh sums
    B*T*H*W products), whose rounding grows with its terms and not with
    its value, so the atol scales with max |ref| where that exceeds 1.
    ``atol_of_max``: the atol is that fraction of max |ref| (for gradients,
    whose scale is far below 1)."""
    import torch

    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    diff = got - ref
    rel_l2 = float(diff.norm() / ref.norm().clamp_min(1e-30))
    scale = float(ref.abs().max())
    atol = bar["atol"] * (scale if atol_of_max else max(1.0, scale) if is_sum else 1.0)
    ok = bool(torch.allclose(got, ref, rtol=bar["rtol"], atol=atol)) and rel_l2 <= bar["rtol"]
    return {"max_abs_err": float(diff.abs().max()), "rel_l2": rel_l2,
            "max_abs_ref": float(ref.abs().max()), "ok": ok}


def device_profile(run, n: int = 3, unit: str = "chunk") -> dict:
    """torch.profiler over ``run(i)`` for i < ``n`` (one chunk or one train
    step each): device time summed by kernel name (device-side events
    only: the host-side aten ops carry their kernels' time too and would
    count it twice) and the device-busy share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    port = {}  # the port's own kernels, whatever their rank
    for key, us, count in rows:
        for kname in PORT_KERNELS:
            if kname in key:
                ms, calls = port.get(kname, (0.0, 0))
                port[kname] = (ms + us / n / 1e3, calls + count / n)
    return {f"{unit}s": n, f"device_ms_per_{unit}": device_us / n / 1e3,
            f"wall_ms_per_{unit}": wall / n * 1e3, "device_busy_share": device_us / 1e6 / wall,
            "kernels": [{"name": k[:100], f"ms_per_{unit}": us / n / 1e3,
                         f"calls_per_{unit}": c / n} for k, us, c in rows[:14]],
            "port_kernels": {k: {f"ms_per_{unit}": ms, f"calls_per_{unit}": calls}
                             for k, (ms, calls) in port.items()}}


def phase_main_path() -> dict:
    """MultiStreamScorer at full width through the kernels, checked against
    the plain versions and the unfused first block, then timed and
    profiled in both settings of ``fused_input``."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops import convlstm, encoder_fused

    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    chunks = torch.randint(0, 256, (CHUNKS, S, T, IMAGE, IMAGE, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    submitted = np.ones(S, bool)
    submitted[S - 1] = False  # attached but idle: its (h, c) must not move

    def scorer(**kw):
        model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
        sc = MultiStreamScorer(model, None, S, T, IMAGE, dtype=torch.bfloat16, **kw)
        for slot in range(S):
            sc.attach(slot)
        return sc

    def drive(sc):
        return np.stack([sc.score_chunk(chunks[i], submitted) for i in range(CHUNKS)])

    main = scorer()  # fused_input at its default
    require(main.fused_input, "fused_input defaults to on for a CUDA batch-norm/pool model")
    idle_before = [(h[S - 1].clone(), c[S - 1].clone()) for h, c in main.states]
    convlstm.convlstm_recurrence.launches = 0
    encoder_fused.fused_first_block.launches = 0
    scores = drive(main)
    torch.cuda.synchronize()
    launches = {"convlstm_serving": convlstm.convlstm_recurrence.launches,
                "first_block": encoder_fused.fused_first_block.launches}
    require(all(v > 0 for v in launches.values()), f"both kernels launched: {launches}")
    require(scores.shape == (CHUNKS, S, T) and bool(np.isfinite(scores).all()), "finite scores")
    idle_same = all(torch.equal(h[S - 1], h0) and torch.equal(c[S - 1], c0)
                    for (h, c), (h0, c0) in zip(main.states, idle_before))
    require(idle_same, "unsubmitted slot's (h, c) bit-identical")
    moved = any(bool(h[0].ne(0).any()) for h, _ in main.states)
    require(moved, "submitted slots' state advanced")

    # The same chunks through the plain versions and through the unfused
    # first block.  A frame score is mostly E[x^2] of the input bytes, which
    # every scorer shares, so the carried (h, c) of each layer (what kernel 1
    # wrote, from features kernel 4 began) and a further chunk's
    # reconstruction are compared as well.
    plain, unfused = scorer(), scorer(fused_input=False)
    with plain_versions():
        others = {"plain_versions": (plain, drive(plain), plain._forward(chunks[0])[0])}
    others["fused_input_false"] = (unfused, drive(unfused), unfused._forward(chunks[0])[0])
    recon = main._forward(chunks[0])[0]
    cmp = {}
    for label, (other, other_scores, other_recon) in others.items():
        pairs = {"scores": (scores, other_scores), "recon": (recon, other_recon)}
        for i, ((h, c), (oh, oc)) in enumerate(zip(main.states, other.states)):
            pairs[f"layer{i}_h"], pairs[f"layer{i}_c"] = (h, oh), (c, oc)
        cmp[label] = {what: agree(got, ref) for what, (got, ref) in pairs.items()}
    emit({"phase": "main_path_compare", "bar": BF16_BAR, "compare": cmp})
    require(all(r["ok"] for per in cmp.values() for r in per.values()),
            f"main path vs plain versions and fused_input=False within {BF16_BAR}")

    main.detach(3)
    main.attach(3)
    require(all(not bool(h[3].any()) and not bool(c[3].any()) for h, c in main.states),
            "detach/re-attach zeroes the slot's state")

    fps, prof = {}, {}
    for label, sc in (("fused_input_true", main), ("fused_input_false", unfused)):
        for i in range(2):
            sc.score_chunk(chunks[i])
        torch.cuda.synchronize()
        n = 10
        start = time.perf_counter()
        for i in range(n):
            sc.score_chunk(chunks[i % CHUNKS])  # returns host scores: synchronizes
        fps[label] = n * S * T / (time.perf_counter() - start)
        prof[label] = device_profile(lambda i: sc.score_chunk(chunks[i % CHUNKS]))
    emit({"phase": "main_path", "streams": S, "chunk": T, "image": IMAGE, "dtype": "bfloat16",
          "chunks": CHUNKS, "launches": launches, "score_mean": float(scores.mean()),
          "frames_per_s": fps, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", **prof})
    return launches


# ------------------------------------------------------------- training


def train_kernel_counters() -> dict:
    from vad_tpu_torch.ops import convlstm, encoder_fused

    return {"convlstm_serving": convlstm.convlstm_recurrence,
            "first_block": encoder_fused.fused_first_block,
            "convlstm_train_forward": convlstm.convlstm_train_forward,
            "convlstm_backward": convlstm.convlstm_backward}


def zero_counters() -> None:
    for fn in train_kernel_counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in train_kernel_counters().items()}


def check_train_kernels(g, shape, dtype, bar):
    """Kernel 2 against ``convlstm_forward_ref`` (h_seq, c_seq, finals) and
    kernel 3 against ``convlstm_backward_ref`` and against torch autograd
    of ``convlstm_recurrence_ref`` (random dh_seq, dhf, dcf), at ``shape``
    (B, T, H, W, C).  Returns (record, ok, the kernels' inputs)."""
    import torch

    from vad_tpu_torch.ops.convlstm import (
        convlstm_backward, convlstm_backward_ref, convlstm_forward_ref,
        convlstm_recurrence_ref, convlstm_train_forward,
    )

    b, t, hgt, wid, c = shape
    rnd = lambda *dims, scale=1.0: torch.randn(dims, generator=g, device="cuda") * scale  # noqa
    gx = rnd(b, t, hgt, wid, 4 * c, scale=0.5).to(dtype)
    wh = rnd(3, 3, c, 4 * c, scale=0.05).to(dtype)
    h0, c0 = rnd(b, hgt, wid, c, scale=0.1), rnd(b, hgt, wid, c, scale=0.1)
    dhs, dhf, dcf = rnd(b, t, hgt, wid, c).to(dtype), rnd(b, hgt, wid, c), rnd(b, hgt, wid, c)
    with no_tf32():
        hs, cs, (hf, cf) = convlstm_train_forward(gx, wh, h0, c0)
        rhs, rcs, (rhf, rcf) = convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=True)
        bwd_args = (gx, wh, h0, c0, rhs, rcs, dhs, dhf, dcf)
        got = convlstm_backward(*bwd_args)
        ref = convlstm_backward_ref(*bwd_args)
        leaves = [x.detach().requires_grad_() for x in (gx, wh, h0, c0)]
        ahs, (ahf, acf) = convlstm_recurrence_ref(*leaves)
        auto = torch.autograd.grad([ahs, ahf, acf], leaves, [dhs, dhf, dcf])
        torch.cuda.synchronize()
    require(cs.dtype == hs.dtype == dtype and hf.dtype == cf.dtype == torch.float32,
            "kernel 2 output dtypes")
    require([x.dtype for x in got] == [dtype, dtype, torch.float32, torch.float32],
            "kernel 3 output dtypes")
    fwd = {name: close(a, r, bar) for name, a, r in (
        ("h_seq", hs, rhs), ("c_seq", cs, rcs), ("h_T", hf, rhf), ("c_T", cf, rcf))}
    names = ("dgates_x", "dw_h", "dh0", "dc0")
    bwd = {name: agree(a, r, bar, is_sum=name == "dw_h") for name, a, r in zip(names, got, ref)}
    vs_auto = {name: agree(a, r, bar, is_sum=name == "dw_h")
               for name, a, r in zip(names, got, auto)}
    ok = (all(e[1] for e in fwd.values()) and all(r["ok"] for r in bwd.values())
          and all(r["ok"] for r in vs_auto.values()))
    rec = {"forward_vs_plain": {k: {"max_abs_err": e[0], "ok": e[1]} for k, e in fwd.items()},
           "backward_vs_plain": bwd, "backward_vs_autograd": vs_auto,
           "forward_max_abs_err": max(e[0] for e in fwd.values()),
           "backward_max_abs_err": max(r["max_abs_err"] for r in bwd.values())}
    rec["max_abs_err"] = max(rec["forward_max_abs_err"], rec["backward_max_abs_err"])
    return rec, ok, (gx, wh, h0, c0, rhs, rcs, dhs, dhf, dcf)


def phase_train_kernels(peak_flops: float, peak_bw: float, f32_flops: float) -> dict:
    """Kernels 2 and 3 at the training shape (B=8, T=16, 16x16,
    C=128), f32 (TF32 off) and bf16: checked, timed, bounded."""
    import torch

    from vad_tpu_torch.ops.convlstm import (
        convlstm_backward, convlstm_backward_ref, convlstm_forward_ref, convlstm_train_forward,
    )

    lat, c = IMAGE // 16, 128
    shape = (B_TRAIN, T, lat, lat, c)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {}
    for label, dtype, bar, flops_peak in (("f32", torch.float32, F32_BAR, f32_flops),
                                          ("bf16", torch.bfloat16, BF16_BAR, peak_flops)):
        rec, ok, args = check_train_kernels(g, shape, dtype, bar)
        gx, wh, h0, c0 = args[:4]
        e = gx.element_size()
        seq = B_TRAIN * T * lat * lat * c  # elements of one [B,T,H,W,C] tensor
        state = B_TRAIN * lat * lat * c * 4  # bytes of one f32 [B,H,W,C] tensor
        w_bytes = 9 * c * 4 * c * e
        gemm = 2 * seq * 9 * c * 4  # one implicit GEMM of the recurrence, FLOP
        costs = {
            # gates_x in, h_seq and c_seq out, h0 c0 in, finals out, Wh in
            "convlstm_train_forward": (gemm, seq * 4 * e + 2 * seq * e + 4 * state + w_bytes,
                                       lambda: convlstm_train_forward(gx, wh, h0, c0),
                                       lambda: convlstm_forward_ref(gx, wh, h0, c0, True)),
            # gates_x, h_seq, c_seq, dh_seq, Wh, h0, c0, dhf, dcf in;
            # dgates_x, dWh, dh0, dc0 out
            "convlstm_backward": (3 * gemm, 2 * seq * 4 * e + 3 * seq * e + 2 * w_bytes
                                  + 6 * state,
                                  lambda: convlstm_backward(*args),
                                  lambda: convlstm_backward_ref(*args)),
        }
        for kname, (flops, nbytes, kernel, plain) in costs.items():
            counted = train_kernel_counters()[kname]
            counted.launches = 0
            kernel()
            per_call = counted.launches
            with no_tf32():
                ms, plain_ms = time_ms(kernel, iters=10), time_ms(plain, iters=3, warmup=1)
            t_ops, t_bytes = flops / flops_peak, nbytes / peak_bw
            own = "forward" if kname == "convlstm_train_forward" else "backward"
            krec = {"phase": "kernel_check", "kernel": kname, "dtype": label,
                    "shape": list(shape), "bar": bar, "ok": ok, "ms": ms, "plain_ms": plain_ms,
                    "launches_per_call": per_call, "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops > t_bytes else "bytes",
                    "flops": flops, "bytes": nbytes, **rec,
                    "max_abs_err": rec[f"{own}_max_abs_err"]}
            emit(krec)
            if label == "bf16":
                out[kname] = krec
        require(ok, f"kernels 2 and 3 {label} vs plain versions and autograd within {bar}")
    return out


def pre_batch_norm_biases(model) -> list:
    """Conv biases that feed a train-mode BatchNorm: the norm subtracts the
    batch mean, so their exact gradient is zero and a computed one is
    rounding noise."""
    if model.norm != "batch":
        return []
    return ([f"encoder.convs.{i}.bias" for i in range(len(model.encoder.convs))]
            + [f"decoder.deconvs.{i}.bias" for i in range(len(model.decoder.norms))])


def phase_train_step_compare() -> None:
    """One full-width ``make_train_step`` step (B=8, T=16, 256x256, the
    default model from ``init_weights(seed)``) through kernels 2 and 3,
    against the same step from the same weights on the plain versions:
    the loss, every parameter's gradient and the BatchNorm running
    statistics after the step, in f32 (TF32 off) and bf16, with ``agree``:
    in f32 the loss and statistics at ``F32_BAR`` and the gradients at
    ``TRAIN_F32_BAR``; in bf16 all at ``BF16_BAR``.

    Two cases the bar cannot judge by relative error: a gradient that is
    zero by construction (``pre_batch_norm_biases``) is held to the
    allclose part only (``F32_BAR`` in f32); and in bf16 the plain step
    itself lands up to ~30% (relative L2) from the f32 step on the first
    encoder layers, so a bf16 gradient whose plain step is at least
    ``BF16_NOISY`` from the f32 step passes when it is no further from the
    plain f32 step than the plain bf16 step is (x1.25 + 0.005) and within
    ``BF16_NOISY_VS_PLAIN`` of the plain bf16 step."""
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    base = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
    zero_by_construction = set(pre_batch_norm_biases(base))
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = torch.randint(0, 256, (B_TRAIN, T, IMAGE, IMAGE, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    runs = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        step = make_train_step(mse_per_sample, dtype)
        for which in ("kernels", "plain"):
            model = copy.deepcopy(base).to("cuda")
            optimizer = make_optimizer(model.parameters(), 1e-4)
            zero_counters()
            with no_tf32(), (plain_versions() if which == "plain" else contextlib.nullcontext()):
                loss = step(model, optimizer, batch, B_TRAIN)
                torch.cuda.synchronize()
            runs[label, which] = {
                "loss": loss, "launches": read_counters(),
                "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                "stats": {n: b.clone() for n, b in model.named_buffers() if ".running_" in n},
            }
    exact = runs["f32", "plain"]["grads"]
    results = {}
    bars = {"f32": (F32_BAR, TRAIN_F32_BAR), "bf16": (BF16_BAR, BF16_BAR)}
    for label in ("f32", "bf16"):
        k, pl = runs[label, "kernels"], runs[label, "plain"]
        bar, grad_bar = bars[label]
        cmp = {"loss": agree(k["loss"], pl["loss"], bar)}
        cmp.update({f"stat:{n}": agree(st, pl["stats"][n], bar)
                    for n, st in k["stats"].items()})
        for n, gr in k["grads"].items():
            rec = agree(gr, pl["grads"][n], grad_bar, atol_of_max=label == "f32")
            if n in zero_by_construction:
                rec["ok"] = bool(torch.allclose(gr.float(), pl["grads"][n].float(), **bar))
                rec["judged_by"] = "allclose only: zero by construction"
            elif label == "bf16" and not rec["ok"]:
                err_k = agree(gr, exact[n])["rel_l2"]
                err_p = agree(pl["grads"][n], exact[n])["rel_l2"]
                if err_p >= BF16_NOISY:
                    rec.update(ok=err_k <= 1.25 * err_p + 0.005
                               and rec["rel_l2"] <= BF16_NOISY_VS_PLAIN,
                               rel_l2_vs_f32=err_k, plain_rel_l2_vs_f32=err_p,
                               judged_by="bf16 noise floor")
            cmp[f"grad:{n}"] = rec
        zero_grads = [n for n, gr in k["grads"].items() if not bool(gr.abs().max() > 0)]
        judged = {n: r for n, r in cmp.items() if "judged_by" not in r}
        worst = max(judged.items(), key=lambda kv: kv[1]["rel_l2"])
        results[label] = {
            "loss": float(k["loss"]), "plain_loss": float(pl["loss"]),
            "launches": k["launches"], "plain_launches": pl["launches"],
            "compared": len(cmp), "failed": {n: r for n, r in cmp.items() if not r["ok"]},
            "worst_by_bar": {"name": worst[0], **worst[1]},
            "worst_abs_err_of_max": max(r["max_abs_err"] / max(r["max_abs_ref"], 1e-30)
                                        for n, r in judged.items() if n.startswith("grad:")),
            "noise_floor": {n: r for n, r in cmp.items()
                            if r.get("judged_by") == "bf16 noise floor"},
            "zero_by_construction_max_abs": max(float(k["grads"][n].abs().max())
                                                for n in zero_by_construction),
            "zero_grads": zero_grads,
        }
        require(k["launches"]["convlstm_train_forward"] > 0
                and k["launches"]["convlstm_backward"] > 0,
                f"{label} train step went through kernels 2 and 3: {k['launches']}")
        require(pl["launches"]["convlstm_train_forward"] == 0
                and pl["launches"]["convlstm_backward"] == 0,
                f"{label} plain step launched no recurrence kernel: {pl['launches']}")
        require(not zero_grads, f"{label}: every parameter got a non-zero gradient")
    emit({"phase": "train_step_compare", "batch": [B_TRAIN, T, IMAGE, IMAGE, 3],
          "bars": {"f32": bars["f32"], "bf16": bars["bf16"][0],
                   "bf16_noise_floor_from": BF16_NOISY,
                   "bf16_noisy_vs_plain": BF16_NOISY_VS_PLAIN}, **results})
    require(all(not r["failed"] for r in results.values()),
            f"train step through the kernels vs the plain versions within {bars}")


def _gradient_bg(size: int):
    import numpy as np

    rows = np.arange(size, dtype=np.int32)
    base = np.stack([50 + rows // 4, 50 + rows // 4, 60 + rows // 4], axis=-1)
    return np.broadcast_to(base[:, None, :], (size, size, 3)).astype(np.uint8)


def _disk_mask(size: int, cx: float, cy: float, radius: float):
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size]
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= radius**2


def _ring_mask(size: int, cx: float, cy: float, radius: float, width: float):
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    return (d2 <= (radius + width / 2) ** 2) & (d2 >= (radius - width / 2) ** 2)


def orbit_frame(t: int, size: int, phase: float, speed: float, anomaly: bool, rng):
    """One synthetic frame (a copy of the JAX package's ``_video_frame``,
    ``vad_tpu/data/synthetic.py``): a disk orbiting the centre on a
    gradient; with ``anomaly``, a dark intruder moving against it."""
    img = _gradient_bg(size).copy()
    center, orbit_r = size / 2, size * 0.27
    ang = phase + speed * t
    cx, cy = center + orbit_r * math.cos(ang), center + orbit_r * math.sin(ang)
    r = size * 0.11
    img[_disk_mask(size, cx, cy, r)] = (200, 200, 210)
    img[_ring_mask(size, cx, cy, r, max(size // 96, 2))] = (150, 150, 160)
    if anomaly:
        ir = size * 0.09 + rng.normal() * size * 0.01
        img[_disk_mask(size, size - cx, size - cy, max(ir, 2))] = (25, 25, 30)
    return img


class WindowSet:
    """In-memory windows with the IPAD dataset's sample dicts (uint8
    frames): the machine with the card has no PIL to read PNG frames."""

    def __init__(self, labels, seed: int):
        import numpy as np

        self.labels = np.asarray(labels, np.int64)
        self.frames = np.empty((len(labels), T, IMAGE, IMAGE, 3), np.uint8)
        for w, label in enumerate(self.labels):
            rng = np.random.default_rng(seed + w)
            phase, speed = rng.uniform(0, 2 * math.pi), rng.uniform(0.12, 0.2)
            for t in range(T):
                self.frames[w, t] = orbit_frame(t, IMAGE, phase, speed, bool(label), rng)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> dict:
        import numpy as np

        return {"frames": self.frames[i], "label": self.labels[i],
                "start_frame": np.int64(0), "video": f"{i:02d}",
                "frame_labels": np.full(T, self.labels[i], np.int64)}


def phase_train() -> dict:
    """``fit`` for 2 epochs at B=8, T=16, 256x256, bf16 over 32 normal
    training windows and 16 test windows (half with the intruder); its
    best checkpoint loaded back into a ``MultiStreamScorer``; then one
    train step timed (frames/s) and profiled in bf16 and in f32."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step
    from vad_tpu_torch.train.video_trainer import fit
    from vad_tpu_torch.train_video import build_parser
    from vad_tpu_torch.utils.checkpoint import load_checkpoint

    train_ds = WindowSet([0] * 32, SEED + 100)
    test_ds = WindowSet([0, 1] * 8, SEED + 200)
    with tempfile.TemporaryDirectory() as tmp:
        args = build_parser().parse_args([
            "--category", "orbit", "--epochs", "2", "--batch-size", str(B_TRAIN),
            "--sequence-length", str(T), "--image-size", str(IMAGE), "--precision", "bf16",
            "--results-dir", tmp, "--num-workers", "2", "--seed", str(SEED),
        ])
        log = io.StringIO()
        zero_counters()
        start = time.perf_counter()
        with contextlib.redirect_stdout(log):
            result = fit(args, train_ds, test_ds, "cuda")
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - start
        launches = read_counters()
        history, run_dir = result["history"], Path(result["results_dir"])
        files = {f: (run_dir / f).exists()
                 for f in ("best_model.ckpt", "final_model.ckpt", "metrics.jsonl")}
        ckpt = load_checkpoint(run_dir / "best_model.ckpt")
        model = VideoAutoencoder.from_config(VideoAEConfig.from_args(ckpt["args"]), device="cpu")
        variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
        sc = MultiStreamScorer(model, variables, 2, T, IMAGE, dtype=torch.bfloat16)
        for slot in range(2):
            sc.attach(slot)
        scores = sc.score_chunk(test_ds.frames[:2])
    losses = history["train_loss"] + history["val_loss"]
    record = {"phase": "train", "epochs": 2, "batch": [B_TRAIN, T, IMAGE, IMAGE, 3],
              "dtype": "bfloat16", "fit_seconds": fit_seconds, "launches": launches,
              "history": history, "files": files, "best_epoch": result["best_epoch"],
              "scorer_scores_mean": float(np.mean(scores)),
              "log_tail": log.getvalue().splitlines()[-8:]}
    emit(record)
    require(len(history["train_loss"]) == 2 and all(math.isfinite(v) for v in losses),
            "2 epochs with finite losses")
    require(all(files.values()), f"checkpoint and metrics files written: {files}")
    require(launches["convlstm_train_forward"] > 0 and launches["convlstm_backward"] > 0,
            f"fit trained through kernels 2 and 3: {launches}")
    require(launches["convlstm_serving"] > 0, f"fit's eval step went through kernel 1: {launches}")
    require(scores.shape == (2, T) and bool(np.isfinite(scores).all()),
            "the best checkpoint scores a chunk in MultiStreamScorer")

    # the train step alone, timed and profiled
    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = torch.randint(0, 256, (B_TRAIN, T, IMAGE, IMAGE, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    speed = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = init_training_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
        model = model.to("cuda")
        optimizer = make_optimizer(model.parameters(), 1e-4)
        step = make_train_step(mse_per_sample, dtype)
        with no_tf32():
            for _ in range(2):
                step(model, optimizer, batch, B_TRAIN)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n = 10
            start = time.perf_counter()
            for _ in range(n):
                loss = step(model, optimizer, batch, B_TRAIN)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            prof = device_profile(lambda i: step(model, optimizer, batch, B_TRAIN), unit="step")
        speed[label] = {"train_frames_per_s": n * B_TRAIN * T / elapsed,
                        "ms_per_step": elapsed / n * 1e3, "loss": float(loss),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": prof}
        require(math.isfinite(float(loss)), f"{label} timed steps give a finite loss")
    emit({"phase": "train_speed", "batch": [B_TRAIN, T, IMAGE, IMAGE, 3], **speed})
    return launches


def main() -> int:
    try:
        import torch  # noqa: F401

        import vad_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root",
              file=sys.stderr)
        return 1
    name, peak_flops, peak_bw, f32_flops = phase_device()
    phase_build()
    checks = {"convlstm_serving": phase_convlstm(peak_flops, peak_bw),
              "first_block": phase_first_block(peak_flops, peak_bw)}
    checks.update(phase_train_kernels(peak_flops, peak_bw, f32_flops))
    phase_edge_shapes()
    launches = phase_main_path()
    phase_train_step_compare()
    train_launches = phase_train()
    probes = phase_probes()
    checks.update(probes)
    kernels = []
    for kname, source, replaces, path_launches in (
        ("convlstm_serving", "vad_tpu_torch/csrc/convlstm_serving.cu",
         "vad_tpu/ops/convlstm_pallas.py:95", launches),
        ("first_block", "vad_tpu_torch/csrc/first_block.cu",
         "vad_tpu/ops/encoder_pallas.py:169", launches),
        ("convlstm_train_forward", "vad_tpu_torch/csrc/convlstm_serving.cu",
         "vad_tpu/ops/convlstm_pallas.py:250", train_launches),
        ("convlstm_backward", "vad_tpu_torch/csrc/convlstm_backward.cu",
         "vad_tpu/ops/convlstm_pallas.py:398", train_launches),
        ("max_pool2x2_backward", "vad_tpu_torch/csrc/pool_bwd.cu",
         "tools/probe_pool_bwd.py:58", probes["launches"]),
        ("first_block_ablate", "vad_tpu_torch/csrc/first_block_ablate.cu",
         "tools/ablate_block1.py:40", probes["launches"]),
    ):
        rec = checks[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[kname], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
        })
    emit({"kernels": kernels})
    import torch

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
