#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vad_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vad_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (f32 with TF32 off, and
bf16), then drives the serving path — ``MultiStreamScorer`` at the
default video model's full width (S=16 streams, T=16 frames per chunk,
256x256, bf16 with f32 cell state, random weights from a seed) — and
checks that it went through both kernels and agrees with the plain
versions, then times it (frames/s) and profiles it (device time by
kernel, device-busy share) with ``fused_input`` on and off.  Each phase
prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no such line,
when there is no CUDA device, outside a checkout of the repository, or
when any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager

S, T, IMAGE = 16, 16, 256  # streams, frames per chunk, frame size
CHUNKS = 3  # chunks driven through the main path
SEED = 0
F32_BAR = dict(rtol=1e-4, atol=1e-5)  # the repo's f32 parity bar
BF16_BAR = dict(rtol=0.05, atol=0.02)  # bf16 policy with f32 cell state

# Dense peaks per card (data sheets): bf16 tensor FLOP/s, memory bytes/s.
PEAKS = {
    "H100 PCIe": (756e12, 2.0e12),
    "H100 NVL": (835e12, 3.9e12),
    "H100": (989e12, 3.35e12),  # SXM, also the fallback
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, warmed up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    name = torch.cuda.get_device_name(0)
    card, (flops, bw) = peaks_for(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "peaks_from": card, "peak_bf16_flops": flops, "peak_bytes_per_s": bw})
    return name, flops, bw


def phase_build():
    from vad_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.build(["convlstm_serving", "first_block"])
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
            flops = 2 * n * IMAGE * IMAGE * 32 * 27
            nbytes = n * IMAGE * IMAGE * 3 + n * (IMAGE // 2) ** 2 * 32 * 2 + (864 + 32) * 4
            rec["bound_ms"] = max(flops / peak_flops, nbytes / peak_bw) * 1e3
            rec["bound_by"] = "operations" if flops / peak_flops > nbytes / peak_bw else "bytes"
            out = rec
        emit(rec)
        require(ok, f"first_block {label} kernel vs plain version within {bar}")
    return out


def phase_edge_shapes() -> None:
    """Both kernels at ragged shapes: partial tiles, frame borders, hidden
    widths that are not multiples of the tile (C=48) or of 8 (C=20, the
    plain-load path)."""
    import torch

    from vad_tpu_torch.ops.convlstm import convlstm_recurrence, convlstm_recurrence_ref
    from vad_tpu_torch.ops.encoder_fused import fused_first_block, fused_first_block_ref

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
    u8 = torch.randint(0, 256, (3, 34, 50, 3), generator=g, device="cuda", dtype=torch.uint8)
    w = torch.randn((32, 3, 3, 3), generator=g, device="cuda") * 0.01
    bias = torch.randn(32, generator=g, device="cuda")
    with no_tf32():
        err, ok = close(fused_first_block(u8, w, bias), fused_first_block_ref(u8, w, bias), F32_BAR)
    cases.append({"kernel": "first_block", "shape": list(u8.shape), "dtype": "torch.float32",
                  "max_abs_err": err, "ok": ok})
    emit({"phase": "edge_shapes", "cases": cases})
    require(all(c["ok"] for c in cases), "kernels at ragged shapes")


def agree(got, ref) -> dict:
    """Max |got - ref|, its relative L2 size and the reference's scale; ok
    when allclose at the bf16 bar and the relative L2 error is within its
    rtol (so a near-zero or rescaled result cannot hide under the atol)."""
    import torch

    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    diff = got - ref
    rel_l2 = float(diff.norm() / ref.norm().clamp_min(1e-30))
    ok = bool(torch.allclose(got, ref, **BF16_BAR)) and rel_l2 <= BF16_BAR["rtol"]
    return {"max_abs_err": float(diff.abs().max()), "rel_l2": rel_l2,
            "max_abs_ref": float(ref.abs().max()), "ok": ok}


def device_profile(sc, chunks, n: int = 3) -> dict:
    """torch.profiler over ``n`` chunks: device time summed by kernel name
    (device-side events only: the host-side aten ops carry their kernels'
    time too and would count it twice) and the device-busy share of the
    window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(n):
            sc.score_chunk(chunks[i % len(chunks)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    return {"chunks": n, "device_ms_per_chunk": device_us / n / 1e3,
            "wall_ms_per_chunk": wall / n * 1e3, "device_busy_share": device_us / 1e6 / wall,
            "kernels": [{"name": k[:100], "ms_per_chunk": us / n / 1e3, "calls_per_chunk": c / n}
                        for k, us, c in rows[:14]]}


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
        prof[label] = device_profile(sc, chunks)
    emit({"phase": "main_path", "streams": S, "chunk": T, "image": IMAGE, "dtype": "bfloat16",
          "chunks": CHUNKS, "launches": launches, "score_mean": float(scores.mean()),
          "frames_per_s": fps, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", **prof})
    return launches


def main() -> int:
    try:
        import torch  # noqa: F401

        import vad_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root",
              file=sys.stderr)
        return 1
    name, peak_flops, peak_bw = phase_device()
    phase_build()
    k1 = phase_convlstm(peak_flops, peak_bw)
    k4 = phase_first_block(peak_flops, peak_bw)
    phase_edge_shapes()
    launches = phase_main_path()
    kernels = []
    for rec, kname, source, replaces in (
        (k1, "convlstm_serving", "vad_tpu_torch/csrc/convlstm_serving.cu",
         "vad_tpu/ops/convlstm_pallas.py:95"),
        (k4, "first_block", "vad_tpu_torch/csrc/first_block.cu",
         "vad_tpu/ops/encoder_pallas.py:169"),
    ):
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
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
