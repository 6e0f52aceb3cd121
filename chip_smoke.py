#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vad_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vad_tpu_torch/csrc`` (reporting each
source's nvcc seconds and each kernel's registers, shared memory and
spills), holds each against its plain PyTorch version on the card (f32
with TF32 off, and bf16; the recurrence kernels 1-3 in every design their
plan can choose at each checked shape, with the plan, the launches per
call, the clusters that fit, kernel 3's time by part and its dWh repeated
bit for bit; kernel 4 with its design and time in both dtypes, and kernels
4 and 6 at ragged frames), then drives four paths at the default video
model's full width:

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
- evaluation, on that checkpoint, f32 with TF32 off, frames made in memory:
  ``--video-dir`` (``score_videos`` over 24 ragged clips on 16 slots,
  through kernels 1 and 4), ``--video`` (``stream_scores``, kernel 1 at
  batch 1) and dataset scoring (``score_windows``), each against the plain
  versions and ``--video-dir`` also against each clip scored alone, with
  frames/s and device time by kernel; then a 64-chunk bf16 stream whose
  carried (h, c) must stay within the bf16 bar of the plain versions;
  ``temporal_features`` (kernel 1 stepwise, f32) against the plain
  versions; and ``--scorer latent`` (the latent-distance scorer fitted on
  training windows' frames) over the test windows, with its AUROC;
- the image model (``ImageAEConfig()``, 256x256) on an MVTec-format
  fixture written with the port's generator: one train step on the card
  against the same step on the CPU (f32 with TF32 off, and bf16), then
  ``python -m vad_tpu_torch.train`` for 2 epochs and ``python -m
  vad_tpu_torch.evaluate`` with both scorers (in process), the card's
  scores and latent maps against the CPU's, train and evaluation images/s
  and profiles (no port kernel runs there);
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
import re
import shutil
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

# Device-side names of the port's kernels (csrc/*.cu), for the profiles; a
# kernel counts under the first name it contains, so longer names that
# contain shorter ones come first.
PORT_KERNELS = ("recurrence_kernel", "convlstm_step_kernel", "first_block_kernel",
                "gate_all_kernel", "gate_kernel", "loop_kernel", "step_kernel", "finish_kernel",
                "dw_kernel_res", "dw_reduce_kernel", "dw_kernel")
# Kernel 3's parts, by device-side name: the gate recompute, the reverse
# loop and dWh in either design, and the stepwise design's last launch
# (dh0 and the sum of the dWh partials).
BWD_PARTS = {"gate_kernel": "gate", "gate_all_kernel": "gate", "loop_kernel": "loop",
             "step_kernel": "loop", "dw_kernel_res": "dw", "dw_reduce_kernel": "dw",
             "dw_kernel": "dw", "finish_kernel": "dh0+dw_sum"}
PROBE_FRAMES = 128  # kernel 5's pool inputs: B*T of the training step (8 x 16)
# Ragged recurrence shapes (B, T, H, W, C): C=48 is no multiple of any
# tile, C=20 of 8 (the plain-load path), 5x7 and 3x9 frames; 8x8 with C=32
# (kernels 1-2 resident in a cluster of 2 with one pixel tile, kernel 3
# stepwise), 8x16 with C=64 (all resident, clusters of 4, two tiles) and
# 8x32 with C=128 (four tiles, but the resident blocks would need 235,536
# bytes of shared memory: every kernel stepwise).
EDGE_SHAPES = ((3, 3, 5, 7, 48), (2, 4, 3, 9, 20), (3, 2, 8, 8, 32), (2, 3, 8, 16, 64),
               (2, 3, 8, 32, 128))
# Ragged frames for kernels 4 and 6 (F, H, W, 3): rows of 150 and 810
# bytes, off 16 (the masked byte path), and 17 and 11 pooled rows (ragged
# last bands of 8); 270 wide spans three bands of 64 pooled columns; 208
# wide has 16-byte rows (whole-chunk loads) and a ragged second span.
EDGE_FRAMES = ((3, 34, 50, 3), (2, 22, 270, 3), (2, 26, 208, 3))
# The evaluation paths (phase_eval): clips of 40-300 frames for --video-dir
# (more clips than slots, so slots recycle), one clip for --video, all cut
# from a bank of orbit frames; the profiled windows' chunks; and the long
# stream whose carried state is checked for drift (64 chunks = 1,024
# frames), with the chunks at which its distance is reported.
EVAL_CLIPS, VIDEO_FRAMES, BANK_FRAMES, PROFILE_CHUNKS = 24, 300, 128, 4
DRIFT_CHUNKS, DRIFT_REPORT = 64, (1, 4, 16, 64)
# The image phase: training images per step of the card-vs-CPU step
# comparison (the CPU takes the same step), and the largest relative L2
# distance between the card's and the CPU's scores and maps (f32, TF32 off).
IMAGE_COMPARE_B, IMAGE_CPU_REL_L2 = 8, 1e-4


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


def no_tf32():
    """f32 convolutions and matrix products without TF32 inside the block."""
    from vad_tpu_torch.utils.precision import tf32_off

    return tf32_off()


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
    return name, flops, bw, f32_flops, smi


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory, stack and spills of each kernel in one
    source's ``-Xptxas -v`` output, by demangled name where ``c++filt`` is
    on the PATH."""
    kernels, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            kernels[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", ln)
            if m:
                kernels[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                     spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                kernels[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                kernels[name]["static_smem"] = int(m.group(1)) if m else 0
    if shutil.which("c++filt") and kernels:
        names = subprocess.run(["c++filt"], input="\n".join(kernels), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
        kernels = {re.sub(r"\(anonymous namespace\)::", "", short): rec
                   for short, rec in zip(names, kernels.values())}
    return kernels


def phase_build():
    from vad_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.build(["convlstm_serving", "first_block", "convlstm_backward", "pool_bwd",
                  "first_block_ablate"])
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "per_source_seconds": {k: v["seconds"] for k, v in _build.build_log.items()},
          "ptxas": {name: ptxas_summary(rec["log"]) for name, rec in _build.build_log.items()}})


def designs(kernel: str, shape, dtype) -> list:
    """Every design ``recurrence_plan`` can choose for ``kernel`` at
    ``shape`` (B, T, H, W, C) and ``dtype``, its own choice first."""
    from vad_tpu_torch.ops.convlstm import recurrence_plan, resident_fits

    b, t, hgt, wid, c = shape
    chosen = recurrence_plan(kernel, b, t, hgt, wid, c, dtype).design
    other = [] if not resident_fits(kernel, hgt, wid, c, dtype) else [
        d for d in ("resident", "stepwise") if d != chosen]
    return [chosen] + other


def plan_record(kernel: str, shape, dtype, design=None) -> dict:
    from dataclasses import asdict

    from vad_tpu_torch.ops.convlstm import recurrence_plan

    return asdict(recurrence_plan(kernel, *shape, dtype, design))


def phase_convlstm(peak_flops: float, peak_bw: float, f32_flops: float) -> dict:
    """Kernel 1 against its plain version at the serving shape, in every
    design its plan can choose there (f32: stepwise; bf16: resident, and
    stepwise forced); the plan's own choice bounded in both dtypes."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_recurrence_ref, recurrence_plan

    lat, c = IMAGE // 16, 128
    shape = (S, T, lat, lat, c)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    gates_x = torch.randn((S, T, lat, lat, 4 * c), generator=g, device="cuda") * 0.5
    w_h = torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05
    h0 = torch.randn((S, lat, lat, c), generator=g, device="cuda") * 0.1
    c0 = torch.randn((S, lat, lat, c), generator=g, device="cuda") * 0.1
    out, f32 = {}, {}
    for label, dtype, bar in (("f32", torch.float32, F32_BAR), ("bf16", torch.bfloat16, BF16_BAR)):
        gx, wh = gates_x.to(dtype), w_h.to(dtype)
        choices = designs("convlstm_serving", shape, dtype)
        for design in choices:
            plan = recurrence_plan("convlstm_serving", *shape, dtype, design)

            def kernel(p=plan):
                seq, _, final = cl._forward_kernel(gx, wh, h0, c0, False, p)
                return seq, final

            with no_tf32():
                cl.convlstm_recurrence.launches = 0
                seq, (hf, cf) = kernel()
                per_call = cl.convlstm_recurrence.launches
                rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh, h0, c0)
                torch.cuda.synchronize()
            require(seq.dtype == dtype and hf.dtype == cf.dtype == torch.float32, "output dtypes")
            errs = [close(a, b, bar) for a, b in ((seq, rseq), (hf, rhf), (cf, rcf))]
            ok = all(e[1] for e in errs) and per_call == plan.launches
            rec = {"phase": "kernel_check", "kernel": "convlstm_serving", "dtype": label,
                   "shape": list(gx.shape), "design": design, "plan": plan_record(
                       "convlstm_serving", shape, dtype, design),
                   "launches_per_call": per_call, "max_abs_err": max(e[0] for e in errs),
                   "bar": bar, "ok": ok, "ms": time_ms(kernel)}
            if plan.cluster > 1:
                rec["active_clusters"] = cl.active_clusters("convlstm_serving", S, lat, lat, c)
            if design == choices[0]:
                hw, e = lat * lat, gx.element_size()
                flops = 2 * S * T * hw * 9 * c * 4 * c
                nbytes = (S * T * hw * 4 * c * e + S * T * hw * c * e  # gates_x in, h_seq out
                          + 4 * S * hw * c * 4 + 9 * c * 4 * c * e)  # h0, c0, h_T, c_T, Wh
                t_ops = flops / (peak_flops if label == "bf16" else f32_flops)
                rec["bound_ms"] = max(t_ops, nbytes / peak_bw) * 1e3
                rec["bound_by"] = "operations" if t_ops > nbytes / peak_bw else "bytes"
                rec["tflops"] = flops / rec["ms"] / 1e9
                if label == "bf16":
                    out = rec
                else:
                    f32 = {k: rec[k] for k in ("design", "ms", "bound_ms", "bound_by", "tflops")}
            emit(rec)
            require(ok, f"convlstm_serving {label} {design} vs plain version within {bar}, "
                        f"{per_call} launches as planned ({plan.launches})")
        if label == "bf16":
            out["plain_ms"] = time_ms(lambda: convlstm_recurrence_ref(gx, wh, h0, c0), iters=5)
            out["f32"] = f32
            emit({**out, "phase": "kernel_time"})
    return out


def phase_first_block(peak_flops: float, peak_bw: float) -> dict:
    """Kernel 4 against its plain version at the serving shape, plus the
    unfused cuDNN block as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from vad_tpu_torch.ops import _build
    from vad_tpu_torch.ops.encoder_fused import (
        DESIGN, WEIGHT_TERMS, first_block_grid, fold_first_block, fused_first_block,
        fused_first_block_ref,
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
        ptxas = ptxas_summary(_build.build_log.get("first_block", {}).get("log", ""))
        own = "first_block_kernel<" + ("__nv_bfloat16" if label == "bf16" else "float")
        resources = {k: v for k, v in ptxas.items() if own in k}
        rec = {"phase": "kernel_check", "kernel": "first_block", "dtype": label,
               "shape": list(u8.shape), "max_abs_err": err, "bar": bar, "ok": ok,
               "design": {**DESIGN, "weight_terms": WEIGHT_TERMS[dtype],
                          "blocks": first_block_grid(n, IMAGE, IMAGE, dtype),
                          "bands": n * (IMAGE // 2 // DESIGN["band_pooled_rows"])
                          * -(-(IMAGE // 2) // DESIGN["band_pooled_cols"]),
                          "ptxas": resources},
               "ms": time_ms(lambda: fused_first_block(u8, w, b, out_dtype=dtype))}
        flops, nbytes = block_cost(n, IMAGE, IMAGE, got.element_size())
        rec["bound_ms"] = max(flops / peak_flops, nbytes / peak_bw) * 1e3
        rec["bound_by"] = "operations" if flops / peak_flops > nbytes / peak_bw else "bytes"
        if label == "bf16":
            # the hand-off to block 2 must be a free view, not a copy
            nchw = got.permute(0, 3, 1, 2)
            require(nchw.is_contiguous(memory_format=torch.channels_last)
                    and nchw.data_ptr() == got.data_ptr(), "NHWC output views as channels-last")
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

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import SMEM_LIMIT, convlstm_recurrence_ref, recurrence_plan
    from vad_tpu_torch.ops.encoder_fused import (
        ABLATION_MODES, first_block_ablate, first_block_ablate_ref, fused_first_block,
        fused_first_block_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    for shape in EDGE_SHAPES:
        b, t, hgt, wid, c = shape
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            gx = (torch.randn((b, t, hgt, wid, 4 * c), generator=g, device="cuda") * 0.5).to(dtype)
            wh = (torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.1).to(dtype)
            h0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.3
            c0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.3
            for design in designs("convlstm_serving", shape, dtype):
                plan = recurrence_plan("convlstm_serving", *shape, dtype, design)
                with no_tf32():
                    cl.convlstm_recurrence.launches = 0
                    seq, _, (hf, cf) = cl._forward_kernel(gx, wh, h0, c0, False, plan)
                    rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh, h0, c0)
                errs = [close(a, r, bar) for a, r in ((seq, rseq), (hf, rhf), (cf, rcf))]
                cases.append({"kernel": "convlstm_serving", "shape": list(shape),
                              "dtype": str(dtype), "design": design,
                              "smem_bytes": plan.smem_bytes,
                              "launches_per_call": cl.convlstm_recurrence.launches,
                              "max_abs_err": max(e[0] for e in errs),
                              "ok": all(e[1] for e in errs) and plan.smem_bytes <= SMEM_LIMIT
                              and cl.convlstm_recurrence.launches == plan.launches})
    for shape in EDGE_SHAPES:
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            for design in train_designs(shape, dtype):
                rec, ok, _ = check_train_kernels(g, shape, dtype, bar, design)
                smem = {k: p["smem_bytes"] for k, p in rec["plans"].items()}
                cases.append({"kernel": "convlstm_train_forward+convlstm_backward",
                              "shape": list(shape), "dtype": str(dtype),
                              "designs": rec["designs"], "smem_bytes": smem,
                              "launches_per_call": rec["launches_per_call"],
                              "dw_h_bitwise_repeat": rec["dw_h_bitwise_repeat"],
                              "max_abs_err": rec["max_abs_err"],
                              "ok": ok and max(smem.values()) <= SMEM_LIMIT})
    # a frame of four tiles whose resident blocks would not fit: the plan's
    # own choice must be stepwise for every kernel
    over = [k for k in ("convlstm_serving", "convlstm_train_forward", "convlstm_backward")
            if recurrence_plan(k, *EDGE_SHAPES[-1], torch.bfloat16).design != "stepwise"]
    require(not over, f"8x32 C=128 bf16 takes the stepwise design, not resident: {over}")
    for frames in EDGE_FRAMES:
        u8 = torch.randint(0, 256, frames, generator=g, device="cuda", dtype=torch.uint8)
        w = torch.randn((32, 3, 3, 3), generator=g, device="cuda") * 0.01
        bias = torch.randn(32, generator=g, device="cuda")
        for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
            with no_tf32():
                err, ok = close(fused_first_block(u8, w, bias, dtype),
                                fused_first_block_ref(u8, w, bias, dtype), bar)
            cases.append({"kernel": "first_block", "shape": list(u8.shape), "dtype": str(dtype),
                          "max_abs_err": err, "ok": ok})
            for mode in ABLATION_MODES:
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
                break
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


def train_designs(shape, dtype) -> list:
    """The designs to run kernels 2 and 3 in at ``shape``: each that the
    plan of either can choose, the plan's own choice first."""
    both = designs("convlstm_train_forward", shape, dtype)
    return both + [d for d in designs("convlstm_backward", shape, dtype) if d not in both]


def train_plans(shape, dtype, design=None) -> dict:
    """Kernels 2 and 3's plans at ``shape``: ``design`` where it fits the
    kernel, else the plan's own choice."""
    from vad_tpu_torch.ops.convlstm import recurrence_plan, resident_fits

    plans = {}
    for kname in ("convlstm_train_forward", "convlstm_backward"):
        fits = design != "resident" or resident_fits(kname, *shape[2:], dtype)
        plans[kname] = recurrence_plan(kname, *shape, dtype, design if fits else None)
    return plans


def check_train_kernels(g, shape, dtype, bar, design=None):
    """Kernel 2 against ``convlstm_forward_ref`` (h_seq, c_seq, finals) and
    kernel 3 against ``convlstm_backward_ref`` and against torch autograd
    of ``convlstm_recurrence_ref`` (random dh_seq, dhf, dcf), at ``shape``
    (B, T, H, W, C), in ``design`` where it fits (``train_plans``).  Also
    that each launches what its plan says and that two calls of kernel 3
    give bit-identical dWh.  Returns (record, ok, the kernels' inputs)."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import (
        convlstm_backward_ref, convlstm_forward_ref, convlstm_recurrence_ref,
    )

    plans = train_plans(shape, dtype, design)
    b, t, hgt, wid, c = shape
    rnd = lambda *dims, scale=1.0: torch.randn(dims, generator=g, device="cuda") * scale  # noqa
    gx = rnd(b, t, hgt, wid, 4 * c, scale=0.5).to(dtype)
    wh = rnd(3, 3, c, 4 * c, scale=0.05).to(dtype)
    h0, c0 = rnd(b, hgt, wid, c, scale=0.1), rnd(b, hgt, wid, c, scale=0.1)
    dhs, dhf, dcf = rnd(b, t, hgt, wid, c).to(dtype), rnd(b, hgt, wid, c), rnd(b, hgt, wid, c)
    with no_tf32():
        cl.convlstm_train_forward.launches = cl.convlstm_backward.launches = 0
        hs, cs, (hf, cf) = cl._forward_kernel(gx, wh, h0, c0, True,
                                              plans["convlstm_train_forward"])
        rhs, rcs, (rhf, rcf) = convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=True)
        bwd_args = (gx, wh, h0, c0, rhs, rcs, dhs, dhf, dcf)
        got = cl._backward_kernel(*bwd_args, plan=plans["convlstm_backward"])
        again = cl._backward_kernel(*bwd_args, plan=plans["convlstm_backward"])
        launches = {"convlstm_train_forward": cl.convlstm_train_forward.launches,
                    "convlstm_backward": cl.convlstm_backward.launches // 2}
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
    repeat = bool(torch.equal(got[1], again[1]))
    as_planned = all(launches[k] == p.launches for k, p in plans.items())
    ok = (all(e[1] for e in fwd.values()) and all(r["ok"] for r in bwd.values())
          and all(r["ok"] for r in vs_auto.values()) and repeat and as_planned)
    rec = {"designs": {k: p.design for k, p in plans.items()},
           "plans": {k: plan_record(k, shape, dtype, p.design) for k, p in plans.items()},
           "launches_per_call": launches, "dw_h_bitwise_repeat": repeat,
           "forward_vs_plain": {k: {"max_abs_err": e[0], "ok": e[1]} for k, e in fwd.items()},
           "backward_vs_plain": bwd, "backward_vs_autograd": vs_auto,
           "forward_max_abs_err": max(e[0] for e in fwd.values()),
           "backward_max_abs_err": max(r["max_abs_err"] for r in bwd.values())}
    rec["max_abs_err"] = max(rec["forward_max_abs_err"], rec["backward_max_abs_err"])
    return rec, ok, (gx, wh, h0, c0, rhs, rcs, dhs, dhf, dcf)


def phase_train_kernels(peak_flops: float, peak_bw: float, f32_flops: float) -> dict:
    """Kernels 2 and 3 at the training shape (B=8, T=16, 16x16, C=128),
    f32 (TF32 off) and bf16, in every design their plans can choose there
    (f32: stepwise; bf16: resident, and stepwise forced): checked, timed,
    bounded, and kernel 3 timed by part (gate recompute, reverse loop, dWh)
    from a device profile of three calls."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_backward_ref, convlstm_forward_ref

    lat, c = IMAGE // 16, 128
    shape = (B_TRAIN, T, lat, lat, c)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {}
    for label, dtype, bar, flops_peak in (("f32", torch.float32, F32_BAR, f32_flops),
                                          ("bf16", torch.bfloat16, BF16_BAR, peak_flops)):
        for design in train_designs(shape, dtype):
            plans = train_plans(shape, dtype, design)
            rec, ok, args = check_train_kernels(g, shape, dtype, bar, design)
            gx, wh, h0, c0 = args[:4]
            e = gx.element_size()
            seq = B_TRAIN * T * lat * lat * c  # elements of one [B,T,H,W,C] tensor
            state = B_TRAIN * lat * lat * c * 4  # bytes of one f32 [B,H,W,C] tensor
            w_bytes = 9 * c * 4 * c * e
            gemm = 2 * seq * 9 * c * 4  # one implicit GEMM of the recurrence, FLOP
            fwd_plan, bwd_plan = plans["convlstm_train_forward"], plans["convlstm_backward"]
            costs = {
                # gates_x in, h_seq and c_seq out, h0 c0 in, finals out, Wh in
                "convlstm_train_forward": (gemm, seq * 4 * e + 2 * seq * e + 4 * state + w_bytes,
                                           lambda: cl._forward_kernel(gx, wh, h0, c0, True,
                                                                      fwd_plan),
                                           lambda: convlstm_forward_ref(gx, wh, h0, c0, True)),
                # gates_x, h_seq, c_seq, dh_seq, Wh, h0, c0, dhf, dcf in;
                # dgates_x, dWh, dh0, dc0 out
                "convlstm_backward": (3 * gemm, 2 * seq * 4 * e + 3 * seq * e + 2 * w_bytes
                                      + 6 * state,
                                      lambda: cl._backward_kernel(*args, plan=bwd_plan),
                                      lambda: convlstm_backward_ref(*args)),
            }
            for kname, (flops, nbytes, kernel, plain) in costs.items():
                plan = plans[kname]
                with no_tf32():
                    ms = time_ms(kernel, iters=10)
                    plain_ms = (time_ms(plain, iters=3, warmup=1) if design == train_designs(
                        shape, dtype)[0] else None)
                t_ops, t_bytes = flops / flops_peak, nbytes / peak_bw
                own = "forward" if kname == "convlstm_train_forward" else "backward"
                krec = {"phase": "kernel_check", "kernel": kname, "dtype": label,
                        "shape": list(shape), **rec, "design": plan.design,
                        "plan": rec["plans"][kname], "bar": bar, "ok": ok, "ms": ms,
                        "plain_ms": plain_ms, "launches_per_call": rec["launches_per_call"][kname],
                        "bound_ms": max(t_ops, t_bytes) * 1e3,
                        "bound_by": "operations" if t_ops > t_bytes else "bytes",
                        "tflops": flops / ms / 1e9, "flops": flops, "bytes": nbytes,
                        "max_abs_err": rec[f"{own}_max_abs_err"]}
                if plan.cluster > 1:
                    krec["active_clusters"] = cl.active_clusters(kname, B_TRAIN, lat, lat, c)
                if kname == "convlstm_backward":
                    with no_tf32():
                        prof = device_profile(lambda i: kernel(), n=3, unit="call")
                    # per launch times the launches a call makes (the
                    # profiler can miss the first launches of its window);
                    # the stepwise loop launches once a step, the rest once
                    parts = {}
                    for name, r in prof["port_kernels"].items():
                        per_launch = r["ms_per_call"] / r["calls_per_call"]
                        part = BWD_PARTS[name]
                        parts[part] = (parts.get(part, 0.0)
                                       + per_launch * (T if name == "step_kernel" else 1))
                    krec["ms_by_part"] = parts
                    krec["profile"] = prof["port_kernels"]
                emit(krec)
                if label == "bf16" and plain_ms is not None:
                    out[kname] = krec
            require(ok, f"kernels 2 and 3 {label} {rec['designs']} vs plain versions and "
                        f"autograd within {bar}, launches as planned, dWh deterministic")
    return out


def pre_batch_norm_biases(model) -> list:
    """Conv biases that feed a train-mode BatchNorm: the norm subtracts the
    batch mean, so their exact gradient is zero and a computed one is
    rounding noise."""
    if model.norm != "batch":
        return []
    return ([f"encoder.convs.{i}.bias" for i in range(len(model.encoder.convs))]
            + [f"decoder.deconvs.{i}.bias" for i in range(len(model.decoder.norms))])


TRAIN_BARS = {"f32": (F32_BAR, TRAIN_F32_BAR), "bf16": (BF16_BAR, BF16_BAR)}


def judge_train_step(test: dict, ref: dict, exact: dict, label: str,
                     zero_by_construction, anchor: dict | None = None) -> dict:
    """``test``'s train step against ``ref``'s (each ``{"loss", "grads",
    "stats"}`` from the same weights and batch, ``label`` its precision)
    with ``agree`` at ``TRAIN_BARS``: the loss and statistics at the first
    bar, the gradients at the second; ``exact`` is the reference's f32
    gradients, for the bf16 noise floor (see ``phase_train_step_compare``).

    ``anchor`` (a float64 step's gradients) judges a gradient that misses
    the bar when the two steps run on different implementations (the card
    against the CPU): it passes when it lies no further from the anchor
    than ``ref``'s does (x1.25, + 1e-5 in f32, + 0.005 in bf16) and within
    the gradient bar's rtol (f32) or ``BF16_NOISY_VS_PLAIN`` (bf16) of
    ``ref``.  Returns the summary the phase lines carry."""
    import torch

    bar, grad_bar = TRAIN_BARS[label]
    cmp = {"loss": agree(test["loss"], ref["loss"], bar)}
    cmp.update({f"stat:{n}": agree(st, ref["stats"][n], bar) for n, st in test["stats"].items()})
    for n, gr in test["grads"].items():
        rec = agree(gr, ref["grads"][n], grad_bar, atol_of_max=label == "f32")
        if n in zero_by_construction:
            rec["ok"] = bool(torch.allclose(gr.float(), ref["grads"][n].float(), **bar))
            rec["judged_by"] = "allclose only: zero by construction"
        elif anchor is not None and not rec["ok"]:
            slack, most = (1e-5, grad_bar["rtol"]) if label == "f32" else (0.005,
                                                                            BF16_NOISY_VS_PLAIN)
            err_k = agree(gr, anchor[n])["rel_l2"]
            err_p = agree(ref["grads"][n], anchor[n])["rel_l2"]
            rec.update(ok=err_k <= 1.25 * err_p + slack and rec["rel_l2"] <= most,
                       rel_l2_vs_f64=err_k, ref_rel_l2_vs_f64=err_p, judged_by="float64 anchor")
        elif label == "bf16" and not rec["ok"]:
            err_k = agree(gr, exact[n])["rel_l2"]
            err_p = agree(ref["grads"][n], exact[n])["rel_l2"]
            if err_p >= BF16_NOISY:
                rec.update(ok=err_k <= 1.25 * err_p + 0.005
                           and rec["rel_l2"] <= BF16_NOISY_VS_PLAIN,
                           rel_l2_vs_f32=err_k, plain_rel_l2_vs_f32=err_p,
                           judged_by="bf16 noise floor")
        cmp[f"grad:{n}"] = rec
    judged = {n: r for n, r in cmp.items() if "judged_by" not in r}
    worst = max(judged.items(), key=lambda kv: kv[1]["rel_l2"])
    return {
        "compared": len(cmp), "failed": {n: r for n, r in cmp.items() if not r["ok"]},
        "worst_by_bar": {"name": worst[0], **worst[1]},
        "worst_abs_err_of_max": max((r["max_abs_err"] / max(r["max_abs_ref"], 1e-30)
                                     for n, r in judged.items() if n.startswith("grad:")),
                                    default=0.0),
        "noise_floor": {n: r for n, r in cmp.items()
                        if r.get("judged_by") in ("bf16 noise floor", "float64 anchor")},
        "zero_by_construction_max_abs": max((float(test["grads"][n].abs().max())
                                             for n in zero_by_construction), default=0.0),
        "zero_grads": [n for n, gr in test["grads"].items() if not bool(gr.abs().max() > 0)],
    }


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
    for label in ("f32", "bf16"):
        k, pl = runs[label, "kernels"], runs[label, "plain"]
        results[label] = {
            "loss": float(k["loss"]), "plain_loss": float(pl["loss"]),
            "launches": k["launches"], "plain_launches": pl["launches"],
            **judge_train_step(k, pl, exact, label, zero_by_construction),
        }
        zero_grads = results[label]["zero_grads"]
        require(k["launches"]["convlstm_train_forward"] > 0
                and k["launches"]["convlstm_backward"] > 0,
                f"{label} train step went through kernels 2 and 3: {k['launches']}")
        require(pl["launches"]["convlstm_train_forward"] == 0
                and pl["launches"]["convlstm_backward"] == 0,
                f"{label} plain step launched no recurrence kernel: {pl['launches']}")
        require(not zero_grads, f"{label}: every parameter got a non-zero gradient")
    emit({"phase": "train_step_compare", "batch": [B_TRAIN, T, IMAGE, IMAGE, 3],
          "bars": {"f32": TRAIN_BARS["f32"], "bf16": TRAIN_BARS["bf16"][0],
                   "bf16_noise_floor_from": BF16_NOISY,
                   "bf16_noisy_vs_plain": BF16_NOISY_VS_PLAIN}, **results})
    require(all(not r["failed"] for r in results.values()),
            f"train step through the kernels vs the plain versions within {TRAIN_BARS}")


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
    frames), so the card's machine needs no image library or files."""

    has_frame_labels = True  # every frame carries its window's label

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


def phase_train(results_dir: str):
    """``fit`` for 2 epochs at B=8, T=16, 256x256, bf16 over 32 normal
    training windows and 16 test windows (half with the intruder), into
    ``results_dir``; its best checkpoint loaded back into a
    ``MultiStreamScorer``; then one train step timed (frames/s) and
    profiled in bf16 and in f32.  Returns the launches of ``fit``, the
    best checkpoint's path and the test windows."""
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
    args = build_parser().parse_args([
        "--category", "orbit", "--epochs", "2", "--batch-size", str(B_TRAIN),
        "--sequence-length", str(T), "--image-size", str(IMAGE), "--precision", "bf16",
        "--results-dir", results_dir, "--num-workers", "2", "--seed", str(SEED),
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
    # training_history.png is drawn only where matplotlib imports
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
    return launches, run_dir / "best_model.ckpt", test_ds


# ----------------------------------------------------------- evaluation


def orbit_bank(n: int, seed: int):
    """``n`` orbit frames without and with the intruder, one orbit."""
    import numpy as np

    rng = np.random.default_rng(seed)
    phase, speed = rng.uniform(0, 2 * math.pi), rng.uniform(0.12, 0.2)
    return tuple(np.stack([orbit_frame(t, IMAGE, phase, speed, anomaly, rng) for t in range(n)])
                 for anomaly in (False, True))


def clip_frames(bank, n: int, offset: int, anomalous: bool):
    """A frame source: ``n`` frames of ``bank`` from ``offset`` (cycling),
    the intruder over the middle 30% when ``anomalous``."""
    normal, intruder = bank
    lo, hi = (int(n * 0.4), int(n * 0.7)) if anomalous else (n, n)
    for t in range(n):
        yield (intruder if lo <= t < hi else normal)[(offset + t) % len(normal)]


def counted(run):
    """``run()`` with the kernels' launch counts zeroed just before and read
    just after: (its result, wall seconds to a synchronized end, launches)."""
    import torch

    zero_counters()
    start = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start, read_counters()


def phase_eval(ckpt_path, test_ds, card: str) -> dict:
    """The evaluation paths at full width on ``fit``'s best checkpoint, f32
    with TF32 off, frames made in memory (no OpenCV, PIL or matplotlib):

    - ``--video-dir``: ``score_videos`` over ``EVAL_CLIPS`` clips of 40-300
      frames (half with the intruder) on 16 slots, so slots recycle and
      clips end in padded short chunks; each clip's scores against the same
      run on the plain versions and against the clip scored alone through
      ``stream_scores`` (batch 1, the unfused first block), at the f32 bar;
      kernels 1 and 4 must launch;
    - ``--video``: ``stream_scores`` over one ``VIDEO_FRAMES``-frame clip,
      scores and error maps against the plain versions; kernel 1 must
      launch;
    - dataset: ``score_windows`` over ``fit``'s test windows at batch 4,
      against the plain versions, with both AUROCs;
    - drift: a ``DRIFT_CHUNKS``-chunk stream through a bf16
      ``MultiStreamScorer`` (kernel 1 resident, kernel 4) and through the
      plain bf16 versions, each layer's carried (h, c) compared with
      ``agree`` after every chunk and held to the bf16 bar at the last;
      both also measured against the plain f32 stream.  Twice: with the
      trained weights and with ``init_weights(SEED)`` (larger states);
    - ``temporal_features`` over the test windows at batch 4 (kernel 1
      stepwise, f32) against the plain versions at the f32 bar;
    - ``--scorer latent``: ``latent_frame_maps`` fitted on 8 training
      windows' frames, then ``score_windows`` over the test windows, with
      both AUROCs (no port kernel: the scorer reads the encoder only).

    frames/s are end to end (host pipeline included) from a second,
    unprofiled run; device time by kernel and the busy share come from a
    profiled window of ``PROFILE_CHUNKS`` chunks.  Every record carries the
    card's name and power limit and the sub-path's seconds; a closing
    ``eval`` line has the phase's."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.batch_score import score_videos
    from vad_tpu_torch.eval.metrics import auroc
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.eval.video_eval import latent_frame_maps, load_video_model, score_windows
    from vad_tpu_torch.eval.video_render import stream_scores
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.train.steps import u8_normalize

    phase_start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        model, _, _ = load_video_model(ckpt_path, "cuda")
    bank = orbit_bank(BANK_FRAMES, SEED + 300)
    rng = np.random.default_rng(SEED + 301)
    lengths = rng.integers(40, 301, EVAL_CLIPS)
    offsets = rng.integers(0, BANK_FRAMES, EVAL_CLIPS)

    def clips(n_clips=EVAL_CLIPS, frames=None):
        return {f"clip{i:02d}": clip_frames(bank, frames or int(lengths[i]), int(offsets[i]),
                                            i % 2 == 1) for i in range(n_clips)}

    def per_chunk(prof, chunks):
        return {k: {"ms_per_chunk": v["ms_per_run"] / chunks,
                    "launches_per_chunk": v["calls_per_run"] / chunks}
                for k, v in prof["port_kernels"].items()}

    out = {"launches": {}}
    # --video-dir
    start = time.perf_counter()
    got, _, launches = counted(lambda: score_videos(model, None, clips(), IMAGE, T, S))
    with plain_versions():
        plain = score_videos(model, None, clips(), IMAGE, T, S)
    alone = {name: stream_scores(model, None, src, IMAGE, chunk=T) for name, src in clips().items()}
    cmp = {}
    for name, res in got.items():
        require(res["error"] is None and len(res["scores"]) == lengths[int(name[4:])],
                f"{name}: every frame scored once ({res['error']})")
        cmp[name] = {"vs_plain": agree(res["scores"], plain[name]["scores"], F32_BAR),
                     "vs_alone": agree(res["scores"], alone[name], F32_BAR)}
    frames = int(lengths.sum())
    _, timed, _ = counted(lambda: score_videos(model, None, clips(), IMAGE, T, S))
    # a window of full slots: S clips of PROFILE_CHUNKS chunks each
    prof = device_profile(lambda i: score_videos(model, None, clips(S, PROFILE_CHUNKS * T),
                                                 IMAGE, T, S), n=1, unit="run")
    out["launches"]["video_dir"] = launches
    emit({"phase": "eval_video_dir", "card": card, "clips": EVAL_CLIPS, "slots": S,
          "frames": frames, "chunks_stepped": launches["first_block"],  # one per step
          "dtype": "float32", "bar": F32_BAR, "launches": launches,
          "frames_per_s": frames / timed, "slot_occupancy": frames / (
              launches["first_block"] * S * T),
          "profiled_window": {"steps": PROFILE_CHUNKS, "slots_busy": S,
                              "device_busy_share": prof["device_busy_share"],
                              "device_ms_per_chunk": prof["device_ms_per_run"] / PROFILE_CHUNKS,
                              "wall_ms_per_chunk": prof["wall_ms_per_run"] / PROFILE_CHUNKS,
                              "port_kernels": per_chunk(prof, PROFILE_CHUNKS)},
          "worst": {what: max((c[what] for c in cmp.values()), key=lambda r: r["rel_l2"])
                    for what in ("vs_plain", "vs_alone")},
          "failed": {n: c for n, c in cmp.items() if not all(r["ok"] for r in c.values())},
          "seconds": time.perf_counter() - start})
    require(launches["convlstm_serving"] > 0 and launches["first_block"] > 0,
            f"--video-dir went through kernels 1 and 4: {launches}")
    require(all(r["ok"] for c in cmp.values() for r in c.values()),
            f"--video-dir scores vs plain versions and vs each clip alone within {F32_BAR}")

    # --video
    def video_run(maps=None, frames=VIDEO_FRAMES):
        on_frame = None if maps is None else (lambda o, r, e, sc: maps.append(e))
        return stream_scores(model, None, clip_frames(bank, frames, 0, True), IMAGE, chunk=T,
                             on_frame=on_frame)

    start = time.perf_counter()
    maps, plain_maps = [], []
    scores, _, launches = counted(lambda: video_run(maps))
    with plain_versions():
        plain_scores = video_run(plain_maps)
    _, timed, _ = counted(video_run)
    prof = device_profile(lambda i: video_run(frames=PROFILE_CHUNKS * T), n=1, unit="run")
    cmp = {"scores": agree(scores, plain_scores, F32_BAR),
           "error_maps": agree(np.stack(maps), np.stack(plain_maps), F32_BAR)}
    out["launches"]["video"] = launches
    emit({"phase": "eval_video", "card": card, "frames": VIDEO_FRAMES, "dtype": "float32",
          "bar": F32_BAR, "launches": launches, "frames_per_s": VIDEO_FRAMES / timed,
          "profiled_window": {"chunks": PROFILE_CHUNKS,
                              "device_busy_share": prof["device_busy_share"],
                              "device_ms_per_chunk": prof["device_ms_per_run"] / PROFILE_CHUNKS,
                              "wall_ms_per_chunk": prof["wall_ms_per_run"] / PROFILE_CHUNKS,
                              "port_kernels": per_chunk(prof, PROFILE_CHUNKS)},
          "compare": cmp, "seconds": time.perf_counter() - start})
    require(len(scores) == VIDEO_FRAMES and len(maps) == VIDEO_FRAMES, "every frame scored once")
    require(launches["convlstm_serving"] > 0, f"--video went through kernel 1: {launches}")
    require(all(r["ok"] for r in cmp.values()), f"--video vs plain versions within {F32_BAR}")

    # dataset
    start = time.perf_counter()
    scored, seconds, launches = counted(lambda: score_windows(model, test_ds, 4))
    plain_start = time.perf_counter()
    with plain_versions():
        plain = score_windows(model, test_ds, 4)
    plain_seconds = time.perf_counter() - plain_start
    cmp = {k: agree(scored[k], plain[k], F32_BAR) for k in ("sequence", "frame")}

    def aurocs(r):
        return {"sequence": auroc(r["labels"], r["sequence"]),
                "frame": auroc(r["frame_labels"].ravel(), r["frame"].ravel())}

    out["launches"]["dataset"] = launches
    emit({"phase": "eval_dataset", "card": card, "windows": len(test_ds), "batch_size": 4,
          "dtype": "float32", "bar": F32_BAR, "launches": launches, "auroc": aurocs(scored),
          "plain_auroc": aurocs(plain), "scoring_seconds": seconds,
          "plain_scoring_seconds": plain_seconds, "compare": cmp,
          "seconds": time.perf_counter() - start})
    require(launches["convlstm_serving"] > 0, f"dataset scoring went through kernel 1: {launches}")
    require(all(r["ok"] for r in cmp.values()), f"dataset scores vs plain within {F32_BAR}")

    # temporal_features: the last ConvLSTM layer's h_seq, kernel 1 stepwise in f32
    start = time.perf_counter()
    windows = torch.from_numpy(test_ds.frames).to("cuda")

    def temporal():
        with torch.no_grad(), no_tf32():
            return torch.cat([model.temporal_features(u8_normalize(w))[0]
                              for w in windows.split(4)])

    h_seq, seconds, launches = counted(temporal)
    with plain_versions():
        plain_h = temporal()
    cmp = agree(h_seq, plain_h, F32_BAR)
    out["launches"]["temporal_features"] = launches
    emit({"phase": "eval_temporal_features", "card": card, "windows": len(test_ds),
          "batch": [4, T, IMAGE, IMAGE, 3], "h_seq": list(h_seq.shape), "dtype": "float32",
          "bar": F32_BAR, "plan": plan_record("convlstm_serving", (4, T, IMAGE // 16,
                                                                    IMAGE // 16, 128),
                                              torch.float32),
          "launches": launches, "seconds_4_calls": seconds, "compare": cmp,
          "phase_seconds": time.perf_counter() - start})
    require(launches["convlstm_serving"] > 0,
            f"temporal_features went through kernel 1: {launches}")
    require(cmp["ok"], f"temporal_features vs plain versions within {F32_BAR}")

    # --scorer latent on the in-memory windows: fit on 8 training windows' frames
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        (maps_fn, state), fit_seconds, fit_launches = counted(
            lambda: latent_frame_maps(model, WindowSet([0] * 8, SEED + 100), 4))
    scored, seconds, launches = counted(
        lambda: score_windows(model, test_ds, 4, frame_maps_fn=maps_fn, scorer_state=state))
    out["launches"]["latent_fit"], out["launches"]["latent"] = fit_launches, launches
    emit({"phase": "eval_latent", "card": card, "fit_frames": 8 * T, "windows": len(test_ds),
          "dtype": "float32", "grid": int(state[0].shape[0] ** 0.5),
          "dim": int(state[0].shape[1]), "launches": launches, "fit_seconds": fit_seconds,
          "scoring_seconds": seconds, "auroc": aurocs(scored),
          "phase_seconds": time.perf_counter() - start})
    require(bool(np.isfinite(scored["frame"]).all()) and scored["frame"].shape == (16, T),
            "latent frame scores finite, one per frame")

    # long-stream drift of the carried state, bf16 (resident kernel 1, tanh.approx)
    stream = torch.from_numpy(np.stack(list(clip_frames(bank, DRIFT_CHUNKS * T, 0, True))))
    stream = stream.to("cuda").reshape(DRIFT_CHUNKS, 1, T, IMAGE, IMAGE, 3)
    seeded = init_weights(VideoAutoencoder.from_config(VideoAEConfig(), device="cpu"), SEED)
    launches = {}
    for label, weights in (("trained", model), ("init_weights", seeded)):
        start = time.perf_counter()

        def scorer(dtype):
            sc = MultiStreamScorer(copy.deepcopy(weights), None, 1, T, IMAGE, dtype=dtype,
                                   device="cuda")
            sc.attach(0)
            return sc

        kernels, plain_bf16, plain_f32 = (scorer(d) for d in (torch.bfloat16, torch.bfloat16,
                                                            torch.float32))
        curve = {}
        zero_counters()
        for i in range(DRIFT_CHUNKS):
            kernels.score_chunk(stream[i])
            with plain_versions():
                plain_bf16.score_chunk(stream[i])
                with no_tf32():
                    plain_f32.score_chunk(stream[i])
            curve[i + 1] = {
                f"layer{j}_{n}": {"vs_plain_bf16": agree(a[k], b[k]),
                                  "vs_plain_f32": agree(a[k], f[k])["rel_l2"],
                                  "plain_bf16_vs_plain_f32": agree(b[k], f[k])["rel_l2"]}
                for j, (a, b, f) in enumerate(zip(kernels.states, plain_bf16.states,
                                                  plain_f32.states))
                for k, n in ((0, "h"), (1, "c"))}
        torch.cuda.synchronize()
        launches = read_counters()
        last = curve[DRIFT_CHUNKS]
        emit({"phase": "eval_drift", "card": card, "weights": label, "chunks": DRIFT_CHUNKS,
              "frames": DRIFT_CHUNKS * T, "dtype": "bfloat16", "bar": BF16_BAR,
              "launches": launches,
              "rel_l2_vs_plain_bf16": {c: {k: r["vs_plain_bf16"]["rel_l2"]
                                           for k, r in curve[c].items()} for c in DRIFT_REPORT},
              "rel_l2_vs_plain_f32": {c: {k: r["vs_plain_f32"] for k, r in curve[c].items()}
                                      for c in DRIFT_REPORT},
              "plain_bf16_rel_l2_vs_plain_f32": {
                  c: {k: r["plain_bf16_vs_plain_f32"] for k, r in curve[c].items()}
                  for c in DRIFT_REPORT},
              "max_rel_l2_any_chunk": max(r["vs_plain_bf16"]["rel_l2"]
                                          for per in curve.values() for r in per.values()),
              "at_last_chunk": {k: r["vs_plain_bf16"] for k, r in last.items()},
              "seconds": time.perf_counter() - start})
        require(launches["convlstm_serving"] > 0 and launches["first_block"] > 0,
                f"the drift stream went through kernels 1 and 4: {launches}")
        require(all(r["vs_plain_bf16"]["ok"] for r in last.values()),
                f"{label}: carried (h, c) after {DRIFT_CHUNKS} chunks vs plain bf16 within "
                f"{BF16_BAR}")
    out["launches"]["drift"] = launches
    emit({"phase": "eval", "card": card, "seconds": time.perf_counter() - phase_start})
    return out


# ------------------------------------------------------------ image model


def image_pre_norm_biases(model) -> list:
    """The image model's conv biases that feed a train-mode BatchNorm (every
    conv but the last): exact gradient zero, computed ones are noise."""
    if model.norm != "batch":
        return []
    return [n for n, _ in model.named_parameters()
            if n.endswith(".bias") and "norm" not in n and n != "decoder.conv.bias"]


def image_step_run(base, batch, dtype, device: str) -> dict:
    """One ``make_train_step`` step of a copy of ``base`` on ``device``:
    the loss, every gradient and the running statistics, on the CPU."""
    import torch

    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    model = copy.deepcopy(base).to(device)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    start = time.perf_counter()
    with no_tf32():
        loss = make_train_step(mse_per_sample, dtype)(model, optimizer, batch.to(device),
                                                      batch.shape[0])
    return {"loss": loss.cpu(), "seconds": time.perf_counter() - start,
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers() if ".running_" in n}}


def phase_image(card: str) -> dict:
    """The image model at the default width (``ImageAEConfig()``: latent
    256, 256x256, BatchNorm, pool stem) on an MVTec-format fixture written
    with the port's ``synthetic.py`` (50 train, 10 good and 20 defect test
    images with masks):

    - one train step on the card against the same step on the CPU (same
      weights from ``init_training_weights(SEED)``, same ``IMAGE_COMPARE_B``
      training images) in f32 (TF32 off) and bf16, judged as
      ``phase_train_step_compare`` judges the video step, with the CPU's
      float64 step as ``judge_train_step``'s anchor: this step's gradients
      are sums with heavy cancellation (BatchNorm's backward), so cuDNN's
      and the CPU's f32 steps can lie as far from float64 as from each
      other, with single entries off by more than the bar's atol;
    - ``python -m vad_tpu_torch.train`` for 2 epochs at batch 16 (in
      process, through ``main``), then ``python -m vad_tpu_torch.evaluate``
      on its best checkpoint with ``--scorer recon``, with ``--score-mode
      max --score-smooth 4``, and with ``--scorer latent``;
    - the card's recon scores and latent maps (from the evaluation's
      ``latent_stats.npz``) against the same model's on the CPU, rel L2 <=
      ``IMAGE_CPU_REL_L2``;
    - train images/s and a profile of the train step (both precisions),
      evaluation images/s and a profile of the scoring pass.

    The image path runs no port kernel: the launch counts must stay 0."""
    import numpy as np
    import torch

    from vad_tpu_torch import evaluate as eval_cli
    from vad_tpu_torch.core.config import ImageAEConfig
    from vad_tpu_torch.data.image_dataset import MVTecDataset
    from vad_tpu_torch.data.synthetic import create_synthetic_image_data
    from vad_tpu_torch.eval import image_eval
    from vad_tpu_torch.eval.latent_score import load_stats, make_distance_fn, stats_state
    from vad_tpu_torch.models.autoencoder import ConvAutoencoder
    from vad_tpu_torch.models.video_autoencoder import init_training_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train import __main__ as train_cli
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step, u8_normalize

    phase_start = time.perf_counter()
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        create_synthetic_image_data(tmp, "synthetic", 50, 10, 20, IMAGE)
        train_ds = MVTecDataset(tmp, "synthetic", "train", IMAGE, normalize=False)
        test_ds = MVTecDataset(tmp, "synthetic", "test", IMAGE, normalize=False)
        fixture_seconds = time.perf_counter() - start

        # one train step, card against CPU
        cfg = ImageAEConfig()
        base = init_training_weights(ConvAutoencoder.from_config(cfg, device="cpu"), SEED)
        zero_by_construction = set(image_pre_norm_biases(base))
        batch = torch.from_numpy(np.stack([train_ds[i]["image"]
                                           for i in range(IMAGE_COMPARE_B)]))
        runs = {}
        zero_counters()
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            for where in ("cuda", "cpu"):
                runs[label, where] = image_step_run(base, batch, dtype, where)
        out["launches"]["step_compare"] = read_counters()
        anchor = image_step_run(base, batch, torch.float64, "cpu")
        compare = {}
        for label in ("f32", "bf16"):
            k, ref = runs[label, "cuda"], runs[label, "cpu"]
            compare[label] = {"loss": float(k["loss"]), "cpu_loss": float(ref["loss"]),
                              "cpu_seconds": ref["seconds"],
                              **judge_train_step(k, ref, runs["f32", "cpu"]["grads"], label,
                                                 zero_by_construction, anchor["grads"])}
        emit({"phase": "image_step_compare", "card": card,
              "batch": [IMAGE_COMPARE_B, IMAGE, IMAGE, 3], "config": cfg.to_dict(),
              "parameters": sum(p.numel() for p in base.parameters()),
              "bars": {"f32": TRAIN_BARS["f32"], "bf16": TRAIN_BARS["bf16"][0]}, **compare})
        require(all(not r["failed"] for r in compare.values()),
                f"image train step card vs CPU within {TRAIN_BARS}")
        require(all(not r["zero_grads"] for r in compare.values()),
                "image train step: every parameter got a non-zero gradient")

        # the two CLIs
        results = Path(tmp) / "results"
        log = io.StringIO()
        zero_counters()
        start = time.perf_counter()
        with contextlib.redirect_stdout(log):
            trained = train_cli.main([
                "--category", "synthetic", "--data-dir", tmp, "--image-size", str(IMAGE),
                "--epochs", "2", "--batch-size", "16", "--num-workers", "4",
                "--results-dir", str(results), "--seed", str(SEED)])
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - start
        out["launches"]["train_cli"] = read_counters()
        history, run_dir = trained["history"], Path(trained["results_dir"])
        ckpt = run_dir / "best_model.ckpt"
        emit({"phase": "image_train", "card": card, "epochs": 2, "batch": 16,
              "train_images": len(train_ds), "test_images": len(test_ds),
              "fixture_seconds": fixture_seconds, "cli_seconds": train_seconds,
              "history": history, "launches": out["launches"]["train_cli"],
              "files": sorted(p.name for p in run_dir.iterdir()),
              "log_tail": log.getvalue().splitlines()[-6:]})
        require(len(history["train_loss"]) == 2
                and all(math.isfinite(v) for v in history["train_loss"] + history["val_loss"]),
                "image training: 2 epochs with finite losses")
        require(ckpt.exists() and (run_dir / "final_model.ckpt").exists(),
                "image training wrote best_model.ckpt and final_model.ckpt")

        evals = {}
        for name, flags in (("recon", ["--scorer", "recon"]),
                            ("recon_max_smooth4", ["--score-mode", "max", "--score-smooth", "4"]),
                            ("latent", ["--scorer", "latent"])):
            log = io.StringIO()
            zero_counters()
            start = time.perf_counter()
            with contextlib.redirect_stdout(log):
                score = eval_cli.main(["--checkpoint", str(ckpt), *flags])
            torch.cuda.synchronize()
            text = (run_dir / "evaluation" / "results.txt").read_text()
            metric = {key: float(m.group(1)) for key, rx in (
                ("pixel_auroc", r"Pixel-level AUROC: ([0-9.]+)"),
                ("aupro", r"AUPRO \(FPR<=0\.3\): ([0-9.]+)"),
                ("ap", r"Average precision \(AUPRC\): ([0-9.]+)"))
                      if (m := re.search(rx, text))}
            out["launches"][f"evaluate_{name}"] = read_counters()
            evals[name] = {"auroc": score, **metric, "cli_seconds": time.perf_counter() - start}
            require(0.0 <= score <= 1.0 and math.isfinite(metric.get("pixel_auroc", 0.0)),
                    f"image evaluation {name}: AUROC {score}")

        # card against CPU on the trained model: recon scores, latent maps
        with contextlib.redirect_stdout(io.StringIO()):
            model, _, _ = image_eval.load_image_model(ckpt, "cuda")
            cpu_model, _, _ = image_eval.load_image_model(ckpt, "cpu")
        stats = load_stats(run_dir / "evaluation" / "latent_stats.npz")
        dfn = make_distance_fn(lambda m, x: m.feature_pyramid(x), stats.layers, stats.grid)
        x = torch.from_numpy(np.stack([test_ds[i]["image"] for i in range(len(test_ds))]))
        vs_cpu = {}
        card_state, cpu_state = stats_state(stats, "cuda"), stats_state(stats)
        with torch.no_grad(), no_tf32():
            for what, fn in (("recon_scores", lambda m, st, xs: m.reconstruction_error(xs)),
                             ("recon_maps", lambda m, st, xs: m.error_map(xs)),
                             ("latent_maps", dfn)):
                got = torch.cat([fn(model, card_state, u8_normalize(xb.cuda())).cpu()
                                 for xb in x.split(10)])
                want = torch.cat([fn(cpu_model, cpu_state, u8_normalize(xb))
                                  for xb in x.split(10)])
                vs_cpu[what] = agree(got, want, dict(rtol=IMAGE_CPU_REL_L2, atol=0.0))
                vs_cpu[what]["ok"] = vs_cpu[what]["rel_l2"] <= IMAGE_CPU_REL_L2
        require(all(r["ok"] for r in vs_cpu.values()),
                f"image scores and latent maps card vs CPU within rel L2 {IMAGE_CPU_REL_L2}")

        # speed: the train step in both precisions, the scoring pass
        g = torch.Generator(device="cuda").manual_seed(SEED + 7)
        u8 = torch.randint(0, 256, (16, IMAGE, IMAGE, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
        speed = {}
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            net = copy.deepcopy(base).to("cuda")
            opt = make_optimizer(net.parameters(), 1e-3)
            step = make_train_step(mse_per_sample, dtype)
            with no_tf32():
                for _ in range(3):
                    step(net, opt, u8, 16)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                n = 20
                start = time.perf_counter()
                for _ in range(n):
                    loss = step(net, opt, u8, 16)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - start
                prof = device_profile(lambda i: step(net, opt, u8, 16), n=5, unit="step")
            speed[label] = {"train_images_per_s": n * 16 / elapsed,
                            "ms_per_step": elapsed / n * 1e3, "loss": float(loss),
                            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "profile": prof}
        image_eval.score_split(model, test_ds, keep_maps=True)  # warm
        torch.cuda.synchronize()
        start = time.perf_counter()
        split = image_eval.score_split(model, test_ds, keep_maps=True)
        torch.cuda.synchronize()
        score_seconds = time.perf_counter() - start
        prof = device_profile(lambda i: image_eval.score_split(model, test_ds, keep_maps=True),
                              n=2, unit="pass")
    record = {"phase": "image", "card": card, "config": cfg.to_dict(),
              "train_images_per_s": {k: v["train_images_per_s"] for k, v in speed.items()},
              "eval_images_per_s": len(split["scores"]) / score_seconds,
              "device_busy_share": {"train_step_f32": speed["f32"]["profile"][
                  "device_busy_share"], "train_step_bf16": speed["bf16"]["profile"][
                  "device_busy_share"], "eval_pass": prof["device_busy_share"]},
              "auroc": {n: e["auroc"] for n, e in evals.items()},
              "pixel_auroc": {n: e.get("pixel_auroc") for n, e in evals.items()},
              "aupro": {n: e.get("aupro") for n, e in evals.items()},
              "vs_cpu": vs_cpu, "evaluations": evals, "train_speed": speed,
              "eval_profile": prof, "launches": out["launches"],
              "seconds": time.perf_counter() - phase_start}
    emit(record)
    launched = [(path, k, v) for path, counts in out["launches"].items()
                for k, v in counts.items() if v]
    require(not launched, f"the image path launched no port kernel: {launched}")
    return out


def main() -> int:
    try:
        import torch  # noqa: F401

        import vad_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root",
              file=sys.stderr)
        return 1
    name, peak_flops, peak_bw, f32_flops, card = phase_device()
    phase_build()
    checks = {"convlstm_serving": phase_convlstm(peak_flops, peak_bw, f32_flops),
              "first_block": phase_first_block(peak_flops, peak_bw)}
    checks.update(phase_train_kernels(peak_flops, peak_bw, f32_flops))
    phase_edge_shapes()
    launches = phase_main_path()
    phase_train_step_compare()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, best_ckpt, test_ds = phase_train(tmp)
        evaluation = phase_eval(best_ckpt, test_ds, card)
    phase_image(card)
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
        # kernels 1-3: launches per call from their plan at the path's shape
        # (the kernel_check shapes); kernels 4-6 launch once a call
        per_call = rec.get("launches_per_call", 1)
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[kname], "launches_per_call": per_call,
            "calls": path_launches[kname] / per_call, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
        })
        if kname in ("convlstm_serving", "first_block"):  # the evaluation paths' launches
            kernels[-1]["eval_launches"] = {path: counts[kname]
                                            for path, counts in evaluation["launches"].items()}
        if kname == "convlstm_serving":
            kernels[-1]["f32"] = rec["f32"]
    emit({"kernels": kernels})
    import torch

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
