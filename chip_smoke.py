#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vad_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vad_tpu_torch/csrc`` (reporting each
source's nvcc seconds and each kernel's registers, shared memory and
spills), holds each against its plain PyTorch version on the card (f32
with TF32 off, and bf16; the recurrence kernels 1-3 in every design their
plan can choose at each checked shape (in f32 stepwise_tc, the plan's
choice, and the FMA design stepwise beside it), at the serving, training
and ``--video`` (B=1) shapes, with the plan, its blocks per step, the
launches per call, the clusters that fit, kernel 3's time by part and its
dWh repeated bit for bit, each line bounded (f32 as 3xTF32 on the tensor
cores, with the FMA bound beside it); kernels 1-3 in bf16 on the 32x32
latent of 512x512 streams (kernel 1 at S=16 and B=1, kernels 2 and 3 at
B=8) on the bf16 stepwise_tc tile and on the WMMA stepwise core, each
against its plain version and against each other (kernel 3 also by part),
and the bf16 tile at the 256x256 serving and training shapes beside
resident; stepwise_tc's weight cache across an
``Adam(fused=True)`` step and a ``copy_``; kernel 4 with its design and
time in both dtypes, and kernels 4 and 6 at ragged frames; kernel 7, the
folded blocks' epilogue, at each of its seven calls a chunk at the 256x256
and 512x512 serving shapes in both dtypes, timed beside its bytes bound),
then drives four paths at the default video model's full width:

- serving: ``MultiStreamScorer`` (S=16 streams, T=16 frames per chunk,
  256x256, bf16 with f32 cell state, random weights from a seed), checked
  to go through kernels 1, 4 and 7 (seven epilogues a chunk) and to agree
  with the plain versions,
  then timed (frames/s) and profiled (device time by kernel, device-busy
  share) with ``fused_input`` on and off; and at 512x512 (S=16, T=16,
  bf16, fused input: kernel 4, then kernel 1 on the bf16 stepwise_tc
  tile) against the plain versions, with its frames/s;
- training: one ``make_train_step`` step (B=8 windows of T=16 frames,
  256x256) through kernels 2 and 3, compared in f32 and bf16 with the same
  step on the plain versions (loss, every gradient, BatchNorm statistics),
  and one bf16 step at 512x512 (kernels 2 and 3 on the bf16 tile), each
  step's launches equal to the plans';
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
  ``temporal_features`` (kernel 1 stepwise_tc, f32) against the plain
  versions; and ``--scorer latent`` (the latent-distance scorer fitted on
  training windows' frames) over the test windows, with its AUROC;
- the image model (``ImageAEConfig()``, 256x256) on an MVTec-format
  fixture written with the port's generator: one train step on the card
  against the same step on the CPU (f32 with TF32 off, and bf16), then
  ``python -m vad_tpu_torch.train`` for 2 epochs and ``python -m
  vad_tpu_torch.evaluate`` with both scorers (in process), the card's
  scores and latent maps against the CPU's, train and evaluation images/s
  and profiles (no port kernel runs there);
- the deployment paths, on ``fit``'s and the image phase's checkpoints:
  ``python -m vad_tpu_torch.export_model`` (bf16 and f32 video artifacts
  with kernel 1 inside, each loaded in a fresh process and held against
  direct scorers; a symbolic-batch image artifact against
  ``reconstruction_error``), ``python -m vad_tpu_torch.utils.torch_import``
  both ways through reference-layout modules, ``stream_step_fast``
  against ``stream_step``, ``python -m vad_tpu_torch.train_video`` with
  ``--tensorboard --profile-dir --debug-nans`` (a trace naming kernels 2
  and 3), and the UI's logic on both checkpoints;
- accuracy: one draw of ``tools/parity/run_parity.py``'s ``video_synthetic``
  fixture, written by the port's generator: ``python -m
  vad_tpu_torch.train_video`` at its budget (15 epochs, 128x128, T=8,
  f32), ``... evaluate_video`` on the best checkpoint (sequence and frame
  AUROC beside the JAX package's recorded yardsticks; the sequence AUROC
  must reach 0.8389) and ``--video-dir`` over four mp4s from
  ``create_synthetic_video_file`` (kernels 1-4);
- scaling (``vad_tpu_torch/parallel/``) on the one card: two processes
  joined by gloo take dp and tp train steps of the default video model
  (B=8 global, f32 and bf16) through kernels 2 and 3 on each rank, held
  against one process on the global batch (and, where cuDNN's algorithms
  part the two f32 steps, against a float64 step) by the judge
  ``multiprocess_check`` applies; ``python -m
  vad_tpu_torch.parallel.multiprocess_check --device cuda`` in both forms
  (the image model data-parallel, the video model's gate weights split
  over the two processes; each run held against a float64 step through
  its own ReLU and max-pool kinks); two ``MultiStreamScorer`` replicas on the card
  (kernels 1 and 4 in each) against the unsplit scorer; ``python -m
  vad_tpu_torch.train_video`` under torchrun's environment at
  WORLD_SIZE=1 (NCCL) beside the plain run.  One card: overhead and
  correctness, not scaling numbers;
- the spatial row split (``--spatial N``), every row shard on the one
  card: kernel 1's row form (halo rows read in place, and staged through
  copies behind events) against its plain version and the unsplit kernel
  1 at 2 and 16 shards, bf16 and f32, on the stepwise_tc tile and on the
  stepwise core; ``MultiStreamScorer(spatial=True)``
  at 256² and 512² (``model_parallel`` 2 and 4) and the ``--spatial 2``
  daemon (/v1/streams, /v1/images) against the unsplit scorer and
  service, with kernel 1's row launches counted and none of kernel 4;
- the bench: ``python -m vad_tpu_torch.bench`` (the JAX package's
  ``bench.py`` on the card) once in process at full size, its output
  captured: each scoring step form against the plain step at the bf16
  bar, then its 11 configuration lines and the headline, in order, with
  positive values, ``mfu`` <= 1, the card's name and power limit, the
  headline the best scoring line, and kernels 1-4's launches counted
  around each line equal to what the plans give (none on the plain
  lines);
- the kernel probes: kernel 5 (the tie-splitting 2x2 max-pool backward)
  held exactly against its plain version at the encoder's four pool
  inputs, kernel 6's five ablation modes against theirs (``full`` equal
  to kernel 4 bit for bit), then ``python -m vad_tpu_torch.tools.
  probe_pool_bwd`` and ``... ablate_block1`` at their defaults.

Each phase prints one JSON line; a ``script`` line gives the whole run's
seconds; the last line is ``{"ok": true, "device": {...}}``.
``python3 chip_smoke.py --artifact-check
<artifact> <checkpoint> <dtype>`` is the export phase's loading process,
``python3 chip_smoke.py --scaling-worker RANK WORLD DIR`` a rank of the
scaling phase.  ``python3 chip_smoke.py --block-epilogue`` runs the device
line, the build and kernel 7's check alone.
``python3 chip_smoke.py --accuracy [--only NAME] [--draws N] [--precision
f32|bf16]`` runs run_parity's four fixtures at their budgets through the
port's CLIs (``--seed`` 0..N-1), one line a draw and one a fixture beside
the JAX package's recorded cell.  Exits non-zero, with no such line,
when there is no CUDA device, outside a checkout of the repository, or
when any check fails.
"""

from __future__ import annotations

import contextlib
import copy
import http.client
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

S, T, IMAGE = 16, 16, 256  # streams, frames per chunk, frame size
CHUNKS = 3  # chunks driven through the main path
B_TRAIN = 8  # training windows per step (T frames each)
B_VIDEO = 1  # evaluate_video --video: one stream, T-frame chunks
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
PORT_KERNELS = ("recurrence_kernel", "convlstm_step_kernel", "convlstm_tc_step",
                "first_block_kernel", "block_epilogue_kernel", "gate_all_kernel", "gate_tc", "gate_kernel", "loop_kernel",
                "dh_tc_step", "step_kernel", "finish_kernel", "finish_tc", "dw_kernel_res",
                "dw_reduce_kernel", "dw_kernel", "dw_tc")
# Kernel 3's parts, by device-side name: the gate recompute, the reverse
# loop and dWh in every design, and the stepwise designs' last launch
# (dh0 and the sum of the dWh partials).
BWD_PARTS = {"gate_kernel": "gate", "gate_all_kernel": "gate", "gate_tc": "gate",
             "loop_kernel": "loop", "step_kernel": "loop", "dh_tc_step": "loop",
             "dw_kernel_res": "dw", "dw_reduce_kernel": "dw", "dw_kernel": "dw", "dw_tc": "dw",
             "finish_kernel": "dh0+dw_sum", "finish_tc": "dh0+dw_sum"}
PROBE_FRAMES = 128  # kernel 5's pool inputs: B*T of the training step (8 x 16)
# Ragged recurrence shapes (B, T, H, W, C): C=48 is no multiple of any
# tile, C=20 of 8 (the plain-load path), 5x7 and 3x9 frames; in bf16, 8x8
# with C=32 (kernels 1-2 resident in a cluster of 2 with one pixel tile,
# kernel 3 on the bf16 tile), 8x16 with C=64 (all resident, clusters of 4,
# two tiles) and 8x32 with C=128 (four tiles, but the resident blocks would
# need 235,536 bytes of shared memory: kernels 1-3 stepwise_tc); 5x7 with
# C=48 runs kernels 1-3 on the bf16 tile with a partial pixel tile (kernel
# 3's dWh on 16-column units past a 7-pixel row).  In f32 every shape runs
# stepwise_tc (clusters of 4-8, partial pixel tiles, C=20 and 48 with ragged
# last K stages) and stepwise.
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
# The serve phase: chunks a stream sends (the reload after SERVE_RELOAD_AT),
# chunks a stream sends while timed, rounds (one chunk a stream) profiled,
# threads posting /v1/images, and chunks a stream through the CLI daemon.
SERVE_CHUNKS, SERVE_RELOAD_AT, SERVE_TIMED_CHUNKS, SERVE_PROFILE_ROUNDS = 8, 4, 16, 4
IMAGE_THREADS, CLI_CHUNKS = 4, 3
# The export phase: chunks through each loaded artifact (the last slot idle
# on the third) and JAX's bar for an f32 artifact against the live scorer
# (tests/test_export.py).  The profiling phase's IPAD set: training and test
# videos and the frames of each (32 and 16 windows of T at stride 4).
EXPORT_CHUNKS, EXPORT_F32_BAR = 4, dict(rtol=1e-5, atol=1e-7)
PROFILE_VIDEOS, PROFILE_VIDEO_FRAMES = (4, 2), 44
# The accuracy check: tools/parity/run_parity.py's four fixtures at its
# budgets (:48-86), each as the generator's method, the category it writes
# and the trainer's flags, beside the JAX package's recorded cells
# (results/parity_vs_reference/README.md:17-24, 85-86: mean, half-range, n)
# of the AUROC (sequence AUROC for video) and the video frame AUROC.
VIDEO_BUDGET = ["--image-size", "128", "--sequence-length", "8", "--stride", "4", "--epochs",
                "15", "--batch-size", "4", "--lr", "1e-4"]
ACCURACY_FIXTURES = {
    "synthetic": {"kind": "image", "method": "synthetic", "category": "synthetic",
                  "flags": ["--image-size", "256", "--epochs", "50", "--batch-size", "16",
                            "--lr", "1e-3", "--loss", "mse"],
                  "jax": (0.9767, 0.0225, 3), "jax_frame": None},
    "textured": {"kind": "image", "method": "synthetic-textured", "category": "textured",
                 "flags": ["--image-size", "256", "--epochs", "50", "--batch-size", "16",
                           "--lr", "1e-3", "--loss", "combined", "--ssim-weight", "0.5"],
                 "jax": (0.7083, 0.1280, 8), "jax_frame": None},
    "video_synthetic": {"kind": "video", "method": "synthetic-video", "category": "S01",
                        "flags": VIDEO_BUDGET, "jax": (0.8889, 0.0, 3),
                        "jax_frame": (1.0, 0.0, 3)},
    "textured_video": {"kind": "video", "method": "synthetic-textured-video", "category": "T01",
                       "flags": VIDEO_BUDGET, "jax": (0.5684, 0.1013, 8),
                       "jax_frame": (0.5793, 0.0450, 6)},
}
# The default run's gate: video_synthetic's sequence AUROC at least JAX's
# recorded 0.8889 less 0.05 (the reference's six draws read 0.8889-0.9352).
# Then --video-dir over ACCURACY_CLIPS mp4s of ACCURACY_CLIP_FRAMES frames,
# the first half with the intruder over ACCURACY_RANGE.
ACCURACY_GATE = 0.8389
ACCURACY_CLIPS, ACCURACY_CLIP_FRAMES, ACCURACY_RANGE = 4, 96, (32, 64)


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


def plain_versions():
    """Route the serving path through the kernels' plain PyTorch versions
    (``vad_tpu_torch/ops/plain.py``, the bench's plain lines' route)."""
    from vad_tpu_torch.ops.plain import plain_versions as routed

    return routed()


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
    from vad_tpu_torch.utils.profiling import device_peaks, tf32_peak

    name = torch.cuda.get_device_name(0)
    card, flops, f32_flops, bw = device_peaks(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "peaks_from": card, "peak_bf16_flops": flops, "peak_f32_flops": f32_flops,
          "peak_tf32_flops": tf32_peak(name), "peak_bytes_per_s": bw})
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
                  "first_block_ablate", "block_epilogue"])
    ptxas = {name: ptxas_summary(rec["log"]) for name, rec in _build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "per_source_seconds": {k: v["seconds"] for k, v in _build.build_log.items()},
          "ptxas": ptxas,
          # the stepwise_tc design's kernels: the wgmma ones (namespace tc;
          # one or two warpgroups) and kernel 3's mma.sync GEMMs (TC = true)
          "stepwise_tc_ptxas": {k: v for rec in ptxas.values() for k, v in rec.items()
                                if "tc::" in k or ", true>" in k}})


def design_fits(kernel: str, shape, dtype, design: str) -> bool:
    from vad_tpu_torch.ops.convlstm import resident_fits, tc_fits

    b, t, hgt, wid, c = shape
    return {"resident": resident_fits(kernel, hgt, wid, c, dtype),
            "stepwise_tc": tc_fits(c, dtype, wid)}.get(design, True)


def designs(kernel: str, shape, dtype) -> list:
    """Every design ``recurrence_plan`` can choose for ``kernel`` at
    ``shape`` (B, T, H, W, C) and ``dtype``, its own choice first."""
    from vad_tpu_torch.ops.convlstm import recurrence_plan

    chosen = recurrence_plan(kernel, *shape, dtype).design
    return [chosen] + [d for d in ("resident", "stepwise_tc", "stepwise")
                       if d != chosen and design_fits(kernel, shape, dtype, d)]


def recurrence_bound(label: str, flops: float, nbytes: float, peak_flops: float,
                     peak_bw: float, f32_flops: float) -> dict:
    """A kernel 1-3 line's bound: the larger of its bytes over the memory
    rate and its operations over the rate of their type.  bf16 runs on the
    tensor cores; f32-accurate work takes three TF32 tensor-core products a
    multiply-add (3xTF32: the stepwise_tc design's arithmetic, and the
    least time the card can take for it), so f32 is bounded at 3 x FLOP
    over the TF32 peak, with the FMA cores' bound (FLOP over the f32 peak)
    beside it as ``bound_fma_ms``."""
    import torch

    from vad_tpu_torch.utils.profiling import tf32_peak

    t_bytes = nbytes / peak_bw
    if label == "bf16":
        t_ops, by = flops / peak_flops, "operations"
    else:
        t_ops, by = 3 * flops / tf32_peak(torch.cuda.get_device_name(0)), "operations (3xTF32)"
    rec = {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": by if t_ops > t_bytes else "bytes"}
    if label == "f32":
        rec["bound_fma_ms"] = max(flops / f32_flops, t_bytes) * 1e3
    return rec


def bounded(rec: dict, what: str) -> dict:
    """``rec`` with its share of its bound (``bound_ms / ms``), which must
    not exceed 1: no line may read faster than the card can go."""
    rec["of_bound"] = rec["bound_ms"] / rec["ms"]
    require(rec["of_bound"] <= 1.0, f"{what} reads {rec['of_bound']:.3f} of its bound")
    return rec


def plan_record(kernel: str, shape, dtype, design=None) -> dict:
    from dataclasses import asdict

    from vad_tpu_torch.ops.convlstm import recurrence_plan

    return asdict(recurrence_plan(kernel, *shape, dtype, design))


def phase_convlstm(peak_flops: float, peak_bw: float, f32_flops: float) -> dict:
    """Kernel 1 against its plain version at the serving shape, in every
    design its plan can choose there (f32: stepwise_tc, and stepwise forced;
    bf16: resident, and the bf16 stepwise_tc tile and stepwise forced), and
    in f32 at the ``--video`` shape (B=1); every line timed and bounded."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_recurrence_ref, recurrence_plan

    lat, c = IMAGE // 16, 128
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out, f32, bf16 = {}, {}, {}
    for b, dtypes in ((S, ("f32", "bf16")), (B_VIDEO, ("f32",))):
        shape = (b, T, lat, lat, c)
        gates_x = torch.randn((b, T, lat, lat, 4 * c), generator=g, device="cuda") * 0.5
        w_h = torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05
        h0 = torch.randn((b, lat, lat, c), generator=g, device="cuda") * 0.1
        c0 = torch.randn((b, lat, lat, c), generator=g, device="cuda") * 0.1
        for label in dtypes:
            dtype, bar = ((torch.float32, F32_BAR) if label == "f32"
                          else (torch.bfloat16, BF16_BAR))
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
                require(seq.dtype == dtype and hf.dtype == cf.dtype == torch.float32,
                        "output dtypes")
                errs = [close(a, r, bar) for a, r in ((seq, rseq), (hf, rhf), (cf, rcf))]
                ok = all(e[1] for e in errs) and per_call == plan.launches
                rec = {"phase": "kernel_check", "kernel": "convlstm_serving", "dtype": label,
                       "shape": list(gx.shape), "design": design, "plan": plan_record(
                           "convlstm_serving", shape, dtype, design),
                       "launches_per_call": per_call, "max_abs_err": max(e[0] for e in errs),
                       "bar": bar, "ok": ok, "ms": time_ms(kernel)}
                if plan.cluster > 1 and design == "resident":
                    rec["active_clusters"] = cl.active_clusters("convlstm_serving", b, lat, lat, c)
                hw, e = lat * lat, gx.element_size()
                flops = 2 * b * T * hw * 9 * c * 4 * c
                nbytes = (b * T * hw * 4 * c * e + b * T * hw * c * e  # gates_x in, h_seq out
                          + 4 * b * hw * c * 4 + 9 * c * 4 * c * e)  # h0, c0, h_T, c_T, Wh
                rec.update(recurrence_bound(label, flops, nbytes, peak_flops, peak_bw, f32_flops))
                rec["tflops"] = flops / rec["ms"] / 1e9
                emit(bounded(rec, f"convlstm_serving {label} {design} at B={b}"))
                require(ok, f"convlstm_serving {label} {design} B={b} vs plain version within "
                            f"{bar}, {per_call} launches as planned ({plan.launches})")
                if label == "bf16":  # the resident choice, and the others beside it
                    bf16[design] = {k: rec[k] for k in (
                        "launches_per_call", "max_abs_err", "ms", "bound_ms", "tflops")}
                    if design == choices[0]:
                        out = rec
                elif label == "f32":  # every f32 design at both shapes, for the kernels line
                    f32[f"B={b} {design}"] = {k: rec[k] for k in (
                        "design", "launches_per_call", "max_abs_err", "ms", "bound_ms",
                        "bound_by", "bound_fma_ms", "tflops")}
                    f32[f"B={b} {design}"]["step_blocks"] = plan.step_blocks
            if label == "bf16":
                out["plain_ms"] = time_ms(lambda: convlstm_recurrence_ref(gx, wh, h0, c0),
                                          iters=5)
            elif b == S:
                f32[f"B={b} plain_ms"] = time_ms(
                    lambda: convlstm_recurrence_ref(gx, wh, h0, c0), iters=5)
    out["f32"], out["bf16_designs"] = f32, bf16
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


def epilogue_calls(image: int) -> list:
    """Kernel 7's seven calls a chunk of the scorer at ``image`` on the
    published widths (``VideoAutoencoder()``): ``(mode, channels, side of
    the convolution's output)``."""
    import torch

    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
    from vad_tpu_torch.ops.block_epilogue import fold_blocks, step_calls

    model = VideoAutoencoder(device="cpu")
    return step_calls(fold_blocks(model.state_dict(), torch.float32), image)


def phase_block_epilogue(peak_bw: float) -> dict:
    """Kernel 7 against its plain version at each of its seven calls a
    chunk (S*T = 256 frames) at 256x256 and 512x512, f32 and bf16: exact
    where the mode has no tanh, within 2 units of the output type's last
    place where it has; each call timed (CUDA events) beside its bytes
    bound (the convolution's output read once, the result written once),
    and in bf16 beside the chain PyTorch ran before the fold (bias add,
    BatchNorm in eval, max-pool, activation)."""
    import torch
    import torch.nn.functional as F

    from vad_tpu_torch.ops import _build
    from vad_tpu_torch.ops.block_epilogue import block_epilogue, block_epilogue_ref

    n = S * T
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    for image in (IMAGE, HIGH_RES):
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            calls, totals = [], {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                                 "library_ms": 0.0}
            for mode, c, side in epilogue_calls(image):
                y = torch.randn((n, side, side, c), generator=g, device="cuda").to(dtype)
                y = y.permute(0, 3, 1, 2)
                b = torch.randn(c, generator=g, device="cuda")
                got = block_epilogue(y, b, mode)
                want = block_epilogue_ref(y, b, mode)
                torch.cuda.synchronize()
                if mode == "last":
                    err, ok = close(got, want, dict(rtol=0.0, atol=2 * torch.finfo(dtype).eps))
                else:
                    err, ok = float((got.float() - want.float()).abs().max()), torch.equal(got,
                                                                                           want)
                nbytes = (y.numel() + got.numel()) * y.element_size() + c * 4
                rec = {"mode": mode, "shape": [n, side, side, c], "max_abs_err": err, "ok": ok,
                       "ms": time_ms(lambda: block_epilogue(y, b, mode)),
                       "bound_ms": nbytes / peak_bw * 1e3, "bytes": nbytes}
                rec["roofline"] = rec["bound_ms"] / rec["ms"]
                if image == IMAGE:
                    rec["plain_ms"] = time_ms(lambda: block_epilogue_ref(y, b, mode), iters=3)
                if dtype == torch.bfloat16:
                    bb = b.to(dtype)[None, :, None, None]
                    stats = [torch.rand(c, generator=g, device="cuda").to(dtype) + 0.5
                             for _ in range(4)]

                    def library():  # the module path after the convolution
                        z = y + bb
                        if mode == "last":
                            return torch.tanh(z)
                        z = F.batch_norm(z, stats[0], stats[1], stats[2], stats[3], False,
                                         0.0, 1e-5)
                        if mode == "decoder":
                            return F.relu(z)
                        return F.leaky_relu(F.max_pool2d(z, 2), 0.2)

                    rec["library_ms"] = time_ms(library, iters=10)
                for k in totals:
                    totals[k] += rec.get(k, 0.0)
                calls.append(rec)
                del y, got, want
            summary = {"phase": "kernel_check", "kernel": "block_epilogue", "dtype": label,
                       "image": image, "frames": n, "calls": calls,
                       "max_abs_err": max(r["max_abs_err"] for r in calls),
                       "ok": all(r["ok"] for r in calls), "bound_by": "bytes",
                       "roofline": totals["bound_ms"] / totals["ms"],
                       **{k: v for k, v in totals.items() if v}}
            if image == IMAGE and label == "bf16":
                ptxas = ptxas_summary(_build.build_log.get("block_epilogue", {}).get("log", ""))
                summary["ptxas"] = ptxas
                out = summary
            emit(summary)
            require(summary["ok"], f"block_epilogue {label} at {image}x{image} vs plain version")
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
    # own choice must be stepwise_tc for kernels 1-3
    over = [k for k in ("convlstm_serving", "convlstm_train_forward", "convlstm_backward")
            if recurrence_plan(k, *EDGE_SHAPES[-1], torch.bfloat16).design != "stepwise_tc"]
    require(not over, f"8x32 C=128 bf16 takes stepwise_tc, not resident: {over}")
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
    from vad_tpu_torch.ops import block_epilogue, convlstm, encoder_fused

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
    block_epilogue.block_epilogue.launches = 0
    scores = drive(main)
    torch.cuda.synchronize()
    launches = {"convlstm_serving": convlstm.convlstm_recurrence.launches,
                "first_block": encoder_fused.fused_first_block.launches,
                "block_epilogue": block_epilogue.block_epilogue.launches}
    require(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    require(launches["block_epilogue"] == 7 * CHUNKS, f"seven epilogues a chunk: {launches}")
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


HIGH_RES = 512  # 512x512 streams: a 32x32 latent, beyond the resident design's frames


def phase_main_path_512() -> dict:
    """``MultiStreamScorer`` on ``VideoAEConfig(image_size=512)`` (S=16, T=16,
    bf16 with f32 cell state, ``fused_input`` on, seeded weights) over
    ``CHUNKS`` chunks of carried state: kernel 4, then kernel 1 on the bf16
    stepwise_tc tile (the plan's choice at 32x32), its launches counted;
    each layer's (h, c), the scores and a further chunk's reconstruction
    against the same scorer on the plain versions at the bf16 bar; then
    frames/s."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops import block_epilogue, convlstm, encoder_fused

    cfg = VideoAEConfig(image_size=HIGH_RES, sequence_length=T)
    lat = HIGH_RES // 16
    plan = convlstm.recurrence_plan("convlstm_serving", S, T, lat, lat, cfg.lstm_hidden_dim,
                                    torch.bfloat16)
    require(plan.design == "stepwise_tc", f"512x512 bf16 streams take stepwise_tc: {plan}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    chunks = torch.randint(0, 256, (CHUNKS, S, T, HIGH_RES, HIGH_RES, 3), generator=g,
                           device="cuda", dtype=torch.uint8)

    def scorer():
        model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
        sc = MultiStreamScorer(model, None, S, T, HIGH_RES, dtype=torch.bfloat16, device="cuda")
        for slot in range(S):
            sc.attach(slot)
        return sc

    main, plain = scorer(), scorer()
    require(main.fused_input, "fused_input is on at 512x512")
    convlstm.convlstm_recurrence.launches = 0
    encoder_fused.fused_first_block.launches = 0
    block_epilogue.block_epilogue.launches = 0
    scores = np.stack([main.score_chunk(chunks[i]) for i in range(CHUNKS)])
    torch.cuda.synchronize()
    launches = {"convlstm_serving": convlstm.convlstm_recurrence.launches,
                "first_block": encoder_fused.fused_first_block.launches,
                "block_epilogue": block_epilogue.block_epilogue.launches}
    layers = len(main.states)
    expect = {"convlstm_serving": CHUNKS * layers * plan.launches, "first_block": CHUNKS,
              "block_epilogue": 7 * CHUNKS}
    require(launches == expect, f"512x512 scorer launches {launches}, planned {expect}")
    require(scores.shape == (CHUNKS, S, T) and bool(np.isfinite(scores).all()), "finite scores")
    with plain_versions():
        plain_scores = np.stack([plain.score_chunk(chunks[i]) for i in range(CHUNKS)])
        plain_recon = plain._forward(chunks[0])[0]
    recon = main._forward(chunks[0])[0]
    pairs = {"scores": (scores, plain_scores), "recon": (recon, plain_recon)}
    for i, ((h, c), (ph, pc)) in enumerate(zip(main.states, plain.states)):
        pairs[f"layer{i}_h"], pairs[f"layer{i}_c"] = (h, ph), (c, pc)
    cmp = {what: agree(got, ref) for what, (got, ref) in pairs.items()}
    for i in range(2):
        main.score_chunk(chunks[i])
    torch.cuda.synchronize()
    n = 6
    start = time.perf_counter()
    for i in range(n):
        main.score_chunk(chunks[i % CHUNKS])  # returns host scores: synchronizes
    fps = n * S * T / (time.perf_counter() - start)
    rec = {"phase": "main_path_512", "streams": S, "chunk": T, "image": HIGH_RES,
           "dtype": "bfloat16", "chunks": CHUNKS, "plan": {"design": plan.design,
                                                          "step_blocks": plan.step_blocks},
           "launches": launches, "bar": BF16_BAR, "compare_plain_versions": cmp,
           "frames_per_s": fps, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    require(all(r["ok"] for r in cmp.values()),
            f"512x512 scorer vs the plain versions within {BF16_BAR}: "
            f"{[k for k, r in cmp.items() if not r['ok']]}")
    return rec


# ------------------------------------------------------------- training


def bwd_parts(prof: dict) -> dict:
    """Kernel 3's device ms a call by part (``BWD_PARTS``) from a
    ``device_profile`` of whole calls: per launch times the launches a call
    makes (the profiler can miss the first launches of its window); the
    stepwise loops launch once a step, the rest once."""
    parts = {}
    for name, r in prof["port_kernels"].items():
        per_launch = r["ms_per_call"] / r["calls_per_call"]
        part = BWD_PARTS[name]
        parts[part] = (parts.get(part, 0.0) + per_launch
                       * (T if name in ("step_kernel", "dh_tc_step") else 1))
    return parts


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
    from vad_tpu_torch.ops.convlstm import recurrence_plan

    plans = {}
    for kname in ("convlstm_train_forward", "convlstm_backward"):
        fits = design is not None and design_fits(kname, shape, dtype, design)
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
    f32 (TF32 off) and bf16, and in f32 at the ``--video`` shape (B=1), in
    every design their plans can choose there (f32: stepwise_tc, and
    stepwise forced; bf16: resident, and the bf16 stepwise_tc tile and
    stepwise forced): checked, timed,
    bounded, and kernel 3 timed by part (gate recompute, reverse loop, dWh)
    from a device profile of three calls."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_backward_ref, convlstm_forward_ref

    lat, c = IMAGE // 16, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out, f32 = {}, {"convlstm_train_forward": {}, "convlstm_backward": {}}
    bf16 = {"convlstm_train_forward": {}, "convlstm_backward": {}}  # every bf16 design
    for b, label, dtype, bar in ((B_TRAIN, "f32", torch.float32, F32_BAR),
                                 (B_TRAIN, "bf16", torch.bfloat16, BF16_BAR),
                                 (B_VIDEO, "f32", torch.float32, F32_BAR)):
        shape = (b, T, lat, lat, c)
        for design in train_designs(shape, dtype):
            plans = train_plans(shape, dtype, design)
            rec, ok, args = check_train_kernels(g, shape, dtype, bar, design)
            gx, wh, h0, c0 = args[:4]
            e = gx.element_size()
            seq = b * T * lat * lat * c  # elements of one [B,T,H,W,C] tensor
            state = b * lat * lat * c * 4  # bytes of one f32 [B,H,W,C] tensor
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
                        shape, dtype)[0] and b == B_TRAIN else None)
                own = "forward" if kname == "convlstm_train_forward" else "backward"
                krec = {"phase": "kernel_check", "kernel": kname, "dtype": label,
                        "shape": list(shape), **rec, "design": plan.design,
                        "plan": rec["plans"][kname], "bar": bar, "ok": ok, "ms": ms,
                        "plain_ms": plain_ms, "launches_per_call": rec["launches_per_call"][kname],
                        **recurrence_bound(label, flops, nbytes, peak_flops, peak_bw, f32_flops),
                        "tflops": flops / ms / 1e9, "flops": flops, "bytes": nbytes,
                        "max_abs_err": rec[f"{own}_max_abs_err"]}
                if plan.cluster > 1 and plan.design == "resident":
                    krec["active_clusters"] = cl.active_clusters(kname, b, lat, lat, c)
                if kname == "convlstm_backward":
                    with no_tf32():
                        prof = device_profile(lambda i: kernel(), n=3, unit="call")
                    krec["ms_by_part"] = bwd_parts(prof)
                    krec["profile"] = prof["port_kernels"]
                emit(bounded(krec, f"{kname} {label} {plan.design} at B={b}"))
                if label == "bf16":  # resident, and the bf16 tile and WMMA core beside it
                    bf16[kname][plan.design] = {k: krec[k] for k in (
                        "launches_per_call", "max_abs_err", "ms", "bound_ms", "of_bound",
                        "tflops")}
                    bf16[kname][plan.design]["ms_by_part"] = krec.get("ms_by_part")
                if label == "bf16" and plain_ms is not None:
                    out[kname] = krec
                elif label == "f32":  # both f32 designs at both shapes, for the kernels line
                    key = f"B={b} {plan.design}"
                    f32[kname][key] = {k: krec[k] for k in (
                        "launches_per_call", "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_fma_ms", "tflops")}
                    f32[kname][key].update(step_blocks=plan.step_blocks, cluster=plan.cluster,
                                           ms_by_part=krec.get("ms_by_part"))
            require(ok, f"kernels 2 and 3 {label} {rec['designs']} at B={b} vs plain versions "
                        f"and autograd within {bar}, launches as planned, dWh deterministic")
    for kname, rec in f32.items():
        out[kname]["f32"] = rec
        out[kname]["bf16_designs"] = bf16[kname]
    return out


# Kernels 1 and 2 in bf16 on the 32x32 latent of 512x512 streams, where the
# resident design (at most four 8x8 tiles) refuses the frame: kernel 1 at
# S=16 and at the --video B=1, kernel 2 at B=8 (B, T, H, W, C).
LARGE_SHAPES = {"convlstm_serving": ((S, T, 32, 32, 128), (B_VIDEO, T, 32, 32, 128)),
                "convlstm_train_forward": ((B_TRAIN, T, 32, 32, 128),)}
# Kernel 3 in bf16 there: the backward of the 512x512 train step (B=8)
LARGE_BACKWARD = (B_TRAIN, T, 32, 32, 128)


def phase_large_frames(peak_flops: float, peak_bw: float) -> dict:
    """Kernels 1 and 2 in bf16 at ``LARGE_SHAPES``, in every design their
    plan can choose there: stepwise_tc (the bf16 tile, the plan's choice)
    and the WMMA stepwise core forced, each against its plain version at the
    bf16 bar (allclose, and rel L2 within its rtol) and the two designs
    against each other; each timed, bounded (``of_bound`` <= 1), with its
    launches and plan."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_forward_ref, recurrence_plan

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dtype, out = torch.bfloat16, {}
    for kname, shapes in LARGE_SHAPES.items():
        cell = kname == "convlstm_train_forward"
        counter = cl.convlstm_train_forward if cell else cl.convlstm_recurrence
        names = ("h_seq", "c_seq", "h_T", "c_T") if cell else ("h_seq", "h_T", "c_T")
        for shape in shapes:
            b, t, hgt, wid, c = shape
            gx = (torch.randn((b, t, hgt, wid, 4 * c), generator=g, device="cuda") * 0.5).to(dtype)
            wh = (torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05).to(dtype)
            h0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.1
            c0 = torch.randn((b, hgt, wid, c), generator=g, device="cuda") * 0.1

            def flat(res):
                seq, cseq, (hf, cf) = res
                return (seq, cseq, hf, cf) if cell else (seq, hf, cf)

            ref = flat(convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=cell))
            plain_ms = time_ms(lambda: convlstm_forward_ref(gx, wh, h0, c0, cell), iters=3,
                               warmup=1)
            hw, e = hgt * wid, gx.element_size()
            flops = 2 * b * t * hw * 9 * c * 4 * c
            nbytes = (b * t * hw * 4 * c * e + (2 if cell else 1) * b * t * hw * c * e
                      + 4 * b * hw * c * 4 + 9 * c * 4 * c * e)  # gates_x, outputs, states, Wh
            got, recs = {}, {}
            for design in designs(kname, shape, dtype):
                plan = recurrence_plan(kname, *shape, dtype, design)

                def kernel(p=plan):
                    return cl._forward_kernel(gx, wh, h0, c0, cell, p)

                counter.launches = 0
                got[design] = flat(kernel())
                per_call = counter.launches
                torch.cuda.synchronize()
                cmp = {n: agree(a, r) for n, a, r in zip(names, got[design], ref)}
                rec = {"phase": "kernel_check", "kernel": kname, "dtype": "bf16",
                       "shape": list(shape), "design": design,
                       "plan": plan_record(kname, shape, dtype, design),
                       "launches_per_call": per_call, "vs_plain": cmp,
                       "max_abs_err": max(r["max_abs_err"] for r in cmp.values()),
                       "bar": BF16_BAR, "ms": time_ms(kernel, iters=10), "plain_ms": plain_ms,
                       "library_ms": None, "flops": flops, "bytes": nbytes,
                       **recurrence_bound("bf16", flops, nbytes, peak_flops, peak_bw, 0.0)}
                rec["tflops"] = flops / rec["ms"] / 1e9
                rec["ok"] = (all(r["ok"] for r in cmp.values()) and per_call == plan.launches)
                emit(bounded(rec, f"{kname} bf16 {design} at {shape}"))
                require(rec["ok"], f"{kname} bf16 {design} at {shape} vs its plain version "
                                   f"within {BF16_BAR}, {per_call} launches as planned "
                                   f"({plan.launches})")
                recs[design] = {k: rec[k] for k in (
                    "launches_per_call", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "of_bound", "tflops", "library_ms")}
                recs[design]["step_blocks"] = plan.step_blocks
            between = {n: agree(a, r) for n, a, r in zip(names, got["stepwise_tc"],
                                                        got["stepwise"])}
            emit({"phase": "kernel_designs", "kernel": kname, "shape": list(shape),
                  "stepwise_tc_vs_stepwise": between})
            require(all(r["ok"] for r in between.values()),
                    f"{kname} bf16 at {shape}: stepwise_tc against stepwise within {BF16_BAR}")
            out.setdefault(kname, {})[f"B={b} 32x32"] = recs
    out["convlstm_backward"] = {f"B={LARGE_BACKWARD[0]} 32x32": check_large_backward(
        g, peak_flops, peak_bw)}
    return out


def check_large_backward(g, peak_flops: float, peak_bw: float) -> dict:
    """Kernel 3 in bf16 at ``LARGE_BACKWARD`` in every design its plan can
    choose there: stepwise_tc (the bf16 tile, the plan's choice) and PR 1's
    WMMA core (stepwise) forced; each against ``convlstm_backward_ref`` at
    the bf16 bar (``agree``, dWh as a long sum), with its launches equal to
    the plan's and its dWh equal bit for bit over two calls; timed, bounded
    (``of_bound`` <= 1) and timed by part (gate, loop, dWh, dh0 + the split
    sum) from a device profile; then the two designs against each other (a
    ``kernel_designs`` line).  Returns each design's summary."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import (
        convlstm_backward_ref, convlstm_forward_ref, recurrence_plan,
    )

    shape, dtype = LARGE_BACKWARD, torch.bfloat16
    b, t, hgt, wid, c = shape
    rnd = lambda *dims, scale=1.0: torch.randn(dims, generator=g, device="cuda") * scale  # noqa
    gx = rnd(b, t, hgt, wid, 4 * c, scale=0.5).to(dtype)
    wh = rnd(3, 3, c, 4 * c, scale=0.05).to(dtype)
    h0, c0 = rnd(b, hgt, wid, c, scale=0.1), rnd(b, hgt, wid, c, scale=0.1)
    hs, cs, _ = convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=True)
    args = (gx, wh, h0, c0, hs, cs, rnd(b, t, hgt, wid, c).to(dtype), rnd(b, hgt, wid, c),
            rnd(b, hgt, wid, c))
    ref = convlstm_backward_ref(*args)
    plain_ms = time_ms(lambda: convlstm_backward_ref(*args), iters=3, warmup=1)
    e, seq = gx.element_size(), b * t * hgt * wid * c
    state, w_bytes = b * hgt * wid * c * 4, 9 * c * 4 * c * e
    flops = 3 * 2 * seq * 9 * c * 4  # the gate recompute, the dh product, dWh
    # gates_x, h_seq, c_seq, dh_seq, Wh, h0, c0, dhf, dcf in; dgates_x, dWh, dh0, dc0 out
    nbytes = 2 * seq * 4 * e + 3 * seq * e + 2 * w_bytes + 6 * state
    names = ("dgates_x", "dw_h", "dh0", "dc0")
    got, recs = {}, {}
    for design in designs("convlstm_backward", shape, dtype):
        plan = recurrence_plan("convlstm_backward", *shape, dtype, design)

        def kernel(p=plan):
            return cl._backward_kernel(*args, plan=p)

        cl.convlstm_backward.launches = 0
        got[design] = kernel()
        repeat = bool(torch.equal(got[design][1], kernel()[1]))
        per_call = cl.convlstm_backward.launches // 2
        torch.cuda.synchronize()
        cmp = {n: agree(a, r, is_sum=n == "dw_h") for n, a, r in zip(names, got[design], ref)}
        prof = device_profile(lambda i: kernel(), n=2, unit="call")
        rec = {"phase": "kernel_check", "kernel": "convlstm_backward", "dtype": "bf16",
               "shape": list(shape), "design": design,
               "plan": plan_record("convlstm_backward", shape, dtype, design),
               "launches_per_call": per_call, "vs_plain": cmp, "dw_h_bitwise_repeat": repeat,
               "max_abs_err": max(r["max_abs_err"] for r in cmp.values()),
               "bar": BF16_BAR, "ms": time_ms(kernel, iters=10), "plain_ms": plain_ms,
               "library_ms": None, "flops": flops, "bytes": nbytes,
               "ms_by_part": bwd_parts(prof), "profile": prof["port_kernels"],
               **recurrence_bound("bf16", flops, nbytes, peak_flops, peak_bw, 0.0)}
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["ok"] = all(r["ok"] for r in cmp.values()) and per_call == plan.launches and repeat
        emit(bounded(rec, f"convlstm_backward bf16 {design} at {shape}"))
        require(rec["ok"], f"convlstm_backward bf16 {design} at {shape} vs its plain version "
                           f"within {BF16_BAR}, {per_call} launches as planned ({plan.launches}), "
                           f"dWh deterministic")
        recs[design] = {k: rec[k] for k in (
            "launches_per_call", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "of_bound", "tflops", "library_ms", "ms_by_part")}
        recs[design]["step_blocks"] = plan.step_blocks
    between = {n: agree(a, r, is_sum=n == "dw_h")
               for n, a, r in zip(names, got["stepwise_tc"], got["stepwise"])}
    emit({"phase": "kernel_designs", "kernel": "convlstm_backward", "shape": list(shape),
          "stepwise_tc_vs_stepwise": between})
    require(all(r["ok"] for r in between.values()),
            f"convlstm_backward bf16 at {shape}: stepwise_tc against stepwise within {BF16_BAR}")
    return recs


def phase_weight_cache() -> dict:
    """stepwise_tc's cached stage images of Wh (``ops/weight_cache.py``) on
    the card: f32 kernel 1 at the ``--video`` shape (B=1, 16x16, C=128) on a
    weight ``Parameter``, then an ``Adam(fused=True)`` step (which leaves the
    weight's version as it was), then a ``torch.no_grad()`` ``copy_``, each
    followed by a call that must equal the plain version on the new weights
    at the f32 bar and differ from the call before; the cache must hit
    while the weight is unchanged."""
    import torch

    from vad_tpu_torch.ops import convlstm as cl
    from vad_tpu_torch.ops.convlstm import convlstm_recurrence_ref

    lat, c = IMAGE // 16, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    gx = torch.randn((B_VIDEO, T, lat, lat, 4 * c), generator=g, device="cuda") * 0.5
    wh = torch.nn.Parameter(torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05)
    h0 = torch.randn((B_VIDEO, lat, lat, c), generator=g, device="cuda") * 0.1
    c0 = torch.randn((B_VIDEO, lat, lat, c), generator=g, device="cuda") * 0.1
    require(cl.recurrence_plan("convlstm_serving", B_VIDEO, T, lat, lat, c,
                               torch.float32).design == "stepwise_tc", "f32 B=1 is stepwise_tc")
    checks, last = {}, None
    optimizer = torch.optim.Adam([wh], lr=1e-2, fused=True)
    for update in ("initial", "adam_fused", "no_grad_copy"):
        if update == "adam_fused":
            version = wh._version
            wh.grad = torch.randn(wh.shape, generator=g, device="cuda")
            optimizer.step()
            require(wh._version == version, "a fused Adam step leaves the version as it was")
        elif update == "no_grad_copy":
            with torch.no_grad():
                wh.copy_(wh * 0.5 + 0.01)
        with no_tf32(), torch.no_grad():
            seq, (hf, cf) = cl.convlstm_recurrence(gx, wh, h0, c0)
            rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh.detach(), h0, c0)
            torch.cuda.synchronize()
        errs = [close(a, r, F32_BAR) for a, r in ((seq, rseq), (hf, rhf), (cf, rcf))]
        moved = last is None or not torch.equal(seq, last)
        checks[update] = {"max_abs_err": max(e[0] for e in errs),
                          "ok": all(e[1] for e in errs) and moved, "moved": moved}
        last = seq
    hit = cl._tc_weights(wh, "fwd") is cl._tc_weights(wh, "fwd")
    rec = {"phase": "weight_cache", "shape": list(gx.shape), "bar": F32_BAR, "checks": checks,
           "cache_hits_when_unchanged": hit, "ok": hit and all(r["ok"] for r in checks.values())}
    emit(rec)
    require(rec["ok"], f"kernel 1 after each weight update equals the plain version: {checks}")
    return rec


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


def phase_train_step_compare(image: int = IMAGE, judged=("f32", "bf16")) -> dict:
    """One full-width ``make_train_step`` step (B=8, T=16, ``image``² frames,
    the default model from ``init_weights(seed)``) through kernels 2 and 3,
    against the same step from the same weights on the plain versions:
    the loss, every parameter's gradient and the BatchNorm running
    statistics after the step, in each precision of ``judged`` (f32 with
    TF32 off, bf16), with ``agree``: in f32 the loss and statistics at
    ``F32_BAR`` and the gradients at ``TRAIN_F32_BAR``; in bf16 all at
    ``BF16_BAR``.  The plain f32 step always runs: it is bf16's noise floor.

    Two cases the bar cannot judge by relative error: a gradient that is
    zero by construction (``zero_gradient_biases``) is held to the
    allclose part only (``F32_BAR`` in f32); and in bf16 the plain step
    itself lands up to ~30% (relative L2) from the f32 step on the first
    encoder layers, so a bf16 gradient whose plain step is at least
    ``BF16_NOISY`` from the f32 step passes when it is no further from the
    plain f32 step than the plain bf16 step is (x1.25 + 0.005) and within
    ``BF16_NOISY_VS_PLAIN`` of the plain bf16 step.  Kernels 2 and 3 must
    launch what their plans say, once a ConvLSTM layer.  Returns each
    judged precision's launches."""
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.parallel.multiprocess_check import zero_gradient_biases
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    cfg = VideoAEConfig(image_size=image, sequence_length=T)
    base = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
    zero_by_construction = set(zero_gradient_biases(base))
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = torch.randint(0, 256, (B_TRAIN, T, image, image, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        step = make_train_step(mse_per_sample, dtype)
        for which in ("kernels", "plain"):
            if which == "kernels" and label not in judged:
                continue
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
            del model, optimizer
            torch.cuda.empty_cache()
    exact = runs["f32", "plain"]["grads"]
    results = {}
    for label in judged:
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
    shape = (B_TRAIN, T, image // 16, image // 16, cfg.lstm_hidden_dim)
    plans = {label: train_plans(shape, torch.bfloat16 if label == "bf16" else torch.float32)
             for label in judged}
    for label, kplans in plans.items():  # one call of kernels 2 and 3 a ConvLSTM layer
        want = {k: cfg.lstm_layers * p.launches for k, p in kplans.items()}
        got = {k: results[label]["launches"][k] for k in want}
        require(got == want, f"{label} train step at {image}²: launches {got}, plans {want}")
    emit({"phase": "train_step_compare" if image == IMAGE else f"train_step_compare_{image}",
          "batch": [B_TRAIN, T, image, image, 3],
          "designs": {label: {k: p.design for k, p in kplans.items()}
                      for label, kplans in plans.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "bars": {"f32": TRAIN_BARS["f32"], "bf16": TRAIN_BARS["bf16"][0],
                   "bf16_noise_floor_from": BF16_NOISY,
                   "bf16_noisy_vs_plain": BF16_NOISY_VS_PLAIN}, **results})
    require(all(not r["failed"] for r in results.values()),
            f"train step through the kernels vs the plain versions within {TRAIN_BARS}")
    return {label: r["launches"] for label, r in results.items()}


class WindowSet:
    """In-memory windows with the IPAD dataset's sample dicts (uint8
    frames drawn by the port's orbit generator, ``_video_frame``), so no
    files are written."""

    has_frame_labels = True  # every frame carries its window's label

    def __init__(self, labels, seed: int):
        import numpy as np

        from vad_tpu_torch.data.synthetic import _video_frame

        self.labels = np.asarray(labels, np.int64)
        self.frames = np.empty((len(labels), T, IMAGE, IMAGE, 3), np.uint8)
        for w, label in enumerate(self.labels):
            rng = np.random.default_rng(seed + w)
            phase, speed = rng.uniform(0, 2 * math.pi), rng.uniform(0.12, 0.2)
            for t in range(T):
                self.frames[w, t] = _video_frame(t, IMAGE, phase, speed, bool(label), rng)

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
    """``n`` orbit frames without and with the intruder, one orbit (the
    port's ``_video_frame``)."""
    import numpy as np

    from vad_tpu_torch.data.synthetic import _video_frame

    rng = np.random.default_rng(seed)
    phase, speed = rng.uniform(0, 2 * math.pi), rng.uniform(0.12, 0.2)
    return tuple(np.stack([_video_frame(t, IMAGE, phase, speed, anomaly, rng)
                           for t in range(n)])
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
      stepwise_tc, f32) against the plain versions at the f32 bar;
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

    # temporal_features: the last ConvLSTM layer's h_seq, kernel 1 stepwise_tc in f32
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


def phase_image(card: str, workdir: Path) -> dict:
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

    The image path runs no port kernel: the launch counts must stay 0.
    Everything is written under ``workdir``; returns the launches, the best
    checkpoint, the evaluation's ``latent_stats.npz`` and the test images
    (uint8) for ``phase_serve``."""
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
    tmp = str(workdir)
    Path(tmp).mkdir(parents=True, exist_ok=True)
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
    out.update(ckpt=ckpt, latent_stats=run_dir / "evaluation" / "latent_stats.npz",
               test_images=x.numpy())
    return out


# --------------------------------------------------------------- serving


def threaded(fn, calls, timeout: float = 300.0) -> list:
    """``fn(*args)`` for each ``args`` of ``calls``, one thread each, all at
    once; their results in order.  The first error is raised."""
    results, errors = [None] * len(calls), []

    def run(i, args):
        try:
            results[i] = fn(*args)
        except BaseException as exc:  # handed to the caller below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    require(not any(t.is_alive() for t in threads), f"{len(calls)} client threads finished")
    if errors:
        raise errors[0]
    return results


@contextmanager
def webhook_receiver():
    """A stdlib alert receiver on a thread: (its URL, the bodies it got, an
    Event set on the first ``stream_anomaly``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    received, anomaly = [], threading.Event()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def do_POST(self) -> None:
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            received.append(body)
            if body.get("type") == "stream_anomaly":
                anomaly.set()
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}/alert", received, anomaly
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def prometheus_samples(text: str) -> dict:
    """``{series: value}`` from Prometheus text; raises on a malformed line."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        m = re.fullmatch(r'([a-z_0-9]+\{(?:[a-z_]+="[^"]*",?)+\}) (\S+)', line)
        require(m is not None, f"Prometheus line parses: {line!r}")
        samples[m.group(1)] = float(m.group(2))
    return samples


def serve_cli(ckpt: Path, streams: list) -> dict:
    """``python -m vad_tpu_torch.serve --dtype float32`` as a subprocess on
    ``ckpt``: its ``Serving ... on host:port`` line, one chunk after another
    of each of ``streams`` (a list of ``[chunks, T, H, W, 3]`` arrays, on
    slots 0, 1, ...) through the client, then SIGINT.  Returns the scores,
    the exit code and the seconds to the Serving line."""
    import queue
    import signal

    from vad_tpu_torch.eval.client import ScoringClient

    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vad_tpu_torch.serve", "--checkpoint", str(ckpt), "--port", "0",
         "--host", "127.0.0.1", "--dtype", "float32"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()

    def read() -> None:
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    try:
        log, port = [], None
        while port is None:
            line = lines.get(timeout=300)
            require(line is not None, f"the serve CLI printed its Serving line: {log[-20:]}")
            log.append(line.rstrip())
            m = re.match(r"Serving \S+ on 127\.0\.0\.1:(\d+) \(", line)
            port = int(m.group(1)) if m else None
        ready = time.perf_counter() - start
        client = ScoringClient("127.0.0.1", port)
        slots = [client.attach() for _ in streams]
        scores = [[client.score_chunk(slot, chunk)["scores"] for chunk in frames]
                  for slot, frames in zip(slots, streams)]
        health = client.health()
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return {"slots": slots, "scores": scores, "exit_code": code, "ready_seconds": ready,
            "serving_line": log[-1], "health": health}


def phase_serve(card: str, video_ckpt: Path, image: dict) -> dict:
    """The serving daemon at full width, in process and as the CLI:

    - one dual daemon, ``serve_from_checkpoint(fit's best checkpoint,
      image_checkpoint=the image phase's best)`` at its defaults (16 slots,
      chunks of 16, bf16, ``fused_input`` on); 16 client threads attach
      and stream ``SERVE_CHUNKS`` chunks of orbit frames each (every fourth
      stream with the intruder), with ``/v1/reload`` to another epoch's
      checkpoint after ``SERVE_RELOAD_AT`` chunks; every chunk's scores
      against a direct bf16 ``MultiStreamScorer`` that makes the same reload
      at the same point (``agree`` at the bf16 bar), the reload refolding
      kernel 4's weights; kernels 1 and 4 must launch;
    - served frames/s end to end and request latency over
      ``SERVE_TIMED_CHUNKS`` more chunks a stream, a profiled window of
      ``SERVE_PROFILE_ROUNDS`` rounds (one chunk a stream each), and the
      direct scorer's frames/s on the same host batches;
    - a ``stream_anomaly`` alert on one stream to a local webhook
      (threshold below its scores, 3 consecutive chunks);
    - ``/v1/images`` from ``IMAGE_THREADS`` threads over the image
      fixture's test images against ``reconstruction_error`` (f32, TF32
      off) at the bf16 bar, and an f32 latent daemon on the image phase's
      ``latent_stats.npz`` against the latent scorer's map means;
    - ``/v1/metrics``: exactly the requests and frames sent, no error, and
      the Prometheus text parses;
    - ``python -m vad_tpu_torch.serve --dtype float32`` as a subprocess:
      ``CLI_CHUNKS`` chunks of two streams against a direct f32 scorer at
      the f32 bar, then SIGINT and exit code 0."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval import image_eval
    from vad_tpu_torch.eval.alerts import AlertNotifier
    from vad_tpu_torch.eval.client import ScoringClient
    from vad_tpu_torch.eval.http_server import serve_from_checkpoint
    from vad_tpu_torch.eval.latent_score import load_stats, make_distance_fn, stats_state
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
    from vad_tpu_torch.train.steps import u8_normalize
    from vad_tpu_torch.utils.checkpoint import load_checkpoint

    phase_start = time.perf_counter()
    saved_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    best = load_checkpoint(video_ckpt)
    run_dir = Path(video_ckpt).parent
    leaf = lambda ck: ck["params"]["encoder"]["Conv_0"]["kernel"]  # noqa: E731
    others = [p for p in sorted(run_dir.glob("checkpoint_epoch_*.ckpt"))
              if not np.array_equal(leaf(load_checkpoint(p)), leaf(best))]
    require(bool(others), f"an epoch checkpoint with other weights than the best in {run_dir}")
    reload_path = others[0]
    reload_ckpt = load_checkpoint(reload_path)

    bank = orbit_bank(BANK_FRAMES, SEED + 400)
    streams = [np.stack(list(clip_frames(bank, SERVE_CHUNKS * T, 9 * k, k % 4 == 3)))
               .reshape(SERVE_CHUNKS, T, IMAGE, IMAGE, 3) for k in range(S)]

    def direct_scorer(ckpt, dtype):
        model = VideoAutoencoder.from_config(VideoAEConfig.from_args(ckpt["args"]), device="cpu")
        sc = MultiStreamScorer(model, {"params": ckpt["params"],
                                       "batch_stats": ckpt["batch_stats"]}, S, T, IMAGE,
                               dtype=dtype)
        for slot in range(S):
            sc.attach(slot)
        return sc

    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        srv = serve_from_checkpoint(str(video_ckpt), host="127.0.0.1", port=0,
                                    image_checkpoint=str(image["ckpt"]))
    start_seconds = time.perf_counter() - start
    srv.start_background()
    vsvc, scorer = srv.services["video"], srv.services["video"].scorer
    require(scorer.fused_input and scorer.dtype == torch.bfloat16 and scorer.num_slots == S,
            "the daemon serves bf16 with fused_input on, 16 slots")
    sent = {"video": 0, "image": 0, "image_frames": 0}
    try:
        clients = [ScoringClient("127.0.0.1", srv.port) for _ in range(S)]

        def stream(k, lo, hi, lat=None):
            out = []
            for i in range(lo, hi):
                t0 = time.perf_counter()
                out.append(clients[k].score_chunk(slots[k], streams[k][i % SERVE_CHUNKS])["scores"])
                if lat is not None:
                    lat.append(time.perf_counter() - t0)
            return np.asarray(out)

        # the main path: 16 streams, a reload mid-stream
        zero_counters()
        slots = threaded(lambda c: c.attach(), [(c,) for c in clients])
        require(sorted(slots) == list(range(S)), f"16 streams got the 16 slots: {slots}")
        served = threaded(stream, [(k, 0, SERVE_RELOAD_AT) for k in range(S)])
        folded = scorer._w_folded.clone()
        reply = clients[0].reload(str(reload_path))
        require(reply == {"reloaded": str(reload_path), "model_type": "video"}, f"reload {reply}")
        require(not torch.equal(scorer._w_folded, folded), "the reload refolded kernel 4's weights")
        served = [np.concatenate([a, b]) for a, b in zip(served, threaded(
            stream, [(k, SERVE_RELOAD_AT, SERVE_CHUNKS) for k in range(S)]))]
        sent["video"] += S * SERVE_CHUNKS
        torch.cuda.synchronize()
        launches = read_counters()
        require(launches["convlstm_serving"] > 0 and launches["first_block"] > 0,
                f"/v1/streams went through kernels 1 and 4: {launches}")
        require(vsvc.health()["active_slots"] == list(range(S)), "streams kept their slots")

        # the same chunks through a direct scorer, the same reload at the same point
        direct = direct_scorer(best, torch.bfloat16)
        want = np.zeros((S, SERVE_CHUNKS, T), np.float32)
        for i in range(SERVE_CHUNKS):
            if i == SERVE_RELOAD_AT:
                direct.reload_variables({"params": reload_ckpt["params"],
                                         "batch_stats": reload_ckpt["batch_stats"]})
            batch = np.zeros((S, T, IMAGE, IMAGE, 3), np.uint8)
            for k in range(S):
                batch[slots[k]] = streams[k][i]
            scores = direct.score_chunk(batch)
            for k in range(S):
                want[k, i] = scores[slots[k]]
        served = np.stack(served)
        require(torch.equal(direct._w_folded, scorer._w_folded),
                "daemon and direct scorer fold the same kernel-4 weights after the reload")
        streams_cmp = {"before_reload": agree(served[:, :SERVE_RELOAD_AT],
                                              want[:, :SERVE_RELOAD_AT]),
                       "after_reload": agree(served[:, SERVE_RELOAD_AT:],
                                             want[:, SERVE_RELOAD_AT:])}
        per_stream = [agree(served[k], want[k]) for k in range(S)]
        require(all(r["ok"] for r in [*streams_cmp.values(), *per_stream]),
                f"16 streams vs the direct scorer within {BF16_BAR}: {streams_cmp}")

        # end to end speed and latency, then a profiled window
        lat: list = []
        m0 = vsvc.metrics.snapshot()
        start = time.perf_counter()
        threaded(stream, [(k, 0, SERVE_TIMED_CHUNKS, lat) for k in range(S)])
        served_seconds = time.perf_counter() - start
        m1 = vsvc.metrics.snapshot()
        sent["video"] += S * SERVE_TIMED_CHUNKS
        timed_ticks = m1["device_steps"] - m0["device_steps"]
        lat_ms = np.asarray(lat) * 1e3
        prof = device_profile(lambda i: threaded(stream, [(k, i, i + 1) for k in range(S)]),
                              n=SERVE_PROFILE_ROUNDS, unit="round")
        m2 = vsvc.metrics.snapshot()
        sent["video"] += S * SERVE_PROFILE_ROUNDS
        prof_ticks = m2["device_steps"] - m1["device_steps"]

        # the direct scorer on the same host batches
        host_batches = [np.stack([streams[k][i] for k in range(S)]) for i in range(SERVE_CHUNKS)]
        direct.score_chunk(host_batches[0])
        torch.cuda.synchronize()
        n = 10
        start = time.perf_counter()
        for i in range(n):
            direct.score_chunk(host_batches[i % SERVE_CHUNKS])  # host scores: synchronizes
        direct_fps = n * S * T / (time.perf_counter() - start)

        # one stream over a threshold below its scores: one stream_anomaly
        with webhook_receiver() as (url, received, anomaly):
            vsvc.notifier = AlertNotifier(url, consecutive=3, cooldown=1000.0)
            threshold, vsvc.score_threshold = vsvc.score_threshold, float(served[0].min()) / 2
            stream(0, 0, 3)
            sent["video"] += 3
            fired = anomaly.wait(timeout=60)
            vsvc.notifier.close()  # delivers what was queued
            alerts = [a for a in received if a["type"] == "stream_anomaly"]
            vsvc.notifier, vsvc.score_threshold = None, threshold
        require(fired and len(alerts) == 1 and alerts[0]["slot"] == slots[0]
                and alerts[0]["consecutive_chunks"] == 3,
                f"one stream_anomaly alert for slot {slots[0]}: {alerts}")

        # images: recon through the dual daemon, from 4 threads
        test_images = image["test_images"]
        parts = np.array_split(np.arange(len(test_images)), IMAGE_THREADS)
        got = threaded(lambda idx: ScoringClient("127.0.0.1", srv.port).score_images(
            test_images[idx])["scores"], [(p,) for p in parts])
        sent["image"] += IMAGE_THREADS
        sent["image_frames"] += len(test_images)
        with contextlib.redirect_stdout(io.StringIO()):
            model, _, _ = image_eval.load_image_model(image["ckpt"], "cuda")
        x = torch.from_numpy(test_images).cuda()
        with torch.no_grad(), no_tf32():
            ref = torch.cat([model.reconstruction_error(u8_normalize(xb)) for xb in x.split(10)])
        images_cmp = agree(np.concatenate(got), ref.cpu())
        require(images_cmp["ok"], f"/v1/images vs reconstruction_error within {BF16_BAR}")

        # the metrics count what was sent
        metrics = ScoringClient("127.0.0.1", srv.port).metrics()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/v1/metrics?format=prometheus")
        samples = prometheus_samples(conn.getresponse().read().decode())
        conn.close()
        video_m, image_m = metrics["video"], metrics["image"]
        require((video_m["requests"], video_m["frames_scored"], video_m["errors"])
                == (sent["video"], sent["video"] * T, 0)
                and (image_m["requests"], image_m["frames_scored"], image_m["errors"])
                == (sent["image"], sent["image_frames"], 0),
                f"/v1/metrics counts what was sent: {sent}, {metrics}")
        require(samples['vad_requests_total{model="video"}'] == sent["video"],
                "Prometheus requests counter")
        health = ScoringClient("127.0.0.1", srv.port).health()
    finally:
        srv.close()

    # the latent scorer: an f32 image daemon on the image phase's statistics
    with contextlib.redirect_stdout(io.StringIO()):
        lsrv = serve_from_checkpoint(str(image["ckpt"]), host="127.0.0.1", port=0,
                                     dtype="float32", latent_stats=str(image["latent_stats"]))
    lsrv.start_background()
    try:
        got = ScoringClient("127.0.0.1", lsrv.port).score_images(test_images)["scores"]
    finally:
        lsrv.close()
    stats = load_stats(image["latent_stats"])
    dfn = make_distance_fn(lambda m, xs: m.feature_pyramid(xs), stats.layers, stats.grid)
    state = stats_state(stats, "cuda")
    with torch.no_grad(), no_tf32():
        ref = torch.cat([dfn(model, state, u8_normalize(xb)).flatten(1).mean(1)
                         for xb in x.split(10)])
    latent_cmp = agree(got, ref.cpu(), F32_BAR)
    require(latent_cmp["ok"], f"latent daemon vs the latent scorer within {F32_BAR}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32

    # the CLI, f32, against a direct f32 scorer (TF32 off)
    cli_streams = [streams[k][:CLI_CHUNKS] for k in range(2)]
    cli = serve_cli(video_ckpt, cli_streams)
    require(cli["exit_code"] == 0, f"the serve CLI exits 0 on SIGINT: {cli['exit_code']}")
    with no_tf32():
        direct32 = direct_scorer(best, torch.float32)
        want32 = np.zeros((2, CLI_CHUNKS, T), np.float32)
        for i in range(CLI_CHUNKS):
            batch = np.zeros((S, T, IMAGE, IMAGE, 3), np.uint8)
            for k, slot in enumerate(cli["slots"]):
                batch[slot] = cli_streams[k][i]
            scores = direct32.score_chunk(batch)
            for k, slot in enumerate(cli["slots"]):
                want32[k, i] = scores[slot]
    cli_cmp = agree(np.asarray(cli["scores"]), want32, F32_BAR)
    require(cli_cmp["ok"] and cli["health"]["dtype"] == "torch.float32"
            and cli["health"]["fused_input"], f"the f32 CLI daemon vs a direct f32 scorer "
                                               f"within {F32_BAR}: {cli_cmp}")

    record = {
        "phase": "serve", "card": card, "streams": S, "chunk": T, "image": IMAGE,
        "dtype": "bfloat16", "fused_input": True, "reloaded": reload_path.name,
        "launches": launches, "start_seconds": start_seconds,
        "streams_vs_direct": streams_cmp,
        "worst_stream_max_abs_err": max(r["max_abs_err"] for r in per_stream),
        "served_frames_per_s": S * SERVE_TIMED_CHUNKS * T / served_seconds,
        "direct_frames_per_s": direct_fps,
        "request_ms": {"p50": float(np.percentile(lat_ms, 50)),
                       "p99": float(np.percentile(lat_ms, 99)), "max": float(lat_ms.max())},
        "device_step_ms": {"mean": video_m["device_step_latency"]["mean_ms"],
                           "min": video_m["device_step_latency"]["min_ms"],
                           "max": video_m["device_step_latency"]["max_ms"]},
        "slots_per_tick": {"timed": S * SERVE_TIMED_CHUNKS / timed_ticks,
                           "profiled": S * SERVE_PROFILE_ROUNDS / prof_ticks,
                           "phase": video_m["requests"] / video_m["device_steps"]},
        "profile": {**prof, "ticks": prof_ticks}, "alerts": len(alerts),
        "images_vs_reconstruction_error": images_cmp, "latent_vs_scorer": latent_cmp,
        "cli": {"vs_direct_f32": cli_cmp, "exit_code": cli["exit_code"],
                "ready_seconds": cli["ready_seconds"], "serving_line": cli["serving_line"]},
        "metrics": {k: {f: m[f] for f in ("requests", "frames_scored", "device_steps", "errors")}
                    for k, m in metrics.items()},
        "hbm": health["video"]["hbm"], "seconds": time.perf_counter() - phase_start,
    }
    emit(record)
    return {"launches": launches}


# ------------------------------------------------- export and the reference


def graph_counts(program) -> dict:
    """Call nodes of an exported program: kernel 1's operator, and the
    plain recurrence's sigmoids (an unrolled time loop would hold them)."""
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {"nodes": len(targets),
            "convlstm_recurrence": sum("vad_tpu_torch.convlstm_recurrence" in t
                                       for t in targets),
            "sigmoid": sum("sigmoid" in t for t in targets)}


def artifact_check(path: str, ckpt_path: str, dtype_name: str) -> int:
    """The loading side of ``phase_export``, run as ``chip_smoke.py
    --artifact-check`` in a fresh process: ``load_artifact`` (the port's ops
    registered by it), ``EXPORT_CHUNKS`` chunks with the state threaded by
    hand and the last slot unsubmitted on the third, kernel 1's launches
    counted in this process, the scores against direct ``MultiStreamScorer``s
    on the same checkpoint, and both timed on device-resident chunks.
    Prints one JSON line."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
    from vad_tpu_torch.ops import convlstm
    from vad_tpu_torch.utils.checkpoint import load_checkpoint
    from vad_tpu_torch.utils.export import load_artifact

    start = time.perf_counter()
    exported = load_artifact(path)
    load_seconds = time.perf_counter() - start
    dtype = getattr(torch, dtype_name)
    ckpt = load_checkpoint(ckpt_path)
    cfg = VideoAEConfig.from_args(ckpt["args"])
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    chunks = torch.randint(0, 256, (EXPORT_CHUNKS, S, T, IMAGE, IMAGE, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    masks = [np.ones(S, bool) for _ in range(EXPORT_CHUNKS)]
    masks[2][S - 1] = False  # attached but idle on the third chunk
    lat = IMAGE // 16
    states = tuple((torch.zeros((S, lat, lat, cfg.lstm_hidden_dim), device="cuda"),
                    torch.zeros((S, lat, lat, cfg.lstm_hidden_dim), device="cuda"))
                   for _ in range(cfg.lstm_layers))
    got, per_call, idle_kept = [], [], None
    for i in range(EXPORT_CHUNKS):
        before = [(h[S - 1].clone(), c[S - 1].clone()) for h, c in states]
        convlstm.convlstm_recurrence.launches = 0
        scores, states = exported.call(chunks[i], states, torch.as_tensor(masks[i], device="cuda"))
        torch.cuda.synchronize()
        per_call.append(convlstm.convlstm_recurrence.launches)
        got.append(scores.cpu().numpy())
        if i == 2:
            idle_kept = all(torch.equal(h[S - 1], h0) and torch.equal(c[S - 1], c0)
                            for (h, c), (h0, c0) in zip(states, before))
    got = np.stack(got)
    plan = convlstm.recurrence_plan("convlstm_serving", S, T, lat, lat, cfg.lstm_hidden_dim, dtype)

    def direct(**kw):
        model = VideoAutoencoder.from_config(cfg, device="cpu")
        sc = MultiStreamScorer(model, variables, S, T, IMAGE, dtype=dtype, device="cuda", **kw)
        for slot in range(S):
            sc.attach(slot)
        return sc

    scorers = {"fused_input_false": direct(fused_input=False)}
    if dtype == torch.bfloat16:
        scorers["fused_input_default"] = direct()
    bar = EXPORT_F32_BAR if dtype == torch.float32 else BF16_BAR
    cmp = {}
    for label, sc in scorers.items():
        want = np.stack([sc.score_chunk(chunks[i], masks[i]) for i in range(EXPORT_CHUNKS)])
        cmp[label] = {**agree(got, want, bar), "bit_equal": bool(np.array_equal(got, want))}
    # frames/s on device-resident chunks, the scores brought to the host
    n, fps = 10, {}
    ones = torch.ones(S, dtype=torch.bool, device="cuda")
    for label, run in (("artifact", lambda i: exported.call(chunks[i % EXPORT_CHUNKS], states,
                                                            ones)[0].cpu()),
                       ("scorer", lambda i: scorers["fused_input_false"].score_chunk(
                           chunks[i % EXPORT_CHUNKS]))):
        for i in range(2):
            run(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        fps[label] = n * S * T / (time.perf_counter() - t0)
    emit({"artifact": path, "dtype": dtype_name, "load_seconds": load_seconds,
          "graph": graph_counts(exported.program), "launches_per_call": per_call,
          "plan_launches": plan.launches, "layers": cfg.lstm_layers, "idle_slot_kept": idle_kept,
          "bar": bar, "compare": cmp, "frames_per_s": fps, "score_mean": float(got.mean())})
    return 0


def phase_export(card: str, video_ckpt: Path, image: dict, workdir: Path) -> dict:
    """``python -m vad_tpu_torch.export_model`` on ``fit``'s best checkpoint
    (``VideoAEConfig()``, 16 slots x 16 frames, 256x256) in bf16 and in f32,
    each artifact loaded in a fresh process (``artifact_check``): kernel 1's
    operator one node a layer and no unrolled recurrence in the graph, its
    launches per call, the unsubmitted slot's (h, c) bit for bit, the
    scores against direct scorers (bf16: ``fused_input=False`` bit for bit
    or within the bf16 bar, the default scorer within the bf16 bar; f32 at
    rtol 1e-5 / atol 1e-7, JAX's bar), and the artifact's frames/s beside
    the scorer's.  Then the image checkpoint exported in f32 with a
    symbolic batch, scored at batches 1, 7 and 16 against
    ``reconstruction_error`` (TF32 off) at that bar."""
    import numpy as np
    import torch

    from vad_tpu_torch.eval.image_eval import load_image_model
    from vad_tpu_torch.utils.export import load_artifact

    phase_start = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)

    def export(ckpt: Path, out: Path, *flags) -> dict:
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vad_tpu_torch.export_model",
                               "--checkpoint", str(ckpt), "--output", str(out), *flags],
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - start
        require(proc.returncode == 0, f"export_model exits 0: {proc.stderr[-2000:]}")
        sidecar = json.loads(Path(str(out) + ".json").read_text())
        return {"seconds": seconds, "bytes": sidecar["bytes"], "sidecar": sidecar,
                "printed": proc.stdout.strip().splitlines()[-4:]}

    video, launches = {}, 0
    for dtype in ("bfloat16", "float32"):
        out = workdir / f"video_{dtype}.pt2"
        rec = export(video_ckpt, out, "--slots", str(S), "--chunk", str(T), "--dtype", dtype)
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--artifact-check",
                               str(out), str(video_ckpt), dtype],
                              capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"the {dtype} artifact loads and runs in a fresh "
                                      f"process: {proc.stderr[-3000:]}")
        check = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["load"] = check
        video[dtype] = rec
        layers = check["layers"]
        require(check["graph"]["convlstm_recurrence"] == layers and
                check["graph"]["sigmoid"] == 0,
                f"{dtype} artifact: kernel 1's operator one node a layer, no unrolled "
                f"recurrence: {check['graph']}")
        require(all(n == layers * check["plan_launches"] for n in check["launches_per_call"]),
                f"{dtype} artifact launches kernel 1 {layers * check['plan_launches']} times "
                f"a call: {check['launches_per_call']}")
        launches += sum(check["launches_per_call"])
        require(check["idle_slot_kept"], f"{dtype} artifact keeps an unsubmitted slot's (h, c)")
        require(all(c["ok"] for c in check["compare"].values()),
                f"{dtype} artifact vs direct scorers: {check['compare']}")
        require(rec["sidecar"]["platforms"] == ["cuda"] and
                not rec["sidecar"]["uses_shape_polymorphism"], f"{dtype} sidecar: {rec['sidecar']}")

    # the image model, symbolic batch, f32
    out = workdir / "image_float32.pt2"
    img = export(image["ckpt"], out, "--dtype", "float32")
    require(img["sidecar"]["uses_shape_polymorphism"], "the image artifact's batch is symbolic")
    saved_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        exported = load_artifact(out)  # f32: TF32 off for the process
        with contextlib.redirect_stdout(io.StringIO()):
            model, _, _ = load_image_model(image["ckpt"], device="cuda")
        images = torch.from_numpy(image["test_images"]).cuda()
        batches = {}
        for b in (1, 7, 16):
            u8 = images[:b]
            got = exported.call(u8)
            with torch.no_grad():
                want = model.reconstruction_error(u8.float() / 127.5 - 1.0)
            batches[b] = {**agree(got, want, EXPORT_F32_BAR),
                          "bit_equal": bool(torch.equal(got, want))}
            require(tuple(got.shape) == (b,) and batches[b]["ok"],
                    f"image artifact at batch {b} vs reconstruction_error: {batches[b]}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    img["batches"] = batches
    img["graph"] = graph_counts(exported.program)
    emit({"phase": "export", "card": card, "video": video, "image": img,
          "artifact_vs_scorer": {d: r["load"]["frames_per_s"]["artifact"]
                                 / r["load"]["frames_per_s"]["scorer"]
                                 for d, r in video.items()},
          "launches": launches, "seconds": time.perf_counter() - phase_start})
    return {"launches": launches}


def reference_image(latent: int):
    """A module with the reference image autoencoder's names and forward
    (``encoder.enc1..4``, ``decoder.dec1..4``; NCHW in and out)."""
    from torch import nn

    def enc(cin, cout):
        return nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.LeakyReLU(0.2),
            nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.LeakyReLU(0.2),
            nn.MaxPool2d(2, 2))

    def dec(cin, cout):
        return nn.Sequential(
            nn.ConvTranspose2d(cin, cout, 2, stride=2), nn.BatchNorm2d(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU())

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder, self.decoder = nn.Module(), nn.Module()
            for i, (ci, co) in enumerate(((3, 32), (32, 64), (64, 128), (128, latent))):
                setattr(self.encoder, f"enc{i + 1}", enc(ci, co))
            for i, (ci, co) in enumerate(((latent, 128), (128, 64), (64, 32))):
                setattr(self.decoder, f"dec{i + 1}", dec(ci, co))
            self.decoder.dec4 = nn.Sequential(
                nn.ConvTranspose2d(32, 32, 2, stride=2), nn.BatchNorm2d(32), nn.ReLU(),
                nn.Conv2d(32, 3, 3, padding=1), nn.Tanh())

        def forward(self, x):  # NCHW
            for name in ("enc1", "enc2", "enc3", "enc4"):
                x = getattr(self.encoder, name)(x)
            for name in ("dec1", "dec2", "dec3", "dec4"):
                x = getattr(self.decoder, name)(x)
            return x

    return Model()


def reference_video(latent: int, hidden: int, layers: int):
    """A module with the reference video autoencoder's names and forward
    (``encoder.encoder.N``, ``convlstm.cells.K.conv``, ``decoder.decoder.N``;
    its ConvLSTM a plain loop over the fused gate conv; [B, T, C, H, W])."""
    import torch
    from torch import nn

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = nn.Module()
            blocks = []
            for ci, co in ((3, 32), (32, 64), (64, 128), (128, latent)):
                blocks += [nn.Conv2d(ci, co, 3, padding=1), nn.BatchNorm2d(co),
                           nn.LeakyReLU(0.2), nn.MaxPool2d(2, 2)]
            self.encoder.encoder = nn.Sequential(*blocks)
            self.convlstm = nn.Module()
            cells = []
            for i in range(layers):
                cell = nn.Module()
                cell.conv = nn.Conv2d((latent if i == 0 else hidden) + hidden, 4 * hidden, 3,
                                      padding=1)
                cells.append(cell)
            self.convlstm.cells = nn.ModuleList(cells)
            self.decoder = nn.Module()
            self.decoder.decoder = nn.Sequential(
                nn.ConvTranspose2d(hidden, 128, 2, stride=2), nn.BatchNorm2d(128), nn.ReLU(),
                nn.ConvTranspose2d(128, 64, 2, stride=2), nn.BatchNorm2d(64), nn.ReLU(),
                nn.ConvTranspose2d(64, 32, 2, stride=2), nn.BatchNorm2d(32), nn.ReLU(),
                nn.ConvTranspose2d(32, 3, 2, stride=2), nn.Tanh())

        def forward(self, x):  # [B, T, C, H, W]
            b, t, c, h, w = x.shape
            z = self.encoder.encoder(x.reshape(b * t, c, h, w))
            cur = z.reshape(b, t, *z.shape[1:])
            for cell in self.convlstm.cells:
                hs = torch.zeros((b, hidden, *z.shape[2:]), device=x.device)
                cs = torch.zeros_like(hs)
                outs = []
                for ti in range(t):
                    i, f, g, o = torch.split(cell.conv(torch.cat([cur[:, ti], hs], 1)),
                                             hidden, dim=1)
                    cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
                    hs = torch.sigmoid(o) * torch.tanh(cs)
                    outs.append(hs)
                cur = torch.stack(outs, dim=1)
            y = self.decoder.decoder(cur.reshape(b * t, hidden, *z.shape[2:]))
            return y.reshape(b, t, 3, h, w)

    return Model()


def phase_reference_import(card: str, video_ckpt: Path, image: dict, workdir: Path) -> dict:
    """``python -m vad_tpu_torch.utils.torch_import --export`` (in process,
    through ``main``) on ``fit``'s and the image phase's best checkpoints;
    each ``.pth`` loaded with ``strict=True`` into the reference's module
    layout (``reference_video``, ``reference_image``) on the card, whose
    reconstructions and scores must equal the port's at the f32 bar (TF32
    off; the port's recurrence is kernel 1); then re-imported to ``.ckpt``,
    whose weights must equal the original's exactly."""
    import numpy as np
    import torch

    from vad_tpu_torch.eval.image_eval import load_image_model
    from vad_tpu_torch.eval.video_eval import load_video_model
    from vad_tpu_torch.utils import torch_import
    from vad_tpu_torch.utils.checkpoint import load_checkpoint

    phase_start = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    out, launches = {}, 0
    for kind, ckpt in (("video", video_ckpt), ("image", image["ckpt"])):
        pth, back = workdir / f"{kind}.pth", workdir / f"{kind}_roundtrip.ckpt"
        with contextlib.redirect_stdout(io.StringIO()):
            torch_import.main(["--checkpoint", str(ckpt), "--out", str(pth), "--export"])
            torch_import.main(["--checkpoint", str(pth), "--out", str(back)])
            load = load_video_model if kind == "video" else load_image_model
            port, _, args = load(ckpt, device="cuda")
        sd = torch.load(str(pth), map_location="cpu", weights_only=True)["model_state_dict"]
        if kind == "video":
            ref = reference_video(args.get("latent_dim", 128), args.get("lstm_hidden_dim", 128),
                                  args.get("lstm_layers", 2))
        else:
            ref = reference_image(args.get("latent_dim", 256))
        missing = ref.load_state_dict(sd, strict=True)
        ref = ref.cuda().eval()
        shape = (2, T, IMAGE, IMAGE, 3) if kind == "video" else (4, IMAGE, IMAGE, 3)
        u8 = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
        x = u8.float() / 127.5 - 1.0
        with torch.no_grad(), no_tf32():
            zero_counters()
            got = port(x)
            launches += read_counters()["convlstm_serving"] if kind == "video" else 0
            nchw = x.permute(0, 1, 4, 2, 3) if kind == "video" else x.permute(0, 3, 1, 2)
            want = ref(nchw)
            want = want.permute(0, 1, 3, 4, 2) if kind == "video" else want.permute(0, 2, 3, 1)
            axes = (2, 3, 4) if kind == "video" else (1, 2, 3)
            got_s, want_s = ((torch.mean(torch.square(x - r), dim=axes)) for r in (got, want))
        a, b = load_checkpoint(ckpt), load_checkpoint(back)
        leaves = {}

        def walk(p, q, name=""):
            if isinstance(p, dict):
                require(set(p) == set(q), f"round trip keeps the tree at {name}")
                for k in p:
                    walk(p[k], q[k], f"{name}/{k}")
            else:
                leaves[name] = bool(np.array_equal(np.asarray(p), np.asarray(q)))

        walk({"params": a["params"], "batch_stats": a["batch_stats"]},
             {"params": b["params"], "batch_stats": b["batch_stats"]})
        out[kind] = {"strict_load": str(missing), "keys": len(sd),
                     "recon": agree(got, want, F32_BAR), "scores": agree(got_s, want_s, F32_BAR),
                     "roundtrip_leaves": len(leaves),
                     "roundtrip_exact": all(leaves.values()), "pth_bytes": pth.stat().st_size}
        require(out[kind]["recon"]["ok"] and out[kind]["scores"]["ok"],
                f"{kind}: the reference layout scores as the port does: {out[kind]}")
        require(out[kind]["roundtrip_exact"],
                f"{kind}: the round-tripped checkpoint's weights equal the original's: "
                f"{[k for k, v in leaves.items() if not v]}")
    require(launches > 0, "the port's video forward went through kernel 1")
    emit({"phase": "reference_import", "card": card, **out, "launches": launches,
          "seconds": time.perf_counter() - phase_start})
    return {"launches": launches}


def phase_stream_step_fast(card: str) -> dict:
    """``VideoAutoencoder.stream_step_fast`` (the decoder as four folded
    quadtree products) against ``stream_step`` at full width, S=16, T=16,
    256x256, bf16, seeded weights, state threaded over ``CHUNKS`` chunks:
    scores and each layer's carried (h, c) at the bf16 bar, kernel 1's
    launches, and both steps' frames/s (device-resident input, the scores
    brought to the host)."""
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops.decoder_fast import fold_decoder_params
    from vad_tpu_torch.utils.weights import state_dict_to_flax

    phase_start = time.perf_counter()
    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
    folded = fold_decoder_params(state_dict_to_flax(model), torch.bfloat16, "cuda")
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    chunks = torch.randint(0, 256, (CHUNKS, S, T, IMAGE, IMAGE, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    xs = [c.to(torch.bfloat16) / 127.5 - 1.0 for c in chunks]

    def run(fast: bool):
        states, scores = model.zero_state(S, IMAGE, IMAGE), []
        for x in xs:
            if fast:
                _, _, fs, states = model.stream_step_fast(x, states, folded, False)
            else:
                _, _, fs, states = model.stream_step(x, states)
            scores.append(fs.float())
        return torch.stack(scores), states

    with torch.no_grad():
        (fast_scores, fast_states), _, fast_launches = counted(lambda: run(True))
        ref_scores, ref_states = run(False)
        cmp = {"scores": agree(fast_scores, ref_scores)}
        for i, ((h, c), (rh, rc)) in enumerate(zip(fast_states, ref_states)):
            cmp[f"layer{i}_h"], cmp[f"layer{i}_c"] = agree(h, rh), agree(c, rc)
        states = model.zero_state(S, IMAGE, IMAGE)
        steps = {"stream_step": lambda i: model.stream_step(xs[i % CHUNKS], states)[2].cpu(),
                 "stream_step_fast": lambda i: model.stream_step_fast(
                     xs[i % CHUNKS], states, folded, False)[2].cpu()}
        fps = {}
        for _ in range(2):  # in turns: step, fast, step, fast
            for label, step in steps.items():
                for i in range(2):
                    step(i)
                torch.cuda.synchronize()
                n = 10
                start = time.perf_counter()
                for i in range(n):
                    step(i)
                fps.setdefault(label, []).append(n * S * T / (time.perf_counter() - start))
    launches = fast_launches["convlstm_serving"]
    record = {"phase": "stream_step_fast", "card": card, "streams": S, "chunk": T,
              "image": IMAGE, "dtype": "bfloat16", "chunks": CHUNKS, "compare": cmp,
              "launches": launches, "frames_per_s": fps,
              "fast_over_step": [f / s for f, s in zip(fps["stream_step_fast"],
                                                       fps["stream_step"])],
              "seconds": time.perf_counter() - phase_start}
    emit(record)
    require(all(r["ok"] for r in cmp.values()),
            f"stream_step_fast vs stream_step within {BF16_BAR}: {cmp}")
    require(launches == CHUNKS * cfg.lstm_layers, f"stream_step_fast launched kernel 1 once a "
                                                  f"layer a chunk: {launches}")
    return {"launches": launches}


def phase_profiling(card: str, workdir: Path) -> dict:
    """``python -m vad_tpu_torch.train_video`` (in process, through
    ``main``) for 2 epochs at 256x256, B=8, T=16, bf16, on an IPAD set the
    port's ``create_synthetic_video_data`` writes (``PROFILE_VIDEOS``
    training and test videos of ``PROFILE_VIDEO_FRAMES``: 32 training and
    16 test windows at stride 4, as ``phase_train``'s): without flags, with ``--debug-nans``, and with
    ``--tensorboard --profile-dir --debug-nans``.  Checks: the trace of the
    second epoch exists and names kernels 2 and 3, kernels 2 and 3 launched
    in each run, event files under ``<run>/tb/`` where tensorboard imports;
    records each run's seconds and epoch seconds."""
    import importlib.util

    from vad_tpu_torch import train_video
    from vad_tpu_torch.data.synthetic import create_synthetic_video_data

    phase_start = time.perf_counter()
    data = workdir / "ipad"
    create_synthetic_video_data(str(data), "orbit", *PROFILE_VIDEOS, PROFILE_VIDEO_FRAMES, IMAGE)
    base = ["--category", "orbit", "--data-dir", str(data), "--epochs", "2",
            "--image-size", str(IMAGE), "--sequence-length", str(T), "--stride", "4",
            "--batch-size", str(B_TRAIN), "--precision", "bf16", "--num-workers", "2",
            "--seed", str(SEED)]
    trace_dir = workdir / "trace"
    runs = {"plain": [], "debug_nans": ["--debug-nans"],
            "all_flags": ["--tensorboard", "--profile-dir", str(trace_dir), "--debug-nans"]}
    out, launches = {}, {}
    for label, flags in runs.items():
        results = workdir / f"results_{label}"
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _, seconds, counts = counted(lambda: train_video.main(
                base + ["--results-dir", str(results)] + flags))
        run_dir = next(results.iterdir())
        epochs = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
        out[label] = {"seconds": seconds, "launches": counts,
                      "epoch_seconds": [e["epoch_seconds"] for e in epochs
                                        if "epoch_seconds" in e],
                      "run_dir": run_dir}
        require(counts["convlstm_train_forward"] > 0 and counts["convlstm_backward"] > 0,
                f"{label}: trained through kernels 2 and 3: {counts}")
        if label == "all_flags":
            launches = counts
    traces = sorted(trace_dir.glob("*.json"))
    require(bool(traces), f"a trace file under {trace_dir}")
    text = traces[0].read_text()
    names = sorted(set(re.findall(r'"name": "([^"]*(?:recurrence_kernel<true>|'
                                  r'convlstm_step_kernel<[^"]*true>|gate_kernel|loop_kernel|'
                                  r'dw_kernel|gate_all_kernel|finish_kernel)[^"]*)"', text)))
    kernel2 = [n for n in names if "recurrence_kernel" in n or "convlstm_step_kernel" in n]
    kernel3 = [n for n in names if n not in kernel2]
    has_tb = importlib.util.find_spec("tensorboard") is not None
    events = sorted((out["all_flags"]["run_dir"] / "tb").glob("events.out.tfevents.*"))
    for rec in out.values():
        rec["run_dir"] = str(rec["run_dir"])
    plain, nans, flagged = (out[k]["epoch_seconds"][1] for k in runs)
    emit({"phase": "profiling", "card": card, "runs": out, "trace_file": traces[0].name,
          "trace_bytes": len(text), "kernel2_names": kernel2[:4], "kernel3_names": kernel3[:8],
          "tensorboard_installed": has_tb, "event_files": [e.name for e in events],
          "second_epoch_seconds": {"plain": plain, "debug_nans": nans, "all_flags": flagged},
          "debug_nans_over_plain": nans / plain, "all_flags_over_plain": flagged / plain,
          "run_seconds_over_plain": out["all_flags"]["seconds"] / out["plain"]["seconds"],
          "seconds": time.perf_counter() - phase_start})
    require(kernel2 and kernel3, f"the trace names kernels 2 and 3: {names[:12]}")
    require(bool(events) == has_tb, f"event files exactly where tensorboard imports: {events}")
    return {"launches": launches, "data": data}


def phase_ui(card: str, video_ckpt: Path, image: dict, video_data: Path,
             workdir: Path) -> dict:
    """``vad_tpu_torch.ui.logic`` on the card (no gradio there): an
    ``AppState`` loads both checkpoints; ``analyze_image`` on a fixture
    test image, whose score must equal ``reconstruction_error``'s on the
    same resized input (f32, TF32 off); ``analyze_video`` on a
    ``VIDEO_FRAMES``-frame mp4 from ``create_synthetic_video_file`` (the
    intruder over its middle 30%), whose scores must
    equal ``stream_scores``' on the same file (kernel 1 launches); all four
    train and evaluation commands name the port's modules, the video
    evaluation finding ``video_data`` (an IPAD set) as ./data/IPAD."""
    import numpy as np
    import torch
    from PIL import Image

    from vad_tpu_torch.data.synthetic import create_synthetic_video_file
    from vad_tpu_torch.eval.video_render import stream_scores
    from vad_tpu_torch.ui import logic

    phase_start = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        state = logic.AppState("cuda")
        loaded = (state.load_image_model(str(image["ckpt"])),
                  state.load_video_model(str(video_ckpt)))
    require(all("loaded successfully" in s and "PyTorch/CUDA" in s for s in loaded),
            f"both checkpoints load: {loaded}")
    fixture = image["test_images"][0]
    recon, heat, report = logic.analyze_image(state, fixture)
    _, _, score = logic.score_image(state, fixture)
    size = int(state.model_args.get("image_size", IMAGE))
    resized = np.asarray(Image.fromarray(fixture).resize((size, size), Image.BILINEAR),
                         np.float32)
    with torch.no_grad(), no_tf32():
        want = float(state.model.reconstruction_error(
            torch.from_numpy(resized[None] / 127.5 - 1.0).cuda())[0])
    image_cmp = {"score": score, "reconstruction_error": want, "equal": score == want,
                 "in_report": f"{score:.6f}" in report, "heatmap": heat is not None}
    require(recon.shape == (size, size, 3) and image_cmp["in_report"]
            and math.isclose(score, want, rel_tol=F32_BAR["rtol"], abs_tol=F32_BAR["atol"]),
            f"analyze_image scores as reconstruction_error: {image_cmp}")

    clip = workdir / "orbit.mp4"
    create_synthetic_video_file(str(clip), VIDEO_FRAMES, IMAGE, 25.0,
                                (int(VIDEO_FRAMES * 0.4), int(VIDEO_FRAMES * 0.7)), SEED + 16)
    (timeline, vreport), seconds, counts = counted(lambda: logic.analyze_video(state, str(clip)))
    got = logic.video_scores(state, str(clip))
    ref = stream_scores(state.video_model, None, str(clip), IMAGE,
                        chunk=int(state.video_args.get("sequence_length", T)))
    video_cmp = {"frames": len(got), "equal": bool(np.array_equal(got, ref)),
                 "max_abs_err": float(np.abs(got - ref).max()),
                 "in_report": f"Total Frames Analyzed: {len(ref)}" in vreport,
                 "timeline": timeline is not None}
    require(len(got) == VIDEO_FRAMES and video_cmp["equal"] and video_cmp["in_report"],
            f"analyze_video scores as stream_scores: {video_cmp}")
    launches = counts["convlstm_serving"]
    require(launches > 0, f"analyze_video went through kernel 1: {counts}")
    # The evaluation commands find their data as the app does when run from
    # a repository root: the image run's stored data dir, and ./data/IPAD for
    # the video run (fit's checkpoint stores the default ./data, which holds
    # no orbit set), here the profiling phase's IPAD set.
    (workdir / "data").mkdir(exist_ok=True)
    (workdir / "data" / "IPAD").symlink_to(video_data.resolve(), target_is_directory=True)
    with contextlib.chdir(workdir):
        commands = {
            "train": logic.build_train_command("c", 1, 2, 1e-3, "mse", "d"),
            "train_video": logic.build_video_train_command("c", 1, 2, 1e-4, "d"),
            "evaluate": logic.build_eval_command(str(image["ckpt"])),
            "evaluate_video": logic.build_eval_command(str(video_ckpt))}
    named = {k: f"vad_tpu_torch.{k}" in (cmd or []) for k, cmd in commands.items()}
    require(all(named.values()), f"all four commands name the port's modules: {commands}")
    emit({"phase": "ui", "card": card, "image": image_cmp, "video": video_cmp,
          "analyze_video_seconds": seconds, "launches": launches, "commands_named": named,
          "seconds": time.perf_counter() - phase_start})
    return {"launches": launches}


# ------------------------------------------------------------- accuracy


def accuracy_data(name: str, data_dir: Path) -> Path:
    """``python -m vad_tpu_torch.data.synthetic --method <method> --category
    <category>`` at its default sizes (in process, once per ``data_dir``)."""
    from vad_tpu_torch.data import synthetic

    fx = ACCURACY_FIXTURES[name]
    if not (data_dir / fx["category"]).exists():
        with contextlib.redirect_stdout(io.StringIO()):
            synthetic.main(["--method", fx["method"], "--data-dir", str(data_dir),
                            "--category", fx["category"]])
    return data_dir


def jax_cell(cell) -> str | None:
    return None if cell is None else f"{cell[0]:.4f} ± {cell[1]:.4f} (n={cell[2]})"


def spread(values: list) -> dict:
    """mean ± half-range over draws, as the JAX package's table gives them."""
    mean, half = sum(values) / len(values), (max(values) - min(values)) / 2
    return {"mean": mean, "half_range": half, "n": len(values),
            "cell": f"{mean:.4f} ± {half:.4f} (n={len(values)})"}


def accuracy_draw(name: str, draw: int, precision: str, data_dir: Path, workdir: Path,
                  card: str) -> dict:
    """One draw of a fixture through the port's CLIs in process: ``python -m
    vad_tpu_torch.train_video`` (or ``... train``) at run_parity's budget
    with ``--seed draw --precision <precision>``, then ``python -m
    vad_tpu_torch.evaluate_video`` (or ``... evaluate``) on its
    ``best_model.ckpt``; the AUROCs from the evaluation's ``results.txt``.
    Emits an ``accuracy_draw`` line."""
    from vad_tpu_torch import evaluate, evaluate_video, train_video
    from vad_tpu_torch.train import __main__ as train_image

    fx = ACCURACY_FIXTURES[name]
    video = fx["kind"] == "video"
    argv = ["--category", fx["category"], *fx["flags"], "--seed", str(draw), "--precision",
            precision, "--data-dir", str(data_dir),
            "--results-dir", str(workdir / f"{name}_{precision}_{draw}")]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, train_seconds, train_launches = counted(
            lambda: (train_video.main if video else train_image.main)(argv))
    run_dir = Path(re.search(r"Models saved to: (\S+)", log.getvalue()).group(1))
    ckpt = run_dir / "best_model.ckpt"
    with contextlib.redirect_stdout(io.StringIO()):
        _, eval_seconds, eval_launches = counted(
            lambda: (evaluate_video.main if video else evaluate.main)(
                ["--checkpoint", str(ckpt), "--data-dir", str(data_dir)]))
    text = (run_dir / "evaluation" / "results.txt").read_text()

    def metric(pattern: str):
        m = re.search(pattern, text)
        return float(m.group(1)) if m else None

    record = {"phase": "accuracy_draw", "fixture": name, "draw": draw, "precision": precision,
              "card": card}
    if video:
        record.update(auroc=metric(r"Sequence-level AUROC: ([0-9.]+)"),
                      frame_auroc=metric(r"Frame-level AUROC: ([0-9.]+)"))
    else:
        record.update(auroc=metric(r"(?m)^AUROC: ([0-9.]+)"),
                      pixel_auroc=metric(r"Pixel-level AUROC: ([0-9.]+)"))
    epochs = [ln for ln in log.getvalue().splitlines() if ln.startswith("Epoch")]
    record.update(train_seconds=train_seconds, eval_seconds=eval_seconds, epochs_run=len(epochs),
                  train_launches=train_launches, eval_launches=eval_launches,
                  log_tail=log.getvalue().splitlines()[-3:])
    emit(record)
    require(record["auroc"] is not None, f"{name} draw {draw}: an AUROC in {text[:300]!r}")
    if video:
        require(train_launches["convlstm_train_forward"] > 0
                and train_launches["convlstm_backward"] > 0
                and eval_launches["convlstm_serving"] > 0,
                f"{name}: trained through kernels 2 and 3, evaluated through kernel 1: "
                f"{train_launches}, {eval_launches}")
    return {**record, "checkpoint": ckpt}


def phase_accuracy(card: str, workdir: Path) -> dict:
    """One draw of run_parity's ``video_synthetic`` on the card, f32: the
    fixture from the port's generator, ``train_video`` (15 epochs, 128x128,
    T=8, B=4, stepwise_tc kernels 2 and 3, kernel 1 in its eval step),
    ``evaluate_video`` in dataset mode (kernel 1), then ``--video-dir`` over
    ``ACCURACY_CLIPS`` mp4s from ``create_synthetic_video_file`` (kernels 4
    and 1), half with the intruder.  Its ``accuracy`` line has both AUROCs
    beside JAX's recorded ones, the training seconds and the mean
    ``--video-dir`` frame score inside and outside the intruder's ranges.
    Fails when the sequence AUROC is below ``ACCURACY_GATE``."""
    import numpy as np

    from vad_tpu_torch import evaluate_video
    from vad_tpu_torch.data.synthetic import create_synthetic_video_file
    from vad_tpu_torch.eval import batch_score

    phase_start = time.perf_counter()
    name = "video_synthetic"
    draw = accuracy_draw(name, 0, "f32", accuracy_data(name, workdir / "data"), workdir, card)
    clips = workdir / "clips"
    clips.mkdir()
    ranges = {}
    for k in range(ACCURACY_CLIPS):
        span = ACCURACY_RANGE if k < ACCURACY_CLIPS // 2 else None
        path = create_synthetic_video_file(str(clips / f"clip{k}.mp4"), ACCURACY_CLIP_FRAMES,
                                           seed=SEED + 20 + k, anomaly_range=span)
        ranges[path] = span
    scored = {}
    real = batch_score.score_videos

    def keep(*args, **kwargs):  # the per-frame scores behind batch_scores.json
        out = real(*args, **kwargs)
        scored.update(out)
        return out

    batch_score.score_videos = keep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, dir_seconds, dir_launches = counted(lambda: evaluate_video.main(
                ["--checkpoint", str(draw["checkpoint"]), "--video-dir", str(clips)]))
    finally:
        batch_score.score_videos = real
    summary = json.loads((draw["checkpoint"].parent / "batch_scoring" /
                          "batch_scores.json").read_text())
    inside, outside = [], []
    for path, span in ranges.items():
        s = np.asarray(scored[path]["scores"], np.float64)
        require(scored[path]["error"] is None and len(s) == ACCURACY_CLIP_FRAMES
                and bool(np.isfinite(s).all()), f"{path}: every frame scored, finite")
        mask = np.zeros(len(s), bool)
        if span is not None:
            mask[span[0]:span[1]] = True
        inside.append(s[mask])
        outside.append(s[~mask])
    inside, outside = np.concatenate(inside), np.concatenate(outside)
    fx = ACCURACY_FIXTURES[name]
    launches = {k: draw["train_launches"][k] + draw["eval_launches"][k] + dir_launches[k]
                for k in dir_launches}
    emit({"phase": "accuracy", "card": card, "fixture": name, "draw": 0, "precision": "f32",
          "sequence_auroc": draw["auroc"], "frame_auroc": draw["frame_auroc"],
          "jax_sequence_auroc": jax_cell(fx["jax"]), "jax_frame_auroc": jax_cell(fx["jax_frame"]),
          "gate": ACCURACY_GATE, "train_seconds": draw["train_seconds"],
          "eval_seconds": draw["eval_seconds"], "video_dir_seconds": dir_seconds,
          "video_dir": {"clips": ACCURACY_CLIPS, "frames": ACCURACY_CLIP_FRAMES,
                        "range": ACCURACY_RANGE,
                        "mean_score_inside_ranges": float(inside.mean()),
                        "mean_score_outside_ranges": float(outside.mean()),
                        "inside_over_outside": float(inside.mean() / outside.mean()),
                        "clip_means": [v["mean_score"] for v in summary["videos"].values()],
                        "launches": dir_launches},
          "launches": launches, "seconds": time.perf_counter() - phase_start})
    require(dir_launches["first_block"] > 0 and dir_launches["convlstm_serving"] > 0,
            f"--video-dir went through kernels 4 and 1: {dir_launches}")
    require(all(launches[k] > 0 for k in launches), f"the phase launched kernels 1-4: {launches}")
    require(draw["auroc"] >= ACCURACY_GATE,
            f"video_synthetic sequence AUROC {draw['auroc']} >= {ACCURACY_GATE}")
    return {"launches": launches}


def accuracy_main(argv: list) -> int:
    """``python3 chip_smoke.py --accuracy [--only NAME] [--draws N]
    [--precision f32|bf16]``: run_parity's protocol with the port on the
    card.  Each fixture (data from the port's generator, written once) is
    trained and evaluated ``--draws`` times with ``--seed`` 0..N-1; one
    ``accuracy_draw`` line a draw and one ``accuracy_fixture`` line a
    fixture, mean ± half-range beside JAX's recorded cell."""
    import argparse

    import torch

    parser = argparse.ArgumentParser(prog="chip_smoke.py --accuracy")
    parser.add_argument("--only", choices=sorted(ACCURACY_FIXTURES), action="append")
    parser.add_argument("--draws", type=int, default=3)
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32")
    args = parser.parse_args(argv)
    name, _, _, _, card = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        for fixture in args.only or list(ACCURACY_FIXTURES):
            data = accuracy_data(fixture, Path(tmp) / "data")
            draws = [accuracy_draw(fixture, d, args.precision, data, Path(tmp), card)
                     for d in range(args.draws)]
            fx = ACCURACY_FIXTURES[fixture]
            record = {"phase": "accuracy_fixture", "fixture": fixture, "kind": fx["kind"],
                      "precision": args.precision, "card": card,
                      "auroc": spread([d["auroc"] for d in draws]), "jax": jax_cell(fx["jax"]),
                      "train_seconds": spread([d["train_seconds"] for d in draws])}
            if fx["kind"] == "video":
                frame = [d["frame_auroc"] for d in draws if d["frame_auroc"] is not None]
                record.update(frame_auroc=spread(frame) if frame else None,
                              jax_frame=jax_cell(fx["jax_frame"]))
            emit(record)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------- scaling

# The scaling phase: the train steps each 2-rank case takes (the gradients
# compared after the first), the learning rate (the video trainer's
# default), the cases (mesh model axis, precision), the two-replica
# scorer's chunks, and the rank processes' time limit.
SCALING_STEPS, SCALING_LR = 2, 1e-4
SCALING_CASES = (("dp", 1, "f32"), ("dp", 1, "bf16"), ("tp", 2, "f32"), ("tp", 2, "bf16"))
SCALING_CHUNKS, SCALING_TIMEOUT, SCALING_EPOCHS = 3, 400.0, 8
SCALING_WD = 1e-5  # Adam's coupled weight decay


def scaling_batches():
    """The global batches every rank and the control draw (u8, host)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    return [rng.integers(0, 256, (B_TRAIN, T, IMAGE, IMAGE, 3), dtype=np.uint8)
            for _ in range(SCALING_STEPS)]


def scaling_run(mesh, precision: str) -> dict:
    """``SCALING_STEPS`` train steps of the full-width video model (from
    ``init_weights(SEED)``, Adam at ``SCALING_LR``) on ``mesh``: this rank's
    rows of each global batch, or all of them on a one-process mesh.
    Returns the losses, each step's full gradients and the full weights and
    running statistics after it (CPU f32), the kernels' launches and the
    wall ms of the last step."""
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.parallel.multihost import owned_batch_positions
    from vad_tpu_torch.parallel.sharding import _gather_full, distribute, gathered
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED).to("cuda")
    optimizer = make_optimizer(model.parameters(), SCALING_LR, weight_decay=SCALING_WD)
    shardings = distribute(model, mesh, optimizer)
    step = make_train_step(mse_per_sample, torch.bfloat16 if precision == "bf16" else None,
                           mesh=mesh)
    rows = owned_batch_positions(mesh, B_TRAIN)

    def full_state():
        with gathered(model, None, mesh):
            return {n: v.detach().float().cpu().clone() for n, v in model.state_dict().items()}

    out = {"losses": [], "grads": [], "states": [], "sliced": sorted(shardings)}
    zero_counters()
    with no_tf32():
        for batch in scaling_batches():
            u8 = torch.from_numpy(batch[rows]).to("cuda")
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = step(model, optimizer, u8, B_TRAIN)
            out["losses"].append(float(loss))
            out["step_ms"] = (time.perf_counter() - start) * 1e3
            out["grads"].append({n: (_gather_full(p.grad, shardings[n], mesh)
                                     if n in shardings else p.grad).float().cpu().clone()
                                 for n, p in model.named_parameters()})
            out["states"].append(full_state())
    out["launches"] = read_counters()
    return out


def scaling_worker(rank: str, world: str, workdir: str) -> int:
    """One rank of the phase's 2-process run (``python3 chip_smoke.py
    --scaling-worker RANK WORLD DIR``): every case of ``SCALING_CASES`` on
    a gloo group over a FileStore in DIR, on ``cuda:0``; writes its
    results to DIR/rank<RANK>.pt."""
    import torch
    import torch.distributed as dist

    from vad_tpu_torch.parallel.sharding import get_mesh, init_distributed

    device = init_distributed("cuda", init_method=f"file://{workdir}/store", rank=int(rank),
                              world_size=int(world))
    require(device == torch.device("cuda", 0) and dist.get_backend() == "gloo",
            f"two ranks on the one card over gloo: {device}, {dist.get_backend()}")
    results = {}
    for name, mp, precision in SCALING_CASES:
        mesh = get_mesh(model_parallel=mp)
        results[f"{name}-{precision}"] = {**scaling_run(mesh, precision), "mesh": mesh.shape}
    torch.save(results, Path(workdir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn(commands: list, logs: list, timeout: float, env=None) -> float:
    """Run ``commands`` at once (one process each, output to ``logs``);
    every process is stopped at ``timeout``.  Fails unless all exit 0;
    returns the wall seconds."""
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env)
             for cmd, log in zip(commands, logs)]
    try:
        rcs = [p.wait(timeout=max(1.0, timeout - (time.perf_counter() - start)))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rcs == [0] * len(procs), f"processes exit 0 within {timeout} s: {rcs}; "
            + " | ".join(Path(log).read_text()[-1500:] for log in logs))
    return time.perf_counter() - start


def scaling_anchor() -> dict:
    """The first step's effective gradients (the gradient plus Adam's
    coupled weight decay) of the 1-process program in float64 on the card
    (from ``init_weights(SEED)``, the first global batch; the plain
    versions: the kernels take f32 and bf16), by parameter name."""
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.steps import make_train_step

    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED).to("cuda")
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)  # leaves .grad
    u8 = torch.from_numpy(scaling_batches()[0]).to("cuda")
    with plain_versions():
        make_train_step(mse_per_sample, torch.float64)(model, optimizer, u8, B_TRAIN)
    return {n: (p.grad + SCALING_WD * p.detach()).double().cpu()
            for n, p in model.named_parameters()}


def judge_scaling(case: str, ranks: list, control: dict, anchor: dict, init: dict,
                  skip: set) -> dict:
    """A 2-rank case against the 1-process control (``phase_scaling``'s
    docstring): the losses, the ranks' agreement and launches here, the
    gradients, weights, updates and running statistics by
    ``multiprocess_check.judge_training``; ``anchor`` is
    ``scaling_anchor``'s effective gradients and ``init`` the weights
    before the first step.  Returns the summary its line carries."""
    import torch

    from vad_tpu_torch.parallel.multiprocess_check import judge_training

    f32 = case.endswith("f32")
    r0, r1 = ranks
    rec = {"mesh": r0["mesh"], "sliced": r0["sliced"], "losses": r0["losses"],
           "control_losses": control["losses"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "control_step_ms": control["step_ms"]}
    rec["loss"] = [agree(torch.tensor(a), torch.tensor(b), F32_BAR if f32 else BF16_BAR)
                   for a, b in zip(r0["losses"], control["losses"])]
    # the ranks hold the same weights and running statistics, bit for bit
    rec["ranks_equal"] = all(torch.equal(a[n], b[n]) for a, b in zip(r0["states"], r1["states"])
                             for n in a)

    def run(r):  # the first step's effective gradient: Adam's input
        return {"grad": {n: g.double() + SCALING_WD * init[n].double()
                         for n, g in r["grads"][0].items()}, "states": r["states"]}

    rec.update(judge_training(run(r0), run(control), anchor, init, skip, f32=f32))
    rec["ok"] = (all(r["ok"] for r in rec["loss"]) and rec["ranks_equal"] and rec["ok"]
                 and all(r["launches"]["convlstm_train_forward"] > 0
                         and r["launches"]["convlstm_backward"] > 0 for r in ranks))
    return rec


def phase_scaling(card: str, video_data: Path, workdir: Path) -> dict:
    """Scaling (``vad_tpu_torch/parallel/``) on the one card; overhead and
    correctness, not scaling numbers (every rank shares the card).

    - Two processes on ``cuda:0`` joined by gloo, each launching kernels 2
      and 3: video train steps of the default model (B=8 global, 4 rows a
      rank under dp; all 8 on both under tp, the model group spanning the
      two processes), f32 (TF32 off) and bf16, against one process taking
      the same steps on the global batch.  Losses at the bar of their
      precision.  The gradients, weights, updates and running statistics
      by ``multiprocess_check.judge_training`` (its docstring), the rule
      that check applies to its own runs: in f32 the first step's
      gradients against the control's or, no less exact than the
      control, against a float64 step on the card (``scaling_anchor``),
      the weights after it at ``F32_BAR`` but where the control's own f32
      error reaches the exact effective gradient, and every step's update
      of each weight against the control's update; in bf16 the updates
      and the last state whole.  The conv biases that feed a train-mode
      BatchNorm (exact gradient 0: Adam turns their noise into lr-sized
      steps) are left out, with the running means they shift; both
      ranks' weights and running statistics are equal bit for bit after
      every step.
    - ``python -m vad_tpu_torch.parallel.multiprocess_check --device cuda``
      in both forms: the image model data-parallel over the two processes
      and (``--model-parallel 2``) the video model's gate weights split
      over them (its own checks: losses against the 1-process control,
      rank 0's checkpoint reloaded by both ranks, the checkpoints after
      the first and the last step against the control's by
      ``judge_training``, each run's gradients against a float64 step
      through the kinks its own first step took).
    - ``MultiStreamScorer`` with two replicas on ``cuda:0`` (S=16, T=16,
      bf16, 8 slots each, kernels 1 and 4 in each) against the unsplit
      scorer: scores and every layer's (h, c) at the bf16 bar.
    - ``python -m vad_tpu_torch.train_video --model-parallel 1`` under
      torchrun's environment at WORLD_SIZE=1 (NCCL), between two runs of
      the same command without it (``SCALING_EPOCHS``, bf16,
      ``phase_profiling``'s orbit set): the distributed path's overhead in
      training frames per second of epochs 2 onward (each epoch's
      evaluation pass included)."""
    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.parallel.multiprocess_check import (
        BF16_REL_L2,
        GRADIENT_NOISE,
        UPDATE_REL_L2,
        launch,
        zero_gradient_biases,
    )
    from vad_tpu_torch.parallel.sharding import get_mesh

    phase_start = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    here = str(Path(__file__).resolve())
    init = init_weights(VideoAutoencoder.from_config(VideoAEConfig(image_size=IMAGE,
                                                                   sequence_length=T),
                                                     device="cpu"), SEED)
    skip = set(zero_gradient_biases(init))
    init = {n: v.detach().float() for n, v in init.named_parameters()}
    # the 1-process control, then the two ranks (the kernels are built: the
    # ranks load them from the build directory)
    controls = {}
    for name, _, precision in SCALING_CASES:
        if precision not in controls:
            controls[precision] = scaling_run(get_mesh(["cuda:0"]), precision)
    anchor = scaling_anchor()
    torch.cuda.empty_cache()
    ranks_seconds = spawn([[sys.executable, here, "--scaling-worker", str(r), "2",
                            str(workdir)] for r in range(2)],
                          [workdir / f"rank{r}.log" for r in range(2)], SCALING_TIMEOUT)
    ranks = [torch.load(workdir / f"rank{r}.pt") for r in range(2)]
    cases = {case: judge_scaling(case, [r[case] for r in ranks],
                                 controls[case.split("-")[1]], anchor, init, skip)
             for case in ranks[0]}
    launches = {k: [sum(c["launches_per_rank"][r][k] for c in cases.values()) for r in range(2)]
                for k in ("convlstm_train_forward", "convlstm_backward")}
    emit({"phase": "scaling_steps", "card": card, "seconds": ranks_seconds, "cases": cases,
          "bars": {"f32": F32_BAR, "bf16": BF16_BAR, "bf16_rel_l2": BF16_REL_L2,
                   "update_rel_l2": UPDATE_REL_L2, "gradient_noise": GRADIENT_NOISE},
          "left_out": sorted(skip)})

    checks = {}
    for mp in (1, 2):  # the image model data-parallel, the video model's gates split
        start = time.perf_counter()
        log = io.StringIO()
        try:  # the record is printed either way; the failure is required below
            with contextlib.redirect_stdout(log):
                launch(processes=2, steps=2, out_dir=str(workdir / f"mpc{mp}"),
                       timeout=SCALING_TIMEOUT, model_parallel=mp, device="cuda")
        except AssertionError:
            pass
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith('{"processes"')]
        rec = json.loads(lines[-1]) if lines else {"ok": False, "log": log.getvalue()[-2000:]}
        checks[f"model_parallel_{mp}"] = {**rec, "seconds": time.perf_counter() - start}
        emit({"phase": "scaling_multiprocess_check", "card": card,
              **checks[f"model_parallel_{mp}"]})

    # two scorer replicas on the one card against the unsplit scorer
    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    base = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
    mesh = get_mesh(["cuda:0", "cuda:0"])
    split = MultiStreamScorer(copy.deepcopy(base), num_slots=S, chunk=T, image_size=IMAGE,
                              dtype=torch.bfloat16, device="cuda", mesh=mesh)
    whole = MultiStreamScorer(copy.deepcopy(base), num_slots=S, chunk=T, image_size=IMAGE,
                              dtype=torch.bfloat16, device="cuda")
    for s in (split, whole):
        for slot in range(S):
            s.attach(slot)
    rng = np.random.default_rng(SEED + 13)
    chunks = [rng.integers(0, 256, (S, T, IMAGE, IMAGE, 3), dtype=np.uint8)
              for _ in range(SCALING_CHUNKS)]
    scores, counts = [], {}
    for label, scorer in (("split", split), ("whole", whole)):
        out, seconds, counts[label] = counted(lambda: [scorer.score_chunk(c) for c in chunks])
        scores.append(np.stack(out))
    score_cmp = agree(torch.from_numpy(scores[0]), torch.from_numpy(scores[1]))
    state_cmp = [{"h": agree(h, wh), "c": agree(c, wc)}
                 for (h, c), (wh, wc) in zip(split.states, whole.states)]
    per_replica = {k: counts["whole"][k] for k in ("convlstm_serving", "first_block")}

    # the trainer's distributed path at WORLD_SIZE=1 over NCCL, beside the plain trainer
    argv = [sys.executable, "-m", "vad_tpu_torch.train_video", "--category", "orbit",
            "--data-dir", str(video_data), "--epochs", str(SCALING_EPOCHS),
            "--image-size", str(IMAGE),
            "--sequence-length", str(T), "--stride", "4", "--batch-size", str(B_TRAIN),
            "--precision", "bf16", "--num-workers", "2", "--seed", str(SEED),
            "--model-parallel", "1"]
    env_plain = {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env_plain["PYTHONPATH"] = str(Path(here).parent)
    trainers = {}
    nccl = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1"}
    for label, extra in (("plain", {}), ("nccl_world_size_1", nccl), ("plain_again", {})):
        if extra:
            extra = {**extra, "MASTER_PORT": str(free_port())}
        results = workdir / f"train_{label}"
        log = workdir / f"train_{label}.log"
        seconds = spawn([argv + ["--results-dir", str(results)]], [log], SCALING_TIMEOUT,
                        env={**env_plain, **extra})
        run_dir = next(results.iterdir())
        epochs = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()
                  if "epoch_seconds" in ln]
        text = log.read_text()
        windows = int(re.search(r"Training sequences: (\d+)", text).group(1))
        later = [e["epoch_seconds"] for e in epochs[1:]]  # the first builds and warms up
        trainers[label] = {"seconds": seconds, "epoch_seconds": [e["epoch_seconds"]
                                                                 for e in epochs],
                           "backend_line": next((ln for ln in text.splitlines()
                                                 if ln.startswith("Process group:")), None),
                           "epoch_frames_per_s": windows * T * len(later) / sum(later)}
    fps = {k: v["epoch_frames_per_s"] for k, v in trainers.items()}
    emit({"phase": "scaling", "card": card,
          "note": "one card shared by every rank and replica: overhead and correctness, "
                  "not scaling",
          "steps_ok": {k: c["ok"] for k, c in cases.items()},
          "step_ms": {k: {"ranks": c["step_ms_per_rank"], "control": c["control_step_ms"]}
                      for k, c in cases.items()},
          "multiprocess_check_ok": {k: c["ok"] for k, c in checks.items()},
          "scorer_two_replicas": {"scores": score_cmp, "states": state_cmp,
                                  "launches": counts, "unsplit_launches": per_replica},
          "trainer": trainers, "nccl_over_plain_frames_per_s":
              2 * fps["nccl_world_size_1"] / (fps["plain"] + fps["plain_again"]),
          "seconds": time.perf_counter() - phase_start})
    require(all(c["ok"] for c in cases.values()),
            f"2-rank dp/tp steps against the 1-process control: "
            f"{ {k: (c['failed'][:6], c['loss']) for k, c in cases.items() if not c['ok']} }")
    require(all(c["ok"] for c in checks.values()),
            f"multiprocess_check on the card: { {k: c.get('failed') for k, c in checks.items()} }")
    require(score_cmp["ok"] and all(s["h"]["ok"] and s["c"]["ok"] for s in state_cmp),
            "two scorer replicas against the unsplit scorer at the bf16 bar")
    require(all(counts["split"][k] == 2 * counts["whole"][k] > 0
                for k in ("convlstm_serving", "first_block")),
            f"each replica launched kernels 1 and 4 as the unsplit scorer does: {counts}")
    require(trainers["nccl_world_size_1"]["backend_line"] is not None
            and "nccl" in trainers["nccl_world_size_1"]["backend_line"],
            f"the WORLD_SIZE=1 trainer joined an NCCL group: {trainers}")
    return {"launches": launches, "scorer_launches": counts["split"]}


# ------------------------------------------------------- spatial row split

# Kernel 1's row form at (B, T, latent rows = columns, C, shards): the
# serving shape split in 2 and in 16 (one latent row a shard), and a 32x32
# latent (512x512 frames) split in 2.  The scorer check: S streams, each
# size's frames, 3 chunks of carried state; JAX's bars for its split
# against its unsplit scorer (tests/test_serving.py:300-330).
SPATIAL_KERNEL_SHAPES = ((16, 16, 16, 128, 2), (16, 16, 16, 128, 16), (16, 16, 32, 128, 2))
SPATIAL_S, SPATIAL_CHUNKS, SPATIAL_SIZES, SPATIAL_TIMED = 4, 3, (256, 512), 3
SPLIT_SCORES, SPLIT_MAPS = dict(rtol=2e-5, atol=1e-7), dict(rtol=2e-4, atol=1e-6)


def check_rows_kernel(shape, label: str, peak_flops: float, peak_bw: float,
                      f32_flops: float, design: str) -> dict:
    """Kernel 1's row form at ``shape`` in ``design`` (stepwise_tc, the
    plan's choice, or stepwise forced) against its plain version and the
    concatenated result against the unsplit kernel 1; the staged form (a
    stream a shard: every neighbour row copied behind an event) must equal
    the in-place form bit for bit.  Times the call and bounds it."""
    import dataclasses

    import torch

    from vad_tpu_torch.ops import convlstm as cl

    b, t, lat, c, n = shape
    dtype = torch.bfloat16 if label == "bf16" else torch.float32
    bar = BF16_BAR if label == "bf16" else F32_BAR
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    gx = (torch.randn((b, t, lat, lat, 4 * c), generator=g, device="cuda") * 0.5).to(dtype)
    wh = (torch.randn((3, 3, c, 4 * c), generator=g, device="cuda") * 0.05).to(dtype)
    h0 = torch.randn((b, lat, lat, c), generator=g, device="cuda") * 0.1
    c0 = torch.randn((b, lat, lat, c), generator=g, device="cuda") * 0.1
    rows = lat // n
    args = ([x.contiguous() for x in gx.split(rows, 2)], wh,
            [x.contiguous() for x in h0.split(rows, 1)], [x.contiguous() for x in c0.split(rows, 1)])

    def joined(seqs, finals):
        return (torch.cat(seqs, 2), torch.cat([f[0] for f in finals], 1),
                torch.cat([f[1] for f in finals], 1))

    with no_tf32():
        cl.convlstm_recurrence.launches = 0
        got = joined(*cl.convlstm_recurrence_rows(*args, design=design))
        per_call = cl.convlstm_recurrence.launches
        staged = joined(*cl.convlstm_recurrence_rows(*args, staged=True, design=design))
        plain = joined(*cl.convlstm_recurrence_rows_ref(*args))
        whole_seq, whole_final = cl.convlstm_recurrence(gx, wh, h0, c0)
        torch.cuda.synchronize()
        ms = time_ms(lambda: cl.convlstm_recurrence_rows(*args, design=design))
        plain_ms = time_ms(lambda: cl.convlstm_recurrence_rows_ref(*args), iters=3, warmup=1)
    vs_plain = [close(a, r, bar) for a, r in zip(got, plain)]
    vs_whole = [close(a, r, bar) for a, r in zip(got, (whole_seq, *whole_final))]
    plan = cl.recurrence_plan("convlstm_serving", b, t, lat, lat, c, dtype, design, shards=n)
    hw, e = lat * lat, gx.element_size()
    flops = 2 * b * t * hw * 9 * c * 4 * c
    nbytes = (b * t * hw * 4 * c * e + b * t * hw * c * e  # gates_x in, h_seq out
              + 4 * b * hw * c * 4 + 9 * c * 4 * c * e)  # h0, c0, h_T, c_T, Wh
    rec = {"shape": list(shape[:3]) + [lat, c], "shards": n, "dtype": label, "design": design,
           "launches_per_call": per_call, "plan": dataclasses.asdict(plan),
           "max_abs_err": max(x[0] for x in vs_plain),
           "max_abs_err_vs_unsplit": max(x[0] for x in vs_whole),
           "staged_equal": all(torch.equal(a, s) for a, s in zip(got, staged)),
           "bar": bar, "ms": ms, "plain_ms": plain_ms,
           **recurrence_bound(label, flops, nbytes, peak_flops, peak_bw, f32_flops),
           "tflops": flops / ms / 1e9}
    bounded(rec, f"the row form {label} {design} at {n} shards")
    rec["ok"] = (all(x[1] for x in vs_plain + vs_whole) and rec["staged_equal"]
                 and per_call == plan.launches == t * n)
    return rec


def video_scorer(ckpt: dict, size: int, dtype, slots: int, mesh=None, return_maps=True):
    """A scorer of the checkpoint's variables at ``size``, every slot
    attached, ``fused_input`` off (JAX's default; the split has no kernel
    4), split over ``mesh``'s rows when one is given."""
    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

    sc = MultiStreamScorer(VideoAutoencoder.from_config(VideoAEConfig.from_args(ckpt["args"]),
                                                        device="cpu"),
                           {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
                           slots, T, size, return_maps=return_maps, dtype=dtype,
                           fused_input=False,
                           device="cuda", mesh=mesh, spatial=mesh is not None)
    for slot in range(slots):
        sc.attach(slot)
    return sc


def check_spatial_scorer(ckpt: dict, size: int, label: str, model_parallel: int,
                         timed: bool) -> dict:
    """The split scorer against the unsplit one over ``SPATIAL_CHUNKS``
    chunks of carried state: scores and maps each chunk, every layer's
    (h, c) after; f32 (TF32 off) at JAX's split bars and the f32 bar for
    (h, c), bf16 at the bf16 bar with rel L2.  The split path's launches
    are counted (kernel 1's row form: T launches a shard a layer a chunk;
    kernel 4 none)."""
    import numpy as np
    import torch

    from vad_tpu_torch.parallel.sharding import get_mesh

    dtype = torch.bfloat16 if label == "bf16" else torch.float32
    split = video_scorer(ckpt, size, dtype, SPATIAL_S,
                         get_mesh(["cuda:0"] * 4, model_parallel=model_parallel))
    whole = video_scorer(ckpt, size, dtype, SPATIAL_S)
    require(split.spatial and not split.fused_input, "the split scorer runs without kernel 4")
    rng = np.random.default_rng(SEED + 30 + size)
    chunks = [torch.from_numpy(rng.integers(0, 256, (SPATIAL_S, T, size, size, 3),
                                            dtype=np.uint8)).cuda()
              for _ in range(SPATIAL_CHUNKS)]
    if label == "f32":
        bars = {"scores": SPLIT_SCORES, "maps": SPLIT_MAPS, "state": F32_BAR}
        judge = lambda got, ref, bar: dict(zip(("max_abs_err", "ok"), close(  # noqa: E731
            torch.as_tensor(got), torch.as_tensor(ref), bar)))
    else:
        bars = {"scores": BF16_BAR, "maps": BF16_BAR, "state": BF16_BAR}
        judge = lambda got, ref, bar: agree(got, ref, bar)  # noqa: E731
    cmp = {"scores": [], "maps": []}
    with no_tf32() if label == "f32" else contextlib.nullcontext():
        zero_counters()
        outs = [split.score_chunk(ch) for ch in chunks]
        torch.cuda.synchronize()
        launches = read_counters()
        for ch, (got, got_maps) in zip(chunks, outs):
            want, want_maps = whole.score_chunk(ch)
            cmp["scores"].append(judge(got, want, bars["scores"]))
            cmp["maps"].append(judge(got_maps, want_maps, bars["maps"]))
        cmp["states"] = [{"h": judge(h.cpu(), wh.cpu(), bars["state"]),
                          "c": judge(c.cpu(), wc.cpu(), bars["state"])}
                         for (h, c), (wh, wc) in zip(split.states, whole.states)]
        fps = {}
        if timed:
            for name, sc in (("split", split), ("unsplit", whole)):
                sc.score_chunk(chunks[0])
                torch.cuda.synchronize()
                start = time.perf_counter()
                for i in range(SPATIAL_TIMED):
                    sc.score_chunk(chunks[i % SPATIAL_CHUNKS])
                fps[name] = SPATIAL_TIMED * SPATIAL_S * T / (time.perf_counter() - start)
    shards = 4  # every cell of the 4-device grid runs its rows
    layers = len(split.model.convlstm.layers)
    expect = SPATIAL_CHUNKS * T * shards * layers
    ok = (all(r["ok"] for r in cmp["scores"] + cmp["maps"])
          and all(s["h"]["ok"] and s["c"]["ok"] for s in cmp["states"])
          and launches["convlstm_serving"] == expect and launches["first_block"] == 0)
    return {"size": size, "dtype": label, "model_parallel": model_parallel,
            "mesh": split.mesh.shape, "bars": bars, "compare": cmp, "launches": launches,
            "expected_launches": expect, "frames_per_s": fps, "ok": ok}


def phase_spatial(card: str, image: dict, workdir: Path, peak_flops: float, peak_bw: float,
                  f32_flops: float) -> dict:
    """The spatial row split (``parallel/spatial.py``, ``--spatial N``) on
    the one card, every row shard on ``cuda:0``: the halo code and kernel
    1's halo reads run for real; scaling across cards is not measured.

    - Kernel 1's row form (``SPATIAL_KERNEL_SHAPES``, bf16 and f32 with
      TF32 off, stepwise_tc (the plan's choice) and stepwise forced)
      against its plain version and, joined, against the unsplit kernel 1,
      at the bar of its type; its staged form equal bit for bit.
    - ``MultiStreamScorer(spatial=True)`` on ``get_mesh(["cuda:0"] * 4,
      model_parallel=2)`` against the unsplit scorer from one ``.ckpt`` of
      the default model (S=4, T=16, 3 chunks of carried state) at 256² and
      512², bf16 and f32; ``model_parallel=4`` at 256² (4 latent rows a
      shard).  Kernel 1's launches counted, kernel 4's none; frames/s split
      and unsplit (bf16).
    - ``serve_from_checkpoint(..., spatial_parallel=2, devices=["cuda:0"] *
      2)`` with the image checkpoint beside: /v1/streams chunks against the
      unsplit scorer, a /v1/images batch against the unsplit service."""
    import dataclasses

    import numpy as np
    import torch

    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval import http_server
    from vad_tpu_torch.eval.client import ScoringClient
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
    from vad_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from vad_tpu_torch.utils.weights import state_dict_to_flax

    phase_start = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    kernel = [check_rows_kernel(shape, label, peak_flops, peak_bw, f32_flops, design)
              for shape in SPATIAL_KERNEL_SHAPES for label in ("bf16", "f32")
              for design in ("stepwise_tc", "stepwise")]
    for rec in kernel:
        emit({"phase": "spatial_kernel", "card": card, **rec})
    require(all(r["ok"] for r in kernel),
            f"kernel 1's row form vs its plain version, the unsplit kernel and its staged "
            f"form: {[(r['shards'], r['dtype'], r['design'], r['max_abs_err'])
                      for r in kernel if not r['ok']]}")

    cfg = VideoAEConfig(image_size=IMAGE, sequence_length=T)
    model = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED + 5)
    ckpt_path = workdir / "video.ckpt"
    save_checkpoint(ckpt_path, {"model_type": "video", **state_dict_to_flax(model),
                                "args": dataclasses.asdict(cfg)})
    ckpt = load_checkpoint(ckpt_path)
    scorers = [check_spatial_scorer(ckpt, size, label, 2, timed=label == "bf16")
               for size in SPATIAL_SIZES for label in ("bf16", "f32")]
    scorers.append(check_spatial_scorer(ckpt, IMAGE, "bf16", 4, timed=False))
    for rec in scorers:
        emit({"phase": "spatial_scorer", "card": card, **rec})
    require(all(r["ok"] for r in scorers),
            "split scorers against the unsplit one, with kernel 1's row launches: "
            f"{[(r['size'], r['dtype'], r['model_parallel'], r['launches']) for r in scorers if not r['ok']]}")

    # the daemon: --spatial 2 on two grid cells of the one card
    with contextlib.redirect_stdout(io.StringIO()):
        srv = http_server.serve_from_checkpoint(
            str(ckpt_path), host="127.0.0.1", port=0, num_slots=2, chunk=T,
            spatial_parallel=2, devices=["cuda:0"] * 2, image_checkpoint=str(image["ckpt"]),
            device="cuda")
        direct = video_scorer(ckpt, IMAGE, torch.bfloat16, 2, return_maps=False)
        iservice = http_server._image_service_from_ckpt(
            load_checkpoint(image["ckpt"]), image["ckpt"], 4, "bfloat16", device="cuda")
    srv.start_background()
    rng = np.random.default_rng(SEED + 40)
    chunks = rng.integers(0, 256, (SPATIAL_CHUNKS, T, IMAGE, IMAGE, 3), dtype=np.uint8)
    images = image["test_images"][:8]
    try:
        scorer = srv.services["video"].scorer
        require(scorer.spatial and not scorer.fused_input and srv.services["image"].spatial,
                "the --spatial 2 daemon's scorer and image service run the row split")
        client = ScoringClient("127.0.0.1", srv.port)
        slot = client.attach()
        zero_counters()
        served = [client.score_chunk(slot, ch)["scores"] for ch in chunks]
        served_images = client.score_images(images)["scores"]
        torch.cuda.synchronize()
        launches = read_counters()
    finally:
        srv.close()
    want = [direct.score_streams({slot: list(ch)})[slot] for ch in chunks]
    daemon = {"streams": agree(np.stack(served), np.stack(want)),
              "images": agree(np.asarray(served_images), iservice.score_images(images)),
              "launches": launches, "chunks": SPATIAL_CHUNKS}
    per_tick = T * 2 * len(direct.model.convlstm.layers)
    daemon["ok"] = (daemon["streams"]["ok"] and daemon["images"]["ok"]
                    and launches["convlstm_serving"] == SPATIAL_CHUNKS * per_tick
                    and launches["first_block"] == 0)
    emit({"phase": "spatial_daemon", "card": card, **daemon})
    require(daemon["ok"], f"the --spatial 2 daemon against the unsplit scorer and service: "
                          f"{daemon}")
    fps = {f"{r['size']}": r["frames_per_s"] for r in scorers if r["frames_per_s"]}
    emit({"phase": "spatial", "card": card,
          "note": "every row shard on one card: the split's cost, not scaling",
          "kernel_ms": {f"{r['shards']}x{r['shape'][2]}-{r['dtype']}-{r['design']}": r["ms"]
                        for r in kernel},
          "kernel_bound_ms": {f"{r['shards']}x{r['shape'][2]}-{r['dtype']}": r["bound_ms"]
                              for r in kernel},
          "scorer_frames_per_s": fps, "scorers_ok": all(r["ok"] for r in scorers),
          "daemon_ok": daemon["ok"], "seconds": time.perf_counter() - phase_start})
    row = next(r for r in kernel if r["shards"] == 2 and r["shape"][3] == 16
               and r["dtype"] == "bf16" and r["design"] == "stepwise_tc")
    forms = {f"{r['shards']}x{r['shape'][3]} {r['dtype']} {r['design']}": {k: r[k] for k in (
        "launches_per_call", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for r in kernel}
    return {"launches": sum(r["launches"]["convlstm_serving"] for r in scorers)
            + launches["convlstm_serving"], "kernel": row, "kernel_forms": forms,
            "first_block_launches": sum(r["launches"]["first_block"] for r in scorers)
            + launches["first_block"]}


# ------------------------------------------------------------- the bench

BENCH_CHUNKS = 2  # chunks of each scoring form held against the plain step


class BenchLines(io.TextIOBase):
    """Standard output for ``vad_tpu_torch.bench.main()``: each line it
    prints, with the port's kernel launches since the previous line (the
    counters are read and zeroed at every newline, so each line's count is
    its own measurement's)."""

    def __init__(self) -> None:
        super().__init__()
        self.pending, self.lines = "", []

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        self.pending += text
        while "\n" in self.pending:
            line, self.pending = self.pending.split("\n", 1)
            if line.strip():
                self.lines.append((line, read_counters()))
                zero_counters()
        return len(text)


def bench_expected_launches() -> dict:
    """``{line: {kernel: launches}}`` of one ``vad_tpu_torch.bench.main()``
    run at its shapes (2 ConvLSTM layers, 16x16 latent, C=128): a step is
    its warm-up plus every timed step, each layer's recurrence one call,
    each call the launches its plan gives; kernel 4 once a fused step."""
    import torch

    from vad_tpu_torch import bench
    from vad_tpu_torch.ops.convlstm import recurrence_plan

    layers, lat, ch = 2, bench.IMAGE_SIZE // 16, 128
    none = dict.fromkeys(train_kernel_counters(), 0)

    def recurrence(kernel: str, b: int, t: int, steps: int, dtype=torch.bfloat16) -> int:
        return steps * layers * recurrence_plan(kernel, b, t, lat, lat, ch, dtype).launches

    out = {}
    for name, form, t in bench.SCORING_CONFIGS:
        steps = 1 + bench.WINDOWS * bench.scoring_iters(t)
        out[name] = {**none, "convlstm_serving": 0 if form == "plain" else
                     recurrence("convlstm_serving", bench.STREAMS, t, steps),
                     "first_block": steps if form == "fused" else 0}
    steps = 1 + bench.WINDOWS * bench.scoring_iters(16)
    out[bench.STRIDE2_CONFIG] = {**none, "convlstm_serving": recurrence(
        "convlstm_serving", bench.STREAMS, 16, steps)}
    out[bench.IMAGE_CONFIG] = dict(none)
    steps = 1 + bench.TRAIN_WINDOWS * bench.TRAIN_ITERS
    for name, compute_dtype, _ in bench.TRAIN_CONFIGS:
        dtype = compute_dtype or torch.float32
        out[name] = {**none, **{k: recurrence(k, bench.TRAIN_BATCH, 16, steps, dtype)
                                for k in ("convlstm_train_forward", "convlstm_backward")}}
    for name, b, frames in ((bench.E2E_CONFIG, 1, bench.E2E_FRAMES),
                            (bench.MS_CONFIG, bench.MS_STREAMS, bench.MS_FRAMES)):
        out[name] = {**none, "convlstm_serving": recurrence(
            "convlstm_serving", b, 16, 1 + math.ceil(frames / 16))}
    out[bench.HEADLINE_METRIC] = dict(none)  # the CPU baseline
    return out


def check_bench_forms() -> dict:
    """Each of the bench's scoring step forms (``bench.scoring_step``) at
    its full size against the plain step on the same weights, over
    ``BENCH_CHUNKS`` chunks of random bytes with the state carried: the
    scores and every layer's (h, c) at the bf16 bar."""
    import numpy as np
    import torch

    from vad_tpu_torch import bench

    rng = np.random.default_rng(SEED + 60)
    chunks = [torch.from_numpy(rng.integers(0, 256, (bench.STREAMS, T, IMAGE, IMAGE, 3),
                                            dtype=np.uint8)).cuda() for _ in range(BENCH_CHUNKS)]

    def run(step, model):
        states, scores = model.zero_state(bench.STREAMS, IMAGE, IMAGE), []
        for chunk in chunks:
            got, states = step(chunk, states)
            scores.append(got)
        return torch.stack(scores), states

    out = {}
    for stem, forms in (("pool", ("fused", "kernel")), ("stride2", ("kernel",))):
        model = bench.video_model("cuda", stem)
        ref_scores, ref_states = run(bench.scoring_step(model, "plain"), model)
        for form in forms:
            scores, states = run(bench.scoring_step(model, form), model)
            rec = {"scores": agree(scores, ref_scores),
                   "states": [{"h": agree(h, rh), "c": agree(c, rc)}
                              for (h, c), (rh, rc) in zip(states, ref_states)]}
            rec["ok"] = rec["scores"]["ok"] and all(
                s["h"]["ok"] and s["c"]["ok"] for s in rec["states"])
            out[f"{stem}-{form}"] = rec
    return out


def phase_bench(card: str) -> dict:
    """``python -m vad_tpu_torch.bench`` (the JAX package's ``bench.py`` on
    the card) once, in process, at full size, its output captured:

    - each scoring form against the plain step (``check_bench_forms``);
    - ``bench.main()``: all 11 configuration lines and the headline, in
      order, each with positive values, ``mfu`` <= 1 and the card's name
      and power limit; the headline equal to the best scoring line;
    - the launches of kernels 1-4 counted around each line, equal to
      ``bench_expected_launches`` (kernel 1 on neither plain line, and on
      the kernel lines run after them: nothing stays routed to the plain
      versions).

    Each bench line is printed again as a ``bench_line`` line with its
    launches; the ``bench`` line has the phase's seconds."""
    import torch

    from vad_tpu_torch import bench
    from vad_tpu_torch.ops import convlstm, encoder_fused
    from vad_tpu_torch.ops.convlstm import recurrence_plan

    phase_start = time.perf_counter()
    forms = check_bench_forms()
    require(all(r["ok"] for r in forms.values()),
            f"the bench's scoring forms against the plain step: "
            f"{ {k: r['scores']['max_abs_err'] for k, r in forms.items() if not r['ok']} }")
    entry = convlstm.convlstm_recurrence, encoder_fused.fused_first_block

    out = BenchLines()
    zero_counters()
    main_start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench.main([])
    main_seconds = time.perf_counter() - main_start
    require((convlstm.convlstm_recurrence, encoder_fused.fused_first_block) == entry,
            "the kernels' entry points are restored after the bench")
    records = [(json.loads(line), launches) for line, launches in out.lines]
    expected = bench_expected_launches()
    names = [rec.get("config", rec.get("metric")) for rec, _ in records]
    require(names == list(expected), f"the bench's lines, in order: {names}")
    scoring = {name for name, _, _ in bench.SCORING_CONFIGS}
    for rec, launches in records:
        name = rec.get("config") or rec["metric"]
        numbers = [v for k, v in rec.items() if isinstance(v, (int, float))]
        emit({"phase": "bench_line", **rec, "launches": launches})
        require(all(v > 0 for v in numbers) and 0 < rec.get("mfu", 1) <= 1,
                f"positive values and mfu <= 1 on {name!r}: {rec}")
        require(rec["device"] == torch.cuda.get_device_name(0) and rec["power_limit_w"] > 0,
                f"{name!r} names the card and its power limit")
        require(launches == expected[name],
                f"kernel launches on {name!r}: {launches}, expected {expected[name]}")
    head = records[-1][0]
    best = max(rec["value"] for rec, _ in records if rec.get("config") in scoring)
    require(head["value"] == best
            and head["flops_per_frame"] == bench.model_flops_per_frame(bench.IMAGE_SIZE)
            and head["vs_baseline"] > 0 and head["baseline_cpu"],
            f"the headline is the best scoring line ({best}): {head}")
    designs = {f"T={t}": recurrence_plan("convlstm_serving", bench.STREAMS, t, IMAGE // 16,
                                         IMAGE // 16, 128, torch.bfloat16).design
               for t in (16, 64)}
    emit({"phase": "bench", "card": card, "lines": len(records),
          "forms_vs_plain": forms, "kernel_1_design": designs, "main_seconds": main_seconds,
          "seconds": time.perf_counter() - phase_start})
    return {k: {rec.get("config", rec.get("metric")): n[k] for rec, n in records if n[k]}
            for k in train_kernel_counters()}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    try:
        import torch  # noqa: F401

        import vad_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--artifact-check"]:  # phase_export's loading process
        return artifact_check(*sys.argv[2:5])
    if sys.argv[1:2] == ["--accuracy"]:
        return accuracy_main(sys.argv[2:])
    if sys.argv[1:2] == ["--scaling-worker"]:  # phase_scaling's rank processes
        return scaling_worker(*sys.argv[2:5])
    script_start = time.perf_counter()
    name, peak_flops, peak_bw, f32_flops, card = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--block-epilogue"]:
        phase_block_epilogue(peak_bw)
        emit({"phase": "script", "seconds": time.perf_counter() - script_start})
        return 0
    checks = {"convlstm_serving": phase_convlstm(peak_flops, peak_bw, f32_flops),
              "first_block": phase_first_block(peak_flops, peak_bw),
              "block_epilogue": phase_block_epilogue(peak_bw)}
    checks.update(phase_train_kernels(peak_flops, peak_bw, f32_flops))
    large = phase_large_frames(peak_flops, peak_bw)
    phase_weight_cache()
    phase_edge_shapes()
    launches = phase_main_path()
    high_res = phase_main_path_512()
    phase_train_step_compare()
    train_512 = phase_train_step_compare(HIGH_RES, judged=("bf16",))["bf16"]
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, best_ckpt, test_ds = phase_train(tmp)
        evaluation = phase_eval(best_ckpt, test_ds, card)
        image = phase_image(card, Path(tmp) / "image")
        serve = phase_serve(card, best_ckpt, image)
        work = Path(tmp)
        export = phase_export(card, best_ckpt, image, work / "export")
        reference = phase_reference_import(card, best_ckpt, image, work / "reference")
        fast = phase_stream_step_fast(card)
        profiling = phase_profiling(card, work / "profiling")
        ui = phase_ui(card, best_ckpt, image, profiling["data"], work / "ui")
        accuracy = phase_accuracy(card, work / "accuracy")
        scaling = phase_scaling(card, profiling["data"], work / "scaling")
        spatial = phase_spatial(card, image, work / "spatial", peak_flops, peak_bw, f32_flops)
        bench_launches = phase_bench(card)
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
        ("block_epilogue", "vad_tpu_torch/csrc/block_epilogue.cu",
         "none (XLA fuses these passes into the convolutions)", launches),
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
        if kname in ("convlstm_serving", "first_block"):  # behind the daemon's /v1/streams
            kernels[-1]["serve_launches"] = serve["launches"][kname]
        if kname in large:  # bf16 on a 32x32 latent: the bf16 stepwise_tc tile and WMMA core
            kernels[-1]["bf16_32x32"] = large[kname]
        if kname == "convlstm_serving":
            kernels[-1]["f32"] = rec["f32"]
            kernels[-1]["bf16_designs_16x16"] = rec["bf16_designs"]  # resident, and the others
            kernels[-1]["main_path_512_launches"] = high_res["launches"][kname]
            # the spatial row split: the split scorers' and the --spatial 2
            # daemon's launches, and the row form (2 shards, bf16) timed
            row = spatial["kernel"]
            kernels[-1]["spatial_launches"] = spatial["launches"]
            kernels[-1]["rows"] = {k: row[k] for k in (
                "shards", "design", "launches_per_call", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")}
            kernels[-1]["rows_forms"] = spatial["kernel_forms"]
        if kname == "first_block":  # kernel 4 is off under the row split, as in JAX
            kernels[-1]["spatial_launches"] = spatial["first_block_launches"]
            kernels[-1]["main_path_512_launches"] = high_res["launches"][kname]
            # the artifacts' loading processes, stream_step_fast, the UI's
            # analyze_video and the port's forward beside the reference layout
            kernels[-1].update(export_launches=export["launches"],
                               fast_launches=fast["launches"], ui_launches=ui["launches"],
                               reference_import_launches=reference["launches"])
        if kname in ("convlstm_train_forward", "convlstm_backward"):  # the profiled CLI run
            kernels[-1]["profiling_launches"] = profiling["launches"][kname]
            kernels[-1]["f32"] = rec["f32"]  # stepwise_tc and stepwise at B=8
            kernels[-1]["bf16_designs_16x16"] = rec["bf16_designs"]  # resident, and the others
            # the 512x512 bf16 train step (train_step_compare_512): the bf16 tile
            kernels[-1]["train_512_launches"] = train_512[kname]
        if kname in accuracy["launches"]:  # train, evaluate and --video-dir of a real model
            kernels[-1]["accuracy_launches"] = accuracy["launches"][kname]
        if kname in scaling["launches"]:  # each of the two gloo ranks' train steps
            kernels[-1]["scaling_launches_per_rank"] = scaling["launches"][kname]
        if kname in ("convlstm_serving", "first_block"):  # two scorer replicas on one card
            kernels[-1]["scaling_scorer_launches"] = scaling["scorer_launches"][kname]
        if kname in bench_launches:  # python -m vad_tpu_torch.bench, by line
            kernels[-1]["bench_launches"] = bench_launches[kname]
    emit({"phase": "script", "seconds": time.perf_counter() - script_start})
    emit({"kernels": kernels})
    import torch

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
