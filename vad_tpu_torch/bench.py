"""The port's benchmark: the JAX package's ``bench.py`` on the card.

    python -m vad_tpu_torch.bench

Workload (the JAX bench's): frames come from a synthetic 720p video,
resized to the model's 256x256 input, and stream through the ConvLSTM
autoencoder's scoring step as a batch of S=16 parallel streams (the
multi-camera serving scenario), ``VideoAEConfig()`` with weights drawn
from seed 0 (``init_training_weights``).

Measured quantity: device-pipeline frames/s at steady state (frames
resident on the card as uint8, normalization + forward on the card, the
scores copied back to the host).  Each configuration is warmed up first
(the first call also builds the CUDA kernels), then timed over 4 windows
of chained steps, each window ended by a real fetch of its last result
(``.cpu()``) and timed on the host clock; the best window counts.

It prints one JSON line per configuration, in the JAX bench's order; each
line names the card (``torch.cuda.get_device_name``) and its power limit
(``nvidia-smi``).  Beside each line its JAX twin and the port's kernels
that run on it (kernel numbers as in ``PERF.md``):

- ``fused input block + recurrence kernel, bf16`` (JAX: ``fused input
  block + fused-pallas recurrence, bf16``): ``stream_step_u8``, kernels 4,
  1 and 7;
- ``recurrence kernel, bf16`` (``fused-pallas recurrence, bf16``):
  normalize, then ``stream_step``, kernel 1;
- ``plain recurrence, bf16`` (``xla scan recurrence, bf16``): the same
  step on the plain recurrence (``ops/plain.plain_versions``), none of
  kernels 1-4;
- the same two at 64-frame windows;
- ``recurrence kernel, bf16, stride2 stem``: its own FLOP count, never
  the headline;
- ``image scoring, bf16, batch 256``: ``ConvAutoencoder.
  reconstruction_error`` on ``ImageAEConfig()``, no port kernel;
- three ``video training step`` lines (f32 with TF32 off, bf16 mixed
  precision, bf16 with the stride2 stem; B=8, T=16, Adam): kernels 2 and
  3;
- ``end-to-end single-stream mp4 (host decode overlapped)``: a 512-frame
  720p mp4 decoded on the host and scored through ``iter_device_chunks``
  (kernel 1), with the decode-only ceiling and the overlap fraction;
- ``end-to-end 4-stream mp4 (aggregate, decode included)``: four mp4s
  decoded concurrently, stacked into one [4, T, H, W, 3] step (kernel 1),
  and the bottleneck named; both end-to-end lines name the host's CPU.

The last line is the headline (JAX's keys): the best video scoring line,
``vs_baseline`` against the reference-equivalent torch model on the
host CPU (``utils/baseline_torch.py``, measured last, since it sets
torch's thread count for the process; the line names that CPU), ``mfu``
and the FLOPs per frame, the image and stride2 scoring figures.

``mfu`` keeps the JAX bench's definition: analytic model FLOP/s (the
convolutions' MACs x 2, ``model_flops_per_frame``) over the card's dense
bf16 peak, 989e12 FLOP/s (NVIDIA's H100 SXM data sheet, at 700 W), and a
training step counts as 3x its forward FLOPs.  The bench runs on a CUDA
card only: without one it raises before it prints anything.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from vad_tpu_torch.core.config import ImageAEConfig, VideoAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
from vad_tpu_torch.ops.block_epilogue import fold_blocks
from vad_tpu_torch.ops.encoder_fused import fold_from_variables
from vad_tpu_torch.ops.plain import plain_versions
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.weights import state_dict_to_flax

IMAGE_SIZE = 256
STREAMS = 16  # parallel camera streams (the JAX bench's saturation point)
N_SOURCE = 128  # source frames the chunks cycle through
SEED = 0
H100_PEAK_BF16_FLOPS = 989e12  # dense, NVIDIA's H100 SXM data sheet, 700 W
FORMS = ("fused", "kernel", "plain")  # the scoring step's three forms
WINDOWS = 4  # timed windows of a scoring line; the best counts
IMAGE_BATCH, IMAGE_ITERS = 256, 12
TRAIN_BATCH, TRAIN_ITERS, TRAIN_WINDOWS = 8, 8, 3
E2E_FRAMES, MS_STREAMS, MS_FRAMES = 512, 4, 256

# (line, step form, frames per chunk), in the JAX bench's order
SCORING_CONFIGS = (
    ("fused input block + recurrence kernel, bf16", "fused", 16),
    ("recurrence kernel, bf16", "kernel", 16),
    ("plain recurrence, bf16", "plain", 16),
    ("recurrence kernel, bf16, 64-frame windows", "kernel", 64),
    ("plain recurrence, bf16, 64-frame windows", "plain", 64),
)
STRIDE2_CONFIG = "recurrence kernel, bf16, stride2 stem"
IMAGE_CONFIG = f"image scoring, bf16, batch {IMAGE_BATCH}"
# (line, compute dtype, stem)
TRAIN_CONFIGS = (
    (f"video training step, f32, B={TRAIN_BATCH}", None, "pool"),
    (f"video training step, bf16 mixed precision, B={TRAIN_BATCH}", torch.bfloat16, "pool"),
    (f"video training step, bf16, stride2 stem, B={TRAIN_BATCH}", torch.bfloat16, "stride2"),
)
E2E_CONFIG = "end-to-end single-stream mp4 (host decode overlapped)"
MS_CONFIG = f"end-to-end {MS_STREAMS}-stream mp4 (aggregate, decode included)"
HEADLINE_METRIC = "720p-video ConvLSTM scoring throughput (device pipeline)"


def scoring_iters(chunk_t: int) -> int:
    """Chained steps in one timed window (about 320 frames a stream)."""
    return max(4, 320 // chunk_t)


# ------------------------------------------------------------ FLOPs


def model_flops_per_frame(image_size: int = 256, stem: str = "pool") -> float:
    """Analytic forward FLOPs per frame of the video scoring pipeline.

    Counts the tensor-core work (convs, ConvTransposes, ConvLSTM gate
    convs) of VideoAutoencoder at default widths; elementwise/BN/gate math
    is excluded (<2%%).  Used to report MFU alongside frames/s.  The
    stride2 stem's encoder convs emit at half resolution (no pool), so that
    model does 1/4 the encoder conv MACs — its MFU must use its own count.
    """
    f = 0.0
    hw = image_size * image_size
    # encoder: 4x conv3x3, channels 3/32/64/128 -> 32/64/128/128; 'pool'
    # computes at full res before each 2x2 pool, 'stride2' emits at half res
    chans = [(3, 32), (32, 64), (64, 128), (128, 128)]
    res = hw
    for cin, cout in chans:
        out_res = res if stem == "pool" else res // 4
        f += out_res * cin * 9 * cout * 2
        res //= 4
    # convlstm: 2 layers x (input conv + hidden conv), 3x3, 128 -> 512 at H/16
    lat_hw = hw // 256
    f += 2 * 2 * (lat_hw * 128 * 9 * 512 * 2)
    # decoder: 4x convtranspose 2x2 stride 2, channels 128/128/64/32 -> 128/64/32/3
    dchans = [(128, 128), (128, 64), (64, 32), (32, 3)]
    res = lat_hw
    for cin, cout in dchans:
        f += res * cin * 4 * cout * 2
        res *= 4
    return f


def image_model_flops(image_size: int = 256, latent: int = 256) -> float:
    """Analytic forward FLOPs per image of ConvAutoencoder (double-conv
    encoder blocks 3->32->64->128->latent, ConvT+Conv decoder mirror)."""
    f = 0.0
    res = image_size * image_size
    cin = 3
    for cout in (32, 64, 128, latent):
        f += res * cin * 9 * cout * 2      # conv1 3x3
        f += res * cout * 9 * cout * 2     # conv2 3x3
        res //= 4
        cin = cout
    # decoder: 3x [ConvT 2x2 stride2 + Conv3x3 refine], then the final
    # ConvT(32) + Conv3x3 -> out_channels (models/autoencoder.py)
    cin = latent
    for cout in (128, 64, 32):
        res *= 4
        # ConvT 2x2 stride 2: each output pixel reads ONE input pixel
        # through one tap -> res_out * cin * cout * 2 (matches the
        # res_in * 4 * ... convention in model_flops_per_frame)
        f += res * cin * cout * 2
        f += res * cout * 9 * cout * 2     # refine conv 3x3
        cin = cout
    res *= 4
    f += res * cin * 32 * 2
    f += res * 32 * 9 * 3 * 2
    return f


def mfu(rate: float, flops_per_item: float, passes: int = 1) -> float:
    """Model FLOP/s over the card's bf16 peak (the JAX bench's MFU);
    ``passes=3`` for a training step (forward + backward ~ 3 forwards)."""
    return rate * passes * flops_per_item / H100_PEAK_BF16_FLOPS


# ------------------------------------------------------------ inputs


def make_source_frames(n_frames: int, image_size: int, workdir=None) -> np.ndarray:
    """uint8 ``[n_frames, image_size, image_size, 3]`` standing in for
    decoded+resized 720p streams: the port's synthetic 720p mp4 (seed 0)
    written into ``workdir`` (a temporary directory when None), decoded
    with OpenCV, each frame resized (``INTER_LINEAR``) then turned RGB.
    Raises when OpenCV is missing or the file does not decode in full."""
    from vad_tpu_torch.data.synthetic import create_synthetic_video_file
    from vad_tpu_torch.data.video_dataset import cv2_module

    cv2 = cv2_module()
    with (nullcontext(workdir) if workdir is not None
          else tempfile.TemporaryDirectory(prefix="vad_torch_bench_")) as d:
        path = str(Path(d) / "source_720p.mp4")
        create_synthetic_video_file(path, n_frames=n_frames, image_size=720, seed=SEED)
        cap = cv2.VideoCapture(path)
        frames = []
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frame = cv2.resize(frame, (image_size, image_size),
                                   interpolation=cv2.INTER_LINEAR)
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
    if len(frames) != n_frames:
        raise RuntimeError(f"OpenCV decoded {len(frames)} of the {n_frames} frames of the "
                           f"synthetic 720p mp4 {path}")
    return np.stack(frames)


def make_chunks(src: np.ndarray, streams: int, chunk_t: int, device, n: int = 4) -> list:
    """``n`` uint8 ``[streams, chunk_t, H, W, 3]`` chunks on ``device``,
    cycled from the source frames (every stream sees the same frames)."""

    def chunk_at(i: int) -> np.ndarray:
        idx = (np.arange(chunk_t) + i * chunk_t) % len(src)
        one = src[idx]
        return np.broadcast_to(one, (streams, *one.shape)).copy()

    return [torch.from_numpy(chunk_at(i)).to(device) for i in range(n)]


def video_model(device, stem: str = "pool", cfg: Optional[VideoAEConfig] = None
                ) -> VideoAutoencoder:
    """``VideoAEConfig(stem=stem)`` (or ``cfg``) with the JAX model's
    initialization drawn from ``SEED``, on ``device``, in eval mode."""
    cfg = cfg or VideoAEConfig(stem=stem)
    model = init_training_weights(VideoAutoencoder.from_config(cfg, device="cpu"), SEED)
    return model.to(device).eval()


def image_model(device) -> ConvAutoencoder:
    """``ImageAEConfig()`` with the JAX model's initialization drawn from
    ``SEED``, on ``device``, in eval mode."""
    model = init_training_weights(ConvAutoencoder.from_config(ImageAEConfig(), device="cpu"),
                                  SEED)
    return model.to(device).eval()


# ------------------------------------------------------------ steps


def scoring_step(model: VideoAutoencoder, form: str = "kernel",
                 dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``step(u8 [S,T,H,W,3], states) -> (frame scores [S,T] f32, new
    states)`` on a copy of ``model`` cast to ``dtype`` (the caller's model
    is left as it is), the carried (h, c) in f32 (``MultiStreamScorer``'s
    policy).  ``form``:

    - ``"fused"``: ``stream_step_u8`` through the fused input block, with
      inference BatchNorm folded from the f32 model into it and into the
      later blocks (kernels 4, 1 and 7 on the card), as the scorer runs it;
    - ``"kernel"``: normalize in ``dtype``, then ``stream_step`` (kernel 1);
    - ``"plain"``: the kernel form with the recurrence on its plain
      version, inside ``plain_versions()`` for the call only."""
    if form not in FORMS:
        raise ValueError(f"unknown scoring form {form!r}; expected one of {FORMS}")
    served = copy.deepcopy(model).to(dtype).eval()
    if form == "fused":
        w_folded, b_folded = (t.to(model.device)
                              for t in fold_from_variables(state_dict_to_flax(model)))
        folded = fold_blocks(model.state_dict(), dtype, model.device)
    route = plain_versions if form == "plain" else nullcontext

    @torch.inference_mode()
    def step(u8: torch.Tensor, states):
        with route():
            if form == "fused":
                s, t, h, w, _ = u8.shape
                _, _, scores, new_states = served.stream_step_u8(
                    u8.reshape(s, t, h, w * 3), states, w_folded, b_folded, folded, False,
                    out_dtype=dtype)
            else:
                x = u8.to(dtype) / 127.5 - 1.0
                _, _, scores, new_states = served.stream_step(x, states)
        return scores.float(), new_states

    return step


def best_window(call: Callable[[int], torch.Tensor], n_iters: int, n_windows: int) -> float:
    """Seconds of the fastest of ``n_windows`` windows, each ``n_iters``
    chained calls ``call(i)`` ended by a fetch of the last result to the
    host (the barrier)."""
    best = float("inf")
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for i in range(n_iters):
            out = call(i)
        out.cpu()
        best = min(best, time.perf_counter() - t0)
    return best


# ------------------------------------------------------------ measurements


def measure(device, form: str = "kernel", chunk_t: int = 16, stem: str = "pool", *,
            src: np.ndarray, streams: int = STREAMS, model: Optional[VideoAutoencoder] = None,
            dtype: torch.dtype = torch.bfloat16, n_iters: Optional[int] = None,
            n_windows: int = WINDOWS) -> Tuple[float, tuple]:
    """Best-window steady-state frames/s of one scoring configuration, and
    the carried states after every step (warm-up included), chained.

    ``model`` defaults to ``video_model(device, stem)``; frames are the
    source's size; ``n_iters`` defaults to ``scoring_iters(chunk_t)``."""
    model = video_model(device, stem) if model is None else model
    step = scoring_step(model, form, dtype)
    chunks = make_chunks(src, streams, chunk_t, device)
    states = model.zero_state(streams, src.shape[1], src.shape[2])
    scores, states = step(chunks[0], states)
    scores.cpu()  # warm-up (the first call builds the kernels)
    n_iters = n_iters or scoring_iters(chunk_t)

    def call(i: int) -> torch.Tensor:
        nonlocal states
        scores, states = step(chunks[i % len(chunks)], states)
        return scores

    return n_iters * streams * chunk_t / best_window(call, n_iters, n_windows), states


def measure_image(device, src: np.ndarray, batch: int = IMAGE_BATCH, *,
                  model: Optional[ConvAutoencoder] = None, dtype: torch.dtype = torch.bfloat16,
                  n_iters: int = IMAGE_ITERS, n_windows: int = WINDOWS
                  ) -> Tuple[float, torch.Tensor]:
    """Steady-state image-scoring images/s (the stateless conv AE, the
    daemon's /v1/images path) over uint8 batches resident on ``device``,
    and the last batch's scores."""
    model = image_model(device) if model is None else model
    served = copy.deepcopy(model).to(dtype).eval()
    bufs = [torch.from_numpy(src[(np.arange(batch) + 37 * i) % len(src)]).to(device)
            for i in range(4)]

    @torch.inference_mode()
    def call(i: int) -> torch.Tensor:
        x = bufs[i % len(bufs)].to(dtype) / 127.5 - 1.0
        return served.reconstruction_error(x).float()

    call(0).cpu()  # warm-up
    rate = n_iters * batch / best_window(call, n_iters, n_windows)
    return rate, call(n_iters - 1)


def measure_train(device, src: np.ndarray, compute_dtype: Optional[torch.dtype] = None,
                  batch: int = TRAIN_BATCH, chunk_t: int = 16, stem: str = "pool", *,
                  model: Optional[VideoAutoencoder] = None, n_iters: int = TRAIN_ITERS,
                  n_windows: int = TRAIN_WINDOWS) -> Tuple[float, torch.optim.Optimizer]:
    """Steady-state video TRAINING-step frames/s (forward + backward + Adam
    + BatchNorm statistics: ``make_train_step``, the trainers' step) over
    two uint8 batches resident on ``device``, and the optimizer after every
    step (warm-up included).  f32 (``compute_dtype=None``) runs with TF32
    off, as the trainers do."""
    from vad_tpu_torch.ops.losses import make_per_sample_loss_fn
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    model = video_model(device, stem) if model is None else model
    optimizer = make_optimizer(model.parameters(), 1e-4, weight_decay=1e-5)
    step = make_train_step(make_per_sample_loss_fn("mse", 0.5), compute_dtype=compute_dtype)
    shape = (batch, chunk_t, *src.shape[1:])
    bufs = [torch.from_numpy(np.broadcast_to(src[(np.arange(chunk_t) + 37 * i) % len(src)],
                                             shape).copy()).to(device) for i in range(2)]
    with tf32_off(compute_dtype is None):
        step(model, optimizer, bufs[0], batch).cpu()  # warm-up
        best = best_window(lambda i: step(model, optimizer, bufs[i % 2], batch), n_iters,
                           n_windows)
    return n_iters * batch * chunk_t / best, optimizer


def measure_e2e_mp4(device, workdir, n_frames: int = E2E_FRAMES, chunk_t: int = 16, *,
                    image_size: int = IMAGE_SIZE, model: Optional[VideoAutoencoder] = None,
                    dtype: torch.dtype = torch.bfloat16) -> Tuple[float, float]:
    """End-to-end SINGLE-STREAM throughput: a 720p mp4 in, per-frame scores
    out, host decode overlapped with the card through the streaming path
    (``eval/video_render.iter_device_chunks``: decode thread, pinned
    non-blocking copy, kernel form of the step), the state carried.

    Returns (e2e frames/s, decode-only frames/s): the second is the same
    decode with no device work, the host's ceiling."""
    from vad_tpu_torch.data.synthetic import create_synthetic_video_file
    from vad_tpu_torch.eval.video_render import iter_device_chunks, iter_video_chunks

    path = create_synthetic_video_file(str(Path(workdir) / "e2e_720p.mp4"), n_frames=n_frames,
                                       image_size=720, seed=SEED)
    t0 = time.perf_counter()
    n_dec = sum(n_valid for _, n_valid in iter_video_chunks(path, chunk_t, image_size))
    decode_s = time.perf_counter() - t0

    model = video_model(device) if model is None else model
    step = scoring_step(model, "kernel", dtype)
    zero = model.zero_state(1, image_size, image_size)
    warm = torch.zeros((1, chunk_t, image_size, image_size, 3), dtype=torch.uint8, device=device)
    step(warm, zero)[0].cpu()  # warm-up, outside the timed window

    states, n_scored = zero, 0
    t0 = time.perf_counter()
    for _, dev, n_valid in iter_device_chunks(path, chunk_t, image_size, device):
        scores, states = step(dev, states)
        n_scored += n_valid
    scores.cpu()  # the barrier
    wall = time.perf_counter() - t0
    if n_scored != n_dec:
        raise RuntimeError(f"scored {n_scored} frames of the {n_dec} decoded")
    return n_scored / wall, n_dec / decode_s


def measure_e2e_multistream(device, workdir, n_streams: int = MS_STREAMS,
                            n_frames: int = MS_FRAMES, chunk_t: int = 16, *,
                            image_size: int = IMAGE_SIZE,
                            model: Optional[VideoAutoencoder] = None,
                            dtype: torch.dtype = torch.bfloat16) -> Tuple[float, float]:
    """End-to-end N-STREAM throughput: N distinct 720p mp4s (seeds 0..N-1)
    decoded concurrently (a decode thread each), their chunks stacked on the
    transfer thread into one ``[N, T, H, W, 3]`` batch, copied pinned and
    non-blocking to the card on its own stream (``eval/video_render.
    device_transfers``), and scored in one step that carries N independent
    states.

    Returns (aggregate frames/s, aggregate decode-only frames/s): the
    second is the same N decoders with no device work, the host's
    ceiling."""
    from vad_tpu_torch.data.synthetic import create_synthetic_video_file
    from vad_tpu_torch.eval.video_render import device_transfers, iter_video_chunks

    paths = [create_synthetic_video_file(str(Path(workdir) / f"stream{i}_720p.mp4"),
                                         n_frames=n_frames, image_size=720, seed=i)
             for i in range(n_streams)]

    def make_iters():
        return [iter_video_chunks(p, chunk_t, image_size) for p in paths]

    t0 = time.perf_counter()
    n_dec = sum(sum(nv for _, nv in parts) for parts in zip(*make_iters()))
    decode_s = time.perf_counter() - t0

    model = video_model(device) if model is None else model
    step = scoring_step(model, "kernel", dtype)
    zero = model.zero_state(n_streams, image_size, image_size)
    warm = torch.zeros((n_streams, chunk_t, image_size, image_size, 3), dtype=torch.uint8,
                       device=device)
    step(warm, zero)[0].cpu()  # warm-up, outside the timed window

    def stacked():  # on the transfer thread
        for parts in zip(*make_iters()):
            yield np.stack([b for b, _ in parts]), sum(nv for _, nv in parts)

    states, n_scored = zero, 0
    t0 = time.perf_counter()
    for _, batch, n_valid in device_transfers(stacked, device):
        scores, states = step(batch, states)
        n_scored += n_valid
    scores.cpu()  # the barrier
    wall = time.perf_counter() - t0
    if n_scored != n_dec:
        raise RuntimeError(f"scored {n_scored} frames of the {n_dec} decoded")
    return n_scored / wall, n_dec / decode_s


# ------------------------------------------------------------ main


def power_limit_w() -> float:
    """The card's power limit in W, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives it (its first card)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return float(line.rsplit(",", 1)[1].split()[0])


def main(argv: Optional[Sequence[str]] = None) -> None:
    argparse.ArgumentParser(
        description="The port's benchmark on the CUDA card: the JAX bench's 11 "
                    "configurations and its headline, one JSON line each."
    ).parse_args(argv)
    device = resolve_device(None)
    from vad_tpu_torch.utils.baseline_torch import cached_host, host_cpu, \
        measure_reference_cpu_fps

    card = {"device": torch.cuda.get_device_name(device), "power_limit_w": power_limit_w()}
    host = {"host_cpu": host_cpu()}

    def emit(rec: dict) -> None:
        print(json.dumps({**rec, **card}), flush=True)

    flops_frame = model_flops_per_frame(IMAGE_SIZE)
    with tempfile.TemporaryDirectory(prefix="vad_torch_bench_") as tmp:
        src = make_source_frames(N_SOURCE, IMAGE_SIZE, tmp)
        results = {}
        for name, form, chunk_t in SCORING_CONFIGS:
            results[name], _ = measure(device, form, chunk_t, src=src)
            emit({"config": name, "value": round(results[name], 1), "unit": "frames/s/chip",
                  "mfu": round(mfu(results[name], flops_frame), 4)})

        # the stride2 stem: another function with its own FLOP count, never
        # the headline (no fused block: it has no pool)
        stride2_fps, _ = measure(device, "kernel", 16, "stride2", src=src)
        emit({"config": STRIDE2_CONFIG, "value": round(stride2_fps, 1), "unit": "frames/s/chip",
              "mfu": round(mfu(stride2_fps, model_flops_per_frame(IMAGE_SIZE, "stride2")), 4)})

        image_fps, _ = measure_image(device, src)
        emit({"config": IMAGE_CONFIG, "value": round(image_fps, 1), "unit": "images/s/chip",
              "mfu": round(mfu(image_fps, image_model_flops(IMAGE_SIZE)), 4)})

        for name, compute_dtype, stem in TRAIN_CONFIGS:
            train_fps, _ = measure_train(device, src, compute_dtype, stem=stem)
            emit({"config": name, "value": round(train_fps, 1), "unit": "frames/s/chip",
                  "mfu": round(mfu(train_fps, model_flops_per_frame(IMAGE_SIZE, stem), 3), 4)})

        e2e_fps, decode_fps = measure_e2e_mp4(device, tmp)
        emit({"config": E2E_CONFIG, "value": round(e2e_fps, 1), "unit": "frames/s",
              "decode_only_fps": round(decode_fps, 1),
              "overlap_fraction": round(e2e_fps / decode_fps, 3), **host})

        ms_fps, ms_decode_fps = measure_e2e_multistream(device, tmp)
        emit({"config": MS_CONFIG, "value": round(ms_fps, 1), "unit": "frames/s",
              "n_streams": MS_STREAMS, "decode_only_fps": round(ms_decode_fps, 1),
              "overlap_fraction": round(ms_fps / ms_decode_fps, 3),
              "bottleneck": ("host decode" if ms_fps / ms_decode_fps >= 0.8
                             else "host non-decode overhead"), **host})

    fps = max(results.values())
    # last: the baseline sets torch's CPU thread count for the process
    baseline_fps = measure_reference_cpu_fps(image_size=IMAGE_SIZE, sequence_length=16)
    baseline_host = cached_host(IMAGE_SIZE, 16)
    emit({"metric": HEADLINE_METRIC, "value": round(fps, 1), "unit": "frames/s/chip",
          "vs_baseline": round(fps / baseline_fps, 1), "mfu": round(mfu(fps, flops_frame), 4),
          "flops_per_frame": flops_frame, "image_scoring_fps": round(image_fps, 1),
          "stride2_scoring_fps": round(stride2_fps, 1),
          "baseline_cpu": baseline_host.get("cpu"),
          "baseline_threads": baseline_host.get("threads")})


if __name__ == "__main__":
    main()
