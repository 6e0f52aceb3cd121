"""Multi-stream anomaly-scoring HTTP daemon: the JAX package's
``vad_tpu/eval/http_server.py`` over the port's scorers.

A stdlib-only (``http.server``) REST front over ``MultiStreamScorer``:
clients attach a stream slot, POST raw uint8 frame chunks and get
per-frame anomaly scores back.  Requests from different streams are
coalesced into one batched device step over the full ``[num_slots,
chunk, H, W, 3]`` batch, which on the card runs the recurrence kernel
(``csrc/convlstm_serving.cu``) and, with ``fused_input``, the fused u8
input block (``csrc/first_block.cu``).

Protocol (JSON unless noted), byte for byte the JAX daemon's, so either
package's ``ScoringClient`` drives either daemon:
    POST   /v1/streams                 -> {"slot": N}            (video)
    DELETE /v1/streams/<slot>          -> {"detached": N}        (video)
    POST   /v1/streams/<slot>/frames   body = raw u8 bytes, header
           X-Frames-Shape: "T,H,W,3"   -> {"scores": [T floats]} (video)
    POST   /v1/images                  body = raw u8 bytes, header
           X-Frames-Shape: "N,H,W,3"   -> {"scores": [N floats]} (image)
    POST   /v1/reload                  body = {"checkpoint": "<path>"}
           -> hot-swaps the served weights in place (both kinds); video
           streams keep their slots and carried state
    GET    /v1/health                  -> config + live slot map
    GET    /v1/metrics                 -> counters + device-step latency
                                          histogram (``?format=prometheus``)

Image checkpoints are served statelessly through /v1/images (requests
padded to a fixed device batch), video checkpoints through the
slot-stateful /v1/streams API.  A frames POST blocks until the scorer
thread has run its chunk: a tick runs as soon as any request is pending
and the device is free.

Threads: every video device step runs on the service's own loop thread
(the kernels launch on that thread's current stream); image steps run on
the HTTP handler threads, one at a time under the image lock.  An f32
service turns TF32 off for the whole process when it is built on the card
and never toggles it per request, so a step on one thread cannot see
another thread switch it back on.

One difference from the JAX daemon, by design: the port's scorer refolds
the fused input block's weights on ``reload_variables``, so ``/v1/reload``
works with ``fused_input`` on (the default on the card), where JAX's
scorer refuses it.
"""

from __future__ import annotations

import json
import pickle
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vad_tpu_torch.core.config import ImageAEConfig, MemAEConfig, VideoAEConfig, is_memae
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.eval.drift import ScoreWindow
from vad_tpu_torch.eval.latent_score import (
    LatentStats,
    load_stats,
    make_distance_fn,
    stats_state,
)
from vad_tpu_torch.eval.metrics import serving_frame_threshold, serving_score_baseline
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.memae import MemAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    data_parallel,
    get_mesh,
    local_devices,
    padded_batch_size,
    replicate,
    spatial_frame_sharding,
)
from vad_tpu_torch.parallel.spatial import RowSplit, replicate_grid
from vad_tpu_torch.utils.checkpoint import CHECKPOINT_SUFFIX, load_checkpoint
from vad_tpu_torch.utils.precision import (
    check_served_image_size,
    check_served_stem,
    checked_cast_like,
)
from vad_tpu_torch.utils.profiling import device_memory_report
from vad_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables

# The JAX daemon's message for weights of another architecture.
_ARCHITECTURE_MISMATCH = (
    "checkpoint does not match the served architecture "
    "(pytree/shape/dtype mismatch); restart the server to "
    "change architectures"
)

_MEMAE_NO_RELOAD = ("hot reload of a MemAE checkpoint is not supported; restart "
                    "the server with the new checkpoint")


def _f32_without_tf32(dtype: torch.dtype, device: torch.device) -> None:
    """An f32 service on the card scores without TF32 for its whole life:
    cuDNN's convolutions default to TF32, and the flags are process-wide."""
    if dtype == torch.float32 and device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


class ServiceMetrics:
    """Thread-safe serving counters + device-step latency distribution.

    Latencies land in fixed log-spaced ms buckets, so the histogram is
    O(1) memory at any request volume; the snapshot is what ``GET
    /v1/metrics`` returns.
    """

    BUCKETS_MS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 5000)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.requests = 0
        self.frames = 0
        self.device_steps = 0
        self.errors = 0
        self._lat_count = 0
        self._lat_sum = 0.0
        self._lat_min = float("inf")
        self._lat_max = 0.0
        self._hist = [0] * (len(self.BUCKETS_MS) + 1)

    def record_request(self, frames: int) -> None:
        with self._lock:
            self.requests += 1
            self.frames += frames

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_step(self, seconds: float) -> None:
        ms = seconds * 1e3
        with self._lock:
            self.device_steps += 1
            self._lat_count += 1
            self._lat_sum += ms
            self._lat_min = min(self._lat_min, ms)
            self._lat_max = max(self._lat_max, ms)
            for i, edge in enumerate(self.BUCKETS_MS):
                if ms <= edge:
                    self._hist[i] += 1
                    break
            else:
                self._hist[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = None
            if self._lat_count:
                lat = {
                    "count": self._lat_count,
                    "sum_ms": round(self._lat_sum, 3),
                    "mean_ms": round(self._lat_sum / self._lat_count, 3),
                    "min_ms": round(self._lat_min, 3),
                    "max_ms": round(self._lat_max, 3),
                    "hist_bucket_edges_ms": list(self.BUCKETS_MS),
                    "hist_counts": list(self._hist),
                }
            return {
                "uptime_s": round(time.time() - self._t0, 1),
                "requests": self.requests,
                "frames_scored": self.frames,
                "device_steps": self.device_steps,
                "errors": self.errors,
                "device_step_latency": lat,
            }


def prometheus_text(snapshots: Dict[str, dict]) -> str:
    """Render metric snapshots ({model_kind: ServiceMetrics.snapshot()+})
    in the Prometheus text exposition format (``GET
    /v1/metrics?format=prometheus``): counters become ``*_total`` series
    labeled by model kind, the device-step latency a cumulative-``le``
    histogram, the drift window's summary gauges."""
    lines = []

    def counter(name: str, help_: str, key: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} counter")
        for kind, snap in snapshots.items():
            lines.append(f'{name}{{model="{kind}"}} {snap[key]}')

    counter("vad_requests_total", "Scoring requests received.", "requests")
    counter("vad_frames_scored_total", "Frames scored.", "frames_scored")
    counter("vad_device_steps_total", "Compiled device steps executed.",
            "device_steps")
    counter("vad_errors_total", "Requests rejected with an error.", "errors")
    lines.append("# HELP vad_device_step_latency_ms Device step latency.")
    lines.append("# TYPE vad_device_step_latency_ms histogram")
    for kind, snap in snapshots.items():
        lat = snap.get("device_step_latency")
        if not lat:
            continue
        cum = 0
        for edge, count in zip(lat["hist_bucket_edges_ms"], lat["hist_counts"]):
            cum += count
            lines.append(
                f'vad_device_step_latency_ms_bucket{{model="{kind}",le="{edge}"}} {cum}'
            )
        lines.append(
            f'vad_device_step_latency_ms_bucket{{model="{kind}",le="+Inf"}} {lat["count"]}'
        )
        lines.append(f'vad_device_step_latency_ms_sum{{model="{kind}"}} {lat["sum_ms"]}')
        lines.append(f'vad_device_step_latency_ms_count{{model="{kind}"}} {lat["count"]}')
    scored = {k: s["scores"] for k, s in snapshots.items()
              if s.get("scores", {}).get("count")}
    if scored:
        for name, help_, key in (
            ("vad_score_window_mean", "Mean anomaly score over the recent window.", "mean"),
            ("vad_score_window_p50", "Median anomaly score over the recent window.", "p50"),
            ("vad_score_window_p99", "p99 anomaly score over the recent window.", "p99"),
            ("vad_score_exceed_rate", "Fraction of recent scores above the calibrated threshold (contract: expected_exceed_rate).", "exceed_rate"),
            ("vad_score_drifting", "1 when the exceedance contract is broken (see eval/drift.py).", "drifting"),
        ):
            rows = [(k, sc[key]) for k, sc in scored.items() if key in sc]
            if not rows:
                continue
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            for kind, val in rows:
                lines.append(f'{name}{{model="{kind}"}} {int(val) if isinstance(val, bool) else val}')
    alerted = {k: s["alerts"] for k, s in snapshots.items() if "alerts" in s}
    if alerted:
        for name, help_, key in (
            ("vad_alerts_delivered_total", "Webhook alerts delivered.", "delivered"),
            ("vad_alerts_failed_total", "Webhook alert deliveries failed.", "failed"),
        ):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} counter")
            for kind, alerts in alerted.items():
                lines.append(f'{name}{{model="{kind}"}} {alerts[key]}')
    return "\n".join(lines) + "\n"


def _metrics_snapshot(service) -> dict:
    """A service's ``ServiceMetrics`` snapshot with its drift window's
    summary (``scores``) and its notifier's delivery counters (``alerts``)."""
    snap = service.metrics.snapshot()
    if service.drift is not None:
        snap["scores"] = service.drift.snapshot()
    if service.notifier is not None:
        snap["alerts"] = {
            "delivered": service.notifier.delivered,
            "failed": service.notifier.failed,
        }
    return snap


def _served_state(model, variables, dtype: torch.dtype) -> dict:
    """``variables`` (a JAX-layout tree) as ``model``'s state dict in the
    served dtype, or the JAX daemon's architecture error."""
    try:
        fresh = flax_to_state_dict(model, variables)
    except (KeyError, ValueError) as exc:
        raise ValueError(_ARCHITECTURE_MISMATCH) from exc
    return checked_cast_like(fresh, model.state_dict(), dtype)


class ImageScoringService:
    """Stateless image-model scoring (no stream slots to manage).

    Requests are padded to a fixed device batch and scored one device
    step at a time under one lock: one shape, so the warm-up in the
    constructor covers cuDNN's algorithm choice for every request.

    ``model``: a port ``ConvAutoencoder``, moved to ``device`` and cast to
    ``dtype`` (the service owns it from here on); ``variables``: optional
    JAX-layout tree to load into it, ``None`` keeps its weights.

    ``mesh``: a one-process ``parallel.sharding.Mesh``: score
    data-parallel over its 'data' axis, one model replica per device, each
    taking ``batch / d`` images (the batch is rounded up to a multiple of
    the axis); ``device`` is then its first device.

    ``spatial``: also split image rows over the mesh's 'model' axis, one
    model copy per grid cell, every halo exchange written out
    (``parallel/spatial.py``, as ``MultiStreamScorer``'s spatial mode; the
    JAX service leaves them to XLA's partitioner).  Needs a mesh, the
    reconstruction scorer and H, H/16 divisible by the 'model' size.

    ``latent_stats``: path to a fitted ``latent_stats.npz`` (either
    package's ``evaluate --scorer latent`` writes one) or a loaded
    ``LatentStats``.  When given, /v1/images scores through the
    Mahalanobis latent-distance path instead of reconstruction error: the
    image score is the mean of the ``G x G`` distance map.  The statistics
    belong to the weights they were fitted on, so a hot reload must supply
    new ones (see ``reload``).  ``torch.float32`` reproduces the
    evaluator's scores; ``torch.bfloat16`` serves the same detector with
    small feature-precision shifts.  ``device`` ``None`` means CUDA.
    """

    kind = "image"

    # chunking cap: one request may hold the device lock for at most this
    # many device steps; larger requests get a 4xx and should be split
    # client-side (otherwise a single huge POST could starve every other
    # request and buffer an unbounded body in RAM)
    MAX_STEPS_PER_REQUEST = 64

    # calibrated anomaly threshold from the checkpoint (p99 of validation
    # normal scores); None = serve raw scores only
    score_threshold: Optional[float] = None
    # optional AlertNotifier (--alert-url): image serving is stateless,
    # so there are no per-stream streak alerts, but sustained
    # score-distribution drift still pages (eval/drift.py)
    notifier = None

    def __init__(self, model, variables, image_size: int, batch: int = 32,
                 dtype: Optional[torch.dtype] = None,
                 drift_window: int = 4096, drift_factor: float = 5.0,
                 latent_stats=None, device=None, mesh=None, spatial: bool = False) -> None:
        if spatial and mesh is None:
            raise ValueError("spatial=True requires a mesh")
        if latent_stats is not None and spatial:
            # the distance map lives on the fit's G x G grid, not image rows
            raise ValueError("the latent scorer does not support spatial "
                             "partitioning; use --data-parallel")
        if mesh is not None:
            device = mesh.replica_devices[0]
            batch = padded_batch_size(batch, mesh)
            if spatial:
                self._rows = spatial_frame_sharding(mesh, image_size)
        self.device = resolve_device(device)
        self.dtype = dtype = dtype or torch.bfloat16
        self.image_size = image_size
        self.batch = batch
        self.spatial = spatial
        self.stem = getattr(model, "stem", "pool")
        _f32_without_tf32(dtype, self.device)
        if variables is not None:
            load_flax_variables(model, variables)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self._latent = None
        self._state = None
        self._dfn = None
        if latent_stats is not None:
            stats = (latent_stats if isinstance(latent_stats, LatentStats)
                     else load_stats(latent_stats))
            self._latent = {
                "grid": stats.grid, "dim": stats.dim,
                "layers": tuple(stats.layers), "n_fit": stats.n_fit,
                "path": (None if isinstance(latent_stats, LatentStats)
                         else str(latent_stats)),
            }
            self._dfn = make_distance_fn(lambda m, x: m.feature_pyramid(x),
                                         stats.layers, stats.grid)
            self._state = stats_state(stats, self.device)
        if spatial:
            self._replicas = [RowSplit(copies) for copies in replicate_grid(self.model, mesh)]
            self._run = data_parallel(self._score_split, mesh)
        else:
            self._replicas = replicate(self.model, mesh)
            self._run = data_parallel(self._score_rows, mesh)
        self._lock = threading.Lock()
        self.metrics = ServiceMetrics()
        # live score-distribution monitor (eval/drift.py); calibrated
        # from the checkpoint by the caller / reload()
        self.drift = (
            ScoreWindow(window=drift_window, factor=drift_factor)
            if drift_window else None
        )
        # warm-up: the first step at the served shape
        self._score(np.zeros((batch, image_size, image_size, 3), np.uint8))

    def _score_rows(self, model, u8: torch.Tensor, state) -> torch.Tensor:
        x = u8.to(self.dtype) / 127.5 - 1.0
        if self._dfn is not None:
            maps = self._dfn(model, state, x)  # [B, G, G] f32
            return maps.reshape(maps.shape[0], -1).mean(dim=1)
        return model.reconstruction_error(x)

    def _score_split(self, split: RowSplit, u8: torch.Tensor, state) -> torch.Tensor:
        del state  # no latent scorer under the row split
        xs = [u8[:, r].to(dev).to(self.dtype) / 127.5 - 1.0
              for r, dev in zip(self._rows, split.devices)]
        return split.reconstruction_error(xs)

    @torch.no_grad()
    def _score(self, u8: np.ndarray) -> np.ndarray:
        """One device step over a full ``[batch, H, W, 3]`` uint8 batch
        (each replica's rows): f32 image scores on the host."""
        u8 = torch.as_tensor(u8, device=self.device)
        return self._run(self._replicas, u8, self._state).float().cpu().numpy()

    def score_images(self, frames: np.ndarray) -> np.ndarray:
        """Score ``n`` frames; requests larger than the device batch are
        chunked into ceil(n / batch) padded device steps server-side (up
        to MAX_STEPS_PER_REQUEST steps), so a client never has to know
        the server's batch size."""
        n = frames.shape[0]
        expect = (self.image_size, self.image_size, 3)
        if frames.ndim != 4 or frames.shape[1:] != expect or frames.dtype != np.uint8:
            raise ValueError(f"expected uint8 [n, {expect}], got {frames.dtype} {frames.shape}")
        if n == 0:
            raise ValueError("empty batch")
        limit = self.batch * self.MAX_STEPS_PER_REQUEST
        if n > limit:
            raise ValueError(
                f"request of {n} frames exceeds the per-request limit of "
                f"{limit} (batch {self.batch} x {self.MAX_STEPS_PER_REQUEST} "
                f"steps); split the request client-side"
            )
        out = np.empty(n, np.float64)
        self.metrics.record_request(n)
        with self._lock:
            for lo in range(0, n, self.batch):
                part = frames[lo : lo + self.batch]
                # a writable copy (the request body is read-only), padded
                padded = np.zeros((self.batch, *expect), np.uint8)
                padded[: part.shape[0]] = part
                t0 = time.time()
                scores = self._score(padded)
                out[lo : lo + part.shape[0]] = scores[: part.shape[0]]
                self.metrics.record_step(time.time() - t0)
        if self.drift is not None:
            self.drift.observe(out)
            if self.notifier is not None and self.drift.drifting():
                # lazy payload: built only when the cooldown is open
                self.notifier.notify(
                    lambda: {"type": "score_drift", "model": "image",
                             **self.drift.snapshot()},
                    source="__score_drift_image__",
                )
        return out

    def metrics_snapshot(self) -> dict:
        return _metrics_snapshot(self)

    def reload(self, checkpoint: str, ckpt: Optional[dict] = None,
               latent_stats: Optional[str] = None) -> None:
        """Hot-swap the served weights from a checkpoint on disk
        (POST /v1/reload).  Same architecture, resolution and stem only;
        in-flight requests finish on the old weights, the next device step
        sees the new ones.  ``ckpt``: the already-loaded dict, to skip a
        second deserialize.

        With the latent scorer the fitted statistics belong to the old
        encoder weights, so the reload must carry a ``latent_stats`` npz
        fitted on the new checkpoint, whose grid, dim and layers match the
        serving fit.  Refused otherwise: stale statistics over new weights
        would score garbage while looking healthy."""
        if ckpt is None:
            ckpt = load_checkpoint(checkpoint)
        if ckpt.get("model_type") != "image":
            raise ValueError(
                "not an image checkpoint; this server serves the image model"
            )
        check_served_image_size(ckpt.get("args") or {}, self.image_size)
        check_served_stem(ckpt.get("args") or {}, self.stem)
        new_state = self._state
        if self._latent is not None:
            if latent_stats is None:
                raise ValueError(
                    "latent scorer active: the fitted statistics belong to "
                    "the currently served weights, so /v1/reload must "
                    'include {"latent_stats": "<npz fitted on the new '
                    'checkpoint>"} (evaluate.py --scorer latent writes one)'
                )
            stats = load_stats(latent_stats)
            want = (self._latent["grid"], self._latent["dim"],
                    self._latent["layers"])
            got = (stats.grid, stats.dim, tuple(stats.layers))
            if got != want:
                raise ValueError(
                    f"latent_stats (grid, dim, layers) {got} does not match "
                    f"the serving fit {want}; restart the server to change "
                    "the scorer geometry"
                )
            new_state = stats_state(stats, self.device)
        elif latent_stats is not None:
            raise ValueError(
                "this server scores by reconstruction; start it with "
                "--latent-stats to serve the latent scorer"
            )
        variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
        new = _served_state(self.model, variables, self.dtype)
        with self._lock:
            for replica in self._replicas:
                for m in (replica.models if self.spatial else [replica]):
                    m.load_state_dict(new, strict=True)
            self._state = new_state
            self.checkpoint = str(checkpoint)
            # the checkpoint's calibrated threshold is a reconstruction-
            # score quantile; it does not apply to latent distances
            self.score_threshold = (
                None if self._latent is not None else ckpt.get("score_threshold")
            )
            if self._latent is not None:
                self._latent.update(
                    {"path": str(latent_stats), "n_fit": stats.n_fit}
                )
        if self.drift is not None:
            # new weights = new score scale; re-anchor the monitor's
            # contract (the window itself is kept: it ages out quickly)
            self.drift.recalibrate(
                self.score_threshold,
                None if self._latent is not None else serving_score_baseline(ckpt),
            )

    def close(self) -> None:
        pass

    def health(self) -> dict:
        h = {
            "model_type": "image",
            "batch": self.batch,
            "image_size": self.image_size,
            "dtype": str(self.dtype),
            "checkpoint": getattr(self, "checkpoint", None),
            "score_threshold": self.score_threshold,
            "scorer": "latent" if self._latent is not None else "recon",
            "hbm": device_memory_report(self.device),
        }
        if self._latent is not None:
            h["latent"] = dict(self._latent)
        return h


class ScoringService:
    """Thread-safe coalescing wrapper around ``MultiStreamScorer``."""

    kind = "video"
    # calibrated anomaly threshold from the checkpoint (p99 of validation
    # normal frame scores); None = serve raw scores only
    score_threshold: Optional[float] = None
    # optional AlertNotifier (--alert-url): fed each attached stream's
    # chunk scores so sustained anomalies fire webhooks
    notifier = None

    def __init__(self, scorer, slot_ttl: Optional[float] = None,
                 drift_window: int = 4096, drift_factor: float = 5.0) -> None:
        """``slot_ttl``: seconds of inactivity after which an attached
        slot may be reclaimed when capacity runs out (``--slot-ttl``).  A
        client that dies without DELETE would otherwise leak its slot
        until a server restart; with a TTL, attach() under full occupancy
        reaps expired slots (never ones with a chunk in flight) instead of
        failing.  None (default): slots are only freed by detach."""
        self.scorer = scorer
        self.slot_ttl = slot_ttl
        self._now = time.time
        self._last_activity: Dict[int, float] = {}
        _f32_without_tf32(scorer.dtype, scorer.device)
        self._lock = threading.Lock()  # guards _pending / _stop
        # serializes every mutation of the scorer's carried state: the
        # batched device step vs. attach/detach slot resets.  Without it
        # an attach()'s state zeroing can be overwritten by an in-flight
        # score_chunk whose new states derive from the pre-reset states.
        self._scorer_lock = threading.Lock()
        self._pending: Dict[int, tuple[np.ndarray, Future]] = {}
        self._wake = threading.Event()
        self._stop = False
        self.metrics = ServiceMetrics()
        # live frame-score distribution over ALL streams (eval/drift.py);
        # calibrated from the checkpoint by the caller / reload()
        self.drift = (
            ScoreWindow(window=drift_window, factor=drift_factor)
            if drift_window else None
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- slots

    def _check_slot(self, slot: int) -> int:
        if not 0 <= slot < self.scorer.num_slots:
            raise ValueError(
                f"slot {slot} out of range [0, {self.scorer.num_slots})"
            )
        return slot

    def attach(self, slot: Optional[int] = None) -> int:
        if slot is not None:
            self._check_slot(slot)
        with self._scorer_lock:
            try:
                got = self.scorer.attach(slot)
            except RuntimeError:
                if slot is not None or not self._reap_expired_locked():
                    raise
                got = self.scorer.attach(slot)
        self._last_activity[got] = self._now()
        return got

    def _reap_expired_locked(self) -> int:
        """Detach slots idle past slot_ttl (caller holds _scorer_lock);
        returns how many were reclaimed.  Slots with a pending chunk are
        active by definition and never reaped."""
        if self.slot_ttl is None:
            return 0
        now = self._now()
        reaped = 0
        with self._lock:
            pending = set(self._pending)
        for s in list(self.scorer.active_slots):
            s = int(s)
            if s in pending:
                continue
            if now - self._last_activity.get(s, now) > self.slot_ttl:
                self.scorer.detach(s)
                self._last_activity.pop(s, None)
                if self.notifier is not None:
                    self.notifier.reset(s)
                print(f"serve: reaped idle slot {s} (ttl {self.slot_ttl}s)",
                      flush=True)
                reaped += 1
        return reaped

    def detach(self, slot: int) -> None:
        self._check_slot(slot)
        with self._scorer_lock:
            self.scorer.detach(slot)
        self._last_activity.pop(slot, None)
        with self._lock:
            pend = self._pending.pop(slot, None)
        if pend is not None:
            pend[1].set_exception(RuntimeError(f"slot {slot} detached"))
        if self.notifier is not None:
            self.notifier.reset(slot)

    # ------------------------------------------------------------- score

    def submit(self, slot: int, frames: np.ndarray) -> Future:
        """Queue one chunk for ``slot``; resolves to its [chunk] scores."""
        s = self.scorer
        self._check_slot(slot)
        expect = (s.chunk,) + s.image_hw + (3,)
        if frames.shape != expect or frames.dtype != np.uint8:
            raise ValueError(f"expected uint8 {expect}, got {frames.dtype} {frames.shape}")
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("server shutting down")
            if not s._active[slot]:
                raise KeyError(f"slot {slot} not attached")
            if slot in self._pending:
                raise RuntimeError(f"slot {slot} already has a chunk in flight")
            self._pending[slot] = (frames, fut)
        self._last_activity[slot] = self._now()
        self.metrics.record_request(s.chunk)
        self._wake.set()
        return fut

    def _loop(self) -> None:
        s = self.scorer
        while True:
            self._wake.wait()
            with self._lock:
                if self._stop:
                    self._fail_pending(RuntimeError("server shutting down"))
                    return
                batch_items = dict(self._pending)
                self._pending.clear()
                self._wake.clear()
            if not batch_items:
                continue
            batch = np.zeros((s.num_slots, s.chunk) + s.image_hw + (3,), np.uint8)
            for slot, (frames, _) in batch_items.items():
                batch[slot] = frames
            try:
                # only submitting slots advance their carried (h, c): the
                # other rows of the batch are zero padding, not frames
                submitted = np.zeros(s.num_slots, bool)
                submitted[list(batch_items)] = True
                t0 = time.time()
                with self._scorer_lock:
                    out = s.score_chunk(batch, submitted=submitted)
                    still_active = s._active.copy()
                # score_chunk returns host scores, so the step is complete
                scores = out[0] if isinstance(out, tuple) else out
                self.metrics.record_step(time.time() - t0)
                for slot, (_, fut) in batch_items.items():
                    if still_active[slot]:
                        slot_scores = np.asarray(scores[slot], np.float64)
                        if self.drift is not None:
                            self.drift.observe(slot_scores)
                        if self.notifier is not None:
                            # counter update + queue put only; delivery is
                            # on the notifier's own thread
                            self.notifier.observe(
                                slot, slot_scores, self.score_threshold
                            )
                        fut.set_result(slot_scores)
                    else:
                        # detached while the chunk was on the device: its
                        # scores are NaN-masked, don't hand those out
                        fut.set_exception(
                            RuntimeError(f"slot {slot} detached during scoring")
                        )
                if (self.notifier is not None and self.drift is not None
                        and self.drift.drifting()):
                    # fleet-level distribution drift (not a per-stream
                    # anomaly) rides the same webhook with its own
                    # cooldown; the payload is built only when the
                    # cooldown lets an alert through
                    self.notifier.notify(
                        lambda: {"type": "score_drift", "model": "video",
                                 **self.drift.snapshot()},
                        source="__score_drift__",
                    )
            except Exception as exc:  # a failed step (a kernel's build or launch included)
                for _, fut in batch_items.values():
                    if not fut.done():
                        fut.set_exception(exc)

    def reload(self, checkpoint: str, ckpt: Optional[dict] = None) -> None:
        """Hot-swap the served weights from a checkpoint on disk
        (POST /v1/reload).  Attached streams keep their slots and carried
        (h, c); the swap waits only for an in-flight device step (the
        scorer lock), and the fused input block is refolded from the new
        weights.  ``ckpt``: the already-loaded dict, to skip a second
        deserialize."""
        if ckpt is None:
            ckpt = load_checkpoint(checkpoint)
        if ckpt.get("model_type") == "image":
            raise ValueError(
                "image checkpoint cannot reload a video server; this "
                "server serves the video model"
            )
        if is_memae(ckpt.get("args")) or isinstance(self.scorer.model, MemAutoencoder):
            raise ValueError(_MEMAE_NO_RELOAD)
        check_served_image_size(ckpt.get("args") or {}, self.scorer.image_size)
        check_served_stem(ckpt.get("args") or {},
                          getattr(self.scorer.model, "stem", "pool"))
        variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
        # metadata swaps under the same lock as the weights, so a scoring
        # tick never pairs new weights with the old threshold
        with self._scorer_lock:
            try:
                self.scorer.reload_variables(variables)
            except (KeyError, ValueError) as exc:
                raise ValueError(_ARCHITECTURE_MISMATCH) from exc
            self.checkpoint = str(checkpoint)
            self.score_threshold = serving_frame_threshold(ckpt)
        if self.drift is not None:
            # new weights = new score scale; re-anchor the monitor
            self.drift.recalibrate(self.score_threshold,
                                   serving_score_baseline(ckpt))

    def metrics_snapshot(self) -> dict:
        return _metrics_snapshot(self)

    def _fail_pending(self, exc: Exception) -> None:
        """Caller must hold self._lock."""
        for _, fut in self._pending.values():
            fut.set_exception(exc)
        self._pending.clear()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._fail_pending(RuntimeError("server shutting down"))
        self._wake.set()
        self._thread.join(timeout=5)

    def health(self) -> dict:
        s = self.scorer
        return {
            "model_type": "video",
            "num_slots": s.num_slots,
            "chunk": s.chunk,
            "image_size": s.image_size,
            "dtype": str(s.dtype),
            "fused_input": bool(getattr(s, "fused_input", False)),
            "active_slots": [int(i) for i in s.active_slots],
            "slot_ttl": self.slot_ttl,
            "checkpoint": getattr(self, "checkpoint", None),
            "score_threshold": self.score_threshold,
            "hbm": device_memory_report(s.device),
        }


class _HTTPServer(ThreadingHTTPServer):
    # Clients open a connection per request, so a daemon with 16 streams
    # takes up to 16 connects at once.  The stdlib's listen queue of 5
    # overflows under that: the kernel drops the extra SYNs and those
    # clients retry after 1 s, then 3 s.
    request_queue_size = 128


def _reload_path_allowed(path: str, roots) -> Optional[str]:
    """None when ``path`` resolves under one of ``roots``, else the 403
    message.  /v1/reload names a file on the daemon's disk; without this
    fence any client that can reach the port gets the daemon to open an
    arbitrary path.  Roots are resolved, so symlinks cannot escape them."""
    if not roots:
        return ("reload is disabled: this server was started without "
                "reload roots (serve.py derives them from --checkpoint/"
                "--watch; pass --reload-root to add more)")
    try:
        # non-strict: normalizes '..' and resolves existing symlinks; a
        # missing file inside a root still passes here and then 400s in
        # load_checkpoint
        p = Path(path).resolve(strict=False)
    except OSError:
        return f"unresolvable checkpoint path: {path}"
    for root in roots:
        if p == root or root in p.parents:
            return None
    return (f"checkpoint path {path} is outside the allowed reload roots "
            f"{[str(r) for r in roots]}")


def _make_handler(services: Dict[str, object], reload_roots=()):
    """Handler over a ``kind -> service`` map: a server holds an image
    service, a video service, or both (``--image-checkpoint``); each
    endpoint routes to its kind and 400s when that model is absent.
    ``reload_roots``: resolved directories POST /v1/reload may read from."""
    primary = next(iter(services.values()))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/v1/health":
                if len(services) == 1:
                    self._json(200, primary.health())
                else:
                    self._json(200, {
                        "model_type": "image+video",
                        **{k: s.health() for k, s in services.items()},
                    })
            elif url.path == "/v1/metrics":
                fmt = parse_qs(url.query).get("format", ["json"])[0]
                if fmt == "prometheus":
                    body = prometheus_text(
                        {k: s.metrics_snapshot() for k, s in services.items()}
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif len(services) == 1:
                    self._json(200, primary.metrics_snapshot())
                else:
                    self._json(200, {k: s.metrics_snapshot() for k, s in services.items()})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:
            svc = primary  # for the error-metrics fallback
            try:
                if self.path == "/v1/reload":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        req = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as exc:
                        self._json(400, {"error": f"invalid JSON body: {exc}"})
                        return
                    path = req.get("checkpoint") if isinstance(req, dict) else None
                    if not path or not isinstance(path, str):
                        self._json(400, {"error": 'body must be {"checkpoint": "<path>"}'})
                        return
                    denied = _reload_path_allowed(path, reload_roots)
                    if denied is not None:
                        self._json(403, {"error": denied})
                        return
                    # optional new fitted statistics for a latent-scoring
                    # image service; a disk path too, so same fence
                    stats_path = req.get("latent_stats")
                    if stats_path is not None:
                        if not isinstance(stats_path, str):
                            self._json(400, {"error": "latent_stats must be a path string"})
                            return
                        denied = _reload_path_allowed(stats_path, reload_roots)
                        if denied is not None:
                            self._json(403, {"error": denied})
                            return
                    if len(services) == 1:
                        svc = primary  # its own kind check gives the clearer error
                        if svc.kind == "image":
                            svc.reload(path, latent_stats=stats_path)
                        elif stats_path is not None:
                            self._json(400, {"error": "latent_stats applies to the image model only"})
                            return
                        else:
                            svc.reload(path)
                    else:
                        ckpt = load_checkpoint(path)  # loaded once, passed through
                        kind = "image" if ckpt.get("model_type") == "image" else "video"
                        svc = services[kind]
                        if kind == "image":
                            svc.reload(path, ckpt=ckpt, latent_stats=stats_path)
                        elif stats_path is not None:
                            self._json(400, {"error": "latent_stats applies to the image model only"})
                            return
                        else:
                            svc.reload(path, ckpt=ckpt)
                    self._json(200, {"reloaded": path, "model_type": svc.kind})
                    return
                if self.path == "/v1/images":
                    svc = services.get("image")
                    if svc is None:
                        svc = primary
                        self._json(400, {"error": "video model is being served; use /v1/streams"})
                        return
                    shape = tuple(
                        int(v) for v in self.headers.get("X-Frames-Shape", "").split(",")
                    )
                    # reject oversize requests BEFORE buffering the body:
                    # the declared shape bounds both the RAM this request
                    # may pin and the device steps it may serialize
                    limit = svc.batch * svc.MAX_STEPS_PER_REQUEST
                    if not shape or shape[0] > limit:
                        self._json(413, {
                            "error": f"request exceeds per-request frame "
                                     f"limit {limit}; split client-side"
                        })
                        return
                    n = int(self.headers.get("Content-Length", 0))
                    if n != int(np.prod(shape)):
                        self._json(400, {
                            "error": f"Content-Length {n} does not match "
                                     f"X-Frames-Shape {shape}"
                        })
                        return
                    frames = np.frombuffer(self.rfile.read(n), np.uint8).reshape(shape)
                    scores = svc.score_images(frames)
                    payload = {"scores": list(scores)}
                    thr = svc.score_threshold
                    if thr is not None:
                        payload["threshold"] = thr
                        payload["anomalous"] = [bool(s > thr) for s in scores]
                    self._json(200, payload)
                    return
                svc = services.get("video")
                if svc is None:
                    svc = primary
                    self._json(400, {"error": "image model is being served; use /v1/images"})
                    return
                if self.path == "/v1/streams":
                    self._json(200, {"slot": svc.attach()})
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) == 4 and parts[:2] == ["v1", "streams"] and parts[3] == "frames":
                    slot = int(parts[2])
                    shape = tuple(
                        int(v) for v in self.headers.get("X-Frames-Shape", "").split(",")
                    )
                    # validate the DECLARED shape before buffering the
                    # body (like /v1/images): a bogus or hostile
                    # Content-Length can otherwise pin arbitrary RAM
                    expect = (svc.scorer.chunk,) + svc.scorer.image_hw + (3,)
                    if shape != expect:
                        svc.metrics.record_error()
                        self._json(400, {
                            "error": f"expected X-Frames-Shape {expect}, got {shape}"
                        })
                        return
                    n = int(self.headers.get("Content-Length", 0))
                    if n != int(np.prod(shape)):
                        svc.metrics.record_error()
                        self._json(400, {
                            "error": f"Content-Length {n} does not match "
                                     f"X-Frames-Shape {shape}"
                        })
                        return
                    raw = self.rfile.read(n)
                    frames = np.frombuffer(raw, np.uint8).reshape(shape)
                    # generous bound: the warm-up built the kernels, so
                    # steady state is ms
                    scores = svc.submit(slot, frames).result(timeout=600)
                    payload = {"slot": slot, "scores": list(scores)}
                    thr = svc.score_threshold
                    if thr is not None:
                        payload["threshold"] = thr
                        payload["anomalous"] = [bool(s > thr) for s in scores]
                    self._json(200, payload)
                    return
                self._json(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, RuntimeError, OSError,
                    pickle.UnpicklingError) as exc:
                # the restricted checkpoint reader raises UnpicklingError
                svc.metrics.record_error()
                self._json(400, {"error": str(exc)})
            except (TimeoutError, FutureTimeoutError):
                svc.metrics.record_error()
                self._json(504, {"error": "scoring timed out"})

        def do_DELETE(self) -> None:
            try:
                svc = services.get("video")
                if svc is None:
                    self._json(400, {"error": "image model is being served; use /v1/images"})
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "streams"]:
                    slot = int(parts[2])
                    svc.detach(slot)
                    self._json(200, {"detached": slot})
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, RuntimeError) as exc:
                self._json(400, {"error": str(exc)})

    return Handler


class CheckpointWatcher:
    """Auto-deploy loop: polls a checkpoint file or results directory and
    hot-reloads the service when a checkpoint appears or changes
    (``--watch``).  A directory is scanned recursively for
    ``best_model.ckpt`` files (checkpoint writes are atomic renames, so a
    poll never sees a half-written file).

    Every changed candidate is attempted, newest first, the newest of each
    model kind: on a dual-model daemon the image and video retrains both
    deploy, and an undeployable newest file cannot starve an older
    deployable one.  A file that fails to reload is remembered at its
    mtime and retried only when it is written again.  Serving continues on
    the current weights through any failure.
    """

    def __init__(self, service, path, interval: float = 30.0,
                 initial: Optional[str] = None) -> None:
        self.service = service  # anything with .reload(path): a scoring
        # service, or ScoringServer (routes by checkpoint kind)
        self.path = Path(path)
        self.interval = interval
        self._stop = threading.Event()
        self._seen: Dict[str, float] = {}
        if initial is not None:
            try:
                p = Path(initial)
                self._seen[str(p.resolve())] = p.stat().st_mtime
            except OSError:
                pass
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _candidates(self):
        if self.path.is_file():
            return [self.path]
        if not self.path.is_dir():
            return []
        cands = list(self.path.rglob(f"best_model{CHECKPOINT_SUFFIX}"))
        cands.sort(key=lambda p: p.stat().st_mtime, reverse=True)
        return cands

    def _reload(self, path: str, ckpt: dict) -> None:
        """Deploy one loaded checkpoint into the right service (the target
        is a single service or a ScoringServer; either way the dict is
        passed through so the weights deserialize exactly once)."""
        services = getattr(self.service, "services", None)
        if services is None:
            self.service.reload(path, ckpt=ckpt)
            return
        kind = "image" if ckpt.get("model_type") == "image" else "video"
        svc = services.get(kind)
        if svc is None:
            raise ValueError(f"no {kind} model is being served")
        svc.reload(path, ckpt=ckpt)

    def poll_once(self) -> bool:
        """One poll step; True iff at least one reload happened."""
        # the newest CHANGED candidate per model kind (candidates come
        # newest first); older changed files of the same kind are only
        # marked seen: deploying them after the newer one would roll the
        # weights backwards
        newest_changed: Dict[str, tuple] = {}
        for p in self._candidates():
            try:
                resolved, mtime = str(p.resolve()), p.stat().st_mtime
            except OSError:
                continue  # deleted between scan and stat
            if self._seen.get(resolved) == mtime:
                continue
            try:
                ckpt = load_checkpoint(resolved)
            except Exception as exc:
                print(f"watch: cannot read {p}: {exc}", flush=True)
                self._seen[resolved] = mtime
                continue
            kind = "image" if ckpt.get("model_type") == "image" else "video"
            if kind in newest_changed:
                self._seen[resolved] = mtime  # superseded
                continue
            newest_changed[kind] = (resolved, mtime, ckpt)

        deployed = False
        for resolved, mtime, ckpt in newest_changed.values():
            try:
                self._reload(resolved, ckpt)
                print(f"watch: hot-reloaded {resolved}", flush=True)
                deployed = True
            except Exception as exc:  # keep serving on the current weights
                print(f"watch: reload of {resolved} failed: {exc}", flush=True)
            # seen either way: a failed file is retried only when it is
            # written again
            self._seen[resolved] = mtime
        return deployed

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()


class ScoringServer:
    """HTTP server wrapper; ``port=0`` binds an ephemeral port.

    Holds one service per model kind: a single image or video service, or
    both at once (``--image-checkpoint``), so one daemon serves
    /v1/images and /v1/streams.
    """

    def __init__(self, scorer=None, host: str = "0.0.0.0", port: int = 8600,
                 service=None, services: Optional[Dict[str, object]] = None,
                 reload_roots=None) -> None:
        if services is not None:
            self.services = dict(services)
        else:
            svc = service if service is not None else ScoringService(scorer)
            self.services = {svc.kind: svc}
        # primary accessor (video first): what the CLI prints
        self.service = self.services.get("video") or next(iter(self.services.values()))
        # POST /v1/reload may only read files under these resolved roots:
        # the run dirs of the checkpoints being served, plus whatever the
        # operator passed (the CLI adds --watch and --reload-root).  A
        # server built with no checkpoint paths and no explicit roots has
        # reload disabled (403 with instructions).
        roots = {
            Path(r).resolve() for r in (reload_roots or ())
        } | {
            Path(cp).resolve().parent
            for svc in self.services.values()
            if (cp := getattr(svc, "checkpoint", None))
        }
        self.reload_roots = sorted(roots)
        self.httpd = _HTTPServer(
            (host, port), _make_handler(self.services, self.reload_roots)
        )
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def reload(self, checkpoint: str, latent_stats: Optional[str] = None) -> str:
        """Route a checkpoint to the service of its kind (the watcher's
        target on dual-model servers); returns the kind reloaded.
        ``latent_stats``: new fitted statistics for an image service
        running the latent scorer (see ImageScoringService.reload)."""
        ckpt = load_checkpoint(checkpoint)  # loaded once, passed through
        kind = "image" if ckpt.get("model_type") == "image" else "video"
        svc = self.services.get(kind)
        if svc is None:
            raise ValueError(f"no {kind} model is being served")
        if kind == "image":
            svc.reload(checkpoint, ckpt=ckpt, latent_stats=latent_stats)
        elif latent_stats is not None:
            raise ValueError("latent_stats applies to the image model only")
        else:
            svc.reload(checkpoint, ckpt=ckpt)
        return kind

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        for svc in self.services.values():
            svc.close()
        if self._thread:
            self._thread.join(timeout=5)


def _image_service_from_ckpt(ckpt, checkpoint, batch, dtype: str,
                             drift_window=4096, drift_factor=5.0,
                             latent_stats=None, device=None, mesh=None, spatial=False):
    """Build an ImageScoringService from a loaded image checkpoint."""
    icfg = ImageAEConfig.from_args(ckpt.get("args", {}))
    imodel = ConvAutoencoder.from_config(icfg, device="cpu")
    ivars = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    service = ImageScoringService(
        imodel, ivars, icfg.image_size, batch=batch, dtype=getattr(torch, dtype),
        drift_window=drift_window, drift_factor=drift_factor,
        latent_stats=latent_stats, device=device, mesh=mesh, spatial=spatial,
    )
    service.checkpoint = str(checkpoint)
    # the calibrated threshold is a reconstruction-score quantile; latent
    # distances live on a different scale
    service.score_threshold = (
        None if latent_stats is not None else ckpt.get("score_threshold")
    )
    if service.drift is not None:
        service.drift.recalibrate(
            service.score_threshold,
            None if latent_stats is not None else serving_score_baseline(ckpt),
        )
    return service


def serve_from_checkpoint(
    checkpoint: str,
    host: str = "0.0.0.0",
    port: int = 8600,
    num_slots: int = 16,
    chunk: int = 16,
    dtype: str = "bfloat16",
    fused_input: Optional[bool] = None,
    data_parallel: bool = False,
    spatial_parallel: int = 1,
    image_checkpoint: Optional[str] = None,
    slot_ttl: Optional[float] = None,
    drift_window: int = 4096,
    drift_factor: float = 5.0,
    reload_roots=None,
    latent_stats: Optional[str] = None,
    device=None,
    devices=None,
) -> ScoringServer:
    """Build a ScoringServer from a checkpoint of either package.

    Video checkpoints get the coalescing multi-stream service (a MemAE
    checkpoint, ``args["model"] == "memae"``, its clip scorer: RGB uint8
    chunks of ``sequence_length`` frames, turned gray on the device; no
    ``fused_input``, mesh or hot reload); image
    checkpoints the stateless batched image service (``num_slots``
    doubles as the image batch).  ``image_checkpoint`` serves an image
    model beside the video model (``checkpoint`` must then be a video
    one): /v1/streams and /v1/images both live, /v1/reload routed by the
    checkpoint's kind.  ``latent_stats`` serves /v1/images through the
    latent-distance scorer with this fitted npz.  ``fused_input`` ``None``
    means on for a batch-norm, pool-stem model on the card.
    ``slot_ttl``: reclaim video slots idle longer than this many seconds
    when attach() finds no free slot.  ``drift_window`` /
    ``drift_factor``: the online score-distribution monitor per model
    kind (window 0 disables).  ``device`` ``None`` means CUDA.

    ``data_parallel``: one model replica per local device of ``device``'s
    type (``devices``, when given, names them: a device may repeat), the
    video slots (rounded up to a multiple of their count) and the image
    batch split over them.  ``spatial_parallel`` N > 1 also splits each
    frame's rows over N of them (a ``get_mesh(devices, model_parallel=N)``
    grid, as JAX's daemon builds over every chip: one card raises JAX's
    "not divisible" unless ``devices`` repeats it); the scorer and the
    image service run their spatial mode.

    The scorer is warmed with one step before the server accepts traffic:
    on the card that first call builds the kernels and picks cuDNN's
    algorithms, and neither may land in a request."""
    device = resolve_device(device)
    spatial = int(spatial_parallel or 1) > 1
    mesh = None
    if data_parallel or spatial:
        mesh = get_mesh(devices if devices is not None else local_devices(device),
                        model_parallel=int(spatial_parallel or 1))
        data_n = mesh.shape[DATA_AXIS]
        num_slots = ((num_slots + data_n - 1) // data_n) * data_n
    ckpt = load_checkpoint(checkpoint)
    print("warming up (the first step builds the kernels)...", flush=True)

    if ckpt.get("model_type") == "image":
        if image_checkpoint:
            raise ValueError(
                "--checkpoint must be the VIDEO model when --image-checkpoint "
                "is given (got two image checkpoints)"
            )
        service = _image_service_from_ckpt(
            ckpt, checkpoint, num_slots, dtype,
            drift_window=drift_window, drift_factor=drift_factor,
            latent_stats=latent_stats, device=device, mesh=mesh, spatial=spatial,
        )
        return ScoringServer(host=host, port=port, service=service,
                             reload_roots=reload_roots)

    if is_memae(ckpt.get("args")):
        scorer = _memae_scorer_from_ckpt(ckpt, num_slots, chunk, dtype, fused_input, device,
                                         mesh, spatial)
    else:
        scorer = _video_scorer_from_ckpt(ckpt, num_slots, chunk, dtype, fused_input, device,
                                         mesh, spatial)
    # build the kernels and pay the first step before accepting traffic
    warm = np.zeros((num_slots, chunk) + scorer.image_hw + (3,), np.uint8)
    scorer.score_chunk(warm)
    vsvc = ScoringService(scorer, slot_ttl=slot_ttl,
                          drift_window=drift_window, drift_factor=drift_factor)
    vsvc.checkpoint = str(checkpoint)
    vsvc.score_threshold = serving_frame_threshold(ckpt)
    if vsvc.drift is not None:
        vsvc.drift.recalibrate(vsvc.score_threshold,
                               serving_score_baseline(ckpt))
    services: Dict[str, object] = {"video": vsvc}
    if image_checkpoint:
        ickpt = load_checkpoint(image_checkpoint)
        if ickpt.get("model_type") != "image":
            raise ValueError("--image-checkpoint must be an image checkpoint")
        services["image"] = _image_service_from_ckpt(
            ickpt, image_checkpoint, num_slots, dtype,
            drift_window=drift_window, drift_factor=drift_factor,
            latent_stats=latent_stats, device=device, mesh=mesh, spatial=spatial,
        )
    elif latent_stats is not None:
        raise ValueError(
            "--latent-stats applies to the image model; this daemon serves "
            "only a video checkpoint (add --image-checkpoint)"
        )
    return ScoringServer(host=host, port=port, services=services,
                         reload_roots=reload_roots)


def _video_scorer_from_ckpt(ckpt: dict, num_slots: int, chunk: int, dtype: str,
                            fused_input: Optional[bool], device, mesh,
                            spatial: bool) -> MultiStreamScorer:
    cfg = VideoAEConfig.from_args(ckpt.get("args", {}))
    if fused_input and cfg.stem != "pool":
        raise ValueError(
            "--fused-input folds conv1+max-pool into one kernel; "
            f"this checkpoint uses the '{cfg.stem}' stem which has no pool "
            "(and no full-res intermediate to fuse away — serve it plain)"
        )
    model = VideoAutoencoder.from_config(cfg, device="cpu")
    variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    return MultiStreamScorer(
        model, variables, num_slots=num_slots, chunk=chunk,
        image_size=cfg.image_size, dtype=getattr(torch, dtype), fused_input=fused_input,
        device=device, mesh=mesh, spatial=spatial,
    )


def _memae_scorer_from_ckpt(ckpt: dict, num_slots: int, chunk: int, dtype: str,
                            fused_input: Optional[bool], device, mesh,
                            spatial: bool) -> MultiStreamScorer:
    """A MemAE checkpoint: ``args`` from ``MemAEConfig.to_dict`` and the
    weights under ``state_dict`` by the official module names."""
    if fused_input:
        raise ValueError("--fused-input folds the ConvLSTM model's first block; "
                         "a MemAE checkpoint has none (serve it without the flag)")
    cfg = MemAEConfig.from_args(ckpt["args"])
    model = MemAutoencoder.from_config(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ckpt["state_dict"].items()},
                          strict=True)
    return MultiStreamScorer(
        model, None, num_slots=num_slots, chunk=chunk, image_size=cfg.image_size,
        dtype=getattr(torch, dtype), fused_input=False, device=device, mesh=mesh,
        spatial=spatial,
    )
