"""The daemon's monitoring pieces in the port against the JAX package's, on
the CPU: ``ScoreWindow`` (same snapshots and verdicts on the same score
streams), ``AlertNotifier`` (same alerts for the same observations; streaks
and cooldowns read through its counters and a closed delivery queue, never
through timed negative waits), ``ServiceMetrics`` and ``prometheus_text``
(same text for the same snapshots), the served-checkpoint guards, the
memory report, and the video service's alert and drift wiring end to end.
"""

import json
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from vad_tpu.eval import alerts as jax_alerts
from vad_tpu.eval import drift as jax_drift
from vad_tpu.eval import http_server as jax_http
from vad_tpu.utils import precision as jax_precision
from vad_tpu.utils import profiling as jax_profiling
from vad_tpu_torch.eval import alerts, drift, http_server
from vad_tpu_torch.utils import precision, profiling

SIZE, CHUNK = 64, 4


@pytest.fixture
def webhook():
    """A local receiver that records every alert body and sets an Event."""
    received, event = [], threading.Event()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            event.set()
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield {"url": f"http://127.0.0.1:{httpd.server_address[1]}/hook",
           "received": received, "event": event}
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


# ------------------------------------------------------------ ScoreWindow


def _chunks(seed, n, lo=1, hi=9, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, scale, int(rng.integers(lo, hi))) + shift for _ in range(n)]


STREAMS = {
    # window, constructor kwargs, chunks, (chunk index, threshold, baseline) recalibrations
    "wraps_the_ring": (37, dict(threshold=0.5), _chunks(0, 120), ()),
    "oversize_chunks": (8, dict(threshold=0.0), [np.arange(-20.0, 0.0), *_chunks(1, 10)], ()),
    "no_threshold": (16, {}, _chunks(2, 20), ()),
    "drift_onset": (1000, dict(threshold=1.0, min_count=100),
                    [np.zeros(950), *_chunks(3, 30, 20, 40, scale=3.0)], ()),
    "small_window_verdict": (64, dict(threshold=1.0), _chunks(4, 40, 2, 6, scale=2.0), ()),
    "downward_drift_baseline": (
        256, dict(threshold=0.3, baseline={"p50": 0.2, "p99": 0.3, "count": 9}),
        _chunks(5, 40, scale=0.05), ()),
    "recalibrate": (100, dict(threshold=10.0), _chunks(6, 60, scale=2.0),
                    ((20, 1.0, {"p50": 0.5, "p99": 1.0}), (40, None, None))),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_score_window_matches_jax(case):
    window, kw, chunks, recal = STREAMS[case]
    ours, theirs = drift.ScoreWindow(window=window, **kw), jax_drift.ScoreWindow(window=window, **kw)
    recal = {i: (thr, base) for i, thr, base in recal}
    verdicts = []
    for i, chunk in enumerate(chunks):
        if i in recal:
            ours.recalibrate(*recal[i])
            theirs.recalibrate(*recal[i])
        ours.observe(chunk)
        theirs.observe(chunk)
        assert ours.snapshot() == theirs.snapshot(), i
        assert ours.exceed_rate() == theirs.exceed_rate()
        verdicts.append(ours.drifting())
        assert verdicts[-1] == theirs.drifting()
    if case == "drift_onset":
        assert not verdicts[0] and verdicts[-1]  # the stream does drift


@pytest.mark.parametrize("scores", [[], [0.5], list(np.linspace(0, 1, 101))])
def test_score_baseline_matches_jax(scores):
    assert drift.score_baseline(scores) == jax_drift.score_baseline(scores)


def test_score_window_concurrent_observe_loses_no_update():
    """Threads observe at once with a short switch interval: the lifetime
    count and the exceedance count equal a recount of what was sent."""
    w = drift.ScoreWindow(window=512, threshold=0.5)
    chunks = _chunks(7, 400, 1, 5)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda part: [w.observe(c) for c in part],
                                    args=(chunks[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    snap = w.snapshot()
    assert snap["total_observed"] == sum(len(c) for c in chunks)
    live = w._buf[: w._filled]
    assert w._exceed_in_window == int(np.sum(live > 0.5))


# ---------------------------------------------------------- AlertNotifier


def _drained(notifier):
    """Close the notifier: its worker delivers everything queued before the
    stop marker and exits, so the counters and the receiver are final."""
    notifier.close()
    assert not notifier._worker.is_alive()
    return notifier


OBSERVATIONS = {
    # (consecutive, cooldown), [(source, score level, threshold) | ("reset", source)]
    "streak_then_alert": ((3, 1000.0), [(0, 0.9, 0.5)] * 3),
    "clean_chunk_resets": ((2, 1000.0), [(0, 0.9, 0.5), (0, 0.1, 0.5), (0, 0.9, 0.5),
                                         (0, 0.9, 0.5)]),
    "cooldown_and_slots": ((1, 1000.0), [(0, 0.9, 0.5), (0, 0.9, 0.5), (1, 0.9, 0.5),
                                         ("reset", 0), (0, 0.9, 0.5)]),
    "no_threshold": ((1, 60.0), [(0, 0.9, None), (1, 0.9, None)]),
    "no_cooldown": ((1, 0.0), [(2, 0.9, 0.5), (2, 0.8, 0.5), (2, 0.2, 0.5)]),
}


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
def test_alert_notifier_matches_jax(case, webhook):
    (consecutive, cooldown), steps = OBSERVATIONS[case]
    got = {}
    for side, module in (("jax", jax_alerts), ("port", alerts)):
        webhook["received"].clear()
        n = module.AlertNotifier(webhook["url"], consecutive=consecutive, cooldown=cooldown)
        streaks = []
        for step in steps:
            if step[0] == "reset":
                n.reset(step[1])
                continue
            source, level, threshold = step
            n.observe(source, np.full(CHUNK, level), threshold)
            streaks.append(dict(n._streak))
        _drained(n)
        alerts_sent = [{k: v for k, v in a.items() if k != "timestamp"}
                       for a in webhook["received"]]
        got[side] = (streaks, alerts_sent, n.delivered, n.failed)
    assert got["port"] == got["jax"]
    expected = {"streak_then_alert": 1, "clean_chunk_resets": 1, "cooldown_and_slots": 3,
                "no_threshold": 0, "no_cooldown": 2}[case]
    assert got["port"][2] == expected and got["port"][3] == 0


def test_streak_below_consecutive_sends_nothing(webhook):
    n = alerts.AlertNotifier(webhook["url"], consecutive=3, cooldown=1000.0)
    hot = np.full(CHUNK, 0.9)
    n.observe(0, hot, 0.5)
    n.observe(0, hot, 0.5)
    assert n._streak[0] == 2 and 0 not in n._last_alert  # nothing enqueued
    n.observe(0, hot, 0.5)
    assert webhook["event"].wait(timeout=30)
    _drained(n)
    (alert,) = webhook["received"]
    assert alert["type"] == "stream_anomaly" and alert["slot"] == 0
    assert alert["consecutive_chunks"] == 3 and alert["frames_flagged"] == CHUNK
    assert alert["max_score"] == pytest.approx(0.9) and alert["threshold"] == 0.5
    assert n.delivered == 1


def test_delivery_failure_is_counted_and_never_raises():
    with socket.socket() as s:  # a local port with nothing listening
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n = alerts.AlertNotifier(f"http://127.0.0.1:{port}/none", consecutive=1, timeout=5.0)
    n.observe(0, np.full(CHUNK, 0.9), 0.5)
    _drained(n)
    assert (n.failed, n.delivered) == (1, 0)


def test_notify_builds_a_lazy_payload_only_when_the_cooldown_is_open(webhook):
    n = alerts.AlertNotifier(webhook["url"], cooldown=1000.0)
    built = []

    def payload():
        built.append(1)
        return {"type": "score_drift"}

    assert n.notify(payload, source="drift") is True
    assert n.notify(payload, source="drift") is False  # cooldown: not built
    assert n.notify({"type": "other"}, source="drift", cooldown=0.0) is True
    _drained(n)
    assert len(built) == 1
    assert [a["type"] for a in webhook["received"]] == ["score_drift", "other"]


# ---------------------------------------------------- metrics, Prometheus


def _metrics_pair(steps_ms, errors=0):
    pair = (jax_http.ServiceMetrics(), http_server.ServiceMetrics())
    for m in pair:
        for ms in steps_ms:
            m.record_request(CHUNK)
            m.record_step(ms / 1e3)
        for _ in range(errors):
            m.record_error()
    return pair


@pytest.mark.parametrize("steps_ms", [[], [0.5, 3.0, 7000.0], list(np.linspace(0.1, 900, 40))])
def test_service_metrics_match_jax(steps_ms):
    theirs, ours = _metrics_pair(steps_ms, errors=2)
    a, b = theirs.snapshot(), ours.snapshot()
    a.pop("uptime_s"), b.pop("uptime_s")
    assert b == a


@pytest.mark.parametrize("variant", ["counters", "latency", "scores_and_alerts"])
def test_prometheus_text_matches_jax(variant):
    snaps = {}
    for kind, steps in (("video", [2.0, 40.0]), ("image", [] if variant == "counters" else [9.0])):
        theirs, _ = _metrics_pair(steps if variant != "counters" else [])
        snaps[kind] = theirs.snapshot()
    if variant == "scores_and_alerts":
        w = drift.ScoreWindow(window=64, threshold=0.5, min_count=8)
        w.observe(np.linspace(0, 1, 32))
        snaps["video"]["scores"] = w.snapshot()
        snaps["image"]["scores"] = drift.ScoreWindow(window=8).snapshot()  # empty window
        snaps["video"]["alerts"] = {"delivered": 2, "failed": 1}
    text = http_server.prometheus_text(snaps)
    assert text == jax_http.prometheus_text(snaps)
    if variant == "scores_and_alerts":
        assert 'vad_score_drifting{model="video"} 1' in text
        assert 'vad_alerts_failed_total{model="video"} 1' in text


# ------------------------------------------------ guards, memory, scorer


GUARD_CASES = [
    ({}, 64, "pool"), ({"image_size": 64}, 64, "pool"), ({"image_size": 64}, (64, 64), "pool"),
    ({"image_size": 128}, 64, "pool"), ({"image_size": 64}, (64, 96), "pool"),
    ({"stem": "stride2"}, 64, "pool"), ({"stem": "pool"}, 64, "stride2"),
    ({"stem": "stride2"}, 64, "stride2"), ({"stem": "pool"}, 64, None),
]


@pytest.mark.parametrize("args,size,stem", GUARD_CASES)
def test_served_checkpoint_guards_match_jax(args, size, stem):
    for check, served in (("check_served_image_size", size), ("check_served_stem", stem)):
        outcome = []
        for module in (jax_precision, precision):
            try:
                getattr(module, check)(args, served)
                outcome.append(None)
            except ValueError as exc:
                outcome.append(str(exc))
        assert outcome[0] == outcome[1], check


@pytest.mark.parametrize("dtype,device,off", [("float32", "cuda", True),
                                              ("bfloat16", "cuda", False),
                                              ("float32", "cpu", False)])
def test_an_f32_service_on_the_card_scores_without_tf32(dtype, device, off):
    """Set once when the service is built, process-wide (no per-request
    toggling that another thread could interleave with)."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        http_server._f32_without_tf32(getattr(torch, dtype), torch.device(device))
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            not off, not off)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_memory_report_on_the_cpu_and_its_line():
    assert profiling.device_memory_report() is None
    assert profiling.device_memory_report("cpu") is None
    for mem in (None, {}, {"peak_gib": 1.5}, {"in_use_gib": 0.25, "peak_gib": 3.0,
                                               "limit_gib": 79.1}):
        assert profiling.format_memory_report(mem) == jax_profiling.format_memory_report(mem)


@pytest.mark.parametrize("size", [64, (64, 96)])
def test_scorer_keeps_its_image_size(size):
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

    model = VideoAutoencoder(latent_dim=16, lstm_hidden_dim=16, lstm_layers=1, device="cpu")
    scorer = MultiStreamScorer(model, None, 2, CHUNK, size, device="cpu")
    assert scorer.image_size == size
    assert scorer.image_hw == (size if isinstance(size, tuple) else (size, size))


# ------------------------------------------------ the service end to end


@pytest.fixture
def video_service():
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights

    model = init_weights(VideoAutoencoder(latent_dim=16, lstm_hidden_dim=16, lstm_layers=1,
                                          device="cpu"), 0)
    svc = http_server.ScoringService(MultiStreamScorer(model, None, 2, CHUNK, SIZE,
                                                       device="cpu"), drift_window=16)
    yield svc
    svc.close()
    assert not svc._thread.is_alive()


def test_service_streak_and_drift_alerts_reach_the_webhook(video_service, webhook):
    """A threshold below every score: a stream_anomaly after 3 chunks and a
    score_drift once the 16-score window is warm, both delivered."""
    svc = video_service
    svc.score_threshold = 1e-9
    svc.drift.recalibrate(1e-9, {"p50": 0.1, "p99": 0.2})
    svc.notifier = alerts.AlertNotifier(webhook["url"], consecutive=3, cooldown=1000.0)
    slot = svc.attach()
    frames = np.random.default_rng(0).integers(0, 256, (CHUNK, SIZE, SIZE, 3), np.uint8)
    # the fifth chunk's reply comes after the fourth tick's drift alert was
    # queued (one loop thread); both alerts' cooldowns hold it back
    for i in range(5):
        scores = svc.submit(slot, frames).result(timeout=120)
        assert scores.shape == (CHUNK,) and np.isfinite(scores).all()
        if i < 2:
            assert slot not in svc.notifier._last_alert
    assert webhook["event"].wait(timeout=30)
    snap = svc.metrics_snapshot()
    _drained(svc.notifier)
    kinds = sorted(a["type"] for a in webhook["received"])
    assert kinds == ["score_drift", "stream_anomaly"]
    assert snap["scores"]["drifting"] is True and snap["scores"]["count"] == 16
    assert snap["requests"] == 5 and snap["frames_scored"] == 5 * CHUNK
    assert svc.notifier.delivered == 2


def test_detach_during_a_step_fails_the_chunk_not_the_service(video_service):
    """A slot detached while its chunk waits on the device gets an error,
    never NaN-masked scores; the other slot's chunk scores."""
    svc = video_service
    a, b = svc.attach(), svc.attach()
    frames = np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8)
    with svc._scorer_lock:  # the loop takes the chunks, then waits here
        fa, fb = svc.submit(a, frames), svc.submit(b, frames)
        svc.scorer.detach(a)
    with pytest.raises(RuntimeError, match="detached"):
        fa.result(timeout=120)
    assert np.isfinite(fb.result(timeout=120)).all()
