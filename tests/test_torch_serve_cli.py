"""``python -m vad_tpu_torch.serve`` and the daemon's life cycle, on the CPU.

The port's parser against ``serve.py``'s (same options, defaults and
choices, plus ``--device``) and the same two parser errors; the CLI run as
a subprocess with alerting and ``--watch`` on, scored through the client
against a direct scorer, hot-reloaded by the watcher, alerting a local
webhook, and stopped by SIGINT with exit code 0; ``CheckpointWatcher.
poll_once``, slot TTL reaping, the refusals, and garbage traffic.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import serve as jax_serve_cli
from vad_tpu_torch import serve as serve_cli
from vad_tpu_torch.eval import http_server
from vad_tpu_torch.eval.client import ScoringClient
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.utils.checkpoint import save_checkpoint
from vad_tpu_torch.utils.weights import state_dict_to_flax

REPO = Path(__file__).resolve().parents[1]
SIZE, SLOTS, CHUNK = 64, 2, 4
VIDEO_ARGS = {"image_size": SIZE, "latent_dim": 16, "lstm_hidden_dim": 16, "lstm_layers": 1}
F32 = dict(rtol=1e-4, atol=1e-5)


def video_model(seed):
    return init_weights(VideoAutoencoder(latent_dim=16, lstm_hidden_dim=16, lstm_layers=1,
                                         device="cpu"), seed)


def write_video(path, seed, **extra):
    save_checkpoint(path, {"model_type": "video", **state_dict_to_flax(video_model(seed)),
                           "args": VIDEO_ARGS, **extra})
    return path


def write_image(path, seed, latent_dim=64, **extra):
    model = init_weights(ConvAutoencoder(latent_dim=latent_dim, device="cpu"), seed)
    save_checkpoint(path, {"model_type": "image", **state_dict_to_flax(model),
                           "args": {"image_size": SIZE, "latent_dim": latent_dim}, **extra})
    return path


def u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --------------------------------------------------------------- parser


def test_parser_has_the_jax_options_defaults_and_choices():
    def spec(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.required,
                         type(a).__name__) for a in parser._actions}

    got, want = spec(serve_cli.build_parser()), spec(jax_serve_cli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", None, str, False, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("flags", [["--watch", "d", "--fused-input"],
                                   ["--watch", "d", "--latent-stats", "s.npz"]],
                         ids=["watch_fused", "watch_latent"])
def test_parser_errors_match_jax(flags, monkeypatch, capsys):
    argv = ["--checkpoint", "x.ckpt", *flags]
    with pytest.raises(SystemExit) as ours:
        serve_cli.main(argv)
    ours_err = capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(SystemExit) as theirs:
        jax_serve_cli.main()
    theirs_err = capsys.readouterr().err
    assert ours.value.code == theirs.value.code == 2
    assert ours_err.splitlines()[-1].split(": error: ")[1] == \
        theirs_err.splitlines()[-1].split(": error: ")[1]


# --spatial N splits each frame's rows over N devices (JAX's daemon spans every
# chip); a host of `cards` CPU devices stands in for the cards here
@pytest.mark.parametrize("flags,cards", [(["--spatial", "2"], 2),
                                         (["--data-parallel", "--spatial", "2"], 4)],
                         ids=["spatial", "data_parallel_spatial"])
def test_spatial_cli_serves_and_answers(flags, cards, tmp_path, monkeypatch, capsys):
    """``serve_cli.main`` with ``--spatial 2`` builds a ('data', 'model')
    grid over the host's devices, serves, and answers /v1/streams chunks
    with the unsplit scorer's scores (JAX's split-against-unsplit bar)."""
    ckpt = write_video(tmp_path / "v.ckpt", 0)
    monkeypatch.setattr(http_server, "local_devices",
                        lambda device: [torch.device("cpu")] * cards)
    made = []
    build = http_server.serve_from_checkpoint
    monkeypatch.setattr(http_server, "serve_from_checkpoint",
                        lambda *a, **k: made.append(build(*a, **k)) or made[-1])
    thread = threading.Thread(target=serve_cli.main, args=([
        "--checkpoint", str(ckpt), "--host", "127.0.0.1", "--port", "0", "--slots",
        str(SLOTS), "--chunk", str(CHUNK), "--dtype", "float32", "--device", "cpu",
        *flags],), daemon=True)
    thread.start()
    deadline = time.time() + 60
    while not (made and "Serving " in capsys.readouterr().out) and time.time() < deadline:
        time.sleep(0.05)
    server = made[0]
    try:
        scorer = server.services["video"].scorer
        assert scorer.spatial and scorer.mesh.shape == {"data": cards // 2, "model": 2}
        c = ScoringClient("127.0.0.1", server.port)
        slot = c.attach()
        ref = MultiStreamScorer(video_model(0), None, SLOTS, CHUNK, SIZE, device="cpu")
        ref.attach(slot)
        for i in range(2):
            chunk = u8(i, CHUNK, SIZE, SIZE, 3)
            got = c.score_chunk(slot, chunk)["scores"]
            np.testing.assert_allclose(got, ref.score_streams({slot: list(chunk)})[slot],
                                       rtol=2e-5, atol=1e-7)
    finally:
        server.httpd.shutdown()  # serve_forever returns and main with it
        thread.join(timeout=30)
        server.close()
    assert not thread.is_alive()


def test_serve_from_checkpoint_refusals(tmp_path):
    video, image = write_video(tmp_path / "v.ckpt", 0), write_image(tmp_path / "i.ckpt", 1)
    cases = [
        (dict(checkpoint=image, image_checkpoint=image), "must be the VIDEO model"),
        (dict(checkpoint=video, image_checkpoint=video), "must be an image checkpoint"),
        (dict(checkpoint=video, latent_stats="s.npz"), "applies to the image model"),
    ]
    for kw, message in cases:
        with pytest.raises(ValueError, match=message):
            http_server.serve_from_checkpoint(**{k: str(v) for k, v in kw.items()},
                                              port=0, host="127.0.0.1", num_slots=SLOTS,
                                              chunk=CHUNK, dtype="float32", device="cpu")
    stride2 = tmp_path / "s.ckpt"
    save_checkpoint(stride2, {"model_type": "video",
                              **state_dict_to_flax(video_model(0)),
                              "args": {**VIDEO_ARGS, "stem": "stride2"}})
    with pytest.raises(ValueError, match="'stride2' stem"):
        http_server.serve_from_checkpoint(str(stride2), fused_input=True, device="cpu")


# ------------------------------------------------------------ the CLI


@pytest.fixture
def webhook():
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


def test_cli_serves_watches_alerts_and_stops_on_sigint(tmp_path, webhook):
    run = tmp_path / "runs" / "a"
    first = write_video(run / "best_model.ckpt", 0, frame_score_threshold=1e-9)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vad_tpu_torch.serve", "--checkpoint", str(first),
         "--host", "127.0.0.1", "--port", "0", "--slots", str(SLOTS), "--chunk", str(CHUNK),
         "--dtype", "float32", "--device", "cpu", "--alert-url", webhook["url"],
         "--alert-consecutive", "2", "--watch", str(tmp_path / "runs"),
         "--watch-interval", "0.2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Serving "):
                break
        assert lines and lines[-1].startswith(f"Serving {first} on 127.0.0.1:"), lines
        port = int(lines[-1].split("127.0.0.1:")[1].split(" ")[0])
        assert f"({SLOTS} slots x {CHUNK}-frame chunks, torch.float32)" in lines[-1]

        c = ScoringClient("127.0.0.1", port)
        slot = c.attach()
        chunks = [u8(i, CHUNK, SIZE, SIZE, 3) for i in range(2)]
        got = [c.score_chunk(slot, ch) for ch in chunks]
        ref = MultiStreamScorer(video_model(0), None, SLOTS, CHUNK, SIZE, device="cpu")
        ref.attach(slot)
        for ch, resp in zip(chunks, got):
            np.testing.assert_allclose(resp["scores"], ref.score_streams({slot: list(ch)})[slot],
                                       **F32)
            assert resp["threshold"] == 1e-9 and all(resp["anomalous"])
        assert webhook["event"].wait(timeout=60)  # two anomalous chunks: one alert
        assert webhook["received"][0]["type"] == "stream_anomaly"
        assert webhook["received"][0]["slot"] == slot

        # a newer retrain lands in the watched tree: hot-reloaded, slot kept
        newer = write_video(tmp_path / "runs" / "b" / "best_model.ckpt", 1)
        os.utime(newer, (time.time() + 5, time.time() + 5))
        deadline = time.time() + 60
        while c.health()["checkpoint"] != str(newer) and time.time() < deadline:
            time.sleep(0.1)
        h = c.health()
        assert h["checkpoint"] == str(newer) and h["active_slots"] == [slot]
        assert h["score_threshold"] is None and c.metrics()["alerts"]["delivered"] == 1

        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


# ---------------------------------------------------- watcher, TTL, fuzz


def image_service(seed=0, batch=2):
    model = init_weights(ConvAutoencoder(latent_dim=64, device="cpu"), seed)
    return http_server.ImageScoringService(model, None, SIZE, batch=batch, dtype=torch.float32,
                                           device="cpu")


def test_watcher_deploys_the_newest_and_survives_bad_checkpoints(tmp_path):
    svc = image_service()
    run1 = write_image(tmp_path / "a" / "best_model.ckpt", 0)
    watcher = http_server.CheckpointWatcher(svc, tmp_path, initial=str(run1))
    assert watcher.poll_once() is False  # the served checkpoint is current

    run2 = write_image(tmp_path / "b" / "best_model.ckpt", 9)
    os.utime(run2, (time.time() + 5, time.time() + 5))
    assert watcher.poll_once() is True
    assert svc.checkpoint == str(run2)
    assert watcher.poll_once() is False  # unchanged: no redeploy

    run3 = write_image(tmp_path / "c" / "best_model.ckpt", 2, latent_dim=16)  # wrong width
    os.utime(run3, (time.time() + 10, time.time() + 10))
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "best_model.ckpt").write_bytes(b"not a pickle")
    assert watcher.poll_once() is False
    assert svc.checkpoint == str(run2)  # still serving the good weights
    assert np.isfinite(svc.score_images(u8(0, 2, SIZE, SIZE, 3))).all()

    single = http_server.CheckpointWatcher(svc, run2, initial=str(run2))
    assert single.poll_once() is False
    write_image(run2, 3)
    os.utime(run2, (time.time() + 20, time.time() + 20))
    assert single.poll_once() is True


def test_watcher_deploys_each_kind_and_never_rolls_back(tmp_path):
    vsvc = http_server.ScoringService(
        MultiStreamScorer(video_model(0), None, SLOTS, CHUNK, SIZE, device="cpu"))
    isvc = image_service()
    target = SimpleNamespace(services={"video": vsvc, "image": isvc})
    try:
        now, paths = time.time(), {}
        for name, write, age, extra in (
                ("img_old", write_image, 30, {"score_threshold": 0.01}),
                ("vid", write_video, 20, {}),
                ("img_new", write_image, 10, {"score_threshold": 0.02})):
            p = write(tmp_path / name / "best_model.ckpt", 1, **extra)
            os.utime(p, (now - age, now - age))
            paths[name] = str(p)
        w = http_server.CheckpointWatcher(target, tmp_path)
        assert w.poll_once() is True
        assert (isvc.checkpoint, isvc.score_threshold) == (paths["img_new"], 0.02)
        assert vsvc.checkpoint == paths["vid"]
        assert w.poll_once() is False
        assert isvc.checkpoint == paths["img_new"]  # the older one was superseded
    finally:
        vsvc.close()


def test_slot_ttl_reaps_only_idle_slots():
    from concurrent.futures import Future

    svc = http_server.ScoringService(
        MultiStreamScorer(video_model(0), None, SLOTS, CHUNK, SIZE, device="cpu"), slot_ttl=10.0)
    try:
        clock = [1000.0]
        svc._now = lambda: clock[0]
        a, b = svc.attach(), svc.attach()
        with pytest.raises(RuntimeError):
            svc.attach()  # full, nothing expired
        clock[0] += 11.0
        with svc._lock:
            svc._pending[a] = (np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8), Future())
        assert svc.attach() == b  # b reaped and recycled; a has a chunk in flight
        with svc._lock:
            svc._pending.pop(a)
        assert sorted(int(s) for s in svc.scorer.active_slots) == [a, b]
    finally:
        svc.close()


def test_listen_queue_takes_every_streams_connect_at_once(tmp_path):
    """More connects than the stdlib's listen queue of 5 complete while the
    server accepts none (the kernel queues them), so a burst of one
    request per stream is never dropped into a SYN retry."""
    srv = http_server.serve_from_checkpoint(
        str(write_video(tmp_path / "v.ckpt", 0)), host="127.0.0.1", port=0, num_slots=SLOTS,
        chunk=CHUNK, dtype="float32", device="cpu")  # not started: nothing accepts
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(("127.0.0.1", srv.port), timeout=5))
    finally:
        for s in socks:
            s.close()
        srv.start_background()  # shutdown() waits for a running serve loop
        srv.close()
    assert len(socks) == 32


def test_garbage_traffic_never_kills_the_daemon(tmp_path):
    srv = http_server.serve_from_checkpoint(
        str(write_video(tmp_path / "v.ckpt", 0)), host="127.0.0.1", port=0, num_slots=SLOTS,
        chunk=CHUNK, dtype="float32", device="cpu")
    srv.start_background()
    try:
        for payload in (b"\x00\xff garbage\r\n\r\n",
                        b"POST /v1/streams/0/frames HTTP/1.1\r\nContent-Length: 99999\r\n"
                        b"X-Frames-Shape: 4,64,64,3\r\n\r\nshort",
                        b"POST /v1/images HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
                        b"PATCH /v1/health HTTP/1.1\r\n\r\n"):
            with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
                s.sendall(payload)
                s.shutdown(socket.SHUT_WR)
                try:
                    s.recv(4096)
                except OSError:
                    pass
        c = ScoringClient("127.0.0.1", srv.port)
        slot = c.attach()
        assert len(c.score_chunk(slot, u8(1, CHUNK, SIZE, SIZE, 3))["scores"]) == CHUNK
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/v1/images", body=b"", headers={"X-Frames-Shape": "1,1,1,3"})
        assert conn.getresponse().status == 400  # video daemon: no image model
        conn.close()
        assert c.health()["active_slots"] == [slot]
    finally:
        srv.close()

