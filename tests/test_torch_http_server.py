"""The port's serving daemon against the JAX package's, on the CPU.

Both daemons serve the same checkpoints (written by the JAX package's
``save_checkpoint``; a port-trained one too), f32, the JAX side on its
plain ``backend='xla'`` scorer and the port's with ``device='cpu'``.  The
same seeded frames go through both in interleaved multi-slot ticks, with
attach, detach and a reload mid-stream, each daemon driven by the other
package's client; ``/v1/images`` scores by reconstruction and by the
latent scorer (the JAX fit's npz served by both); and the same bad
requests must give the same status code and error string.

Bar: f32 rtol 1e-4 / atol 1e-5, chunk by chunk.
"""

import http.client
import json
import pickle
import threading

import jax
import numpy as np
import pytest

from vad_tpu.eval import http_server as jax_http
from vad_tpu.eval.client import ScoringClient as JaxClient
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.eval import http_server
from vad_tpu_torch.eval.client import ScoringClient, ScoringError
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.utils.weights import state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
SIZE, SLOTS, CHUNK, IMAGE_BATCH = 64, 3, 4, 3
VIDEO_ARGS = {"image_size": SIZE, "latent_dim": 32, "lstm_hidden_dim": 32, "lstm_layers": 2}
IMAGE_ARGS = {"image_size": SIZE, "latent_dim": 64}


def video_tree(seed, **kw):
    args = {**VIDEO_ARGS, **kw}
    model = VideoAutoencoder(latent_dim=args["latent_dim"], lstm_hidden_dim=args["lstm_hidden_dim"],
                             lstm_layers=args["lstm_layers"], stem=args.get("stem", "pool"),
                             device="cpu")
    return state_dict_to_flax(init_weights(model, seed))


def image_tree(seed, latent_dim=64):
    return state_dict_to_flax(init_weights(ConvAutoencoder(latent_dim=latent_dim, device="cpu"),
                                           seed))


def write(path, model_type, tree, args, **extra):
    """A checkpoint as the JAX package writes it."""
    jax_save_checkpoint(path, {"model_type": model_type, "params": tree["params"],
                               "batch_stats": tree["batch_stats"], "args": args, **extra})
    return str(path)


def u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Video and image checkpoints (two of each kind for reloads), the
    JAX fit's latent statistics for both image checkpoints, and checkpoints
    each daemon must refuse."""
    import jax.numpy as jnp

    from vad_tpu.eval.latent_score import fit_latent_stats, save_stats
    from vad_tpu.models.autoencoder import ConvAutoencoder as JaxImageModel

    d = tmp_path_factory.mktemp("serve")
    out = {"dir": d}
    baseline = {"count": 64, "mean": 0.3, "std": 0.01, "p50": 0.3, "p90": 0.31, "p99": 0.32}
    for name, seed in (("video_a", 0), ("video_b", 1)):
        out[name] = write(d / f"{name}.ckpt", "video", video_tree(seed), VIDEO_ARGS,
                          frame_score_threshold=0.33 + 0.01 * seed, score_baseline=baseline)
    fit_x = u8(50, 8, SIZE, SIZE, 3).astype(np.float32) / 127.5 - 1.0
    jmodel = JaxImageModel(latent_dim=64)
    for name, seed in (("image_a", 2), ("image_b", 3)):
        tree = image_tree(seed)
        out[name] = write(d / f"{name}.ckpt", "image", tree, IMAGE_ARGS, score_threshold=0.4)
        variables = jax.tree.map(jnp.asarray, tree)
        stats = fit_latent_stats(
            lambda v, x: jmodel.apply(v, x, method=JaxImageModel.feature_pyramid),
            variables, [fit_x[:4], fit_x[4:]], proj_dim=16)
        out[f"stats_{name[-1]}"] = str(d / f"stats_{name[-1]}.npz")
        save_stats(out[f"stats_{name[-1]}"], stats)
    stats = fit_latent_stats(
        lambda v, x: jmodel.apply(v, x, method=JaxImageModel.feature_pyramid),
        jax.tree.map(jnp.asarray, image_tree(2)), [fit_x[:4]], proj_dim=8)
    out["stats_other"] = str(d / "stats_other.npz")
    save_stats(out["stats_other"], stats)
    out["video_narrow"] = write(d / "video_narrow.ckpt", "video", video_tree(4, latent_dim=16),
                                {**VIDEO_ARGS, "latent_dim": 16})
    out["video_128"] = write(d / "video_128.ckpt", "video", video_tree(0),
                             {**VIDEO_ARGS, "image_size": 128})
    out["video_stride2"] = write(d / "video_stride2.ckpt", "video", video_tree(0),
                                 {**VIDEO_ARGS, "stem": "stride2"})

    class Payload:
        def __reduce__(self):
            return (print, ("never run",))

    out["crafted"] = str(d / "crafted.ckpt")
    with open(out["crafted"], "wb") as f:
        pickle.dump({"model_type": "video", "params": Payload()}, f)
    return out


def serve_pair(video=None, image=None, latent_stats=None, roots=()):
    """The JAX and the port daemon on the same checkpoints, f32, started."""
    servers = {}
    for side, serve, kw in (("jax", jax_http.serve_from_checkpoint, {}),
                            ("port", http_server.serve_from_checkpoint, {"device": "cpu"})):
        srv = serve(video or image, host="127.0.0.1", port=0, num_slots=SLOTS, chunk=CHUNK,
                    dtype="float32", image_checkpoint=image if video else None,
                    latent_stats=latent_stats, reload_roots=list(roots), **kw)
        srv.start_background()
        servers[side] = srv
    return servers


@pytest.fixture(scope="module")
def dual(ckpts):
    """Video + recon image daemons of both packages."""
    servers = serve_pair(ckpts["video_a"], ckpts["image_a"], roots=[ckpts["dir"]])
    yield servers
    for srv in servers.values():
        srv.close()


@pytest.fixture(scope="module")
def latent(ckpts):
    """Image-only daemons of both packages on the latent scorer."""
    servers = serve_pair(image=ckpts["image_a"], latent_stats=ckpts["stats_a"],
                         roots=[ckpts["dir"]])
    yield servers
    for srv in servers.values():
        srv.close()


@pytest.fixture
def fresh(dual, ckpts):
    """Both dual daemons with every slot detached and video_a served."""
    for srv in dual.values():
        svc = srv.services["video"]
        for slot in list(svc.scorer.active_slots):
            svc.detach(int(slot))
        if svc.checkpoint != ckpts["video_a"]:
            srv.reload(ckpts["video_a"])
    return dual


def req(srv, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def post_frames(srv, slot, frames):
    return req(srv, "POST", f"/v1/streams/{slot}/frames", body=frames.tobytes(),
               headers={"X-Frames-Shape": ",".join(map(str, frames.shape))})


# ---------------------------------------------------------------- video


def run_tick(client, chunks):
    """Submit ``{slot: frames}`` concurrently (one thread each, so the
    daemon coalesces them into shared ticks); ``{slot: response}``."""
    out, errors = {}, []

    def one(slot, frames):
        try:
            out[slot] = client.score_chunk(slot, frames)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=item) for item in chunks.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return out


def test_video_scores_match_jax_through_ticks_attach_detach_reload(fresh, ckpts):
    """Chunk-by-chunk parity over a script of ticks; the port's daemon is
    driven by the JAX client and the JAX daemon by the port's."""
    clients = {"jax": ScoringClient("127.0.0.1", fresh["jax"].port),
               "port": JaxClient("127.0.0.1", fresh["port"].port)}
    got = {side: [] for side in clients}
    for side, c in clients.items():
        slots = [c.attach() for _ in range(SLOTS)]
        assert slots == [0, 1, 2]
        script = [("tick", [0, 1, 2]), ("tick", [0, 2]), ("tick", [1]),
                  ("detach", 1), ("attach", 1), ("tick", [0, 1]),
                  ("reload", ckpts["video_b"]), ("tick", [0, 1, 2]), ("tick", [2, 0])]
        for step, (what, arg) in enumerate(script):
            if what == "tick":
                resp = run_tick(c, {s: u8(1000 * step + s, CHUNK, SIZE, SIZE, 3) for s in arg})
                got[side].append({s: resp[s] for s in sorted(resp)})
            elif what == "detach":
                c.detach(arg)
            elif what == "attach":
                assert c.attach() == arg  # the freed slot, state zeroed
            else:
                assert c.reload(arg) == {"reloaded": arg, "model_type": "video"}
        assert c.health()["video"]["active_slots"] == [0, 1, 2]
        for s in range(SLOTS):
            c.detach(s)
    for tick_jax, tick_port in zip(got["jax"], got["port"], strict=True):
        assert tick_jax.keys() == tick_port.keys()
        for slot, want in tick_jax.items():
            have = tick_port[slot]
            np.testing.assert_allclose(have["scores"], want["scores"], **F32)
            assert have["slot"] == want["slot"] == slot
            assert have["threshold"] == want["threshold"]
            assert have["anomalous"] == [s > have["threshold"] for s in have["scores"]]
    # the reload took: the last ticks score under video_b's threshold
    assert got["port"][-1][0]["threshold"] == 0.34


def test_idle_slot_state_does_not_move(fresh):
    """A neighbour's ticks leave an idle stream's carried state alone: its
    second chunk scores as a direct scorer fed its two chunks back to back."""
    from vad_tpu_torch.eval.serving import MultiStreamScorer

    srv = fresh["port"]
    c = ScoringClient("127.0.0.1", srv.port)
    a, b = c.attach(), c.attach()
    chunk_b = u8(7, CHUNK, SIZE, SIZE, 3)
    first = c.score_chunk(b, chunk_b)["scores"]
    for i in range(3):
        c.score_chunk(a, u8(8 + i, CHUNK, SIZE, SIZE, 3))
    second = c.score_chunk(b, chunk_b)["scores"]
    served = srv.services["video"].scorer
    model = VideoAutoencoder(**{k: VIDEO_ARGS[k] for k in ("latent_dim", "lstm_hidden_dim",
                                                           "lstm_layers")}, device="cpu")
    model.load_state_dict(served.model.state_dict())
    ref = MultiStreamScorer(model, None, SLOTS, CHUNK, SIZE, device="cpu")
    slot = ref.attach()
    want = [ref.score_streams({slot: list(chunk_b)})[slot] for _ in range(2)]
    np.testing.assert_allclose(first, want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(second, want[1], rtol=1e-6, atol=1e-7)
    c.detach(a)
    c.detach(b)


# ---------------------------------------------------------------- images


def test_image_scores_match_jax_through_reload(dual, ckpts):
    """Recon scores, a request over the device batch (two padded steps),
    then a reload to other weights; the JAX client drives the port."""
    clients = {"jax": ScoringClient("127.0.0.1", dual["jax"].port),
               "port": JaxClient("127.0.0.1", dual["port"].port)}
    got = {}
    for side, c in clients.items():
        got[side] = [c.score_images(u8(20, 5, SIZE, SIZE, 3)),
                     c.score_images(u8(21, 1, SIZE, SIZE, 3))]
        assert c.reload(ckpts["image_b"])["model_type"] == "image"
        got[side].append(c.score_images(u8(20, 5, SIZE, SIZE, 3)))
        c.reload(ckpts["image_a"])
    for want, have in zip(got["jax"], got["port"], strict=True):
        np.testing.assert_allclose(have["scores"], want["scores"], **F32)
        assert have["threshold"] == want["threshold"] == 0.4
    assert not np.allclose(got["port"][0]["scores"], got["port"][2]["scores"])


def test_latent_scores_match_jax_through_reload(latent, ckpts):
    """The latent scorer (the JAX fit's npz, its projection included) in
    both daemons, before and after a reload that brings new statistics."""
    got = {}
    for side, srv in latent.items():
        c = ScoringClient("127.0.0.1", srv.port)
        h = c.health()
        assert h["scorer"] == "latent" and h["score_threshold"] is None
        got[side] = [c.score_images(u8(30, 4, SIZE, SIZE, 3))]
        c._request("POST", "/v1/reload", body=json.dumps(
            {"checkpoint": ckpts["image_b"], "latent_stats": ckpts["stats_b"]}).encode())
        got[side].append(c.score_images(u8(30, 4, SIZE, SIZE, 3)))
        assert c.health()["latent"]["path"] == ckpts["stats_b"]
        c._request("POST", "/v1/reload", body=json.dumps(
            {"checkpoint": ckpts["image_a"], "latent_stats": ckpts["stats_a"]}).encode())
    for want, have in zip(got["jax"], got["port"], strict=True):
        np.testing.assert_allclose(have["scores"], want["scores"], **F32)
        assert "threshold" not in have


# ------------------------------------------------------------- protocol


def _pending_chunk(srv):
    """Hold a fake chunk in flight for slot 0 (attached) while the request
    runs; remove it after."""
    svc = srv.services["video"]
    svc.attach(0)
    with svc._lock:
        svc._pending[0] = (None, None)
    try:
        return post_frames(srv, 0, np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8))
    finally:
        with svc._lock:
            svc._pending.pop(0)
        svc.detach(0)


def _attached(call):
    def run(srv):
        svc = srv.services["video"]
        slot = svc.attach()
        try:
            return call(srv, slot)
        finally:
            svc.detach(slot)
    return run


def _reload(body):
    return lambda c: (lambda srv: req(srv, "POST", "/v1/reload",
                                      body=json.dumps(body(c)).encode()))


FRAMES_SHAPE = f"{CHUNK},{SIZE},{SIZE},3"
# (daemon, request): the same request against both packages' daemons.
BAD_REQUESTS = {
    "frames_wrong_shape": ("dual", lambda c: _attached(
        lambda srv, s: post_frames(srv, s, np.zeros((CHUNK + 1, SIZE, SIZE, 3), np.uint8)))),
    "frames_wrong_dtype": ("dual", lambda c: _attached(
        lambda srv, s: req(srv, "POST", f"/v1/streams/{s}/frames",
                           body=np.zeros((CHUNK, SIZE, SIZE, 3), np.float32).tobytes(),
                           headers={"X-Frames-Shape": FRAMES_SHAPE}))),
    "frames_unknown_slot": ("dual", lambda c: lambda srv: post_frames(
        srv, 2, np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8))),
    "frames_slot_out_of_range": ("dual", lambda c: lambda srv: post_frames(
        srv, 999, np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8))),
    "frames_negative_slot": ("dual", lambda c: lambda srv: post_frames(
        srv, -1, np.zeros((CHUNK, SIZE, SIZE, 3), np.uint8))),
    "frames_bad_shape_header": ("dual", lambda c: lambda srv: req(
        srv, "POST", "/v1/streams/0/frames", body=b"x", headers={"X-Frames-Shape": "1"})),
    "double_chunk_in_flight": ("dual", lambda c: _pending_chunk),
    "delete_unknown_slot": ("dual", lambda c: lambda srv: req(srv, "DELETE", "/v1/streams/999")),
    "delete_not_an_int": ("dual", lambda c: lambda srv: req(srv, "DELETE", "/v1/streams/abc")),
    "unknown_path": ("dual", lambda c: lambda srv: req(srv, "GET", "/v1/nope")),
    "too_many_images": ("dual", lambda c: lambda srv: req(
        srv, "POST", "/v1/images", body=b"",
        headers={"X-Frames-Shape": f"{IMAGE_BATCH * 64 + 1},{SIZE},{SIZE},3"})),
    "images_length_mismatch": ("dual", lambda c: lambda srv: req(
        srv, "POST", "/v1/images", body=b"abc", headers={"X-Frames-Shape": f"2,{SIZE},{SIZE},3"})),
    "images_empty": ("dual", lambda c: lambda srv: req(
        srv, "POST", "/v1/images", body=b"", headers={"X-Frames-Shape": f"0,{SIZE},{SIZE},3"})),
    "images_wrong_size": ("dual", lambda c: lambda srv: req(
        srv, "POST", "/v1/images", body=bytes(2 * 32 * 32 * 3),
        headers={"X-Frames-Shape": "2,32,32,3"})),
    "streams_on_image_daemon": ("latent", lambda c: lambda srv: req(srv, "POST", "/v1/streams")),
    "reload_bad_json": ("dual", lambda c: lambda srv: req(srv, "POST", "/v1/reload",
                                                          body=b"not json")),
    "reload_not_a_dict": ("dual", _reload(lambda c: ["x"])),
    "reload_outside_roots": ("dual", _reload(lambda c: {"checkpoint": "/etc/passwd"})),
    "reload_missing_file": ("dual", _reload(lambda c: {"checkpoint": str(c["dir"] / "no.ckpt")})),
    "reload_crafted_pickle": ("dual", _reload(lambda c: {"checkpoint": c["crafted"]})),
    "reload_other_architecture": ("dual", _reload(lambda c: {"checkpoint": c["video_narrow"]})),
    "reload_other_image_size": ("dual", _reload(lambda c: {"checkpoint": c["video_128"]})),
    "reload_other_stem": ("dual", _reload(lambda c: {"checkpoint": c["video_stride2"]})),
    "reload_stats_for_video": ("dual", _reload(
        lambda c: {"checkpoint": c["video_a"], "latent_stats": c["stats_a"]})),
    "reload_recon_with_stats": ("dual", _reload(
        lambda c: {"checkpoint": c["image_a"], "latent_stats": c["stats_a"]})),
    "reload_video_into_image_daemon": ("latent", _reload(lambda c: {"checkpoint": c["video_a"]})),
    "latent_reload_without_stats": ("latent", _reload(lambda c: {"checkpoint": c["image_a"]})),
    "latent_reload_stats_not_a_path": ("latent", _reload(
        lambda c: {"checkpoint": c["image_a"], "latent_stats": 3})),
    "latent_reload_other_geometry": ("latent", _reload(
        lambda c: {"checkpoint": c["image_a"], "latent_stats": c["stats_other"]})),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_request_gives_the_jax_status_and_error(case, request, ckpts):
    daemon, make = BAD_REQUESTS[case]
    servers = request.getfixturevalue("fresh" if daemon == "dual" else daemon)
    call = make(ckpts)
    status, body = call(servers["jax"])
    assert 400 <= status < 500, body
    assert call(servers["port"]) == (status, body)
    if daemon == "dual":
        assert servers["port"].services["video"].checkpoint == ckpts["video_a"]


def test_health_and_metrics_have_the_jax_keys(fresh):
    for srv in fresh.values():
        c = ScoringClient("127.0.0.1", srv.port)
        slot = c.attach()
        c.score_chunk(slot, u8(40, CHUNK, SIZE, SIZE, 3))
        c.score_images(u8(41, 2, SIZE, SIZE, 3))
        c.detach(slot)

    def keys(tree, depth=2):
        if not isinstance(tree, dict) or depth == 0:
            return None
        return {k: keys(v, depth - 1) for k, v in tree.items() if k != "hbm"}

    views = {side: {"health": ScoringClient("127.0.0.1", srv.port).health(),
                    "metrics": ScoringClient("127.0.0.1", srv.port).metrics()}
             for side, srv in fresh.items()}
    for what in ("health", "metrics"):
        assert keys(views["port"][what], 3) == keys(views["jax"][what], 3), what
    for kind in ("video", "image"):
        assert "hbm" in views["port"]["health"][kind]
        assert views["port"]["health"][kind]["hbm"] is None  # no card: nothing to report
    h = views["port"]["health"]["video"]
    assert (h["image_size"], h["num_slots"], h["chunk"]) == (SIZE, SLOTS, CHUNK)
    assert h["fused_input"] is False  # off on the CPU
    assert views["port"]["metrics"]["image"]["requests"] >= 1


def test_port_trained_checkpoint_is_served_by_both(tmp_path):
    """A checkpoint the port's trainer wrote, served by both daemons, each
    through its own package's client."""
    from argparse import Namespace

    from vad_tpu_torch.train.video_trainer import fit
    from vad_tpu_torch.train_video import build_parser

    class Windows:
        def __init__(self, labels, seed):
            self.labels = np.asarray(labels, np.int64)
            self.frames = u8(seed, len(labels), CHUNK, SIZE, SIZE, 3)

        def __len__(self):
            return len(self.labels)

        def __getitem__(self, i):
            return {"frames": self.frames[i], "label": self.labels[i]}

    args = build_parser().parse_args(
        ["--category", "mem", "--device", "cpu", "--latent-dim", "16", "--lstm-hidden-dim",
         "16", "--lstm-layers", "1", "--image-size", str(SIZE), "--sequence-length",
         str(CHUNK), "--batch-size", "2", "--num-workers", "0", "--epochs", "1",
         "--results-dir", str(tmp_path)])
    result = fit(Namespace(**vars(args)), Windows([0] * 2, 60), Windows([0, 1], 61), "cpu")
    ckpt = str(result["results_dir"] / "best_model.ckpt")
    servers = serve_pair(ckpt)
    try:
        got = {}
        for side, client in (("jax", JaxClient), ("port", ScoringClient)):
            c = client("127.0.0.1", servers[side].port)
            slot = c.attach()
            got[side] = [c.score_chunk(slot, u8(70 + i, CHUNK, SIZE, SIZE, 3))
                         for i in range(2)]
        for want, have in zip(got["jax"], got["port"], strict=True):
            np.testing.assert_allclose(have["scores"], want["scores"], **F32)
            assert have.get("threshold") == want.get("threshold")
    finally:
        for srv in servers.values():
            srv.close()


def test_client_errors_carry_the_status(fresh):
    c = ScoringClient("127.0.0.1", fresh["port"].port)
    with pytest.raises(ScoringError) as exc:
        c.detach(999)
    assert exc.value.status == 400 and "out of range" in exc.value.message
