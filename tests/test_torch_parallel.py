"""The port's scaling (``vad_tpu_torch/parallel/``) against the JAX
package's single-device program, on the CPU.

Step level: a 2-rank gloo group spawned here (``run_ranks``) takes train
steps on its rows of one global batch: data parallelism for the video and
the image model (a padded tail: the mask comes from global positions),
``accum_steps=2`` over dp=2 (each rank's slice of each microbatch), and
tensor parallelism of the ConvLSTM gates (tp=2, f32 and bf16).  Each is
held against JAX's own ``make_train_step`` on the global batch (``backend=
'xla'``, highest matmul precision) with the float64 anchor and the rules of
``tests/test_torch_training.py``, and against the port's 1-process step;
the BatchNorm running statistics must be equal on both ranks and match
JAX's.  Evaluators, scorer and daemon: ``--data-parallel`` over two CPU
replicas against the unsplit port and against JAX.  The spatial row split
(``--spatial``) has its own file, ``tests/test_torch_spatial.py``.

The spawned ranks import only torch and the port (this module's top level
does too); the JAX side runs in the test process.  Each spawn has its own
timeout, so a hung rendezvous fails the test.

Bars: f32 rtol 1e-4 / atol 1e-5; gradients rtol 5e-4 / atol 1e-6; bf16
rtol 0.05 / atol 0.02.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.ops.losses import mse_per_sample
from vad_tpu_torch.parallel.sharding import get_mesh
from vad_tpu_torch.train.steps import make_train_step
from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)
BF16 = dict(rtol=0.05, atol=0.02)
JAX_F32_DRIFT = 1e-2  # rel L2, port f32 vs JAX f32 (JAX's f32 step drifts up to 5.1e-3)
SIZE, T, LATENT, HIDDEN, BATCH = 32, 2, 16, 16, 4
SPAWN_TIMEOUT = 240.0
REPO = Path(__file__).resolve().parents[1]

# (case id, model, mesh model axis, n_real, accum, compute dtype)
CASES = [
    ("video-dp2-tail", "video", 1, 3, 1, None),
    ("video-dp2-accum2", "video", 1, 4, 2, None),
    ("image-dp2", "image", 1, 4, 1, None),
    ("video-tp2", "video", 2, 3, 1, None),
    ("video-tp2-bf16", "video", 2, 3, 1, "bf16"),
]


# ------------------------------------------------------------ spawning


def run_ranks(fn_name: str, world: int, tmp: Path, spec, timeout: float = SPAWN_TIMEOUT):
    """Run this module's ``fn_name(rank, world, store, spec)`` in ``world``
    fresh processes joined by a gloo group over a ``FileStore`` in
    ``tmp``; returns each rank's result (pickled by the worker)."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "spec.pkl").write_bytes(pickle.dumps(spec))
    code = ("import importlib.util, sys; "
            f"s = importlib.util.spec_from_file_location('tp_worker', {str(Path(__file__))!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            f"m.{fn_name}(int(sys.argv[1]), {world}, {str(tmp)!r})")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env, cwd=str(REPO),
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks did not finish in {timeout} s: "
                    + (tmp / "rank0.log").read_text()[-3000:])
    for log in logs:
        log.close()
    assert rcs == [0] * world, "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                                         for r in range(world))
    return [pickle.loads((tmp / f"result{r}.pkl").read_bytes()) for r in range(world)]


def _join(rank: int, world: int, tmp: str):
    from vad_tpu_torch.parallel.sharding import init_distributed

    torch.set_num_threads(2)
    init_distributed("cpu", init_method=f"file://{tmp}/store", rank=rank, world_size=world)
    return pickle.loads((Path(tmp) / "spec.pkl").read_bytes())


def _finish(rank: int, tmp: str, result) -> None:
    import torch.distributed as dist

    (Path(tmp) / f"result{rank}.pkl").write_bytes(pickle.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------- the port's step


def build(kind: str, variables):
    if kind == "video":
        model = VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=HIDDEN, lstm_layers=1,
                                 device="cpu")
    else:
        model = ConvAutoencoder(latent_dim=LATENT, device="cpu")
    return load_flax_variables(model, variables)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def port_step(case, variables, u8, mesh=None):
    """One port train step on ``mesh`` (None: one process) from
    ``variables``: (loss, full gradients and batch statistics as Flax
    leaves)."""
    from vad_tpu_torch.parallel.multihost import owned_batch_positions
    from vad_tpu_torch.parallel.sharding import _gather_full, distribute, gathered

    _, kind, _, n_real, accum, dtype = case
    model = build(kind, variables)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the weights, leaves .grad
    shardings = distribute(model, mesh, opt)
    rows = np.arange(len(u8)) if mesh is None or not mesh.distributed else \
        owned_batch_positions(mesh, len(u8), accum_steps=accum)
    compute = torch.bfloat16 if dtype == "bf16" else None
    loss = make_train_step(mse_per_sample, compute, accum_steps=accum, mesh=mesh)(
        model, opt, torch.from_numpy(u8[rows]), n_real)
    grads = build(kind, variables)
    with torch.no_grad():
        for (name, p), dst in zip(model.named_parameters(), grads.parameters()):
            g = p.grad if name not in shardings else _gather_full(p.grad, shardings[name], mesh)
            dst.copy_(g)
    with gathered(model, None, mesh):
        stats = leaves(state_dict_to_flax(model)["batch_stats"])
    return float(loss), leaves(state_dict_to_flax(grads)["params"]), stats


def step_worker(rank: int, world: int, tmp: str) -> None:
    spec = _join(rank, world, tmp)
    results = {}
    for case in CASES:
        mesh = get_mesh(model_parallel=case[2])
        variables, u8 = spec[case[1]]
        results[case[0]] = port_step(case, variables, u8, mesh)
    _finish(rank, tmp, results)


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def inputs():
    """Perturbed JAX variables and a u8 batch per model, from numpy seeds."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_training import perturbed
    from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
    from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE

    jv = JaxVAE(latent_dim=LATENT, lstm_hidden_dim=HIDDEN, lstm_layers=1, backend="xla")
    ji = JaxAE(latent_dim=LATENT)
    vinit = jv.init(jax.random.key(0), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    iinit = ji.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(4)
    return {
        "models": {"video": jv, "image": ji},
        "video": (perturbed(vinit, np.random.default_rng(3)),
                  rng.integers(0, 256, (BATCH, T, SIZE, SIZE, 3), dtype=np.uint8)),
        "image": (perturbed(iinit, np.random.default_rng(5)),
                  rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results for every case of ``CASES`` (one spawn)."""
    spec = {k: inputs[k] for k in ("video", "image")}
    return run_ranks("step_worker", 2, tmp_path_factory.mktemp("steps"), spec)


def jax_reference(inputs, case):
    """(JAX f32 loss, gradients, statistics; its float64 gradients; JAX
    bf16 ... when the case is bf16): JAX's single-device step on the
    global batch."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_training import jax_step

    _, kind, _, n_real, accum, dtype = case
    jmodel = inputs["models"][kind]
    variables, u8 = inputs[kind]
    with jax.default_matmul_precision("highest"):
        f32 = jax_step(jmodel, variables, u8, n_real, accum, None)
        bf16 = jax_step(jmodel, variables, u8, n_real, accum, jnp.bfloat16) if dtype else None
    with jax.enable_x64(True):
        variables64 = jax.tree.map(lambda a: a.astype(np.float64), variables)
        _, anchor, _ = jax_step(jmodel, variables64, u8, n_real, accum, jnp.float64)
    return f32, anchor, bf16


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- step level


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_distributed_step_matches_jax_single_device(inputs, ranks, case):
    """The 2-rank step against JAX's single-device step on the global batch.

    Loss at the f32 bar (bf16 bar under bf16).  Gradients, in f32: each at
    the gradient bar against the float64 anchor or against JAX's f32, or no
    further from the anchor than JAX's f32 gradient (the image model's
    rule, ``tests/test_torch_image_model.py``: its f32 step is
    ill-conditioned), and within ``JAX_F32_DRIFT`` of JAX's f32; in bf16 no
    further from the anchor than 1.5x JAX's bf16 gradient + 0.01.  A conv
    bias that feeds a train-mode BatchNorm has an exact gradient of 0: the
    allclose bar against the anchor only.  Both ranks return the same loss,
    gradients and statistics."""
    name, kind, mp, n_real, accum, dtype = case
    loss, grads, stats = ranks[0][name]
    other = ranks[1][name]
    assert other[0] == loss
    for a, b in zip((grads, stats), other[1:]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    (jloss, jgrads, jstats), anchor, jbf16 = jax_reference(inputs, case)
    if dtype:
        jloss, jgrads_bf16, jstats = jbf16
    np.testing.assert_allclose(loss, jloss, **(BF16 if dtype else F32))
    assert grads.keys() == jgrads.keys() == anchor.keys()
    for key, want in anchor.items():
        if np.abs(want).max() < 1e-12:  # zero by construction: rounding noise
            np.testing.assert_allclose(grads[key], want, **(BF16 if dtype else GRAD),
                                       err_msg=key)
            continue
        if dtype is None:
            assert (np.allclose(grads[key], want, **GRAD)
                    or np.allclose(grads[key], jgrads[key], **GRAD)
                    or rel_l2(grads[key], want) <= rel_l2(jgrads[key], want)), key
            assert rel_l2(grads[key], jgrads[key]) <= JAX_F32_DRIFT, key
        else:
            assert rel_l2(grads[key], want) <= 1.5 * rel_l2(jgrads_bf16[key], want) + 0.01, key
    assert stats.keys() == jstats.keys() and stats
    for key in jstats:
        np.testing.assert_allclose(stats[key], jstats[key], **(BF16 if dtype else F32),
                                   err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_distributed_step_matches_the_one_process_step(inputs, ranks, case):
    """The 2-rank step against the port's own 1-process step on the global
    batch: the loss at the f32 bar (bf16's under bf16), every gradient that
    is not zero by construction at the gradient bar (under bf16 the bf16
    bar and rel L2 <= its rtol, since the gradients are far below its
    atol), and the BatchNorm running statistics at the f32 bar.  Under tp
    (one data row, the model group spanning both ranks) the two compute
    the same sums in the same order."""
    name, kind, mp, n_real, accum, dtype = case
    variables, u8 = inputs[kind]
    loss, grads, stats = ranks[0][name]
    want_loss, want_grads, want_stats = port_step(case, variables, u8)
    bar = BF16 if dtype else F32
    np.testing.assert_allclose(loss, want_loss, **bar)
    for key, want in want_grads.items():
        if np.abs(want).max() < 1e-6 * max(np.abs(g).max() for g in want_grads.values()):
            continue  # a zero-by-construction bias: rounding noise on both sides
        np.testing.assert_allclose(grads[key], want, **(BF16 if dtype else GRAD), err_msg=key)
        if dtype:
            assert rel_l2(grads[key], want) <= BF16["rtol"], key
    for key, want in want_stats.items():
        np.testing.assert_allclose(stats[key], want, **F32, err_msg=key)
    if mp > 1 and dtype is None:
        assert loss == want_loss


def test_tensor_parallel_matches_data_parallel_only(ranks):
    """tp=2 against dp-only on the same rows (``tests/test_parallel.py``'s
    tp-vs-dp check, at one step): the same loss and gradients at the f32
    and gradient bars.  The dp case pads the same tail (n_real 3 of 4)."""
    loss_tp, grads_tp, stats_tp = ranks[0]["video-tp2"]
    loss_dp, grads_dp, stats_dp = ranks[0]["video-dp2-tail"]
    np.testing.assert_allclose(loss_tp, loss_dp, **F32)
    scale = max(np.abs(g).max() for g in grads_dp.values())
    for key, want in grads_dp.items():
        if np.abs(want).max() >= 1e-6 * scale:
            np.testing.assert_allclose(grads_tp[key], want, **GRAD, err_msg=key)
    for key, want in stats_dp.items():
        np.testing.assert_allclose(stats_tp[key], want, **F32, err_msg=key)


# ------------------------------------------- evaluators, scorer and daemon


@pytest.fixture(scope="module")
def video_model(inputs):
    model = build("video", inputs["video"][0])
    return model.eval()


def test_score_windows_data_parallel(inputs, video_model):
    """``score_windows`` over two CPU replicas (a 5-window set: batches of
    4 padded to the replicas' multiple) against the unsplit port and JAX's
    reconstruction error on the same windows, at the f32 bar."""
    import jax.numpy as jnp

    from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
    from vad_tpu_torch.eval.video_eval import score_windows

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (5, T + 2, SIZE, SIZE, 3), dtype=np.uint8)

    class Windows:
        labels = [0, 1, 0, 1, 1]

        def __len__(self):
            return len(frames)

        def __getitem__(self, i):
            return {"frames": frames[i], "label": self.labels[i]}

    mesh = get_mesh(["cpu", "cpu"])
    got = score_windows(video_model, Windows(), batch_size=3, mesh=mesh)
    want = score_windows(video_model, Windows(), batch_size=3)
    np.testing.assert_allclose(got["frame"], want["frame"], **F32)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    variables = inputs["video"][0]
    jmodel = inputs["models"]["video"]
    x = jnp.asarray(frames, jnp.float32) / 127.5 - 1.0
    jframe = np.asarray(jmodel.apply(variables, x, per_frame=True,
                                     method=JaxVAE.reconstruction_error))
    np.testing.assert_allclose(got["frame"], jframe, **F32)


def test_score_split_data_parallel(inputs):
    """The image evaluator's ``score_split`` (scores and maps) over two CPU
    replicas against the unsplit port and JAX's maps, at the f32 bar."""
    import jax.numpy as jnp

    from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
    from vad_tpu_torch.eval.image_eval import score_split

    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (7, SIZE, SIZE, 3), dtype=np.uint8)

    class Split:
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return {"image": images[i], "label": i % 2, "defect_type": "x",
                    "mask": np.zeros((SIZE, SIZE), np.float32)}

    model = build("image", inputs["image"][0]).eval()
    mesh = get_mesh(["cpu", "cpu"])
    got = score_split(model, Split(), batch_size=4, score_mode="p99", keep_maps=True,
                      mesh=mesh, num_workers=0)
    want = score_split(model, Split(), batch_size=4, score_mode="p99", keep_maps=True,
                       num_workers=0)
    np.testing.assert_allclose(got["scores"], want["scores"], **F32)
    np.testing.assert_allclose(got["maps"], want["maps"], **F32)
    x = jnp.asarray(images, jnp.float32) / 127.5 - 1.0
    jmaps = np.asarray(inputs["models"]["image"].apply(
        inputs["image"][0], x, per_pixel=True, method=JaxAE.reconstruction_error))
    np.testing.assert_allclose(got["maps"], jmaps, **F32)


def test_multistream_scorer_two_replicas(inputs, video_model):
    """``MultiStreamScorer(mesh=...)`` with two CPU replicas (2 slots each)
    against the unsplit scorer and JAX's scorer on the same chunks: every
    chunk's scores and every layer's carried (h, c), slot 2 idle on the
    second chunk (its state must not move), at the f32 bar."""
    import jax.numpy as jnp

    from vad_tpu.eval.serving import MultiStreamScorer as JaxScorer
    from vad_tpu_torch.eval.serving import MultiStreamScorer

    variables = inputs["video"][0]
    split = MultiStreamScorer(build("video", variables), num_slots=4, chunk=T, image_size=SIZE,
                              device="cpu", mesh=get_mesh(["cpu", "cpu"]))
    whole = MultiStreamScorer(build("video", variables), num_slots=4, chunk=T, image_size=SIZE,
                              device="cpu")
    jax_s = JaxScorer(inputs["models"]["video"], variables, num_slots=4, chunk=T,
                      image_size=SIZE, dtype=jnp.float32)
    assert len(split._replicas) == 2 and split._replicas[1].model is not split.model
    for s in (split, whole, jax_s):
        for slot in range(4):
            s.attach(slot)
    rng = np.random.default_rng(9)
    for k in range(2):
        chunk = rng.integers(0, 256, (4, T, SIZE, SIZE, 3), dtype=np.uint8)
        submitted = np.array([True, True, k == 0, True])
        got = split.score_chunk(chunk, submitted=submitted)
        np.testing.assert_allclose(got, whole.score_chunk(chunk, submitted=submitted), **F32)
        np.testing.assert_allclose(got, jax_s.score_chunk(chunk, submitted=submitted), **F32)
    for (h, c), (wh, wc), (jh, jc) in zip(split.states, whole.states, jax_s.states):
        np.testing.assert_allclose(h.numpy(), wh.numpy(), **F32)
        np.testing.assert_allclose(c.numpy(), wc.numpy(), **F32)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **F32)
    with pytest.raises(ValueError, match="must divide evenly"):
        MultiStreamScorer(build("video", variables), num_slots=3, chunk=T, image_size=SIZE,
                          device="cpu", mesh=get_mesh(["cpu", "cpu"]))


def test_scorer_reload_refreshes_every_replica(inputs):
    """A hot reload reaches both replicas: after it the split scorer
    matches an unsplit scorer built on the new weights."""
    from tests.test_torch_training import perturbed
    from vad_tpu_torch.eval.serving import MultiStreamScorer

    variables = inputs["video"][0]
    fresh = perturbed(variables, np.random.default_rng(11))
    split = MultiStreamScorer(build("video", variables), num_slots=2, chunk=T, image_size=SIZE,
                              device="cpu", mesh=get_mesh(["cpu", "cpu"]))
    split.reload_variables(fresh)
    whole = MultiStreamScorer(build("video", fresh), num_slots=2, chunk=T, image_size=SIZE,
                              device="cpu")
    chunk = np.random.default_rng(12).integers(0, 256, (2, T, SIZE, SIZE, 3), dtype=np.uint8)
    for s in (split, whole):
        s.attach(0), s.attach(1)
    np.testing.assert_allclose(split.score_chunk(chunk), whole.score_chunk(chunk), **F32)


def test_daemon_data_parallel_serves_like_the_unsplit_daemon(inputs, tmp_path):
    """``serve_from_checkpoint(data_parallel=True)`` over two CPU replicas:
    3 slots round up to 4 (2 a replica); two streams' scores over HTTP and
    ``/v1/images`` of an image daemon, against the unsplit daemons."""
    from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from vad_tpu_torch.eval.client import ScoringClient
    from vad_tpu_torch.eval.http_server import serve_from_checkpoint

    video_args = {"latent_dim": LATENT, "lstm_hidden_dim": HIDDEN, "lstm_layers": 1,
                  "image_size": SIZE, "sequence_length": T}
    vckpt, ickpt = tmp_path / "v.ckpt", tmp_path / "i.ckpt"
    jax_save_checkpoint(vckpt, {**inputs["video"][0], "args": video_args, "model_type": "video"})
    jax_save_checkpoint(ickpt, {**inputs["image"][0], "model_type": "image",
                                "args": {"latent_dim": LATENT, "image_size": SIZE}})
    rng = np.random.default_rng(13)
    chunks = rng.integers(0, 256, (2, 2, T, SIZE, SIZE, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (5, SIZE, SIZE, 3), dtype=np.uint8)
    out = {}
    for dp in (False, True):
        server = serve_from_checkpoint(str(vckpt), host="127.0.0.1", port=0, num_slots=3,
                                       chunk=T, dtype="float32", data_parallel=dp,
                                       image_checkpoint=str(ickpt), device="cpu",
                                       devices=["cpu", "cpu"] if dp else None)
        server.start_background()
        try:
            client = ScoringClient("127.0.0.1", server.port)
            health = client.health()
            slots = [client.attach() for _ in range(2)]
            scores = [[client.score_chunk(slot, chunk[i])["scores"]
                       for i, slot in enumerate(slots)] for chunk in chunks]
            out[dp] = (health, np.asarray(scores, np.float64),
                       np.asarray(client.score_images(images)["scores"], np.float64))
        finally:
            server.close()
    (h0, s0, i0), (h1, s1, i1) = out[False], out[True]
    assert h0["video"]["num_slots"] == 3 and h1["video"]["num_slots"] == 4
    assert h1["image"]["batch"] == 4
    np.testing.assert_allclose(s1, s0, **F32)
    np.testing.assert_allclose(i1, i0, **F32)


# ------------------------------------------------------------------ layout


def test_mesh_grid_and_param_shardings_follow_jax():
    """``get_mesh``'s data-major grid and ``convlstm_param_shardings``' rule
    (the gate weights and bias over 'model' when 4H % mp == 0, nothing
    else; nothing at mp 1) against JAX's on the same widths."""
    import jax

    from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
    from vad_tpu.parallel.sharding import convlstm_param_shardings as jax_shardings
    from vad_tpu.parallel.sharding import get_mesh as jax_get_mesh
    from vad_tpu_torch.parallel.sharding import convlstm_param_shardings

    mesh = get_mesh(["cpu"] * 8, model_parallel=2)
    assert mesh.shape == dict(jax_get_mesh(model_parallel=2).shape) == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="not divisible by model_parallel=3"):
        get_mesh(["cpu"] * 8, model_parallel=3)
    for hidden, mp in ((16, 2), (16, 8), (6, 4)):
        jmodel = JaxVAE(latent_dim=8, lstm_hidden_dim=hidden, lstm_layers=2, backend="xla")
        params = jmodel.init(jax.random.key(0), np.zeros((1, 2, 16, 16, 3), np.float32),
                             train=False)["params"]
        jmesh = jax_get_mesh(model_parallel=mp)
        want = sum(int(s.spec != jax.sharding.PartitionSpec())
                   for s in jax.tree.leaves(jax_shardings(params, jmesh)))
        model = VideoAutoencoder(latent_dim=8, lstm_hidden_dim=hidden, lstm_layers=2,
                                 device="cpu")
        got = convlstm_param_shardings(model, get_mesh(["cpu"] * 8, model_parallel=mp))
        # JAX's fused kernel and bias are the port's w_x, w_h and bias
        assert len(got) == want // 2 * 3, (hidden, mp, got)
        assert set(got.values()) <= {0, 3}
    assert convlstm_param_shardings(VideoAutoencoder(latent_dim=8, device="cpu"),
                                    get_mesh(["cpu"] * 8)) == {}
