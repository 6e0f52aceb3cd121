"""The spatial row split (``spatial=True``, ``--spatial N``) of the PyTorch
port against the JAX package's, on the CPU.

JAX splits image rows over the mesh's 'model' axis and lets XLA's SPMD
partitioner write the halo exchanges; the port writes them by hand
(``vad_tpu_torch/parallel/spatial.py``) and runs kernel 1's row form
(``convlstm_recurrence_rows``; its plain version here).  Both packages take
one variables tree and the same seeded uint8 frames; JAX runs on the 8
virtual CPU devices of ``tests/conftest.py`` (``backend='xla'``, as its
split requires), the port on a grid of CPU devices of the same shape.

- The split video scorer against JAX's split scorer and against the
  port's unsplit scorer over 3 carried chunks with error maps, for both
  norms and both stems, at ``model_parallel`` 2 and 4 (one latent row a
  shard at 64²); slot detach, reattach and idle slots.
- ``convlstm_recurrence_rows_ref`` against the unsplit recurrence and
  JAX's ``lax.scan`` at 1, 2 and 4 shards.
- The split image service against JAX's; the daemon over
  ``serve_from_checkpoint(spatial_parallel=2, devices=["cpu", "cpu"])``
  in JAX's ``test_spatial_sharded_server_parity`` protocol.
- The layouts against JAX's shardings, and every refusal JAX makes, with
  JAX's messages.

Bars: port against JAX rtol 1e-4 / atol 1e-5 (f32); split against unsplit
JAX's own: scores rtol 2e-5 / atol 1e-7, maps rtol 2e-4 / atol 1e-6,
(h, c) at the f32 bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.eval.http_server import ImageScoringService as JaxImageService
from vad_tpu.eval.serving import MultiStreamScorer as JaxScorer
from vad_tpu.models.autoencoder import ConvAutoencoder as JaxImageAE
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.models.video_autoencoder import convlstm_step as jax_convlstm_step
from vad_tpu.parallel.sharding import get_mesh as jax_get_mesh
from vad_tpu.parallel.sharding import spatial_frame_sharding as jax_frame_sharding
from vad_tpu.parallel.sharding import spatial_state_sharding as jax_state_sharding
from vad_tpu_torch.eval.client import ScoringClient
from vad_tpu_torch.eval.http_server import ImageScoringService, serve_from_checkpoint
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.ops.convlstm import convlstm_recurrence_ref, convlstm_recurrence_rows_ref
from vad_tpu_torch.parallel.sharding import (
    get_mesh,
    spatial_frame_sharding,
    spatial_state_sharding,
)
from vad_tpu_torch.utils.checkpoint import save_checkpoint

F32 = dict(rtol=1e-4, atol=1e-5)
SCORES = dict(rtol=2e-5, atol=1e-7)  # JAX's split-against-unsplit bars
MAPS = dict(rtol=2e-4, atol=1e-6)
SIZE, SLOTS, CHUNK, DEVICES = 64, 4, 3, 8


def variables_for(jmodel, seed, sample):
    """JAX init with norm statistics and biases drawn off identity."""
    init = jmodel.init(jax.random.key(seed), sample, train=False)
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name in ("bias", "mean"):
            return a + rng.normal(size=a.shape).astype(np.float32) * 0.05
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return walk(init)


def video_pair(norm="batch", stem="pool", seed=0):
    kw = dict(latent_dim=32, lstm_hidden_dim=32, lstm_layers=2, norm=norm, stem=stem)
    jmodel = JaxVAE(backend="xla", **kw)
    return jmodel, kw, variables_for(jmodel, seed, jnp.zeros((1, 2, SIZE, SIZE, 3)))


def port_mesh(model_parallel):
    return get_mesh(["cpu"] * DEVICES, model_parallel=model_parallel)


def frames(seed, slots=SLOTS, size=SIZE):
    rng = np.random.default_rng(100 + seed)
    return rng.integers(0, 256, (slots, CHUNK, size, size, 3), dtype=np.uint8)


def assert_states(ts, other, bar=F32):
    for (h, c), (oh, oc) in zip(ts.states, other.states):
        np.testing.assert_allclose(h.numpy(), np.asarray(oh), **bar)
        np.testing.assert_allclose(c.numpy(), np.asarray(oc), **bar)


# ---------------------------------------------------------------- scorer


@pytest.mark.parametrize("norm,stem,model_parallel", [
    ("batch", "pool", 2), ("batch", "pool", 4), ("group", "pool", 2), ("batch", "stride2", 2),
], ids=["batch-pool-mp2", "batch-pool-mp4-one-latent-row", "group-pool-mp2",
        "batch-stride2-mp2"])
def test_split_scorer_matches_jax_split_and_port_unsplit(norm, stem, model_parallel):
    """Scores, maps and every layer's (h, c) over 3 carried chunks."""
    jmodel, kw, variables = video_pair(norm, stem)
    js = JaxScorer(jmodel, variables, SLOTS, CHUNK, SIZE, return_maps=True,
                   mesh=jax_get_mesh(model_parallel=model_parallel), spatial=True)
    split = MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables, SLOTS, CHUNK,
                              SIZE, return_maps=True, device="cpu",
                              mesh=port_mesh(model_parallel), spatial=True)
    whole = MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables, SLOTS, CHUNK,
                              SIZE, return_maps=True, device="cpu")
    assert split.mesh.shape == {"data": DEVICES // model_parallel, "model": model_parallel}
    assert not split.fused_input
    for s in (js, split, whole):
        for slot in range(SLOTS):
            s.attach(slot)
    for k in range(3):
        batch = frames(k)
        (got, got_maps), (want, want_maps) = split.score_chunk(batch), js.score_chunk(batch)
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got_maps, want_maps, **F32)
        unsplit, unsplit_maps = whole.score_chunk(batch)
        np.testing.assert_allclose(got, unsplit, **SCORES)
        np.testing.assert_allclose(got_maps, unsplit_maps, **MAPS)
    assert_states(split, js)
    assert_states(split, whole)


def test_split_scorer_slot_reset_and_idle_slots_match_jax():
    """Detach and reattach (the slot's rows of (h, c) zeroed on every
    shard) and slots left out of a chunk (their state kept), against
    JAX's split scorer; the states setter splits what the getter joins."""
    jmodel, kw, variables = video_pair()
    js = JaxScorer(jmodel, variables, SLOTS, CHUNK, SIZE,
                   mesh=jax_get_mesh(model_parallel=2), spatial=True)
    ts = MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables, SLOTS, CHUNK, SIZE,
                           device="cpu", mesh=port_mesh(2), spatial=True)
    for s in (js, ts):
        for slot in range(SLOTS):
            s.attach(slot)
    first = frames(0)
    np.testing.assert_allclose(ts.score_chunk(first), js.score_chunk(first), **F32)
    for s in (js, ts):
        s.detach(2)
        assert s.attach(2) == 2
    assert all(float(h[2].abs().max()) == 0.0 for h, _ in ts.states)
    submitted = np.array([True, False, True, False])
    for k in (1, 2):
        np.testing.assert_allclose(ts.score_chunk(frames(k), submitted),
                                   js.score_chunk(frames(k), submitted), **F32)
    assert_states(ts, js)
    saved = ts.states
    ts.score_chunk(frames(3))
    ts.states = saved
    for (h, c), (sh, sc) in zip(ts.states, saved):
        assert torch.equal(h, sh) and torch.equal(c, sc)


def test_split_scorer_reload_matches_unsplit():
    """``reload_variables`` reaches every copy of the grid; attached slots
    keep their rows of (h, c)."""
    jmodel, kw, variables = video_pair()
    new = variables_for(jmodel, 7, jnp.zeros((1, 2, SIZE, SIZE, 3)))
    out = []
    for spatial in (True, False):
        s = MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables, SLOTS, CHUNK,
                              SIZE, device="cpu", mesh=port_mesh(2) if spatial else None,
                              spatial=spatial)
        for slot in range(SLOTS):
            s.attach(slot)
        s.score_chunk(frames(0))
        s.reload_variables(new)
        out.append(s.score_chunk(frames(1)))
    np.testing.assert_allclose(out[0], out[1], **SCORES)


# ----------------------------------------------------------- recurrence


def jax_scan(gates_x, w_h, h0, c0):
    """JAX's XLA recurrence (``ConvLSTMLayer``'s ``lax.scan``)."""
    def step(carry, g):
        h, c = jax_convlstm_step(g, *carry, w_h)
        return (h, c), h.astype(gates_x.dtype)

    final, h_seq = jax.lax.scan(step, (h0, c0), jnp.moveaxis(gates_x, 1, 0))
    return jnp.moveaxis(h_seq, 0, 1), final


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_rows_ref_matches_unsplit_and_jax_scan(shards):
    rng = np.random.default_rng(shards)
    b, t, hgt, wid, ch = 2, 4, 8, 5, 8
    gx = rng.normal(size=(b, t, hgt, wid, 4 * ch)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.2).astype(np.float32)
    h0, c0 = (rng.normal(size=(b, hgt, wid, ch)).astype(np.float32) for _ in range(2))
    rows = hgt // shards
    split = lambda a, dim: list(torch.from_numpy(a).split(rows, dim))  # noqa: E731
    seqs, finals = convlstm_recurrence_rows_ref(split(gx, 2), torch.from_numpy(w),
                                                split(h0, 1), split(c0, 1))
    assert len(seqs) == shards and seqs[0].shape == (b, t, rows, wid, ch)
    seq = torch.cat(seqs, 2).numpy()
    hf = torch.cat([f[0] for f in finals], 1).numpy()
    cf = torch.cat([f[1] for f in finals], 1).numpy()
    want_seq, (want_h, want_c) = convlstm_recurrence_ref(*(torch.from_numpy(a)
                                                          for a in (gx, w, h0, c0)))
    np.testing.assert_allclose(seq, want_seq.numpy(), **F32)
    np.testing.assert_allclose(hf, want_h.numpy(), **F32)
    np.testing.assert_allclose(cf, want_c.numpy(), **F32)
    j_seq, (j_h, j_c) = jax_scan(*(jnp.asarray(a) for a in (gx, w, h0, c0)))
    np.testing.assert_allclose(seq, np.asarray(j_seq), **F32)
    np.testing.assert_allclose(hf, np.asarray(j_h), **F32)
    np.testing.assert_allclose(cf, np.asarray(j_c), **F32)


# --------------------------------------------------------- image, daemon


@pytest.mark.parametrize("norm,stem", [("batch", "pool"), ("group", "stride2")])
def test_split_image_service_matches_jax(norm, stem):
    jmodel = JaxImageAE(latent_dim=64, norm=norm, stem=stem)
    variables = variables_for(jmodel, 0, jnp.zeros((1, SIZE, SIZE, 3)))
    imgs = np.random.default_rng(11).integers(0, 255, (5, SIZE, SIZE, 3), dtype=np.uint8)
    want = JaxImageService(jmodel, variables, SIZE, batch=4, dtype=jnp.float32,
                           mesh=jax_get_mesh(model_parallel=2), spatial=True).score_images(imgs)
    got = {}
    for spatial in (True, False):
        svc = ImageScoringService(ConvAutoencoder(latent_dim=64, norm=norm, stem=stem,
                                                  device="cpu"), variables, SIZE, batch=4,
                                  dtype=torch.float32, device="cpu",
                                  mesh=port_mesh(2) if spatial else None, spatial=spatial)
        got[spatial] = svc.score_images(imgs)
    assert svc.batch == 4
    np.testing.assert_allclose(got[True], want, **F32)
    np.testing.assert_allclose(got[True], got[False], **SCORES)


def test_spatial_daemon_follows_jax_server_parity(tmp_path):
    """JAX's ``test_spatial_sharded_server_parity``: a chunk posted to the
    split daemon scores as a plain scorer scores it; here also /v1/images
    against the unsplit image service, and the video scores against JAX's
    plain scorer."""
    jmodel, kw, variables = video_pair(seed=3)
    video = tmp_path / "v.ckpt"
    save_checkpoint(video, {"model_type": "video", **variables,
                            "args": {"image_size": SIZE, **{k: v for k, v in kw.items()}}})
    jimage = JaxImageAE(latent_dim=64)
    ivars = variables_for(jimage, 4, jnp.zeros((1, SIZE, SIZE, 3)))
    image = tmp_path / "i.ckpt"
    save_checkpoint(image, {"model_type": "image", **ivars,
                            "args": {"image_size": SIZE, "latent_dim": 64}})
    server = serve_from_checkpoint(str(video), "127.0.0.1", 0, num_slots=2, chunk=CHUNK,
                                   dtype="float32", spatial_parallel=2,
                                   image_checkpoint=str(image), device="cpu",
                                   devices=["cpu", "cpu"])
    server.start_background()
    try:
        assert server.services["video"].scorer.spatial
        assert server.services["image"].spatial
        c = ScoringClient("127.0.0.1", server.port)
        slot = c.attach()
        chunk = frames(9, slots=1)[0]
        got = c.score_chunk(slot, chunk)["scores"]
        imgs = frames(10, slots=1)[0]
        got_images = c.score_images(imgs)["scores"]
    finally:
        server.close()
    ref = MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables, 2, CHUNK, SIZE,
                            device="cpu")
    rs = ref.attach()
    batch = np.zeros((2, CHUNK, SIZE, SIZE, 3), np.uint8)
    batch[rs] = chunk
    np.testing.assert_allclose(got, ref.score_chunk(batch)[rs], rtol=2e-5, atol=1e-6)
    js = JaxScorer(jmodel, variables, 2, CHUNK, SIZE)
    js.attach(rs)
    np.testing.assert_allclose(got, js.score_chunk(batch)[rs], **F32)
    whole = ImageScoringService(ConvAutoencoder(latent_dim=64, device="cpu"), ivars, SIZE,
                                batch=2, dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(got_images, whole.score_images(imgs), **SCORES)


# ------------------------------------------------------ layouts, refusals


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_layouts_are_jax_shardings(model_parallel):
    """Model index j's rows of a frame and of the carried state are the
    rows JAX's shardings give mesh column j."""
    jmesh = jax_get_mesh(model_parallel=model_parallel)
    mesh = port_mesh(model_parallel)
    frame_shape, state_shape = (8, 2, SIZE, SIZE, 3), (8, SIZE // 16, SIZE // 16, 32)
    for ours, theirs, shape, dim in (
            (spatial_frame_sharding(mesh, SIZE), jax_frame_sharding(jmesh), frame_shape, 2),
            (spatial_state_sharding(mesh, SIZE), jax_state_sharding(jmesh), state_shape, 1)):
        index = theirs.devices_indices_map(shape)
        for j in range(model_parallel):
            rows = index[jmesh.devices[0, j]][dim]
            assert (rows.start, rows.stop) == (ours[j].start, ours[j].stop)


def jax_error(fn) -> str:
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_refusals_carry_jax_messages():
    jmodel, kw, variables = video_pair()
    jmesh, mesh = jax_get_mesh(model_parallel=2), port_mesh(2)

    def port(**k):
        return lambda: MultiStreamScorer(VideoAutoencoder(device="cpu", **kw), variables,
                                         SLOTS, CHUNK, device="cpu", **k)

    def theirs(**k):
        return lambda: JaxScorer(jmodel, variables, SLOTS, CHUNK, **k)

    for args in (dict(image_size=SIZE, spatial=True),
                 dict(image_size=SIZE, spatial=True, fused_input=True, mesh="mesh"),
                 dict(image_size=48, spatial=True, mesh="mesh")):
        ours = {**args, "mesh": mesh} if "mesh" in args else args
        want = {**args, "mesh": jmesh} if "mesh" in args else args
        assert jax_error(port(**ours)) == jax_error(theirs(**want))
    jimage = JaxImageAE(latent_dim=64)
    ivars = variables_for(jimage, 0, jnp.zeros((1, SIZE, SIZE, 3)))

    def image(size=SIZE, **k):
        return lambda: ImageScoringService(ConvAutoencoder(latent_dim=64, device="cpu"), ivars,
                                           size, batch=4, device="cpu", **k)

    def jax_image(size=SIZE, **k):
        return lambda: JaxImageService(jimage, ivars, size, batch=4, **k)

    stats = "latent_stats.npz"  # refused before it is read, in both packages
    assert jax_error(image(spatial=True)) == jax_error(jax_image(spatial=True))
    assert jax_error(image(spatial=True, mesh=mesh, latent_stats=stats)) == \
        jax_error(jax_image(spatial=True, mesh=jmesh, latent_stats=stats))
    assert jax_error(image(48, spatial=True, mesh=mesh)) == \
        jax_error(jax_image(48, spatial=True, mesh=jmesh))
    # one device: the daemon's --spatial 2 mesh is "not divisible", as JAX's
    assert jax_error(lambda: serve_from_checkpoint("unread.ckpt", spatial_parallel=2,
                                                   device="cpu")) == \
        jax_error(lambda: jax_get_mesh(jax.devices()[:1], model_parallel=2))
