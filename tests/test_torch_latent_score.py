"""The port's latent-distance scorer (``vad_tpu_torch/eval/latent_score.py``)
and the video model's feature pyramids against the JAX package's, on the
CPU.

``_resample``'s branches and ``upsample_maps`` at odd sizes, the fit
(given JAX's projection, or none) with uneven and expanding batches, the
distance maps, stats files read by either package, the seeded projection,
and ``VideoAutoencoder.feature_pyramid`` / ``temporal_features`` (on the
CPU ``temporal_features`` runs kernel 1's plain version).  Backbones: a
seeded JAX init (latent 16, 32 px) with biases, scales and statistics
moved off identity, loaded into the port; inputs from a numpy seed.  The
JAX video model runs its plain ``backend='xla'`` path.

Bars: f32 rtol 1e-4 / atol 1e-5 (features, resampling, the fitted mean);
distance maps rtol 1e-4 / atol 1e-4, tighter than the rtol 1e-3 the
Cholesky solve's amplification of f32 rounding could need: they read at
most 2.1e-5 relative here (the maps are distances of order 10-100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training import perturbed
from vad_tpu.eval import latent_score as jls
from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu_torch.eval import latent_score as ls
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.utils.weights import load_flax_variables

F32 = dict(rtol=1e-4, atol=1e-5)
MAPS = dict(rtol=1e-4, atol=1e-4)
SIZE, LATENT = 32, 16


@pytest.fixture(scope="module")
def image_pair():
    jmodel = JaxAE(latent_dim=LATENT)
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(1))
    model = ConvAutoencoder(latent_dim=LATENT, device="cpu")
    load_flax_variables(model, variables).eval()

    def jax_pyramid(v, x):
        return jmodel.apply(v, x, method=JaxAE.feature_pyramid)

    def port_pyramid(m, x):
        return m.feature_pyramid(x)

    return jax_pyramid, variables, port_pyramid, model


@pytest.fixture(scope="module")
def video_pair():
    jmodel = JaxVAE(latent_dim=LATENT, lstm_hidden_dim=LATENT, lstm_layers=2, backend="xla")
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(2))
    model = VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT, lstm_layers=2,
                             device="cpu")
    return jmodel, variables, load_flax_variables(model, variables).eval()


def batches(seed, sizes, shape=(SIZE, SIZE, 3)):
    rng = np.random.default_rng(seed)
    return [(0.1 + rng.normal(scale=0.3, size=(n, *shape))).astype(np.float32) for n in sizes]


@pytest.mark.parametrize("h,grid", [(8, 8), (16, 4), (12, 4), (2, 8), (3, 6),
                                    (7, 4), (5, 8), (9, 5), (3, 7)],
                         ids=["same", "pool4", "pool3", "repeat4", "repeat2",
                              "shrink7to4", "grow5to8", "shrink9to5", "grow3to7"])
def test_resample_matches_jax(h, grid):
    """Identity, exact average pool, nearest repeat, and the bilinear
    fallback (antialiased when it shrinks) at non-integer ratios."""
    f = np.random.default_rng(h * 10 + grid).normal(size=(2, h, h, 5)).astype(np.float32)
    got = ls._resample(torch.from_numpy(f), grid).numpy()
    want = np.asarray(jls._resample(jnp.asarray(f), grid))
    assert got.shape == want.shape == (2, grid, grid, 5)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("grid,size", [(4, 9), (5, 13), (7, 32), (8, 5), (6, 31)])
def test_upsample_maps_matches_jax(grid, size):
    m = np.random.default_rng(grid * size).normal(size=(3, grid, grid)).astype(np.float32)
    got = ls.upsample_maps(torch.from_numpy(m), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jls.upsample_maps(jnp.asarray(m), size)), **F32)


def jax_fit_and_maps(pyramid_fn, variables, fit, probe, **kw):
    stats = jls.fit_latent_stats(pyramid_fn, variables, iter(fit), **kw)
    maps = jls.make_distance_step(pyramid_fn, stats)(variables, jnp.asarray(probe))
    return stats, np.asarray(maps)


@pytest.mark.parametrize("proj_dim,grid,layers", [(24, None, (0, 1, 2)), (None, 4, (1, 2)),
                                                  (12, 6, (0, 3))],
                         ids=["proj24", "no-proj-grid4", "proj12-grid6"])
def test_fit_matches_jax(image_pair, proj_dim, grid, layers):
    """Batches of 5, 5 and a tail of 3 (JAX pads the tail; the port does
    not): ``n_fit`` equal, the mean at the f32 bar, the distance maps at the
    maps bar.  The port fits with JAX's projection."""
    jax_pyr, variables, port_pyr, model = image_pair
    fit, probe = batches(3, (5, 5, 3)), batches(4, (4,))[0]
    jstats, jmaps = jax_fit_and_maps(jax_pyr, variables, fit, probe, layers=layers, grid=grid,
                                     proj_dim=proj_dim, seed=1)
    proj = None if jstats.proj is None else torch.tensor(np.asarray(jstats.proj))
    stats = ls.fit_latent_stats(port_pyr, model, fit, layers=layers, grid=grid,
                                proj_dim=proj_dim, proj=proj)
    assert (stats.n_fit, stats.grid, stats.layers, stats.dim) == (
        jstats.n_fit, jstats.grid, jstats.layers, jstats.dim)
    assert stats.n_fit == 13 and (proj is None) == (proj_dim is None)
    np.testing.assert_allclose(stats.mean.numpy(), np.asarray(jstats.mean), **F32)
    maps = ls.make_distance_step(port_pyr, stats)(model, torch.from_numpy(probe)).numpy()
    assert maps.shape == jmaps.shape == (4, stats.grid, stats.grid)
    np.testing.assert_allclose(maps, jmaps, **MAPS)


def test_expanding_pyramid_fn_counts_frames(video_pair):
    """``temporal_features`` expands windows to frames: uneven window
    batches (3, 3 and a tail of 2) fit to the JAX statistics, ``n_fit``
    counts frames, and the distance maps come one per frame."""
    jmodel, variables, model = video_pair

    def jax_pyr(v, windows):
        (h,) = jmodel.apply(v, windows, method=JaxVAE.temporal_features)
        return (h.reshape(-1, *h.shape[2:]),)

    def port_pyr(m, windows):
        (h,) = m.temporal_features(windows)
        return (h.flatten(0, 1),)

    fit = batches(5, (3, 3, 2), (4, SIZE, SIZE, 3))
    probe = batches(6, (2,), (4, SIZE, SIZE, 3))[0]
    jstats, jmaps = jax_fit_and_maps(jax_pyr, variables, fit, probe, layers=(0,), proj_dim=8)
    stats = ls.fit_latent_stats(port_pyr, model, fit, layers=(0,), proj_dim=8,
                                proj=torch.tensor(np.asarray(jstats.proj)))
    assert stats.n_fit == jstats.n_fit == 8 * 4
    np.testing.assert_allclose(stats.mean.numpy(), np.asarray(jstats.mean), **F32)
    maps = ls.make_distance_step(port_pyr, stats)(model, torch.from_numpy(probe)).numpy()
    assert maps.shape == (2 * 4, stats.grid, stats.grid)
    np.testing.assert_allclose(maps, jmaps, **MAPS)


def test_stats_files_score_in_either_package(image_pair, tmp_path):
    """A port fit saved and read by JAX, and a JAX fit read by the port:
    the same npz keys and dtypes, and the reader's maps equal the writer's."""
    jax_pyr, variables, port_pyr, model = image_pair
    fit, probe = batches(7, (6, 6)), batches(8, (3,))[0]
    stats = ls.fit_latent_stats(port_pyr, model, fit, proj_dim=20, seed=3)
    ls.save_stats(tmp_path / "port.npz", stats)
    jstats = jls.fit_latent_stats(jax_pyr, variables, iter(fit), proj_dim=20, seed=3)
    jls.save_stats(tmp_path / "jax.npz", jstats)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert (a[key].dtype, a[key].shape) == (b[key].dtype, b[key].shape), key

    port_maps = ls.make_distance_step(port_pyr, stats)(model, torch.from_numpy(probe)).numpy()
    read_by_jax = jls.load_stats(tmp_path / "port.npz")
    np.testing.assert_allclose(
        np.asarray(jls.make_distance_step(jax_pyr, read_by_jax)(variables, jnp.asarray(probe))),
        port_maps, **MAPS)
    jax_maps = np.asarray(jls.make_distance_step(jax_pyr, jstats)(variables, jnp.asarray(probe)))
    read_by_port = ls.load_stats(tmp_path / "jax.npz")
    assert read_by_port.n_fit == 12 and read_by_port.layers == (0, 1, 2)
    np.testing.assert_allclose(
        ls.make_distance_step(port_pyr, read_by_port)(model, torch.from_numpy(probe)).numpy(),
        jax_maps, **MAPS)


def test_projection_is_seeded_and_scaled():
    a, b, c = (ls.make_projection(200, 64, s) for s in (0, 0, 1))
    assert a.shape == (200, 64) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.std() * 64 ** 0.5) == pytest.approx(1.0, rel=0.05)
    assert ls.make_projection(64, 64, 0) is None and ls.make_projection(64, None, 0) is None


def test_fit_or_load_round_trip(image_pair, tmp_path, capsys):
    _, _, port_pyr, model = image_pair
    fit = batches(9, (4, 4))
    stats = ls.fit_or_load(port_pyr, model, fit, save_path=tmp_path / "s.npz", what="images",
                           proj_dim=16)
    assert "fit on 8 images (stats -> s.npz)" in capsys.readouterr().out
    again = ls.fit_or_load(port_pyr, model, [], load_path=tmp_path / "s.npz", what="images")
    assert "loaded latent stats" in capsys.readouterr().out
    for name in ("mean", "precision", "proj"):
        assert torch.equal(getattr(stats, name), getattr(again, name)), name
    assert (again.grid, again.layers, again.n_fit) == (stats.grid, stats.layers, 8)
    with pytest.raises(ValueError, match="at least one batch"):
        ls.fit_latent_stats(port_pyr, model, [])
    with pytest.raises(ValueError, match="out of range"):
        ls.fit_latent_stats(port_pyr, model, fit, layers=(4,))


@pytest.mark.parametrize("windows", [False, True], ids=["frames", "windows"])
def test_video_feature_pyramid_matches_jax(video_pair, windows):
    jmodel, variables, model = video_pair
    shape = (2, 3, SIZE, SIZE, 3) if windows else (4, SIZE, SIZE, 3)
    x = np.random.default_rng(10).uniform(-1, 1, shape).astype(np.float32)
    with torch.no_grad():
        got = model.feature_pyramid(torch.from_numpy(x))
    want = jmodel.apply(variables, jnp.asarray(x), method=JaxVAE.feature_pyramid)
    lead = shape[:-3]
    assert [tuple(f.shape) for f in got] == [f.shape for f in want] == [
        (*lead, 16, 16, 32), (*lead, 8, 8, 64), (*lead, 4, 4, 128), (*lead, 2, 2, LATENT)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_temporal_features_match_jax(video_pair):
    jmodel, variables, model = video_pair
    x = np.random.default_rng(11).uniform(-1, 1, (2, 5, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        (got,) = model.temporal_features(torch.from_numpy(x))
    (want,) = jmodel.apply(variables, jnp.asarray(x), method=JaxVAE.temporal_features)
    assert tuple(got.shape) == want.shape == (2, 5, 2, 2, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
