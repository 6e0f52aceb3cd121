"""A long stream through the port's ``MultiStreamScorer`` against the JAX
package's, on the CPU.

Three slots carry their (h, c) across 32 chunks of 4 frames from the
textured video fixture (``create_synthetic_textured_video_data``, 32x32:
two videos with the counter-scrolling patch, one without), through a
2-layer model of latent and hidden width 16 whose weights are a seeded JAX
init with biases, scales and statistics moved off identity.  Every chunk's
scores and the final carried state are held at the f32 bar, so a drift
that builds up over the stream would show; the relative L2 distance of
the scores and of the state is printed after the first and the last
chunk.  JAX runs its plain ``backend='xla'`` scorer.

Bar: f32 rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from tests.test_torch_training import perturbed
from vad_tpu.eval.serving import MultiStreamScorer as JaxScorer
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu_torch.data.synthetic import create_synthetic_textured_video_data
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

F32 = dict(rtol=1e-4, atol=1e-5)
SIZE, SLOTS, CHUNK, CHUNKS = 32, 3, 4, 32
MODEL = dict(latent_dim=16, lstm_hidden_dim=16, lstm_layers=2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def stream_frames(tmp_path):
    """uint8 [SLOTS, CHUNKS * CHUNK, SIZE, SIZE, 3]: the fixture's test videos."""
    root = create_synthetic_textured_video_data(str(tmp_path), "T01", n_train_videos=0,
                                                n_test_videos=SLOTS,
                                                frames_per_video=CHUNKS * CHUNK,
                                                image_size=SIZE)
    videos = sorted((root / "testing" / "frames").iterdir())
    return np.stack([np.stack([np.asarray(Image.open(f).convert("RGB"))
                               for f in sorted(v.glob("*.png"))]) for v in videos])


def test_long_stream_matches_jax(tmp_path):
    frames = stream_frames(tmp_path)
    assert frames.shape == (SLOTS, CHUNKS * CHUNK, SIZE, SIZE, 3)
    jmodel = JaxVAE(backend="xla", **MODEL)
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(2))
    js = JaxScorer(jmodel, variables, SLOTS, CHUNK, SIZE, return_maps=False,
                   dtype=jnp.float32)
    ts = MultiStreamScorer(VideoAutoencoder(device="cpu", **MODEL), variables, SLOTS, CHUNK,
                           SIZE, return_maps=False, dtype=torch.float32, device="cpu")
    for slot in range(SLOTS):
        assert ts.attach(slot) == js.attach(slot)

    def state_distance():
        got = np.concatenate([t.numpy().ravel() for hc in ts.states for t in hc])
        want = np.concatenate([np.asarray(t).ravel() for hc in js.states for t in hc])
        return got, want

    report = {}
    with jax.default_matmul_precision("highest"):
        for k in range(CHUNKS):
            chunk = np.ascontiguousarray(frames[:, k * CHUNK:(k + 1) * CHUNK])
            got, want = ts.score_chunk(chunk), np.asarray(js.score_chunk(chunk))
            assert got.shape == (SLOTS, CHUNK) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, err_msg=f"chunk {k}", **F32)
            if k in (0, CHUNKS - 1):
                report[k + 1] = (rel_l2(got, want), rel_l2(*state_distance()))
    h_c = state_distance()
    np.testing.assert_allclose(*h_c, **F32)
    assert np.abs(h_c[1]).max() > 0.01  # the state carried something
    for chunk, (scores, state) in report.items():
        print(f"after chunk {chunk}: scores rel L2 {scores:.3e}, (h, c) rel L2 {state:.3e}")
