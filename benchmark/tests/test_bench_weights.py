"""Seeded weights (``weights.make_weights``): the draw of the existing
configurations pinned bit for bit, and the layout of any reference drawn
with a fan-scaled standard deviation for every kernel or matrix."""

import hashlib
import math

import pytest
import torch

from benchmark.manifest import Manifest
from benchmark.weights import make_weights

M = Manifest()
SEED = 2**31 + 7
# sha256 over each weight's name and float32 bytes in layout order, drawn on
# the CPU by torch's generator (torch 2.13); both configurations have the
# same widths, so the same weights
PINNED = "5f6942ef294cd780f915116882b2bc31302bf2af507d8c27ad4279985792c6b9"

STUB = '''
TINY = {}


def layout(cfg):
    return [("enc.conv3d.weight", (64, 32, 3, 3, 3)), ("enc.conv3d.bias", (64,)),
            ("enc.norm.weight", (64,)), ("enc.norm.running_var", (64,)),
            ("dec.deconv3d.weight", (64, 32, 4, 4, 4)), ("memory.weight", (2000, 256)),
            ("head.weight", (10, 512))]
'''


def _digest(weights) -> str:
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["video_ae_256", "video_ae_512"])
def test_the_configurations_draw_the_pinned_weights(name):
    weights = make_weights(M.config(name), SEED, "cpu")
    assert all(t.dtype == torch.float32 for t in weights.values())
    assert _digest(weights) == PINNED


def test_kernels_and_matrices_of_any_rank_are_fan_scaled(tmp_path):
    """A Conv3d kernel [out, in, k, k, k], a ConvTranspose3d one [in, out,
    k, k, k] and 2-D matrices [out, in] get Xavier's sqrt(2 / (fan_in +
    fan_out)) within sampling error; 1-D tensors keep their draws."""
    (tmp_path / "stub3d.py").write_text(STUB)
    weights = make_weights({"reference": str(tmp_path / "stub3d.py")}, 5, "cpu")
    for name, (a, b, *k) in [("enc.conv3d.weight", (64, 32, 3, 3, 3)),
                             ("dec.deconv3d.weight", (64, 32, 4, 4, 4)),
                             ("memory.weight", (2000, 256)), ("head.weight", (10, 512))]:
        w = weights[name]
        want = math.sqrt(2.0 / ((a + b) * math.prod(k)))
        # the std of n normal draws has a relative error of about 1 / sqrt(2 n)
        assert abs(float(w.std()) / want - 1) < 6 / math.sqrt(2 * w.numel()), name
        assert abs(float(w.mean())) < 6 * want / math.sqrt(w.numel()), name
    assert float(weights["enc.conv3d.bias"].abs().max()) < 0.05 * 6
    assert abs(float(weights["enc.norm.weight"].mean()) - 1) < 0.1
    assert float(weights["enc.norm.running_var"].min()) >= 0.5
