"""Inference BatchNorm folded into encoder blocks 2-4 and the decoder, and
the epilogue pass that ends each folded block (``ops/block_epilogue.py``,
kernel 7).

On the CPU: each folded block against the model's module path (conv, the
bias, BatchNorm in eval, pool, activation) at every block of each mode,
f32 and bf16; the fused scorer, which takes the folded path, against the
module path on the same weights and chunks, before and after a reload.
Tests marked ``card`` run the kernel against its plain version at the
serving shapes of the 256x256 and 512x512 cells, and count its launches
through the scorer; they skip without a CUDA device: ``python -m pytest
--noconftest tests/test_torch_block_epilogue.py -m card`` on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.ops import block_epilogue as ep
from vad_tpu_torch.utils.weights import state_dict_to_flax

LATENT, SIZE, SLOTS, CHUNK = 32, 32, 2, 3
# each mode's layers: (the module's conv index, its input's side)
LAYERS = {"encoder": [(1, 16), (2, 8), (3, 4)], "decoder": [(0, 2), (1, 4), (2, 8)],
          "last": [(3, 16)]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(seed: int, device="cpu") -> VideoAutoencoder:
    """A small model in eval mode whose BatchNorm scales are half negative,
    so a fold that pooled after the scale would be caught."""
    model = init_weights(VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT,
                                          lstm_layers=1, device="cpu"), seed)
    with torch.no_grad():
        for norm in (*model.encoder.norms, *model.decoder.norms):
            norm.weight[::2] *= -1
    return model.to(device).eval()


def _module_block(model, mode: str, i: int, y: torch.Tensor) -> torch.Tensor:
    """The model's own eval path of one block, in ``y``'s type."""
    if mode == "encoder":
        z = model.encoder.norms[i](model.encoder.convs[i](y))
        return F.leaky_relu(F.max_pool2d(z, 2), 0.2)
    z = model.decoder.deconvs[i](y)
    return torch.tanh(z) if mode == "last" else F.relu(model.decoder.norms[i](z))


def _folded_block(folded, mode: str, i: int, y: torch.Tensor) -> torch.Tensor:
    if mode == "encoder":
        w, b = folded.encoder[i - 1]
        return ep.block_epilogue(F.conv2d(y, w, None, padding=1), b, mode)
    w, b = folded.decoder[i]
    return ep.block_epilogue(F.conv_transpose2d(y, w, None, stride=2), b, mode)


def _input(model, mode: str, i: int, side: int, seed: int) -> torch.Tensor:
    cin = (model.encoder.convs[i] if mode == "encoder" else model.decoder.deconvs[i]).in_channels
    g = torch.Generator().manual_seed(seed)
    return torch.randn((3, side, side, cin), generator=g).permute(0, 3, 1, 2)  # channels-last


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ep.MODES)
def test_folded_block_matches_the_module_path(mode, dtype):
    """f32: the fold and the one-pass epilogue give the module path's
    result (relative gap <= 1e-5).  bf16: the folded block, rounded once
    after the convolution and once at the end, stays as close to the f32
    module path as the module path run in bf16 (which rounds after the
    bias, BatchNorm and pool as well)."""
    model = _model(1)
    folded = ep.fold_blocks(model.state_dict(), dtype)
    model_low = _model(1).to(dtype)
    for n, (i, side) in enumerate(LAYERS[mode]):
        y = _input(model, mode, i, side, n)
        with torch.no_grad():
            want = _module_block(model, mode, i, y)
            got = _folded_block(folded, mode, i, y.to(dtype))
            module_low = _module_block(model_low, mode, i, y.to(dtype))
        assert got.dtype == dtype and got.shape == want.shape
        assert got.permute(0, 2, 3, 1).is_contiguous()  # channels-last, as the next conv reads it
        if dtype == torch.float32:
            assert _rel(got, want) <= 1e-5, (mode, i)
        else:
            assert _rel(got, want) <= max(1.5 * _rel(module_low, want), 2 ** -8), (mode, i)


@pytest.mark.parametrize("mode", ep.MODES)
def test_epilogue_rounds_once_from_f32(mode):
    """The bf16 epilogue is the f32 epilogue of the same bf16 input,
    rounded once; NaN passes through the pool and the activation."""
    g = torch.Generator().manual_seed(5)
    c = 3 if mode == "last" else 16
    y = torch.randn((2, 6, 4, c), generator=g).to(torch.bfloat16).permute(0, 3, 1, 2)
    y[0, 1, 0, 0] = float("nan")
    b = torch.randn(c, generator=g)
    got = ep.block_epilogue(y, b, mode)
    want = ep.block_epilogue(y.float(), b, mode).to(torch.bfloat16)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[0, 1].isnan().any())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_fold_leaves_the_last_layer_and_casts():
    model = _model(2)
    sd = model.state_dict()
    folded = ep.fold_blocks(sd, torch.bfloat16)
    assert len(folded.encoder) == 3 and len(folded.decoder) == 4
    assert all(w.dtype == torch.bfloat16 and b.dtype == torch.float32
               for w, b in (*folded.encoder, *folded.decoder))
    w, b = folded.decoder[-1]
    assert torch.equal(w, sd["decoder.deconvs.3.weight"].to(torch.bfloat16))
    assert torch.equal(b, sd["decoder.deconvs.3.bias"])
    # a ConvTranspose2d weight scales along dim 1, a Conv2d weight along dim 0
    s = sd["decoder.norms.0.weight"] / torch.sqrt(sd["decoder.norms.0.running_var"] + ep.BN_EPS)
    torch.testing.assert_close(ep.fold_blocks(sd, torch.float32).decoder[0][0],
                               sd["decoder.deconvs.0.weight"] * s[None, :, None, None])


def _scorers(seed: int):
    """The fused scorer (the folded path) and the module path on the same
    weights, every slot attached, f32 on the CPU."""
    out = []
    for fused in (True, False):
        sc = MultiStreamScorer(_model(seed), None, SLOTS, CHUNK, SIZE, dtype=torch.float32,
                               fused_input=fused, device="cpu")
        for slot in range(SLOTS):
            sc.attach(slot)
        out.append(sc)
    return out


def _agree(a: MultiStreamScorer, b: MultiStreamScorer, seed: int, chunks: int = 3) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(chunks):
        frames = rng.integers(0, 256, (SLOTS, CHUNK, SIZE, SIZE, 3), dtype=np.uint8)
        got, want = a.score_chunk(frames), b.score_chunk(frames)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for (h, c), (h_want, c_want) in zip(a.states, b.states):
        torch.testing.assert_close(h, h_want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(c, c_want, rtol=1e-5, atol=1e-6)


def test_fused_scorer_takes_the_folded_path_and_agrees_with_the_modules(monkeypatch):
    fused, modules = _scorers(3)
    calls = []
    monkeypatch.setattr(ep, "block_epilogue",
                        lambda y, b, mode: calls.append((mode, y.shape[1], y.shape[2]))
                        or ep.block_epilogue_ref(y, b, mode))
    _agree(fused, modules, 7, chunks=1)
    assert [mode for mode, _, _ in calls] == ["encoder"] * 3 + ["decoder"] * 3 + ["last"]
    assert calls == ep.step_calls(fused._replicas[0].folded, SIZE)
    monkeypatch.undo()
    _agree(fused, modules, 8)


def test_reload_refolds_every_block():
    """After a reload to other weights both scorers serve those weights,
    and the fused one's folded layers are the new weights' fold."""
    fused, modules = _scorers(3)
    _agree(fused, modules, 9, chunks=1)
    other = _model(4)
    variables = state_dict_to_flax(other)
    for sc in (fused, modules):
        sc.reload_variables(variables)
    refolded = ep.fold_blocks(other.state_dict(), torch.float32)
    for (w, b), (w_new, b_new) in zip((*fused._replicas[0].folded.encoder,
                                       *fused._replicas[0].folded.decoder),
                                      (*refolded.encoder, *refolded.decoder)):
        torch.testing.assert_close(w, w_new, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(b, b_new, rtol=1e-6, atol=1e-7)
    _agree(fused, modules, 10)


def _cell_calls(image: int):
    """The seven calls of a chunk at a scoring cell's shape: the published
    widths (``VideoAutoencoder()``) on ``image x image`` frames."""
    model = VideoAutoencoder(device="cpu")
    return ep.step_calls(ep.fold_blocks(model.state_dict(), torch.float32), image)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("image", [256, 512])
def test_card_kernel_matches_its_plain_version_at_the_cells_shapes(card, image, dtype):
    """Bit for bit where the modes need no transcendental (max, add,
    LeakyReLU, ReLU are exact in f32); within 2 units of the last place of
    the output type for tanh."""
    g = torch.Generator(device=card).manual_seed(image)
    for mode, c, side in _cell_calls(image):
        y = torch.randn((256, side, side, c), generator=g, device=card).to(dtype)
        y = y.permute(0, 3, 1, 2)
        b = torch.randn(c, generator=g, device=card)
        got = ep.block_epilogue(y, b, mode)
        want = ep.block_epilogue_ref(y, b, mode)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.permute(0, 2, 3, 1).is_contiguous()
        if mode == "last":
            ulp = torch.finfo(dtype).eps
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 * ulp)
        else:
            assert torch.equal(got, want), (mode, c, side)
        del y, got, want


@pytest.mark.card
def test_card_scorer_launches_seven_epilogues_a_chunk(card):
    fused = MultiStreamScorer(_model(3), None, SLOTS, CHUNK, 64, dtype=torch.bfloat16,
                              device=card)
    modules = MultiStreamScorer(_model(3), None, SLOTS, CHUNK, 64, dtype=torch.bfloat16,
                                fused_input=False, device=card)
    assert fused.fused_input
    for sc in (fused, modules):
        for slot in range(SLOTS):
            sc.attach(slot)
    rng = np.random.default_rng(11)
    before = ep.block_epilogue.launches
    for _ in range(3):
        frames = rng.integers(0, 256, (SLOTS, CHUNK, 64, 64, 3), dtype=np.uint8)
        got, want = fused.score_chunk(frames), modules.score_chunk(frames)
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert ep.block_epilogue.launches - before == 3 * 7
