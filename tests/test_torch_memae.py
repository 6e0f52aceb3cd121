"""MemAE in the port (``models/memae.py``) against the plain reference
(``benchmark/reference/memae.py``) on the CPU at tiny widths, in float32:
the forward, the memory's addressing and read (the kept set at the
shrinkage's threshold too), the multi-stream scorer and the daemon; the
scorer's forward with inference BatchNorm3d folded in against the module
forward, and what the benchmark's judge and faults reach through it.  The
test marked ``card`` runs the folded scorer at the published widths and
skips without a CUDA device: ``python -m pytest --noconftest
tests/test_torch_memae.py -m card`` on the card."""

import numpy as np
import pytest
import torch
from torch import nn

from benchmark import scene
from benchmark.reference import memae as ref
from benchmark.runners import clip_scorer
from benchmark.weights import make_weights, program_state_dict
from vad_tpu_torch.core.config import MemAEConfig, is_memae
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models import memae
from vad_tpu_torch.models.memae import MemAutoencoder, MemoryUnit, fold_for_scoring
from vad_tpu_torch.ops import block_epilogue as ep

TINY = MemAEConfig(widths=(8, 8, 16, 16), mem_dim=64, image_size=32, sequence_length=8)
CFG = {**TINY.to_dict(), "reference": "reference/memae.py"}
MEMORY_SCALE = 64.0  # logits' std 2.7-6 at these widths: a read of 3-20 of the 64 items
RTOL, ATOL = 1e-4, 1e-5


def _weights(seed):
    w = make_weights(CFG, seed, "cpu")
    w[ref.MEMORY] = w[ref.MEMORY] * MEMORY_SCALE
    return w


def _model(weights, cfg=TINY):
    model = MemAutoencoder.from_config(cfg, device="cpu").eval()
    model.load_state_dict(program_state_dict(weights))
    return model


def _clips(seed, streams=3):
    return torch.as_tensor(scene.stream_pool(seed, streams, 1, TINY.sequence_length, 32)[0])


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_forward_addressing_and_read_match_the_reference(seed):
    w, u8 = _weights(seed), _clips(seed)
    model, num = _model(w), ref.Numerics("f32")
    with torch.no_grad():
        x = ref.gray(u8)
        z = model.encoder(x)
        torch.testing.assert_close(z, ref.encode(x, w, num), rtol=RTOL, atol=ATOL)
        q = ref.queries(z)
        att = model.mem_rep.memory.address(q)
        want = ref.address(q, w, TINY.shrink_thres, num)
        torch.testing.assert_close(att, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(att > 0, want > 0)
        kept = (att > 0).sum(dim=1).float()
        assert 1 <= float(kept.mean()) < TINY.mem_dim / 2  # the read is sparse, never empty
        torch.testing.assert_close(model.mem_rep(z), ref.memory(z, w, TINY.shrink_thres, num),
                                   rtol=RTOL, atol=ATOL)
        _, err, scores = model.score_clips(u8)
        want_scores, _ = ref.score_clips(u8, w, CFG, num)
    torch.testing.assert_close(scores, want_scores, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(err.mean(dim=(2, 3)), scores)


def test_the_kept_set_at_the_threshold_is_the_reference_s():
    """Softmax weights a part in 1e4 and 1e3 on either side of lambda:
    those above are kept and those below dropped, by the port and the
    reference alike."""
    lam, d = 0.0025, 1e-4
    near = [lam * (1 + d), lam * (1 - d), lam * (1 + 10 * d), lam * (1 - 10 * d), 0.001]
    p = np.array(near + [0.6, 0.0], np.float64)
    p[-1] = 1.0 - p.sum()
    q = torch.tensor(np.log(np.stack([p, np.roll(p, 3)])), dtype=torch.float32)
    unit = MemoryUnit(len(p), len(p), lam)
    with torch.no_grad():
        unit.weight.copy_(torch.eye(len(p)))  # the logits are the queries
        got = unit.address(q)
        read = unit(q)
    want = ref.address(q, {ref.MEMORY: unit.weight.detach()}, lam, ref.Numerics("f32"))
    kept = torch.tensor(p > lam)
    assert torch.equal(got > 0, torch.stack([kept, kept.roll(3)]))
    assert torch.equal(got > 0, want > 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(read, got)  # M = I reads the weights back


def test_scorer_scores_each_clip_alone_and_marks_idle_slots():
    w, u8 = _weights(7), _clips(7)
    scorer = MultiStreamScorer(_model(w), None, num_slots=3, chunk=TINY.sequence_length,
                               image_size=32, dtype=torch.float32, device="cpu",
                               return_maps=True)
    scorer.attach(0)
    scorer.attach(2)
    assert scorer.states == ()
    want, _ = ref.score_clips(u8, w, CFG, ref.Numerics("f32"))
    for _ in range(2):  # nothing is carried from one chunk to the next
        scores, maps = scorer.score_chunk(u8.numpy())
        np.testing.assert_allclose(scores[[0, 2]], want[[0, 2]].numpy(), rtol=RTOL, atol=ATOL)
        assert np.isnan(scores[1]).all()
        assert maps.shape == (3, TINY.sequence_length, 32, 32)
    with pytest.raises(ValueError, match="MemAE"):
        scorer.reload_variables({})


@pytest.mark.parametrize("kw", [{"fused_input": True}, {"mesh": "two cpus"}, {"spatial": True},
                                {"chunk": 4}], ids=["fused_input", "mesh", "spatial", "chunk"])
def test_scorer_refuses_what_a_clip_model_cannot_do(kw):
    if kw.get("mesh"):
        from vad_tpu_torch.parallel.sharding import get_mesh

        kw = {"mesh": get_mesh(["cpu", "cpu"])}
    args = {"num_slots": 2, "chunk": TINY.sequence_length, "image_size": 32, "device": "cpu",
            **kw}
    with pytest.raises(ValueError, match="MemAE"):
        MultiStreamScorer(MemAutoencoder.from_config(TINY, device="cpu"), None, **args)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _scorer(weights, dtype=torch.float32, slots=3):
    scorer = MultiStreamScorer(_model(weights), None, num_slots=slots,
                               chunk=TINY.sequence_length, image_size=32, dtype=dtype,
                               device="cpu")
    for slot in range(slots):
        scorer.attach(slot)
    return scorer


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_folded_forward_equals_the_module_forward(seed):
    """In eval mode, f32: the folded encoder and decoder (bias-free
    convolutions, each ending in the ``leaky`` epilogue) give the module
    path's z and reconstruction (relative gap <= 1e-5); the weights come
    out channels-last-3d, the biases f32."""
    model = _model(_weights(seed))
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, nn.BatchNorm3d)):
            bn.weight[::2] *= -1  # negative scales too
    folded = fold_for_scoring(model.state_dict(), torch.float32)
    assert len(folded.encoder) == 4 and len(folded.decoder) == 3
    for w, b in (*folded.encoder, *folded.decoder):
        assert w.is_contiguous(memory_format=torch.channels_last_3d)
        assert w.permute(0, 2, 3, 4, 1).is_contiguous() and b.dtype == torch.float32
    x = ref.gray(_clips(seed)).contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        z, z_folded = model.encoder(x), model.encoder(x, folded.encoder)
        want, got = model(x), model(x, folded)
    assert _rel(z_folded, z) <= 1e-5
    assert _rel(got, want) <= 1e-5
    assert z_folded.is_contiguous(memory_format=torch.channels_last_3d)


def test_the_fold_reads_the_pre_cast_f32_statistics():
    """The scorer folds from the state dict it was handed, before its bf16
    cast: its folded layers equal ``fold_for_scoring`` of the f32 weights
    and statistics; a state dict taken after the cast is refused."""
    w = _weights(13)
    f32_weights = _model(w).state_dict()
    scorer = _scorer(w, torch.bfloat16)
    served = scorer._replicas[0].folded
    want = fold_for_scoring(f32_weights, torch.bfloat16)
    for (w_got, b_got), (w_want, b_want) in zip((*served.encoder, *served.decoder),
                                                (*want.encoder, *want.decoder)):
        assert w_got.dtype == torch.bfloat16 and b_got.dtype == torch.float32
        assert torch.equal(w_got, w_want) and torch.equal(b_got, b_want)
    mean, var = f32_weights["encoder.1.running_mean"], f32_weights["encoder.1.running_var"]
    s = f32_weights["encoder.1.weight"] / torch.sqrt(var + ep.BN_EPS)
    bias = (f32_weights["encoder.0.bias"] - mean) * s + f32_weights["encoder.1.bias"]
    torch.testing.assert_close(served.encoder[0][1], bias, rtol=1e-6, atol=1e-7)
    assert scorer.model.encoder[1].running_var.dtype == torch.bfloat16  # the modules were cast
    with pytest.raises(ValueError, match="before cast_for_scoring"):
        fold_for_scoring(scorer.model.state_dict(), torch.bfloat16)


def test_folded_chunk_hooks_see_z_and_z_hat_once():
    """The benchmark's judge takes z and z_hat by forward hooks on
    ``model.encoder`` and ``model.mem_rep``: in a folded chunk each fires
    once, with what the unfolded path computes."""
    w, u8 = _weights(17), _clips(17)
    scorer = _scorer(w)
    assert scorer._replicas[0].folded is not None
    model, caught = scorer.model, {"z": [], "z_hat": []}
    hooks = [module.register_forward_hook(
        lambda _m, _i, out, name=name: caught[name].append(out.detach().clone()))
        for name, module in (("z", model.encoder), ("z_hat", model.mem_rep))]
    try:
        scores = scorer.score_chunk(u8.numpy())
        assert [len(caught["z"]), len(caught["z_hat"])] == [1, 1]
        with torch.no_grad():
            _, _, want_scores = model.score_clips(u8)  # the module path
    finally:
        for h in hooks:
            h.remove()
    for name in ("z", "z_hat"):
        assert _rel(caught[name][0], caught[name][1]) <= 1e-5, name
    np.testing.assert_allclose(scores, want_scores.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fault", ["memory_bypassed", "no_shrink"])
def test_a_planted_memory_fault_changes_the_folded_scores(fault):
    """The benchmark's faults patch ``model.mem_rep.forward`` and the
    memory's ``shrink_thres``; the folded path calls the module, so both
    still reach the scores, which repeat exactly without a fault (without
    shrinkage the tiny model's read moves its scores by about 3e-4)."""
    w, u8 = _weights(19), _clips(19)
    scorer = _scorer(w)
    sound = scorer.score_chunk(u8.numpy())
    np.testing.assert_array_equal(scorer.score_chunk(u8.numpy()), sound)
    clip_scorer.plant(scorer, fault, 3)
    broken = scorer.score_chunk(u8.numpy())
    assert np.abs(broken - sound).max() > 1e-4 * np.abs(sound).max()


class _Official(nn.Module):
    """``AutoEncoderCov3DMem`` as github.com/donggong1/memae-anomaly-detection
    builds it (its modules and their order; ``MemModule`` holds
    ``MemoryUnit``, whose weight is M and whose bias is None)."""

    def __init__(self, chnum_in=1, mem_dim=2000):
        super().__init__()

        def block(conv, ch):
            return [conv, nn.BatchNorm3d(ch), nn.LeakyReLU(0.2, inplace=True)]

        f2, f, fx2 = 96, 128, 256
        self.encoder = nn.Sequential(
            *block(nn.Conv3d(chnum_in, f2, 3, stride=(1, 2, 2), padding=1), f2),
            *block(nn.Conv3d(f2, f, 3, stride=2, padding=1), f),
            *block(nn.Conv3d(f, fx2, 3, stride=2, padding=1), fx2),
            *block(nn.Conv3d(fx2, fx2, 3, stride=2, padding=1), fx2))
        self.mem_rep = nn.Module()
        self.mem_rep.memory = nn.Module()
        self.mem_rep.memory.weight = nn.Parameter(torch.zeros(mem_dim, fx2))
        self.decoder = nn.Sequential(
            *block(nn.ConvTranspose3d(fx2, fx2, 3, stride=2, padding=1, output_padding=1), fx2),
            *block(nn.ConvTranspose3d(fx2, f, 3, stride=2, padding=1, output_padding=1), f),
            *block(nn.ConvTranspose3d(f, f2, 3, stride=2, padding=1, output_padding=1), f2),
            nn.ConvTranspose3d(f2, chnum_in, 3, stride=(1, 2, 2), padding=1,
                               output_padding=(0, 1, 1)))


def test_an_official_state_dict_loads_strictly_at_the_published_widths():
    official = _Official()
    for p in official.parameters():
        nn.init.normal_(p)
    model = MemAutoencoder(device="cpu")  # MemAEConfig()'s widths, built without a forward
    assert sum(p.numel() for p in model.parameters()) == 6_492_801
    model.load_state_dict(official.state_dict(), strict=True)
    assert torch.equal(model.mem_rep.memory.weight, official.mem_rep.memory.weight)
    folded = fold_for_scoring(official.state_dict(), torch.bfloat16)  # the official keys fold
    assert [w.shape[0] for w, _ in folded.encoder] == [96, 128, 256, 256]
    assert [w.shape[1] for w, _ in folded.decoder] == [256, 128, 96]
    assert [k for k, _ in ref.layout({**MemAEConfig().to_dict()})] == [
        k for k in official.state_dict() if not k.endswith("num_batches_tracked")]


def test_config_round_trips_and_marks_checkpoints():
    args = TINY.to_dict()
    assert is_memae(args) and not is_memae({"latent_dim": 128}) and not is_memae(None)
    assert MemAEConfig.from_args(args) == TINY
    assert MemAEConfig.from_args({"model": "memae"}) == MemAEConfig()


def test_the_daemon_serves_a_memae_checkpoint(tmp_path):
    from vad_tpu_torch.eval.client import ScoringClient
    from vad_tpu_torch.eval.http_server import serve_from_checkpoint
    from vad_tpu_torch.utils.checkpoint import save_checkpoint

    w = _weights(11)
    path = save_checkpoint(tmp_path / "memae.ckpt", {
        "model_type": "video", "args": TINY.to_dict(),
        "state_dict": _model(w).state_dict()})
    with pytest.raises(ValueError, match="--fused-input"):
        serve_from_checkpoint(str(path), port=0, host="127.0.0.1", num_slots=2,
                              chunk=TINY.sequence_length, dtype="float32", fused_input=True,
                              device="cpu")
    srv = serve_from_checkpoint(str(path), port=0, host="127.0.0.1", num_slots=2,
                                chunk=TINY.sequence_length, dtype="float32", device="cpu")
    srv.start_background()
    try:
        client = ScoringClient("127.0.0.1", srv.port)
        slot = client.attach()
        u8 = _clips(11, streams=1)
        got = client.score_chunk(slot, u8[0].numpy())["scores"]
        want, _ = ref.score_clips(u8, w, CFG, ref.Numerics("f32"))
        np.testing.assert_allclose(got, want[0].numpy(), rtol=RTOL, atol=ATOL)
        with pytest.raises(ValueError, match="MemAE"):
            srv.services["video"].reload(str(path))
        client.detach(slot)
    finally:
        srv.close()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_card_folded_scorer_runs_seven_epilogues_on_channels_last_outputs(card, monkeypatch):
    """At the published widths, bf16: every folded convolution's output
    comes back from cuDNN channels-last-3d (no copy before the epilogue),
    a chunk launches kernel 7 seven times, and the scores stay within
    bf16's reach of the module path's."""
    cfg = MemAEConfig(image_size=64)
    w = make_weights({**cfg.to_dict(), "reference": "reference/memae.py"}, 23, "cpu")
    w[ref.MEMORY] = w[ref.MEMORY] * 80.0
    model = MemAutoencoder.from_config(cfg, device="cpu")
    model.load_state_dict(program_state_dict(w))
    scorer = MultiStreamScorer(model, None, num_slots=2, chunk=cfg.sequence_length,
                               image_size=64, dtype=torch.bfloat16, device=card)
    for slot in range(2):
        scorer.attach(slot)
    layouts, inner = [], memae._leaky_epilogue

    def recorded(y, b):
        layouts.append(y.is_contiguous(memory_format=torch.channels_last_3d))
        return inner(y, b)

    monkeypatch.setattr(memae, "_leaky_epilogue", recorded)
    u8 = torch.as_tensor(scene.stream_pool(23, 2, 1, cfg.sequence_length, 64)[0])
    before = ep.block_epilogue.launches
    scores = scorer.score_chunk(u8.numpy())
    assert ep.block_epilogue.launches - before == 7
    assert layouts == [True] * 7
    with torch.no_grad():
        _, _, want = scorer.model.score_clips(u8.to(card))  # the module path, bf16
    np.testing.assert_allclose(scores, want.cpu().numpy(), rtol=0.02, atol=1e-3)
