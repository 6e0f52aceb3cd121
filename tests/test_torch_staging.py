"""The scorer's staged host-to-device copy (``vad_tpu_torch/eval/staging.py``,
``MultiStreamScorer.score_chunk``).

On the CPU a CPU destination and an unpinned host buffer drive the same
fill and copy as the card's pinned buffer, and a CPU scorer is made to
take the staged path by its engagement test.  Tests marked ``card`` run
the pinned path on a CUDA device and skip without one: ``python -m pytest
tests/test_torch_staging.py -m card`` on the card."""

import numpy as np
import pytest
import torch

from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.eval.staging import StagedCopy
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights

SLOTS, CHUNK, SIZE = 3, 3, 32
SHAPE = (SLOTS, CHUNK, SIZE, SIZE, 3)
FORMS = ["numpy", "tensor", "view"]


def frames(seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def host_form(form, seed):
    """A chunk of ``SHAPE`` as a numpy array, a CPU tensor or a
    non-contiguous view (every other frame of a longer chunk)."""
    if form == "numpy":
        return frames(seed)
    if form == "tensor":
        return torch.from_numpy(frames(seed))
    view = frames(seed, (SLOTS, 2 * CHUNK, SIZE, SIZE, 3))[:, ::2]
    assert not view.flags.c_contiguous
    return view


def mask(seed):
    return np.random.default_rng(seed).random(SLOTS) < 0.5


def stager(device="cpu"):
    return StagedCopy([(SHAPE, torch.uint8), ((SLOTS,), torch.bool)], device)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(device="cpu"):
    model = VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1, device="cpu")
    return init_training_weights(model, 0).to(device)


def scorers(device="cpu"):
    """Two scorers of the same weights on ``device``, every slot attached:
    the first goes through the staged copy whatever the device, the second
    through the direct one."""
    pair = [MultiStreamScorer(_model(device), None, SLOTS, CHUNK, SIZE, device=device)
            for _ in range(2)]
    pair[0]._stages = lambda frames: frames.device.type == "cpu"
    pair[1]._stages = lambda frames: False
    for s in pair:
        for slot in range(SLOTS):
            s.attach(slot)
    return pair


def assert_same_run(staged, direct, chunks):
    """Both scorers over ``chunks`` of (frames, submitted): bitwise equal
    scores and carried (h, c) after every chunk."""
    for x, submitted in chunks:
        np.testing.assert_array_equal(staged.score_chunk(x, submitted),
                                      direct.score_chunk(x, submitted))
        for (h, c), (h2, c2) in zip(staged.states, direct.states):
            assert torch.equal(h, h2) and torch.equal(c, c2)


@pytest.mark.parametrize("form", FORMS)
def test_the_bytes_that_land_are_the_input(form):
    copy = stager()
    x, m = host_form(form, 1), mask(1)
    u8, got = copy.copy(x, m)
    assert u8 is copy.dest[0] and got is copy.dest[1]
    np.testing.assert_array_equal(u8.numpy(), np.asarray(x))
    np.testing.assert_array_equal(got.numpy(), m)


@pytest.mark.parametrize("form", FORMS)
def test_back_to_back_chunks_never_mix(form):
    """Chunk n + 1 lands whole over chunk n in the same buffers, and
    chunk n's bytes are gone; so is what the caller changes afterwards."""
    copy = stager()
    first = host_form(form, 2)
    copy.copy(first, mask(2))
    second = host_form(form, 3)
    u8, _ = copy.copy(second, mask(3))
    np.testing.assert_array_equal(u8.numpy(), np.asarray(second))
    want = np.array(second)
    second[:] = 0  # the caller reuses its array once the call returned
    np.testing.assert_array_equal(u8.numpy(), want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "arrays"])
def test_a_wrong_array_raises_before_anything_is_staged(bad):
    copy = stager()
    good = frames(4)
    copy.copy(good, mask(4))
    wrong = {"shape": (frames(5)[:, :1], mask(5)), "dtype": (frames(5).astype(np.int16), mask(5)),
             "arrays": (frames(5),)}[bad]
    with pytest.raises(ValueError, match="expected"):
        copy.copy(*wrong)
    np.testing.assert_array_equal(copy.host[0].numpy(), good)
    np.testing.assert_array_equal(copy.dest[0].numpy(), good)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_the_scorer_checks_frames_before_staging(bad):
    """A wrong chunk raises as before (ValueError for its shape, TypeError
    for its dtype) and stages nothing: no buffer before the first good
    chunk, the last good chunk's bytes after it."""
    staged, _ = scorers()
    wrong = frames(6)[:, :1] if bad == "shape" else frames(6).astype(np.float32)
    error = ValueError if bad == "shape" else TypeError
    with pytest.raises(error, match="expected" if bad == "shape" else "uint8"):
        staged.score_chunk(wrong)
    assert staged._staging is None
    good = frames(7)
    staged.score_chunk(good)
    with pytest.raises(error):
        staged.score_chunk(wrong)
    np.testing.assert_array_equal(staged._staging.host[0].numpy(), good)


@pytest.mark.parametrize("form", FORMS)
def test_the_staged_scorer_equals_the_direct_copy(form):
    """Scores and carried (h, c) bitwise equal to the direct copy's over
    several chunks, with slots left out of some; the staging's buffers are
    made once."""
    staged, direct = scorers()
    chunks = [(host_form(form, 10 + i), [True, i % 2 == 0, i != 2]) for i in range(4)]
    assert_same_run(staged, direct, chunks[:1])
    buffers = staged._staging
    assert_same_run(staged, direct, chunks[1:])
    assert staged._staging is buffers


def test_a_caller_that_overwrites_its_frames_changes_nothing():
    staged, direct = scorers()
    x = frames(20)
    want = direct.score_chunk(x.copy())
    got = staged.score_chunk(x)
    x[:] = 255  # at once, as a daemon refills its batch
    np.testing.assert_array_equal(got, want)
    assert_same_run(staged, direct, [(frames(21), None)])


def test_staging_engages_for_host_frames_bound_for_a_card():
    """Where the frames live and where they go decide, nothing else."""
    scorer = MultiStreamScorer(_model(), None, SLOTS, CHUNK, SIZE, device="cpu")
    host, on_card = torch.zeros(1), torch.zeros(1, device="meta")
    assert not scorer._stages(host)
    scorer.device = torch.device("cuda")  # the test alone: no card is touched
    assert scorer._stages(host) and not scorer._stages(on_card)


@pytest.mark.card
def test_card_buffer_is_pinned(card):
    copy = stager(card)
    assert all(h.is_pinned() for h in copy.host)
    assert all(d.device.type == "cuda" for d in copy.dest)


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
def test_card_staged_copy_equals_the_direct_copy(card, form):
    copy = stager(card)
    for seed in (30, 31):
        x, m = host_form(form, seed), mask(seed)
        u8, got = copy.copy(x, m)
        copy.release()
        assert torch.equal(u8, torch.as_tensor(np.asarray(x), device=card))
        assert torch.equal(got, torch.as_tensor(m, device=card))


@pytest.mark.card
def test_card_scorer_stages_host_frames_and_not_device_ones(card):
    """On the card the scorer stages host frames (bitwise as the direct
    copy, through pinned buffers) and takes a device chunk as it is."""
    staged, direct = scorers(card)
    del staged._stages  # the class's own test
    chunks = [(frames(40 + i), None) for i in range(3)]
    assert_same_run(staged, direct, chunks)
    assert staged._staging.host[0].is_pinned() and direct._staging is None
    on_card = torch.as_tensor(frames(43), device=card)
    fresh = MultiStreamScorer(_model(card), None, SLOTS, CHUNK, SIZE, device=card)
    for slot in range(SLOTS):
        fresh.attach(slot)
    fresh.score_chunk(on_card)
    assert fresh._staging is None
