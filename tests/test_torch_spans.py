"""The program's spans (``vad_tpu_torch/utils/profiling.py`` ``span``) in
the scorer, the model and the train step, on the CPU at a small size
(latent 32, hidden 32, one ConvLSTM layer, 32x32 frames, 2 slots of 2
frames; batches of 2 windows of 3 frames)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
from vad_tpu_torch.ops.losses import mse_per_sample
from vad_tpu_torch.train.state import make_optimizer
from vad_tpu_torch.train.steps import make_train_step
from vad_tpu_torch.utils import profiling

SLOTS, CHUNK, SIZE = 2, 2, 32


def _model():
    return init_training_weights(VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32,
                                                  lstm_layers=1, device="cpu"), 0)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _scorer():
    scorer = MultiStreamScorer(_model(), None, SLOTS, CHUNK, SIZE, device="cpu")
    for slot in range(SLOTS):
        scorer.attach(slot)
    return scorer


def _score(scorer):
    return scorer.score_chunk(_frames((SLOTS, CHUNK, SIZE, SIZE, 3)))


def _train(accum_steps=1):
    model = _model()
    step = make_train_step(mse_per_sample, accum_steps=accum_steps)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    batch = torch.from_numpy(_frames((2, 3, SIZE, SIZE, 3), 1))
    return lambda: step(model, optimizer, batch, 2)


def _ranges(prof):
    """The ``vad.*`` ranges a profile recorded: ``(name, start_ns, end_ns)``
    in order of start."""
    events = prof.profiler.kineto_results.events()
    found = [(e.name(), e.start_ns(), e.end_ns()) for e in events
             if e.is_user_annotation() and e.name().startswith("vad.")]
    return sorted(found, key=lambda r: r[1])


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_span_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("vad.a") is profiling.span("vad.b")
    with profiling.span("vad.a"), profiling.span("vad.a"):  # reentrant
        pass


@pytest.mark.parametrize("call", ["score_chunk", "train_step"])
def test_spans_off_never_enter_record_function(call, monkeypatch):
    """With no profiler running a span costs a flag check: it never builds
    a ``record_function``."""
    run = (lambda: _score(_scorer())) if call == "score_chunk" else _train()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()


def test_score_chunk_spans_nest():
    scorer = _scorer()
    _score(scorer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _score(scorer)
    ranges = _ranges(prof)
    (chunk,) = _named(ranges, "vad.scorer.chunk")
    (h2d,) = _named(ranges, "vad.scorer.h2d")
    (step,) = _named(ranges, "vad.scorer.step")
    assert _inside(h2d, chunk) and _inside(step, chunk) and h2d[2] <= step[1]
    (encoder,) = _named(ranges, "vad.model.encoder")
    (decoder,) = _named(ranges, "vad.model.decoder")
    assert _inside(encoder, step) and _inside(decoder, step) and encoder[2] <= decoder[1]


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_spans_in_order(accum_steps):
    """One ``vad.train.step`` holds forward and backward (one of each a
    microbatch), then the optimizer step, none overlapping the next."""
    run = _train(accum_steps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ranges = _ranges(prof)
    (step,) = _named(ranges, "vad.train.step")
    parts = [r for r in ranges if r[0] in ("vad.train.forward", "vad.train.backward",
                                            "vad.train.optimizer")]
    assert [r[0].split(".")[-1] for r in parts] == (
        ["forward", "backward"] * accum_steps + ["optimizer"])
    assert all(_inside(r, step) for r in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    forwards = _named(ranges, "vad.train.forward")
    for name in ("vad.model.encoder", "vad.model.decoder"):
        inner = _named(ranges, name)
        assert len(inner) == accum_steps
        assert all(any(_inside(r, f) for f in forwards) for r in inner)


def test_trace_names_the_scorer_spans(tmp_path):
    """``profiling.trace`` (the trainers' ``--profile-dir``) records the
    spans into its Chrome trace."""
    scorer = _scorer()
    with profiling.trace(tmp_path / "trace"):
        _score(scorer)
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"vad.scorer.chunk", "vad.scorer.h2d", "vad.scorer.step",
            "vad.model.encoder", "vad.model.decoder"} <= names
