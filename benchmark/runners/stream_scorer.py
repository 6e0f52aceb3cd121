"""Multi-stream scoring through the port's ``MultiStreamScorer.score_chunk``
(the daemon's scorer), closed loop, one chunk in flight.

Traffic parameters: ``slots`` streams, all attached and all submitting
every tick; ``chunk`` frames a stream a tick; ``dtype`` and
``fused_input`` of the scorer; host uint8 chunks cycled from a pool of
``pool_chunks`` seeded chunks of every stream (``scene.stream_pool``);
``warm_chunks`` chunks scored before the window.

``correct`` (``judge``): the reference recomputes, from the program's own
carried state, every slot of the first chunk (from zero state) and of
``sample_chunks`` chunks drawn from the seed (a reservoir over the run),
comparing the scores and each layer's new (h, c); and it follows
``follow_slots`` slots drawn from the seed from zero state through every
chunk of the run, comparing every score and the final (h, c), so that
what the sampled check skips, the state carried over many chunks, is
held too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import judge, scene
from benchmark.reference import video_ae as ref
from benchmark.weights import make_weights, program_state_dict

# A CPU test run (``benchmark/tests/cases.py``): its traffic, the faults
# that ``plant`` takes, and whether a sound float32 run is held to the
# cell's limits.
SMALL = {"slots": 4, "chunk": 4, "pool_chunks": 2, "warm_chunks": 2, "sample_chunks": 3,
         "dtype": "float32"}
FAULTS = ("unchanged", "half_batch", "altered")
SOUND_SMALL_RUN_CORRECT = True


def _rng(ctx, key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(ctx.seed), key]))


def _program_scorer(ctx, weights, slots: int, chunk: int):
    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

    model = VideoAutoencoder.from_config(VideoAEConfig.from_args(ctx.cfg), device=ctx.device)
    model.load_state_dict(program_state_dict(weights))
    fused = ctx.traffic["fused_input"] if ctx.cuda else False
    return MultiStreamScorer(model, None, num_slots=slots, chunk=chunk,
                             image_size=ctx.cfg["image_size"],
                             dtype=getattr(torch, ctx.traffic["dtype"]),
                             fused_input=fused, device=ctx.device)


def plant(scorer, fault: str, slots: int):
    """Break the scorer underneath (tests and control runs only)."""
    inner = scorer.score_chunk

    def unchanged(frames, submitted=None):
        before = scorer.states
        out = inner(frames, submitted)
        scorer.states = before
        return out

    def half_batch(frames, submitted=None):
        half = slots // 2
        before = scorer.states
        out = inner(frames, submitted)
        after = scorer.states
        # the second half of the slots is left out: its rows repeat the first half's
        out[half:2 * half] = out[:half]
        scorer.states = tuple((torch.cat([h[:half], hb[half:]]), torch.cat([c[:half], cb[half:]]))
                              for (h, c), (hb, cb) in zip(after, before))
        return out

    def altered(frames, submitted=None):
        out = inner(frames, submitted)
        out[slots - 1] *= 1.1  # the last stream's answers altered where they are produced
        return out

    scorer.score_chunk = {"unchanged": unchanged, "half_batch": half_batch,
                          "altered": altered}[fault]


class CellRun:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        tr, size = ctx.traffic, ctx.cfg["image_size"]
        self.slots, self.chunk = tr["slots"], tr["chunk"]
        self.weights = make_weights(ctx.cfg, ctx.seed, ctx.device)
        self.pool = scene.stream_pool(ctx.seed, self.slots, tr["pool_chunks"], self.chunk, size)
        ctx.mark("weights and frames")
        if ctx.side == "program":
            self.scorer = _program_scorer(ctx, self.weights, self.slots, self.chunk)
        else:
            self.scorer = ref.ReferenceScorer(ctx.cfg, self.weights, self.slots, self.chunk,
                                              "fp8", ctx.device)
        if ctx.fault:
            plant(self.scorer, ctx.fault, self.slots)
        for s in range(self.slots):
            self.scorer.attach(s)
        self.follow = np.sort(_rng(ctx, 1).choice(self.slots, tr["follow_slots"], replace=False))
        self.sampler = _rng(ctx, 2)
        self.scores = []  # every chunk's scores [slots, chunk]
        self.samples = {}  # reservoir place -> (chunk number, states before, after)
        ctx.mark("program")
        for _ in range(tr["warm_chunks"]):
            self._score()
        ctx.sync()
        ctx.mark("warm-up")

    def _score(self):
        i = len(self.scores)
        frames = self.pool[i % len(self.pool)]
        keep = self.ctx.traffic["sample_chunks"]
        # chunk 0 always; of the later chunks a uniform reservoir of ``keep``,
        # chosen before the chunk runs
        if i == 0:
            pos = "start"
        elif i <= keep:
            pos = i - 1
        else:
            j = int(self.sampler.integers(0, i))
            pos = j if j < keep else None
        before = self.scorer.states if pos is not None else None
        with self.ctx.tracer.span("score_chunk"):
            out = self.scorer.score_chunk(frames)
        self.scores.append(out)
        if pos is not None:
            self.samples[pos] = (i, before, self.scorer.states)

    def window(self) -> dict:
        ctx = self.ctx
        first = len(self.scores)
        ctx.window_started()
        start = time.perf_counter()
        deadline = start + ctx.seconds
        while True:
            self._score()  # returns host scores: the chunk is complete
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - start
        ctx.window_closed()
        chunks = len(self.scores) - first
        self.final = self.scorer.states
        return {"e2e": {"frames_per_s": chunks * self.slots * self.chunk / elapsed},
                "counts": {"chunks": chunks, "frames": chunks * self.slots * self.chunk,
                           "window_s": elapsed},
                "attempted": chunks, "failed": 0}

    @torch.no_grad()
    def judge(self) -> dict:
        ctx = self.ctx
        del self.scorer
        if ctx.cuda:
            torch.cuda.empty_cache()
        num, w = ref.Numerics("f32"), self.weights
        score_gap, state_gap = 0.0, 0.0
        with ref.exact_f32():
            for i, before, after in self.samples.values():
                u8 = torch.as_tensor(self.pool[i % len(self.pool)], device=ctx.device)
                got, states = ref.score_chunk(w, u8, before, num)
                score_gap = max(score_gap, judge.rel_gap(self.scores[i], got.cpu()))
                state_gap = max(state_gap, judge.state_gap(after, states))
            follow = torch.as_tensor(self.follow)
            states = ref.zero_states(ctx.cfg, len(self.follow), self.pool.shape[3:5], ctx.device)
            for i, out in enumerate(self.scores):
                u8 = torch.as_tensor(self.pool[i % len(self.pool)][self.follow], device=ctx.device)
                got, states = ref.score_chunk(w, u8, states, num)
                score_gap = max(score_gap, judge.rel_gap(out[self.follow], got.cpu()))
            final = tuple((h[follow.to(h.device)], c[follow.to(c.device)]) for h, c in self.final)
            state_gap = max(state_gap, judge.state_gap(final, states))
        return {"score_gap": score_gap, "state_gap": state_gap}


def prepare(ctx) -> CellRun:
    return CellRun(ctx)
