"""Multi-stream scoring of a clip model (MemAE) through the port's
``MultiStreamScorer.score_chunk`` (the daemon's scorer), closed loop, one
chunk in flight.

Traffic parameters: ``slots`` streams, all attached and all submitting
every tick; ``chunk`` frames a stream a tick, one clip (the model carries
no state from one chunk to the next); ``dtype`` of the scorer's
convolutions (the memory's read runs in float32 whatever it is); host
RGB uint8 chunks cycled from a pool of ``pool_chunks`` seeded chunks of
every stream (``scene.stream_pool``); ``warm_chunks`` chunks scored before
the window.

The weights are ``weights.make_weights``'s draw with the memory M scaled
by the configuration's ``assumed.memory_scale``: under the plain draw
every softmax weight lies below the shrinkage's threshold, so the read is
empty and the decoder never sees the input (``PERF.md``).

``correct`` (``judge``): every slot of the first chunk and of
``sample_chunks`` chunks drawn from the seed (a reservoir over the run,
each chosen before it runs), as the timed path produced them: the frame
scores against the reference's float32 forward of the same frames
(``score_gap``), the encoder's z (``latent_gap``), and the memory's read
z_hat against the reference's addressing and read of the program's own z
(``read_gap``), so that a threshold flip the convolutions cause does not
hide one the addressing causes.  z and z_hat are taken by forward hooks on
the scorer's ``model.encoder`` and ``model.mem_rep``, registered only
around the sampled chunks.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import judge, scene
from benchmark.reference import memae as ref
from benchmark.weights import make_weights, program_state_dict

# A CPU test run (``benchmark/tests/cases.py``): its traffic, the faults
# that ``plant`` takes, and whether a sound float32 run is held to the
# cell's limits.
SMALL = {"slots": 4, "chunk": 8, "pool_chunks": 2, "warm_chunks": 1, "sample_chunks": 3,
         "dtype": "float32"}
FAULTS = ("altered", "half_batch", "no_shrink", "memory_bypassed")
SOUND_SMALL_RUN_CORRECT = True


def _rng(ctx, key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(ctx.seed), key]))


def cell_weights(cfg: dict, seed: int, device) -> dict:
    """The seeded draw, M scaled by ``assumed.memory_scale``."""
    w = make_weights(cfg, seed, device)
    w[ref.MEMORY] = w[ref.MEMORY] * float(cfg["assumed"]["memory_scale"])
    return w


def _program_scorer(ctx, weights, slots: int, chunk: int):
    from vad_tpu_torch.core.config import MemAEConfig
    from vad_tpu_torch.eval.serving import MultiStreamScorer
    from vad_tpu_torch.models.memae import MemAutoencoder

    model = MemAutoencoder.from_config(MemAEConfig.from_args(ctx.cfg), device=ctx.device)
    model.load_state_dict(program_state_dict(weights))
    return MultiStreamScorer(model, None, num_slots=slots, chunk=chunk,
                             image_size=ctx.cfg["image_size"],
                             dtype=getattr(torch, ctx.traffic["dtype"]), fused_input=False,
                             device=ctx.device)


def plant(scorer, fault: str, slots: int):
    """Break the scorer underneath (tests and control runs only)."""
    inner = scorer.score_chunk

    def altered(frames, submitted=None):
        out = inner(frames, submitted)
        out[slots - 1] *= 1.1  # the last stream's answers altered where they are produced
        return out

    def half_batch(frames, submitted=None):
        half = slots // 2
        frames = np.array(frames)
        frames[half:2 * half] = frames[:half]  # the second half answered from the first's
        return inner(frames, submitted)

    if fault == "no_shrink":
        scorer.model.mem_rep.memory.shrink_thres = 0.0
    elif fault == "memory_bypassed":
        scorer.model.mem_rep.forward = lambda z: z  # the decoder fed z
    else:
        scorer.score_chunk = {"altered": altered, "half_batch": half_batch}[fault]


def clip_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest relative L2 gap of one clip's tensor over the clips."""
    p, r = program.double().flatten(1), reference.to(program.device).double().flatten(1)
    gaps = torch.linalg.vector_norm(p - r, dim=1) / torch.linalg.vector_norm(r, dim=1).clamp_min(
        1e-30)
    return float(gaps.max())


class CellRun:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        tr, size = ctx.traffic, ctx.cfg["image_size"]
        self.slots, self.chunk = tr["slots"], tr["chunk"]
        self.weights = cell_weights(ctx.cfg, ctx.seed, ctx.device)
        self.pool = scene.stream_pool(ctx.seed, self.slots, tr["pool_chunks"], self.chunk, size)
        ctx.mark("weights and frames")
        if ctx.side == "program":
            self.scorer = _program_scorer(ctx, self.weights, self.slots, self.chunk)
        else:
            self.scorer = ref.ReferenceClipScorer(ctx.cfg, self.weights, self.slots, self.chunk,
                                                  "fp8", ctx.device)
        if ctx.fault:
            plant(self.scorer, ctx.fault, self.slots)
        for s in range(self.slots):
            self.scorer.attach(s)
        self.sampler = _rng(ctx, 2)
        self.chunks = 0
        self.samples = {}  # reservoir place -> (chunk number, scores, z, z_hat)
        ctx.mark("program")
        for _ in range(tr["warm_chunks"]):
            self._score()
        ctx.sync()
        ctx.mark("warm-up")

    def _place(self, i: int):
        """Chunk 0 always; of the later chunks a uniform reservoir of
        ``sample_chunks``, chosen before the chunk runs."""
        keep = self.ctx.traffic["sample_chunks"]
        if i == 0:
            return "start"
        if i <= keep:
            return i - 1
        j = int(self.sampler.integers(0, i))
        return j if j < keep else None

    def _score(self):
        i = self.chunks
        frames = self.pool[i % len(self.pool)]
        pos = self._place(i)
        caught = {"z": [], "z_hat": []}
        hooks = []
        if pos is not None:
            model = self.scorer.model
            for name, module in (("z", model.encoder), ("z_hat", model.mem_rep)):
                hooks.append(module.register_forward_hook(
                    lambda _m, _i, out, name=name: caught[name].append(out.detach().clone())))
        try:
            with self.ctx.tracer.span("score_chunk"):
                out = self.scorer.score_chunk(frames)
        finally:
            for h in hooks:
                h.remove()
        self.chunks += 1
        if pos is not None:
            self.samples[pos] = (i, out, torch.cat(caught["z"]), torch.cat(caught["z_hat"]))

    def window(self) -> dict:
        ctx = self.ctx
        first = self.chunks
        ctx.window_started()
        start = time.perf_counter()
        deadline = start + ctx.seconds
        while True:
            self._score()  # returns host scores: the chunk is complete
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - start
        ctx.window_closed()
        chunks = self.chunks - first
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
        num, w, shrink = ref.Numerics("f32"), self.weights, ctx.cfg["shrink_thres"]
        score_gap = latent_gap = read_gap = 0.0
        kept, queries = [], 0
        with ref.exact_f32():
            for i, scores, z, z_hat in self.samples.values():
                u8 = torch.as_tensor(self.pool[i % len(self.pool)], device=ctx.device)
                want, want_z = ref.score_clips(u8, w, ctx.cfg, num)
                score_gap = max(score_gap, judge.rel_gap(scores, want.cpu()))
                latent_gap = max(latent_gap, clip_gap(z, want_z))
                att = ref.address(ref.queries(z.float()), w, shrink, num)
                read = ref.memory(z.float(), w, shrink, num)
                read_gap = max(read_gap, clip_gap(z_hat, read))
                kept.append((att > 0).sum(dim=1).cpu())
                queries += att.shape[0]
        kept = torch.cat(kept).double()
        print(f"memory read of the sampled chunks (the reference's addressing of the program's "
              f"z): {float(kept.mean())!r} items kept a query on average, "
              f"{100.0 * float((kept == 0).sum()) / queries!r}% of {queries} queries empty",
              file=sys.stderr)
        return {"score_gap": score_gap, "latent_gap": latent_gap, "read_gap": read_gap}


def prepare(ctx) -> CellRun:
    return CellRun(ctx)
