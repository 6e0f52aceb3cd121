"""The MemAE cell's own data: its seeded memory read at the published
widths is sparse and never empty, and its counts of work are those made
by hand."""

import pytest
import torch

from benchmark import counts_memae, scene
from benchmark.manifest import Manifest
from benchmark.reference import memae as ref
from benchmark.runners.clip_scorer import cell_weights

M = Manifest()
CFG = M.config("memae_256")


@pytest.mark.parametrize("seed", [2**31 + 31, 4_100_000_001])
def test_the_cells_seeded_read_is_sparse_and_never_empty(seed):
    """On 64x64 frames of the cell's scenes, M scaled by the configuration's
    ``memory_scale`` keeps 10-200 of the 2,000 items a query on average,
    and under 1% of the queries read nothing (the plain draw keeps none)."""
    w = cell_weights(CFG, seed, "cpu")
    u8 = torch.as_tensor(scene.stream_pool(seed, 4, 1, CFG["sequence_length"], 64)[0])
    num = ref.Numerics("f32")
    with torch.no_grad(), ref.exact_f32():
        q = ref.queries(ref.encode(ref.gray(u8), w, num))
        kept = (ref.address(q, w, CFG["shrink_thres"], num) > 0).sum(dim=1).double()
        plain = {**w, ref.MEMORY: w[ref.MEMORY] / CFG["assumed"]["memory_scale"]}
        none = (ref.address(q, plain, CFG["shrink_thres"], num) > 0).sum(dim=1)
    assert q.shape == (4 * 2 * 4 * 4, 256)
    assert 10 <= float(kept.mean()) <= 200
    assert float((kept == 0).double().mean()) < 0.01
    assert int(none.max()) == 0


def test_flops_per_frame_by_hand():
    enc = (16 * 128 * 128 * 1 * 96 + 8 * 64 * 64 * 96 * 128 + 4 * 32 * 32 * 128 * 256
           + 2 * 16 * 16 * 256 * 256) * 27
    mem = 2 * (2 * 16 * 16) * 2000 * 256
    assert counts_memae.flops_per_frame(CFG) == 2 * (2 * enc + mem) / 16
    assert counts_memae.flops_per_frame(CFG) == pytest.approx(4.086e9, rel=1e-4)
    assert counts_memae.memory_read_flops(512, 2000, 256) == 4 * 512 * 2000 * 256
