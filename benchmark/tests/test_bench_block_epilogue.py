"""``block_epilogue_roofline`` and its counts (``benchmark/counts_epilogue.py``)
on synthetic traces: the bytes bound of every chunk over the device time of
the kernels named ``block_epilogue_kernel*``, and nothing where no such
kernel ran."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import counts, counts_epilogue
from benchmark import manifest as mf
from benchmark.tracing import Trace

M = mf.Manifest()
METRIC = "block_epilogue_roofline"
CELLS = ("video256.stream16", "video512.stream16")
ENCODER = "void (anonymous namespace)::block_epilogue_kernel_encoder<__nv_bfloat16>(...)"
DECODER = "void (anonymous namespace)::block_epilogue_kernel_decoder<__nv_bfloat16>(...)"
LAST = "void (anonymous namespace)::block_epilogue_kernel_last<__nv_bfloat16>(...)"


def _trace(rows):
    trace = Trace.__new__(Trace)
    trace.lo, trace.hi, trace.default_label, trace.spans = 0.0, 1.0, "outside", []
    trace.names = [r[0] for r in rows]
    trace.kinds = np.array([r[1] for r in rows])
    trace.iv = np.array([(r[2], r[3]) for r in rows]).reshape(-1, 2)
    return trace


def _run(cell, rows, chunks):
    entry = M.workload(cell)
    return SimpleNamespace(trace=_trace(rows), cfg=M.config(entry["config"]),
                           traffic=M.traffic(entry["traffic"]), counts={"chunks": chunks})


def _read(run):
    return mf.metric_reader(METRIC, M.folder).read(run)


def test_a_chunks_bytes_at_the_published_widths():
    """Each call's convolution output read once and its result written
    once (encoder blocks pooled 2x2), with its f32 bias: 16 x 16 frames."""
    cfg = M.config("video_ae_256")
    assert counts_epilogue.calls(cfg) == [
        ("encoder", 64, 128), ("encoder", 128, 64), ("encoder", 128, 32),
        ("decoder", 128, 32), ("decoder", 64, 64), ("decoder", 32, 128), ("last", 3, 256)]
    frames = 256
    enc = frames * (128 * 128 * 64 + 64 * 64 * 128 + 32 * 32 * 128) * 2
    dec = frames * (32 * 32 * 128 + 64 * 64 * 64 + 128 * 128 * 32 + 256 * 256 * 3) * 2
    bias = (64 + 128 + 128 + 128 + 64 + 32 + 3) * 4
    assert counts_epilogue.chunk_bytes(cfg, frames, 2) == enc * 5 / 4 + 2 * dec + bias
    assert counts_epilogue.chunk_bytes(cfg, frames, 2) == pytest.approx(2.2314e9, rel=1e-4)
    # 512x512: every activation 4x, the biases the same
    big = counts_epilogue.chunk_bytes(M.config("video_ae_512"), frames, 2)
    assert big == pytest.approx(4 * (enc * 5 / 4 + 2 * dec) + bias)


@pytest.mark.parametrize("cell", CELLS)
def test_the_bound_over_the_kernels_device_time(cell):
    """Three chunks, each of the seven calls 0.2 ms on the device, beside
    kernels of other names, which are not counted."""
    rows, t = [], 0.0
    for _ in range(3):
        for name in (ENCODER,) * 3 + (DECODER,) * 3 + (LAST,):
            rows.append((name, "kernel", t, t + 2e-4))
            rows.append(("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", t + 2e-4, t + 5e-4))
            t += 5e-4
    rows.append(("Memcpy HtoD (Pinned -> Device)", "memcpy", t, t + 1e-3))
    run = _run(cell, rows, chunks=3)
    tr = run.traffic
    bound = counts.bound_s(0.0, counts_epilogue.chunk_bytes(run.cfg, tr["slots"] * tr["chunk"], 2))
    assert _read(run) == pytest.approx(100.0 * 3 * bound / (21 * 2e-4))


@pytest.mark.parametrize("program", ["unfolded_blocks", "no_trace"])
def test_a_program_without_the_kernel_reads_nothing(program):
    """The parent of the fold (BatchNorm, max-pool and activations as
    PyTorch's kernels) launches no epilogue: the metric is left out."""
    rows = [("void at::native::batch_norm_transform_input_channels_last_kernel", "kernel",
             0.0, 1e-3),
            ("void at::native::max_pool_forward_nhwc", "kernel", 1e-3, 2e-3),
            ("void at::native::elementwise_kernel<128, 4>", "kernel", 2e-3, 3e-3)]
    run = _run(CELLS[0], rows, chunks=1)
    if program == "no_trace":
        run.trace = None
    assert _read(run) is None


def test_the_metric_is_declared_for_the_scoring_cells():
    entry = next(m for m in M.data["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == list(CELLS) and entry["layer"] == "kernels"
    assert entry["moves"] == "frames_per_s" and entry["source"] == "device_trace"
