"""``memae_epilogue_roofline`` and its counts
(``benchmark/counts_memae_epilogue.py``) on synthetic traces: the bytes
bound of every chunk over the device time of the kernels named
``block_epilogue_kernel*``, and nothing where no such kernel ran."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import counts, counts_memae_epilogue
from benchmark import manifest as mf
from benchmark.tracing import Trace

M = mf.Manifest()
METRIC = "memae_epilogue_roofline"
CELL = "memae256.clip16"
LEAKY = "void (anonymous namespace)::block_epilogue_kernel_leaky<__nv_bfloat16>(...)"


def _trace(rows):
    trace = Trace.__new__(Trace)
    trace.lo, trace.hi, trace.default_label, trace.spans = 0.0, 1.0, "outside", []
    trace.names = [r[0] for r in rows]
    trace.kinds = np.array([r[1] for r in rows])
    trace.iv = np.array([(r[2], r[3]) for r in rows]).reshape(-1, 2)
    return trace


def _run(rows, chunks):
    entry = M.workload(CELL)
    return SimpleNamespace(trace=_trace(rows), cfg=M.config(entry["config"]),
                           traffic=M.traffic(entry["traffic"]), counts={"chunks": chunks})


def _read(run):
    return mf.metric_reader(METRIC, M.folder).read(run)


def test_a_chunks_bytes_at_the_published_widths():
    """Each of the seven calls' convolution output read once and its result
    written once, with its f32 bias: 16 clips of 16 frames, bf16."""
    cfg = M.config("memae_256")
    assert counts_memae_epilogue.calls(cfg) == [
        (16, 128, 128, 96), (8, 64, 64, 128), (4, 32, 32, 256), (2, 16, 16, 256),
        (4, 32, 32, 256), (8, 64, 64, 128), (16, 128, 128, 96)]
    clips = 16
    enc = clips * (16 * 128 * 128 * 96 + 8 * 64 * 64 * 128 + 4 * 32 * 32 * 256
                   + 2 * 16 * 16 * 256)
    dec = clips * (4 * 32 * 32 * 256 + 8 * 64 * 64 * 128 + 16 * 128 * 128 * 96)
    assert enc + dec == 975_175_680
    bias = (96 + 128 + 256 + 256 + 256 + 128 + 96) * 4
    assert counts_memae_epilogue.chunk_bytes(cfg, clips, 2) == 2 * 2 * (enc + dec) + bias
    assert counts_memae_epilogue.chunk_bytes(cfg, clips, 2) == 3_900_707_584
    assert counts.bound_s(0.0, 3_900_707_584) == pytest.approx(1.1644e-3, rel=1e-4)


def test_the_bound_over_the_kernels_device_time():
    """Two chunks, each of the seven calls 0.2 ms on the device, beside
    cuDNN's convolutions and the copy, which are not counted."""
    rows, t = [], 0.0
    for _ in range(2):
        for _ in range(7):
            rows.append((LEAKY, "kernel", t, t + 2e-4))
            rows.append(("sm90_xmma_dgrad_implicit_gemm_bf16", "kernel", t + 2e-4, t + 9e-4))
            t += 9e-4
    rows.append(("Memcpy HtoD (Pinned -> Device)", "memcpy", t, t + 1e-3))
    run = _run(rows, chunks=2)
    tr = run.traffic
    bound = counts.bound_s(0.0, counts_memae_epilogue.chunk_bytes(run.cfg, tr["slots"], 2))
    assert _read(run) == pytest.approx(100.0 * 2 * bound / (14 * 2e-4))


@pytest.mark.parametrize("program", ["unfolded_layers", "no_trace"])
def test_a_program_without_the_kernel_reads_nothing(program):
    """The parent of the fold (BatchNorm3d, the bias add and LeakyReLU as
    PyTorch's kernels) launches no epilogue: the metric is left out."""
    rows = [("void at::native::elementwise_kernel<128, 4>", "kernel", 0.0, 1e-3),
            ("void at::native::vectorized_elementwise_kernel<8>", "kernel", 1e-3, 2e-3),
            ("implicit_convolveNd_sgemm", "kernel", 2e-3, 3e-3)]
    run = _run(rows, chunks=1)
    if program == "no_trace":
        run.trace = None
    assert _read(run) is None


def test_the_metric_is_declared_for_the_memae_cell():
    entry = next(m for m in M.data["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == [CELL] and entry["layer"] == "kernels"
    assert entry["moves"] == "frames_per_s" and entry["source"] == "device_trace"
