"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and frames from the seed, the program built and every
shape the cell uses warmed up) is timed as ``setup_s``; then the cell's
runner measures for ``--seconds``.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profile of the window.  After the window the reference judges what
the program produced (``correct``); the numbers compared and their limits
are the last lines on standard error and the last key of the line.

The run needs as many CUDA devices as the cell asks for, and exits
non-zero without a result line when it lacks them, when the program is
missing, when a traced window holds no kernel, or when the process has
loaded JAX or the JAX package.  A per-layer metric whose reader finds
nothing to read (its kernels off the path) is left out of the line, with
a line on standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # the program's kernel caches, at fixed paths in the checkout


def _environment() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]  # the folder's modules are ``benchmark.*``
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def execute(manifest, cell: dict, seed: int, seconds: float, trace: bool, device,
            side: str = "program", fault=None, cfg=None, traffic=None):
    """Drive one run of ``cell`` on ``device``: ``(result, verdict)``.
    ``cfg``/``traffic`` replace the cell's files (tests at small sizes)."""
    import torch

    from benchmark import manifest as mf
    from benchmark.context import Context
    from benchmark.judge import Verdict
    from benchmark.tracing import Tracer

    cfg = cfg or manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    tracer = Tracer(trace, traffic.get("idle_label", "no span"))
    ctx = Context(cell["name"], cfg, traffic, seed, seconds, torch.device(device), tracer,
                  side=side, fault=fault)
    ctx.mark("imports")
    cell_run = mf.runner(traffic["runner"]).prepare(ctx)
    tracer.start()
    ctx.mark("profiler" if trace else "prepared")
    out = cell_run.window()
    tracer.stop()
    if trace and not tracer.trace.busy_s(kinds=("kernel",)) > 0:
        # no device time at all: every reading of the trace would be silent or wrong
        raise RuntimeError("the traced window holds no kernel: the profiler saw no device work")
    cuda = ctx.cuda
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = cell_run.judge()
    verdict = Verdict(numbers, manifest.limits(cell["name"]))
    view = SimpleNamespace(trace=tracer.trace, cfg=cfg, traffic=traffic, **out)
    metrics = {}
    if trace:
        for m in manifest.per_layer(cell["name"]):
            value = mf.metric_reader(m["name"], manifest.folder).read(view)
            if value is None:  # its kernels are off the path, or renamed: left out of the line
                print(f"METRIC {m['name']} LEFT OUT: nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(cell["name"]):
            value = ctx.setup_s if m["name"] == "setup_s" else out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": verdict.correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = {"device_ops": tracer.trace.top_ops(),
                               "idle_gaps": tracer.trace.idle_gaps()}
    result["checks"] = verdict.checks()
    print("set-up: " + ", ".join(f"{what} {age:.2f} s" for what, age in ctx.marks)
          + f", window {ctx.setup_s:.2f} s", file=sys.stderr)
    del cell_run
    gc.collect()
    return result, verdict


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    import torch

    from benchmark.manifest import Manifest, forbidden_modules

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    import vad_tpu_torch  # noqa: F401  (the program under test; missing = no result)

    result, verdict = execute(manifest, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for line in verdict.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
