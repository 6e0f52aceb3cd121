"""Readings that set a cell's limits, many seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]
        [--side program|control] [--fault unchanged|half_batch|altered]
        [--seconds <s>]

``--side program`` runs the cell as ``run.py`` does (sound runs: the
lower readings); ``--side control`` puts the reference, one precision
lower than the cell states, in the program's place (the upper readings);
``--fault`` plants one of the faults that the cell can have under the
timed path.  One JSON line a seed: the compared numbers, the end-to-end
metrics and the counts.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import ROOT, _environment, execute


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--side", choices=("program", "control"), default="program")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    _environment()
    from benchmark.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    seconds = args.seconds or manifest.data["run_seconds"]
    for seed in args.seeds:
        result, verdict = execute(manifest, cell, seed, seconds, False, args.device,
                                  side=args.side, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": args.side,
                          "fault": args.fault,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "attempted": result["attempted"], "failed": result["failed"],
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                          "numbers": verdict.numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
