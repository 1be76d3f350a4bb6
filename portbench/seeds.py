"""The check's readings over many seeds in one process, for setting a
cell's limits: the program as served, or its control (`--control`: the
program's own fp8 activation path, the nearest precision below the
configuration's bf16 activations).

    python -m portbench.seeds --workload mistral7b.chat --seconds 10 \\
        --seeds 101 102 103 [--control]

One JSON line a seed: the numbers compared, the requests and tokens they
were taken over, and whether the run came out correct against the limits
of the configuration file. Each seed makes its weights, engine and
traffic anew, as a run of `portbench.run` does. A tool, not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, imports, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.seeds")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.seeds: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    for seed in args.seeds:
        res, nums, _ = harness.run(
            bench, args.workload, seed, args.seconds, False,
            torch.device("cuda"), time.monotonic(), control=args.control)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": res["correct"], **nums}), flush=True)
    found = imports.forbidden()
    if found:
        print(f"portbench.seeds: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
