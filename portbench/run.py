"""The benchmark's command: one run of one cell on one H100.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with a trace `breakdown`, and
last `check`: each number compared beside its limit), and the same
numbers as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for) and if
any module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up counts from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness, imports, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, nums, _ = harness.run(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"), T_START)
    found = imports.forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("setup_s by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in nums["setup_parts"].items()),
        file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
