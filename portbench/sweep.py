"""The knee of a cell's mix offered as an open loop, at several fixed
rates (Poisson arrivals of the cell's lengths):

    python -m portbench.sweep --workload mistral7b.chat --seed 7 \\
        --seconds 30 --rates 0.4 0.6 0.8

One line a rate: the metrics, the requests due in the window, and the
backlog (requests sent and not yet given a first token) over the window's
first and last thirds. The knee is the highest rate whose backlog does not
grow over a window. An open-loop cell that measures latency offers about
four fifths of it; above the knee the backlog grows all through a run and
the tokens completed are capped by the rate offered. A tool run once when
such a cell's rate is set, with the generator as committed; the
benchmark's runs do not call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import endtoend, harness, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    for rate in args.rates:
        traffic_d = dict(spec.traffic(cell["traffic"]), loop="open",
                         rate_rps=rate)
        t = time.monotonic()
        res, _, backlog = harness.run(
            bench, args.workload, args.seed, args.seconds, False,
            torch.device("cuda"), t, traffic_d=traffic_d)
        win = [n for s, n in backlog if 0 <= s < args.seconds]
        third = max(1, len(win) // 3)
        print(json.dumps({
            "rate_rps": rate, "metrics": {k: v["value"] for k, v in
                                          res["metrics"].items()},
            "attempted": res["attempted"], "correct": res["correct"],
            "backlog_first_third": sum(win[:third]) / third,
            "backlog_last_third": sum(win[-third:]) / third,
            "backlog": win}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
