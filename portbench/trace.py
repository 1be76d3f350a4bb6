"""Reduce one torch.profiler Chrome trace to what the per-layer metrics read.

Device events are the card's kernels, copies and fills. A device event
belongs to the spans (`pb.*`, from spans.py) that hold, on the launching
thread, the runtime call with its correlation id. The device is busy over
the UNION of its events' intervals (events on two streams that overlap
count once), and the traced window runs from the first event to the end
of the last.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    # device seconds under (phase, op) spans; op "all" = the whole phase
    device_s: dict = dataclasses.field(default_factory=dict)
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


def union_s(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of [start, end) pairs, in the
    units given."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class _Level:
    """Spans of one level on one thread (they do not overlap each other),
    searchable by a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        return None


def summarize(trace: dict, top: int = 10) -> Summary:
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    out = Summary()
    if not ev or not dev:
        return out
    t_lo = min(float(e["ts"]) for e in ev)
    t_hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in ev)
    out.window_s = (t_hi - t_lo) * 1e-6
    busy, merged = union_s((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev)
    out.busy_s = busy * 1e-6

    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    out.device_ops = [[n, s] for n, s in by_name.most_common(top)]

    # the pb.* spans by thread and level, and each launch's time and thread
    levels = collections.defaultdict(lambda: ([], []))
    for e in ev:
        if e.get("cat") == "user_annotation" and e["name"].startswith("pb."):
            s, name = float(e["ts"]), e["name"][3:]
            lv = levels[(e.get("pid"), e.get("tid"))]
            lv[0 if name in ("decode", "prefill") else 1].append(
                (s, s + float(e["dur"]), name))
    index = {k: (_Level(v[0]), _Level(v[1])) for k, v in levels.items()}
    launch = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
    device_s = collections.Counter()
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        where = launch.get(corr)
        if where is None or where[1] not in index:
            continue
        phases, ops = index[where[1]]
        phase = phases.at(where[0])
        if phase is None:
            continue
        device_s[phase, "all"] += float(e["dur"]) * 1e-6
        op = ops.at(where[0])
        if op is not None:
            device_s[phase, op] += float(e["dur"]) * 1e-6
    out.device_s = dict(device_s)

    # the idle gaps between busy intervals, by what the host was doing:
    # each piece of a gap goes to the innermost host event open over it,
    # on the thread that launched most (its events nest)
    host = [e for e in ev if e.get("cat") in HOST_CATS]
    threads = collections.Counter(w[1] for w in launch.values())
    main = threads.most_common(1)[0][0] if threads else None
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in host
                   if (e.get("pid"), e.get("tid")) == main),
                  key=lambda h: (h[0], -h[1]))
    bounds = sorted({t for h in host for t in h[:2]})
    stack, k = [], 0

    def innermost(t):
        nonlocal k
        while k < len(host) and host[k][0] <= t:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        return stack[-1][2] if stack else "(host outside any traced op)"

    gaps = collections.Counter()
    edges = [t_lo] + [x for iv in merged for x in iv] + [t_hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cuts = bounds[bisect.bisect_right(bounds, a):
                      bisect.bisect_left(bounds, b)]
        for p, q in zip([a] + cuts, cuts + [b]):
            gaps[innermost(p)] += (q - p) * 1e-6
    out.idle_gaps = [[n, s] for n, s in gaps.most_common(top)]
    return out
