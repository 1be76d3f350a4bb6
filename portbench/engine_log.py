"""What the engine-log metrics read: the port's own iteration records
(`gabby_tpu_torch.runtime.tracing.LOG`: each engine iteration's start, the
seconds of its phases compose, admit, decode, fetch and emit, its decode
steps and the prompt tokens it prefilled) and admission stamps
(`Request.admit_ts`), over the counted half-window of a traced run, [t0,
t0 + count_s), the one `decode_step_ms` divides. Each returns None where
the window holds nothing to read, as on a program without the log."""

from __future__ import annotations

import collections
import statistics


def _window(run) -> tuple[float, float]:
    return run.t0, run.t0 + run.count_s


def iterations(run) -> list:
    """The records of the run's engine that started in the window: the
    engine that logged most there (a run serves one)."""
    try:
        from gabby_tpu_torch.runtime import tracing
    except ImportError:
        return []
    lo, hi = _window(run)
    recs = [r for r in list(tracing.LOG) if lo <= r.t0 < hi]
    if not recs:
        return []
    engine = collections.Counter(r.engine for r in recs).most_common(1)[0][0]
    return [r for r in recs if r.engine == engine]


def ms_per_step(run, phases: tuple):
    """The seconds of `phases` summed over the window's iterations, in ms,
    over the decode steps they ran."""
    recs = iterations(run)
    steps = sum(r.steps for r in recs)
    if not steps:
        return None
    return 1e3 * sum(getattr(r, p) for r in recs for p in phases) / steps


def admit_ms_per_ktok(run):
    """The admit phase's ms over the window's iterations per 1000 prompt
    tokens they prefilled."""
    recs = iterations(run)
    tokens = sum(r.prompt_tokens for r in recs)
    if not tokens:
        return None
    return 1e3 * sum(r.admit for r in recs) / (tokens / 1e3)


def admit_wait_ms(run):
    """The median wait from submission to admission (`admit_ts -
    submit_ts`) of the requests admitted in the window, in ms."""
    lo, hi = _window(run)
    waits = []
    for rec in run.records:
        req = rec.request
        t = getattr(req, "admit_ts", None)
        if t is not None and lo <= t < hi:
            waits.append((t - req.submit_ts) * 1e3)
    return statistics.median(waits) if waits else None
