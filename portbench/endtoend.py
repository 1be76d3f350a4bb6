"""End-to-end metrics from the client's records, on the host's clock.

A record is one request as the client saw it: when it was due (an open
loop's scheduled arrival; a closed loop's send), its prompt length, and
the time each of its tokens was received. The window is [t0, t1). Every
number is taken over all the work and all the time of the window; the run
does not drain, so a request still running at t1 counts with what it has
shown by then.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Record:
    prompt_len: int
    max_tokens: int
    due: float
    times: list = dataclasses.field(default_factory=list)
    finish: Optional[str] = None
    request: object = None  # the engine's Request while it runs

    def in_window(self, t0: float, t1: float) -> list:
        return [t for t in self.times if t0 <= t < t1]


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if len(values) else None


def ttfts_ms(recs, t0: float, t1: float) -> list[float]:
    """Over every request due in the window: first token received minus
    due; one with no first token by t1 counts t1 - due, so a stall cannot
    hide."""
    vals = []
    for r in recs:
        if t0 <= r.due < t1:
            first = r.times[0] if r.times and r.times[0] < t1 else t1
            vals.append((first - r.due) * 1e3)
    return vals


def tpots_ms(recs, t0: float, t1: float) -> list[float]:
    """Over every request with tokens received at two or more different
    times in the window: (last - first) over the tokens received after the
    first of those times. Tokens arrive a burst at a time (the engine
    fetches once a burst); for one token at a time this is the usual
    (last - first) / (tokens - 1), and it does not shrink with the tokens
    that share the first arrival."""
    vals = []
    for r in recs:
        ts = r.in_window(t0, t1)
        if len(ts) >= 2 and ts[-1] > ts[0]:
            later = sum(1 for t in ts if t > ts[0])
            vals.append((ts[-1] - ts[0]) / later * 1e3)
    return vals


def output_tok_s(recs, t0: float, t1: float) -> float:
    return sum(len(r.in_window(t0, t1)) for r in recs) / (t1 - t0)


def prompt_tok_s(recs, t0: float, t1: float) -> float:
    """Prompt tokens of the requests whose first token came in the window,
    per second of it."""
    return sum(r.prompt_len for r in recs
               if r.times and t0 <= r.times[0] < t1) / (t1 - t0)

