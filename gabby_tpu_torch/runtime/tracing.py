"""The port's own measurement at its layer boundaries: profiler spans and
the engine's iteration log.

`span(name)` opens `torch.profiler.record_function("gabby." + name)` while
torch.profiler records (a `--profiler-port` capture, runtime/profiler.py,
or any `torch.profiler.profile`): the span lands in that Chrome trace, on
the clock of the kernels launched under it, so the device's idle gaps can
be put down to the phase the host was in. Otherwise it returns one shared
no-op context and allocates nothing. The sites, from the engine down:

    engine      gabby.engine.iteration, holding gabby.engine.compose,
                .admit, .decode, .fetch and .emit (runtime/engine.py)
    model step  gabby.model.prefill, gabby.model.decode_step,
                gabby.model.sample (runtime/generate.py)
    ops         gabby.matmul (ops/linear.linear), gabby.attn (the entries
                of ops/attention.py)

`Clock` books one engine iteration's seconds to its five phases from the
clock reads that delimit the engine's spans, on `time.monotonic` (the
clock of `Request.submit_ts` and `admit_ts`), always, profiler or not.
Each iteration that runs a plan appends one `Iteration` record to `LOG`, a
ring of the last 8192 over every engine of the process, each record
tagged with its engine's id; `Engine.stats` keeps the phases' running
sums.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch

PHASES = ("compose", "admit", "decode", "fetch", "emit")
COMPOSE, ADMIT, DECODE, FETCH, EMIT = range(len(PHASES))

# one iteration of an engine's loop: its start on time.monotonic, the
# seconds of each phase, the decode steps of its burst and the prompt
# tokens its admission prefilled (burst lanes or one chunk; a reused
# prefix is not prefilled)
Iteration = collections.namedtuple(
    "Iteration", ("engine", "t0") + PHASES + ("steps", "prompt_tokens"))

LOG: "collections.deque[Iteration]" = collections.deque(maxlen=8192)

_OFF = contextlib.nullcontext()
_PROFILER = torch.autograd.profiler  # its flag is read at every site
_engine_ids = itertools.count(1)


def span(name: str):
    """A profiler span `gabby.<name>` while torch.profiler records, else
    the shared no-op."""
    if _PROFILER._is_profiler_enabled:
        return torch.profiler.record_function("gabby." + name)
    return _OFF


class Clock:
    """One engine's iteration clock. `start()` opens an iteration;
    `lap(phase)` books the seconds since the last read to `phase` and
    returns the read; `close()` logs the iteration's record."""

    __slots__ = ("engine", "t0", "last", "secs", "steps", "prompt_tokens")

    def __init__(self):
        self.engine = next(_engine_ids)
        self.start()

    def start(self) -> None:
        self.t0 = self.last = time.monotonic()
        self.secs = [0.0] * len(PHASES)
        self.steps = self.prompt_tokens = 0

    def lap(self, phase: int) -> float:
        now = time.monotonic()
        self.secs[phase] += now - self.last
        self.last = now
        return now

    def close(self) -> Iteration:
        rec = Iteration(self.engine, self.t0, *self.secs, self.steps,
                        self.prompt_tokens)
        LOG.append(rec)
        return rec
