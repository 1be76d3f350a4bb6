"""The engine-log readers (engine_log.py and the metrics that call it)
against synthetic iteration records and requests: the counted
half-window [t0, t0 + count_s) alone, the run's engine alone, the
per-step and per-token quotients, the median queue wait, and None on an
empty window or a program without the log."""

from __future__ import annotations

import collections
import sys
import types

import pytest

from gabby_tpu_torch.runtime import tracing
from portbench import endtoend, spec

T0, COUNT_S = 100.0, 10.0


def _it(t0, engine=1, compose=0.0, admit=0.0, decode=0.0, fetch=0.0,
        emit=0.0, steps=0, prompt_tokens=0):
    return tracing.Iteration(engine, t0, compose, admit, decode, fetch, emit,
                             steps, prompt_tokens)


def _req(submit, admit):
    rec = endtoend.Record(prompt_len=16, max_tokens=8, due=submit)
    rec.request = types.SimpleNamespace(submit_ts=submit, admit_ts=admit)
    return rec


def _run(records=()):
    return types.SimpleNamespace(t0=T0, count_s=COUNT_S,
                                 records=list(records))


@pytest.fixture()
def log(monkeypatch):
    ring = collections.deque(maxlen=8192)
    monkeypatch.setattr(tracing, "LOG", ring)
    return ring


WINDOW = [
    _it(99.0, admit=1.0, decode=1.0, steps=8, prompt_tokens=512),  # before
    _it(100.0, compose=0.001, admit=0.2, decode=0.4, fetch=0.01, emit=0.03,
        steps=8, prompt_tokens=512),
    _it(105.0, compose=0.002, decode=0.5, fetch=0.02, emit=0.05, steps=8),
    _it(101.0, engine=2, admit=9.0, steps=1, prompt_tokens=64),  # another
    _it(110.0, admit=1.0, decode=1.0, steps=8, prompt_tokens=512),  # after
]
REQUESTS = [_req(99.5, 100.1), _req(100.0, 100.3), _req(101.0, 101.2),
            _req(98.0, 99.9), _req(109.0, 110.0), _req(104.0, None)]

EXPECTED = {
    "admit_ms_per_step": 200 / 16,
    "dispatch_ms_per_step": 900 / 16,
    "fetch_ms_per_step": 30 / 16,
    "emit_ms_per_step": (3 + 80) / 16,
    "admit_ms_per_ktok": 200 / 0.512,
    "admit_wait_ms.serve": 300.0,   # waits 600, 300, 200 ms
    "admit_wait_ms.prefill": 300.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_takes_the_window_and_the_runs_engine(log, name):
    log.extend(WINDOW)
    got = spec.reader(name).read(_run(REQUESTS))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_on_an_empty_window(log, name):
    log.extend(r for r in WINDOW if not T0 <= r.t0 < T0 + COUNT_S)
    assert spec.reader(name).read(
        _run(r for r in REQUESTS
             if r.request.admit_ts is None
             or not T0 <= r.request.admit_ts < T0 + COUNT_S)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_the_programs_log(monkeypatch, name):
    # a program that lacks the log: the module is missing and requests
    # carry no admission stamp
    monkeypatch.setitem(sys.modules, "gabby_tpu_torch.runtime.tracing", None)
    reqs = [endtoend.Record(16, 8, 100.5, request=types.SimpleNamespace(
        submit_ts=100.5))]
    assert spec.reader(name).read(_run(reqs)) is None


def test_iterations_without_steps_give_no_quotient(log):
    log.append(_it(102.0, admit=0.5, prompt_tokens=0))
    for name in ("admit_ms_per_step", "admit_ms_per_ktok"):
        assert spec.reader(name).read(_run()) is None
