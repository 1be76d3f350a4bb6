"""The port's own measurement (runtime/tracing.py) on the CPU with a tiny
random int4 model: `tracing.span` is the shared no-op while the profiler
is off (no span site reaches `record_function`); under a `Capturer`
capture the `gabby.*` spans nest engine > model step > op on the engine
thread; each iteration record's phases fit its wall, and the records'
decode steps and prompt tokens are the engine's counters; `admit_ts` lies
between submission and the first token for burst and single admissions;
the ring stays bounded; `stats_snapshot()` carries the phases' seconds
and `recent` the queue wait."""

from __future__ import annotations

import json
import threading
import time

import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops import quant
from gabby_tpu_torch.runtime import generate, tracing
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.runtime.profiler import Capturer
from gabby_tpu_torch.tokenizer import Tokenizer

MAX_SEQ = 256
MODES = {"dense": {}, "paged": dict(paged_pages=1 + 4 * MAX_SEQ // 16,
                                     page_size=16),
         "spec": dict(speculate_tokens=4)}


@pytest.fixture(scope="module")
def model():
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    gen = torch.Generator().manual_seed(7)
    params = llama.init_params(cfg, gen, dtype=torch.float32, device="cpu")
    return cfg, llama.fuse_projections(quant.quantize_tree(
        params, 4, unembed_bits=4, unembed_group=256))


def _engine(model, **kw) -> Engine:
    cfg, params = model
    return Engine(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size),
                  EngineConfig(batch_slots=4, max_seq=MAX_SEQ,
                               kv_quantized=True, cache_dtype="float32",
                               steps_per_call=4, spf_age_limit=1e9, **kw),
                  device="cpu", stop_ids=set())


def _prompt(n: int, k: int) -> list[int]:
    return [(k * 31 + j * 7) % 200 + 3 for j in range(n)]


def _wait(req) -> str:
    while True:
        _, fin = req.out.get(timeout=300)
        if fin is not None:
            return fin


def _drive(eng, reqs, limit=2000) -> None:
    """Iterations of a stopped engine until every request has finished."""
    fins = {id(r): None for r in reqs}
    admitting = None
    for _ in range(limit):
        if all(f is not None for f in fins.values()):
            return
        _, admitting = eng._iteration(admitting)
        for r in reqs:
            while not r.out.empty():
                _, fin = r.out.get_nowait()
                if fin is not None:
                    fins[id(r)] = fin
    raise AssertionError(f"requests unfinished: {fins}")


def _stopped(model, **kw) -> Engine:
    eng = _engine(model, **kw)
    eng.shutdown()
    eng._shutdown = False
    return eng


def _records(eng) -> list:
    return [r for r in tracing.LOG if r.engine == eng._clock.engine]


def test_span_off_is_the_shared_noop_and_never_records(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function reached with the profiler "
                             "off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = tracing.span("engine.iteration")
    assert off is tracing.span("matmul") is tracing._OFF
    with off:
        pass
    # every site: the engine's phases, the model step's and the ops'
    eng = _engine(model)
    try:
        reqs = [eng.submit_ids(_prompt(n, k), max_tokens=6)
                for k, n in enumerate((10, 12, 70))]
        assert [_wait(r) for r in reqs] == ["length"] * 3
    finally:
        eng.shutdown()
    assert _records(eng)


def _inside(a: dict, b: dict) -> bool:
    return (b["ts"] <= a["ts"] + 0.5
            and a["ts"] + a["dur"] <= b["ts"] + b["dur"] + 0.5)


def test_capture_nests_the_spans_on_the_engine_thread(model, tmp_path):
    eng = _engine(model)
    cap = Capturer(False)
    # the profiler's first start in a process costs seconds: paid here
    warm = torch.profiler.profile(activities=cap.activities())
    warm.start()
    warm.stop()
    eng.capturer = cap
    got = {}
    th = threading.Thread(
        target=lambda: got.setdefault("req", cap.capture(2.0, timeout=120)))
    try:
        th.start()
        time.sleep(0.3)  # the engine opens the window at its next boundary
        reqs = [eng.submit_ids(_prompt(n, k), max_tokens=16)
                for k, n in enumerate((10, 12, 40, 70))]
        assert all(_wait(r) in ("stop", "length") for r in reqs)
        th.join(150)
        assert not th.is_alive()
    finally:
        eng.shutdown()
    path = tmp_path / "trace.json"
    got["req"].profile.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("gabby.")]
    assert {e["tid"] for e in spans} == {eng._thread.native_id}
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    for name in ("compose", "admit", "decode", "fetch", "emit"):
        for e in by["gabby.engine." + name]:
            assert any(_inside(e, it) for it in by["gabby.engine.iteration"])
    for e in by["gabby.model.prefill"]:
        assert any(_inside(e, a) for a in by["gabby.engine.admit"])
    steps = by["gabby.model.decode_step"]
    assert len(steps) >= 8
    for step in steps:
        dec = [d for d in by["gabby.engine.decode"] if _inside(step, d)]
        assert dec and any(_inside(dec[0], it)
                           for it in by["gabby.engine.iteration"])
        for op in ("gabby.matmul", "gabby.attn"):
            assert any(_inside(e, step) for e in by[op]), op
    for e in by["gabby.model.sample"]:
        assert any(_inside(e, d) for d in by["gabby.engine.decode"])


@pytest.mark.parametrize("mode", list(MODES))
def test_iteration_records_add_up_to_the_counters(model, mode):
    eng = _stopped(model, **MODES[mode])
    s0 = eng.stats_snapshot()
    donor = eng.submit_ids(_prompt(80, 1), max_tokens=6)
    _drive(eng, [donor])
    # a prompt that shares the donor's 80 tokens takes them from its rows
    _drive(eng, [eng.submit_ids(_prompt(80, 1) + _prompt(20, 2),
                                max_tokens=6)])
    _drive(eng, [eng.submit_ids(_prompt(n, k), max_tokens=9)
                 for k, n in ((3, 10), (4, 12), (5, 40))])
    t_end = time.monotonic()
    s1 = eng.stats_snapshot()
    recs = _records(eng)
    assert s1["prefix_hits"] - s0["prefix_hits"] == 1
    assert len(recs) == s1["iterations"] - s0["iterations"] >= 3
    for rec, nxt in zip(recs, recs[1:] + [None]):
        phases = [getattr(rec, p) for p in tracing.PHASES]
        assert min(phases) >= 0
        wall = (nxt.t0 if nxt is not None else t_end) - rec.t0
        assert sum(phases) <= wall
    assert sum(r.steps for r in recs) == (s1["decode_steps"]
                                          - s0["decode_steps"])

    def prefilled(s):
        return s["prompt_tokens"] - s["prefix_tokens_reused"]
    assert sum(r.prompt_tokens for r in recs) == prefilled(s1) - prefilled(s0)
    for p in tracing.PHASES:
        assert s1[p + "_s"] - s0[p + "_s"] == pytest.approx(
            sum(getattr(r, p) for r in recs), rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("burst", [True, False])
def test_admit_ts_lies_between_submission_and_first_token(model, burst):
    eng = _stopped(model)
    lens = (10, 12) if burst else (40,)
    reqs = [eng.submit_ids(_prompt(n, k), max_tokens=5)
            for k, n in enumerate(lens)]
    _drive(eng, reqs)
    assert eng.stats["burst_admissions"] == (len(lens) if burst else 0)
    for r in reqs:
        assert r.submit_ts <= r.admit_ts <= r.first_token_ts
    queue_ms = sorted(round((r.admit_ts - r.submit_ts) * 1e3, 1)
                      for r in reqs)
    assert sorted(s["queue_ms"] for s in
                  eng.stats_snapshot()["recent"]) == queue_ms


def test_the_ring_stays_bounded():
    clock = tracing.Clock()
    assert tracing.LOG.maxlen == 8192
    for i in range(tracing.LOG.maxlen + 10):
        clock.start()
        clock.steps = i
        clock.close()
    assert len(tracing.LOG) == tracing.LOG.maxlen
    assert tracing.LOG[-1].engine == clock.engine
    assert tracing.LOG[-1].steps == tracing.LOG.maxlen + 9
    assert tracing.LOG[0].steps == 10


def test_stats_snapshot_carries_phase_seconds_and_queue_wait(model):
    eng = _engine(model)
    try:
        reqs = [eng.submit_ids(_prompt(n, k), max_tokens=8)
                for k, n in enumerate((10, 30))]
        assert all(_wait(r) == "length" for r in reqs)
    finally:
        eng.shutdown()  # the last iteration has logged once it returns
    s = eng.stats_snapshot()
    assert s["iterations"] >= 1
    assert all(isinstance(s[p + "_s"], float) for p in tracing.PHASES)
    assert s["decode_s"] > 0 and s["admit_s"] > 0
    assert len(s["recent"]) == 2
    for span in s["recent"]:
        assert 0 <= span["queue_ms"] <= span["ttft_ms"]


def test_model_step_spans_under_a_profile(model):
    """The model step's entries, called alone, record their spans in a
    profile opened on the calling thread, and none without one."""
    cfg, params = model
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    cache = create_cache(cfg, 2, MAX_SEQ, dtype=torch.float32,
                         quantized=True, device="cpu")
    tokens = torch.tensor(_prompt(16, 0), dtype=torch.int64)
    sstate = generate.SamplingState.greedy(2, "cpu")
    with torch.profiler.profile() as prof:
        logits, cache = generate.prefill_slot(params, cfg, tokens, 16, 0, 0,
                                              cache)
        generate.decode_loop(
            params, cfg, torch.tensor([5, 6], dtype=torch.int32),
            torch.tensor([16, 0], dtype=torch.int32),
            torch.tensor([True, False]), cache, sstate, 2)
    names = [e.name for e in prof.events()]
    assert names.count("gabby.model.prefill") == 1
    assert names.count("gabby.model.decode_step") == 2
    assert names.count("gabby.model.sample") == 2
    # every layer's four products and the unembed, a step and the chunk
    assert names.count("gabby.matmul") == 3 * (4 * cfg.num_layers + 1)
    assert names.count("gabby.attn") == 3 * cfg.num_layers
