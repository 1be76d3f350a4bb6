"""Dispatch-ahead fetches (`EngineConfig.pipeline_fetch`, the server's
`--pipeline-fetch`) in the port's engine, on the CPU.

With the fetch pipelined, burst N+1 is dispatched before burst N's host
view is read, so the host's bookkeeping lags one burst; what comes out
must not change. tests/test_engine.py:995-1035 on the port: six prompts
on two slots with varying max_tokens (slot reuse and overshoot) give the
synchronous streams, as they give gabby_tpu's pipelined engine's; the
same on the paged pool with a stop string, a penalized request, a
`top_logprobs` request and a seeded sampled request in the mix (the
logprobs and top rows equal too). Speculation leaves pipelining off, the
attention window and the page horizon cover the pending record's steps,
and a pending record is drained when no slot is live and at shutdown,
where every request is answered. Engines that must reach an exact state
are driven an iteration at a time with their loop stopped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.runtime.engine import (Engine, EngineConfig, Request,
                                            _BurstRecord, _Slot)
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

MAX_SEQ = 128
# the reference test's prompts and max_tokens
PROMPTS = [[(11 * i + j) % 250 + 2 for j in range(10 + (i % 3) * 17)]
           for i in range(6)]
MAX_TOKENS = [4 + (i % 3) * 3 for i in range(6)]
BASE = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
            steps_per_call_busy=2, default_max_tokens=8,
            cache_dtype="float32")


@pytest.fixture(scope="module")
def model():
    jc = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tcfg.tiny(max_seq_len=MAX_SEQ), params, tparams


def _engine(model, **kw):
    _, tc, _, tparams = model
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**{**BASE, **kw}), device="cpu")


def _finish(req):
    while True:
        _, fin = req.out.get(timeout=300)
        if fin is not None:
            return fin


def _serve(eng, extra=None):
    """PROMPTS (extra: request index -> further submit arguments) all
    queued before the engine's first iteration, then served with its loop
    stopped, an iteration at a time: each request's (tokens, finish,
    logprobs, top rows). Both modes must see the same arrivals: submitted
    to a running loop, the requests an iteration finds waiting depend on
    thread timing, and a burst admission (the lane-masked batched chunk)
    does not give a lone admission's f32 bits."""
    extra = extra or {}
    eng.shutdown()
    eng._shutdown = False
    reqs = [eng.submit_ids(p, max_tokens=n, **extra.get(i, {}))
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_TOKENS))]
    fins: list = [None] * len(reqs)
    admitting = None
    for _ in range(10000):
        for i, r in enumerate(reqs):
            while fins[i] is None and not r.out.empty():
                fins[i] = r.out.get()[1]
        if all(f is not None for f in fins):
            break
        _, admitting = eng._iteration(admitting)
    assert all(f is not None for f in fins), fins
    worked, _ = eng._iteration(admitting)  # idle: settles a pending record
    assert not worked
    return [(tuple(r.token_ids), fin, tuple(r.token_logprobs),
             tuple(map(tuple, r.token_top))) for r, fin in zip(reqs, fins)]


def _both(model, extra=None, **kw):
    out = {}
    for mode in (True, False):
        # no age guard: when it fires depends on the wall clock, and so
        # would the admission order
        eng = _engine(model, pipeline_fetch=mode, spf_age_limit=1e9, **kw)
        try:
            assert eng._pipeline == mode
            out[mode] = _serve(eng, extra)
        finally:
            eng.shutdown()
        assert eng._pending_burst is None
    return out


def test_pipeline_fetch_matches_synchronous(model):
    """tests/test_engine.py:995-1035: slot reuse stresses the epoch guard,
    varying max_tokens the overshoot discard."""
    out = _both(model)
    assert out[True] == out[False]
    assert [len(r[0]) for r in out[True]] == MAX_TOKENS
    assert {r[1] for r in out[True]} == {"length"}


def test_pipelined_streams_match_the_reference_pipelined_engine(model):
    jc, _, params, _ = model
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(**BASE, pipeline_fetch=True))
    try:
        reqs = [jeng.submit_ids(p, max_tokens=n)
                for p, n in zip(PROMPTS, MAX_TOKENS)]
        want = [tuple(r.token_ids) for r in reqs if _finish(r)]
    finally:
        jeng.shutdown()
    eng = _engine(model, pipeline_fetch=True)
    try:
        got = [r[0] for r in _serve(eng)]
    finally:
        eng.shutdown()
    assert got == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pipelined_features_match_synchronous(model, paged):
    """A stop string (cut from request 0's synchronous text), a penalized
    request, a top_logprobs request and a seeded sampled one among the six:
    tokens, finishes, logprobs and top rows equal, dense and on the paged
    pool (pages of 16)."""
    kw = dict(paged_pages=1 + 2 * MAX_SEQ // 16, page_size=16) if paged \
        else {}
    eng = _engine(model, **kw)
    try:
        first = eng.submit_ids(PROMPTS[0], max_tokens=MAX_TOKENS[0])
        _finish(first)
        text = eng.tokenizer.decode(first.token_ids)
    finally:
        eng.shutdown()
    stop = text[2:4]
    assert stop and len(first.token_ids) == MAX_TOKENS[0]
    extra = {0: dict(stop=[stop]),
             1: dict(presence_penalty=1.5, frequency_penalty=0.5,
                     logit_bias={7: 5.0}),
             2: dict(top_logprobs=3),
             3: dict(seed=1234, temperature=1.0)}
    out = _both(model, extra, **kw)
    assert out[True] == out[False]
    assert out[True][0][1] == "stop"
    assert len(out[True][0][0]) < MAX_TOKENS[0]
    assert len(out[True][2][3]) == len(out[True][2][0]) > 0


def test_speculation_leaves_pipelining_off(model):
    eng = _engine(model, pipeline_fetch=True, speculate_tokens=3)
    try:
        assert not eng._pipeline
        req = eng.submit_ids(PROMPTS[1], max_tokens=6)
        assert _finish(req) == "length" and len(req.token_ids) == 6
        assert eng._pending_burst is None
    finally:
        eng.shutdown()


def _record(steps):
    return _BurstRecord(packed=None, steps=steps, n_top=0, epochs=(0, 0),
                        first_slots=())


def _request(ids, n):
    return Request(prompt_ids=list(ids), max_tokens=n, temperature=0.0,
                   top_k=0, top_p=1.0)


def test_attention_window_covers_the_pending_steps(model):
    """The reference's lag term (gabby_tpu/runtime/engine.py:861-865): a
    slot 1010 rows in, a burst of 8 fits the 1024 window alone; with a
    pending record of 8 steps the host's count may be 8 short, so the
    window grows to the next rung."""
    eng = _engine(model, max_seq=4096, pipeline_fetch=True)
    eng.shutdown()
    eng._slots[0] = _Slot(request=_request([5] * 1010, 64),
                          prompt_len=1010)
    assert eng._attn_window(8) == 1024
    eng._pending_burst = _record(8)
    assert eng._attn_window(8) == 2048


def test_page_horizon_covers_the_pending_steps(model, monkeypatch):
    """The paged pool backs each live slot past the burst's furthest write
    plus the pending record's steps (the reference's :1680-1690)."""
    eng = _engine(model, pipeline_fetch=True, paged_pages=1 + 2 * 8,
                  page_size=16, steps_per_call_busy=4)
    eng.shutdown()
    eng._shutdown = False
    eng._backlog = [_request(PROMPTS[0], 12), _request(PROMPTS[3], 12)]
    _, admitting = eng._iteration(None)  # a burst, then 4 steps
    assert admitting is None and eng._pending_burst is not None
    horizons = []
    ensure = eng._ensure_pages
    monkeypatch.setattr(eng, "_ensure_pages", lambda i, upto: horizons.append(
        (i, upto)) or ensure(i, upto))
    lag = eng._pending_burst.steps
    want = [(i, s.prompt_len + len(s.request.token_ids) + lag + 4 + 2)
            for i, s in enumerate(eng._slots)]
    eng._iteration(None)
    assert horizons == want
    eng._shutdown = True


def test_pending_record_is_drained_when_no_slot_is_live(model):
    """Two requests of 5 tokens (the first token and a burst of 4): the
    first record carries all 5, and its host bookkeeping finishes both
    one iteration late, with the next burst's record pending. That record
    holds only overshoot; the next iteration, with no slot live, drains
    it and drops its tokens."""
    eng = _engine(model, pipeline_fetch=True, steps_per_call_busy=4)
    eng.shutdown()
    eng._shutdown = False
    reqs = [_request(PROMPTS[0], 5), _request(PROMPTS[3], 5)]
    eng._backlog = list(reqs)
    eng._iteration(None)
    assert all(not r.token_ids for r in reqs)  # the host lags one burst
    eng._iteration(None)
    assert [len(r.token_ids) for r in reqs] == [5, 5]
    assert all(s is None for s in eng._slots)
    assert eng._pending_burst is not None
    worked, _ = eng._iteration(None)
    assert not worked and eng._pending_burst is None
    assert [len(r.token_ids) for r in reqs] == [5, 5]
    eng._shutdown = True


def test_shutdown_with_a_record_pending_answers_every_request(model):
    """Two requests live with their whole output in the pending record and
    a third waiting: at shutdown the record is drained first, so the two
    finish "length" with their 5 tokens, and the third hears "abort"."""
    eng = _engine(model, pipeline_fetch=True, steps_per_call_busy=4)
    eng.shutdown()
    eng._shutdown = False
    reqs = [_request(PROMPTS[i], 5) for i in (0, 3, 1)]
    eng._backlog = list(reqs)
    eng._iteration(None)
    assert eng._pending_burst is not None
    assert all(not r.token_ids for r in reqs)
    eng._shutdown = True
    eng._loop()  # the loop's exit path: drain, then the abort sweep
    fins = [_finish(r) for r in reqs]
    assert fins == ["length", "length", "abort"]
    assert [len(r.token_ids) for r in reqs] == [5, 5, 0]
    assert eng._pending_burst is None
