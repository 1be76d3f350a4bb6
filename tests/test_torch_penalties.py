"""OpenAI penalties and logit_bias in the port held against gabby_tpu on the
`tiny` preset, on the CPU: `generate.PenaltyState`, `apply_penalties`,
`count_token`, `set_penalty_slot`, `count_slot_token` and `penalize_row` on
the same numpy inputs (and a Hypothesis property over the penalty values
and bias maps), then the engine against gabby_tpu's engine: the five
penalty parametrisations of tests/test_penalties.py, a forcing
logit_bias, penalized and plain requests side by side, the state's
lifecycle, validation message for message, and the same on the paged pool,
with speculation on and through burst admission.

Weights come from gabby_tpu's init_params (f32) through params_from_numpy;
both engines decode greedily on f32 caches, the reference one request at a
time. Tolerances: the penalty functions 1e-6 (f32 elementwise, the same
operation order); token streams by equality; logprobs 1e-3."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.runtime import generate as jgen
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.runtime.engine import RequestError as JRequestError
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, RequestError
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

PEN_TOL = dict(rtol=1e-6, atol=1e-6)
MAX_SEQ = 128
PAGED = dict(paged_pages=1 + 2 * (MAX_SEQ // 16), page_size=16)
MSGS = [{"role": "user", "content": "repeat repeat repeat"}]
PLAIN = [{"role": "user", "content": "plain neighbor"}]
# the five parametrisations of tests/test_penalties.py:76-82
CASES = [
    dict(presence_penalty=1.5),
    dict(frequency_penalty=1.2),
    dict(presence_penalty=0.8, frequency_penalty=0.7,
         logit_bias={7: 4.0, 11: -6.0}),
    dict(repetition_penalty=1.8),
    dict(presence_penalty=0.5, frequency_penalty=0.3, logit_bias={7: 4.0},
         repetition_penalty=1.3),
]


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """gabby_tpu's engine takes its jnp contracts, which have no s8 form
    of decode attention: the port's s8 switch is off here too."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


@pytest.fixture(scope="module")
def model():
    jc = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tcfg.tiny(max_seq_len=MAX_SEQ), params, tparams


def _engine(model, **kw):
    _, tc, _, tparams = model
    base = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
                cache_dtype="float32")
    base.update(kw)
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**base), device="cpu")


def _jengine(model, **kw):
    jc, _, params, _ = model
    base = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
                cache_dtype="float32")
    base.update(kw)
    return JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(**base))


def _drain(req, timeout=300):
    while True:
        _, fin = req.out.get(timeout=timeout)
        if fin is not None:
            return fin


def _serve(eng, msgs, **kw):
    """(token ids, token logprobs, finish) of one request served alone."""
    req = eng.submit(msgs, **kw)
    fin = _drain(req)
    return list(req.token_ids), list(req.token_logprobs), fin


@pytest.fixture(scope="module")
def want(model):
    """gabby_tpu's engine's greedy streams and logprobs, each request
    served alone, on the dense cache and on the paged pool."""
    out = {}
    for label, kw in (("dense", {}), ("paged", PAGED)):
        jeng = _jengine(model, **kw)
        try:
            for i, case in enumerate(CASES):
                out[label, i] = _serve(jeng, MSGS, max_tokens=12, **case)
            out[label, "plain"] = _serve(jeng, PLAIN, max_tokens=10)
            out[label, "msgs"] = _serve(jeng, MSGS, max_tokens=10)
            out[label, "pen"] = _serve(jeng, MSGS, max_tokens=10,
                                       presence_penalty=1.5,
                                       frequency_penalty=0.9)
            out[label, "bias"] = _serve(jeng, MSGS, max_tokens=4,
                                        logit_bias={33: 100.0})
        finally:
            jeng.shutdown()
    return out


# ---- the functions ----------------------------------------------------------


def _state(seed, b=3, v=64):
    """Random penalty rows: counts 0-3 on about half the vocabulary, a bias
    row, a prompt mask, and per-slot presence, frequency and rep."""
    r = np.random.default_rng(seed)
    counts = (r.integers(0, 4, (b, v)) * (r.random((b, v)) < 0.5)).astype(
        np.int32)
    return dict(
        counts=counts,
        presence=r.uniform(-2, 2, b).astype(np.float32),
        frequency=r.uniform(-2, 2, b).astype(np.float32),
        bias=(r.uniform(-100, 100, (b, v))
              * (r.random((b, v)) < 0.2)).astype(np.float32),
        rep=r.uniform(0.1, 10, b).astype(np.float32),
        prompt_mask=r.random((b, v)) < 0.3)


def _jstate(d):
    return jgen.PenaltyState(**{k: jnp.asarray(a) for k, a in d.items()})


def _tstate(d):
    return tgen.PenaltyState(**{k: torch.from_numpy(np.array(a))
                                for k, a in d.items()})


def _logits(seed, b=3, v=64):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 4).astype(
        np.float32)


def _assert_state_equal(tstate, jstate):
    for name in ("counts", "presence", "frequency", "bias", "rep",
                 "prompt_mask"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   **PEN_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_matches_reference(seed):
    d, logits = _state(seed), _logits(seed + 10)
    want = np.asarray(jgen.apply_penalties(jnp.asarray(logits), _jstate(d)))
    got = tgen.apply_penalties(torch.from_numpy(logits), _tstate(d))
    np.testing.assert_allclose(got.numpy(), want, **PEN_TOL)
    assert torch.equal(tgen.apply_penalties(torch.from_numpy(logits), None),
                       torch.from_numpy(logits))


def test_penalty_state_zeros_matches_reference():
    j = jgen.PenaltyState.zeros(3, 64)
    t = tgen.PenaltyState.zeros(3, 64, "cpu")
    _assert_state_equal(t, j)
    assert t.counts.dtype == torch.int32 and t.prompt_mask.dtype == torch.bool


def test_count_token_matches_reference():
    d = _state(3)
    nxt = np.asarray([5, 63, 5], np.int32)
    active = np.asarray([True, False, True])
    j = jgen.count_token(_jstate(d), jnp.asarray(nxt), jnp.asarray(active))
    t = _tstate(d)
    assert tgen.count_token(t, torch.from_numpy(nxt),
                            torch.from_numpy(active)) is t
    _assert_state_equal(t, j)
    assert tgen.count_token(None, torch.from_numpy(nxt),
                            torch.from_numpy(active)) is None


def test_set_penalty_slot_matches_reference():
    d, row = _state(4), _state(5, b=1)
    args = (row["counts"][0], row["presence"][0], row["frequency"][0],
            row["bias"][0], row["rep"][0], row["prompt_mask"][0])
    j = jgen.set_penalty_slot(_jstate(d), jnp.int32(1),
                              *[jnp.asarray(a) for a in args])
    t = _tstate(d)
    tgen.set_penalty_slot(t, 1, torch.from_numpy(args[0]), float(args[1]),
                          float(args[2]), torch.from_numpy(args[3]),
                          float(args[4]), torch.from_numpy(args[5]))
    _assert_state_equal(t, j)


def test_count_slot_token_matches_reference():
    d = _state(6)
    j = jgen.count_slot_token(_jstate(d), jnp.int32(2), jnp.int32(17))
    t = _tstate(d)
    tgen.count_slot_token(t, 2, torch.tensor(17, dtype=torch.int32))
    _assert_state_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1])
def test_penalize_row_matches_reference_and_apply_penalties(seed):
    d, logits = _state(seed, b=1), _logits(seed + 20, b=1)
    args = (d["counts"][0], d["presence"][0], d["frequency"][0],
            d["bias"][0], d["rep"][0], d["prompt_mask"][0])
    want = np.asarray(jgen.penalize_row(jnp.asarray(logits[0]),
                                        *[jnp.asarray(a) for a in args]))
    got = tgen.penalize_row(torch.from_numpy(logits[0]),
                            torch.from_numpy(args[0]), float(args[1]),
                            float(args[2]), torch.from_numpy(args[3]),
                            float(args[4]), torch.from_numpy(args[5]))
    np.testing.assert_allclose(got.numpy(), want, **PEN_TOL)
    batched = tgen.apply_penalties(torch.from_numpy(logits), _tstate(d))
    np.testing.assert_allclose(got.numpy(), batched[0].numpy(), **PEN_TOL)


@settings(max_examples=40, deadline=None)
@given(presence=st.floats(-2, 2, width=32),
       frequency=st.floats(-2, 2, width=32),
       rep=st.floats(0.0625, 10, width=32),
       bias=st.dictionaries(st.integers(0, 63),
                            st.floats(-100, 100, width=32), max_size=12),
       prompt=st.sets(st.integers(0, 63), max_size=10),
       sampled=st.lists(st.integers(0, 63), max_size=12))
def test_penalty_property_matches_reference(presence, frequency, rep, bias,
                                            prompt, sampled):
    """Any penalty values and bias map: a slot admitted with them
    (set_penalty_slot), its sampled tokens counted one by one
    (count_slot_token), then apply_penalties, agrees with gabby_tpu's
    same calls within 1e-6; and a token whose +100 bias beats every other
    token's bias by more than the spread of the penalized, unbiased row is
    the argmax (a smaller lead proves nothing: the penalties alone can
    spread the row by more than 100)."""
    v = 64
    bias_row = np.zeros((v,), np.float32)
    for k, x in bias.items():
        bias_row[k] = x
    prompt_row = np.zeros((v,), bool)
    prompt_row[list(prompt)] = True
    zeros = np.zeros((v,), np.int32)
    j = jgen.set_penalty_slot(
        jgen.PenaltyState.zeros(2, v), jnp.int32(1), jnp.asarray(zeros),
        jnp.float32(presence), jnp.float32(frequency),
        jnp.asarray(bias_row), jnp.float32(rep), jnp.asarray(prompt_row))
    t = tgen.set_penalty_slot(
        tgen.PenaltyState.zeros(2, v, "cpu"), 1, torch.from_numpy(zeros),
        presence, frequency, torch.from_numpy(bias_row), rep,
        torch.from_numpy(prompt_row))
    for tok in sampled:
        j = jgen.count_slot_token(j, jnp.int32(1), jnp.int32(tok))
        tgen.count_slot_token(t, 1, torch.tensor(tok))
    _assert_state_equal(t, j)
    logits = _logits(len(sampled), b=2, v=v)
    want = np.asarray(jgen.apply_penalties(jnp.asarray(logits), j))
    got = tgen.apply_penalties(torch.from_numpy(logits), t).numpy()
    np.testing.assert_allclose(got, want, **PEN_TOL)
    np.testing.assert_array_equal(got[0], logits[0])  # slot 0 is clean
    if bias and max(bias.values()) == 100.0:
        forced = max(bias, key=bias.get)
        lead = 100.0 - max([0.0] + [x for k, x in bias.items() if k != forced])
        if lead > np.ptp(got[1] - bias_row) + 1e-3:
            assert got[1, forced] == got[1].max()


# ---- the engine -------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["presence", "frequency", "bias", "repetition",
                              "all"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_penalized_generation_matches_reference_engine(model, want, case,
                                                       paged):
    """tests/test_penalties.py:76-103 against the port: the same greedy
    text and token ids as gabby_tpu's engine, logprobs of the adjusted
    distribution within 1e-3; the first token is counted and penalized
    like the rest."""
    label = "paged" if paged else "dense"
    eng = _engine(model, default_max_tokens=12, **(PAGED if paged else {}))
    try:
        ids, lps, fin = _serve(eng, MSGS, max_tokens=12, **CASES[case])
    finally:
        eng.shutdown()
    want_ids, want_lps, want_fin = want[label, case]
    assert ids == want_ids and fin == want_fin
    assert eng.tokenizer.decode(ids) == eng.tokenizer.decode(want_ids)
    np.testing.assert_allclose(lps, want_lps, rtol=0, atol=1e-3)
    assert eng._pstate is None and eng._pen_slots == set()


def test_logit_bias_forces_token(model, want):
    """A +100 bias dominates every logit of the tiny model: greedy emits
    that token from the first on, as gabby_tpu's engine does."""
    eng = _engine(model)
    try:
        ids, lps, _ = _serve(eng, MSGS, max_tokens=4, logit_bias={33: 100.0})
    finally:
        eng.shutdown()
    assert ids == [33] * 4 == want["dense", "bias"][0]
    assert all(lp > -1e-3 for lp in lps)  # nearly all the mass


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_penalized_and_plain_requests_are_isolated(model, want, paged):
    """A plain request decoding beside a penalized one gives its stream
    served alone; the penalized one gives its own."""
    label = "paged" if paged else "dense"
    eng = _engine(model, **(PAGED if paged else {}))
    res = {}
    try:
        def run(name, msgs, **kw):
            res[name] = _serve(eng, msgs, max_tokens=10, **kw)

        ts = [threading.Thread(target=run, args=("pen", MSGS),
                               kwargs=dict(presence_penalty=1.5,
                                           frequency_penalty=0.9)),
              threading.Thread(target=run, args=("plain", PLAIN))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        eng.shutdown()
    assert res["plain"][0] == want[label, "plain"][0]
    assert res["pen"][0] == want[label, "pen"][0]
    np.testing.assert_allclose(res["pen"][1], want[label, "pen"][1],
                               rtol=0, atol=1e-3)


def _stopped_engine(model, **kw):
    """An engine whose loop is stopped but which takes submissions: the
    test drives it an iteration at a time (`_drive`)."""
    eng = _engine(model, **kw)
    eng.shutdown()
    eng._shutdown = False
    return eng


def _drive(eng, reqs, until=None, limit=400):
    """Run loop iterations until every request in `reqs` has its final
    item (or `until()` holds); returns each request's finish reason so
    far (None while live)."""
    fins = {id(r): None for r in reqs}
    admitting = None
    for _ in range(limit):
        _, admitting = eng._iteration(admitting)
        for r in reqs:
            while not r.out.empty():
                _, fin = r.out.get_nowait()
                if fin is not None:
                    fins[id(r)] = fin
        if until is not None and until():
            break
        if admitting is None and all(fins.values()):
            break
    return [fins[id(r)] for r in reqs]


def test_penalty_state_lifecycle(model, want):
    """The state exists only while a penalized request is live: created at
    its admission, a freed slot's rows cleared while another penalized
    request stays, dropped (None) after the last; a plain request after it
    gives the plain stream."""
    eng = _stopped_engine(model)
    assert eng._pstate is None
    # a +100 bias keeps the long request off EOS: it outlives the short one
    long = eng.submit(MSGS, max_tokens=40, presence_penalty=1.0,
                      logit_bias={33: 100.0})
    short = eng.submit(PLAIN, max_tokens=2, frequency_penalty=0.5,
                       logit_bias={9: 3.0})

    def slot_of(req):
        return [s is not None and s.request is req for s in eng._slots]

    assert _drive(eng, [long, short], until=lambda: len(short.token_ids) == 2
                  and any(slot_of(long))) == [None, "length"]
    live = slot_of(long).index(True)
    freed = 1 - live
    assert eng._pen_slots == {live}
    pst = eng._pstate
    assert pst.counts[live].sum() > 0 and float(pst.presence[live]) == 1.0
    assert not pst.counts[freed].any() and not pst.bias[freed].any()
    assert not pst.prompt_mask[freed].any()
    assert float(pst.rep[freed]) == 1.0
    assert float(pst.frequency[freed]) == 0.0
    assert _drive(eng, [long]) == ["length"]
    assert long.token_ids == [33] * 40
    assert eng._pstate is None and eng._pen_slots == set()
    plain = eng.submit(MSGS, max_tokens=10)
    _drive(eng, [plain])
    assert plain.token_ids == want["dense", "msgs"][0]


def test_speculation_waits_while_a_penalty_is_live(model, want,
                                                   monkeypatch):
    """With speculation on, a live penalized request keeps every burst on
    the plain loop (a draft's argmax would need counts that evolve inside
    the verify block); both streams still equal the reference's, and
    speculation runs again once the state is gone."""
    eng = _stopped_engine(model, speculate_tokens=4,
                          spec_auto_breakeven=False, spec_breakeven=1.0)
    spec_calls = []
    real = tgen.spec_decode_loop

    def spying(*args, **kw):
        spec_calls.append(eng._pstate is None)
        return real(*args, **kw)

    monkeypatch.setattr(tgen, "spec_decode_loop", spying)
    pen = eng.submit(MSGS, max_tokens=10, presence_penalty=1.5,
                     frequency_penalty=0.9)
    plain = eng.submit(PLAIN, max_tokens=10)
    _drive(eng, [pen, plain])
    after = eng.submit(MSGS, max_tokens=10)
    _drive(eng, [after])
    assert pen.token_ids == want["dense", "pen"][0]
    assert plain.token_ids == want["dense", "plain"][0]
    assert after.token_ids == want["dense", "msgs"][0]
    assert spec_calls and all(spec_calls)
    assert eng.stats_snapshot()["spec_macro_steps"] > 0


def test_burst_leaves_penalized_requests_to_the_single_path(model, want):
    """Three same-schedule requests submitted together into an idle
    engine, one of them penalized: the two plain ones admit as a burst,
    the penalized one alone (its admission writes penalty rows); every
    stream is the reference's."""
    eng = _stopped_engine(model, batch_slots=4)
    reqs = [eng.submit(PLAIN, max_tokens=10),
            eng.submit(MSGS, max_tokens=10, presence_penalty=1.5,
                       frequency_penalty=0.9),
            eng.submit(MSGS, max_tokens=10)]
    _, admitting = eng._iteration(None)
    assert admitting is None and eng.stats["burst_admissions"] == 2
    assert [eng._slots[i].request for i in (0, 1)] == [reqs[0], reqs[2]]
    assert eng._pstate is None
    _drive(eng, reqs)
    assert [r.token_ids for r in reqs] == [
        want["dense", "plain"][0], want["dense", "pen"][0],
        want["dense", "msgs"][0]]
    assert eng._pstate is None and eng.stats["burst_admissions"] == 2


VALIDATION = [
    dict(presence_penalty=3.0), dict(presence_penalty=-2.5),
    dict(frequency_penalty=-2.5), dict(frequency_penalty=2.01),
    dict(repetition_penalty=-1.0), dict(repetition_penalty=10.5),
    dict(logit_bias={5: 200.0}), dict(logit_bias={5: -100.5}),
    dict(logit_bias={10 ** 9: 1.0}), dict(logit_bias={-1: 1.0}),
    dict(logit_bias={"x": 1.0}), dict(logit_bias={5: "y"}),
    dict(logit_bias={i: 1.0 for i in range(301)}),
]


@pytest.fixture(scope="module")
def stopped(model):
    """One engine of each package, their loops stopped: submit_ids
    validates before it enqueues."""
    jeng, eng = _jengine(model, batch_slots=1), _engine(model, batch_slots=1)
    jeng.shutdown()
    eng.shutdown()
    return jeng, eng


@pytest.mark.parametrize("kw", VALIDATION, ids=range(len(VALIDATION)))
def test_penalty_validation_matches_reference(stopped, kw):
    jeng, eng = stopped
    with pytest.raises(JRequestError) as jerr:
        jeng.submit_ids([2, 3], **kw)
    with pytest.raises(RequestError) as err:
        eng.submit_ids([2, 3], **kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(presence_penalty=2.0, frequency_penalty=-2.0),
    dict(repetition_penalty=10.0), dict(repetition_penalty=0.01),
    dict(logit_bias={"7": "-100", 255: 100}),
    dict(logit_bias={i: 0.5 for i in range(256)}),  # the whole vocabulary
], ids=range(5))
def test_penalty_bounds_are_accepted(stopped, kw):
    """The bounds themselves pass, and logit_bias keys and values are
    normalized to ints and floats, as in the reference."""
    jeng, eng = stopped
    j, t = jeng.submit_ids([2, 3], **kw), eng.submit_ids([2, 3], **kw)
    for name in ("presence_penalty", "frequency_penalty",
                 "repetition_penalty", "logit_bias", "penalized"):
        assert getattr(t, name) == getattr(j, name)
