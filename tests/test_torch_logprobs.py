"""logprobs and top_logprobs in the port held against gabby_tpu on the `tiny`
preset, on the CPU: `generate.top_candidates`, `token_logprob` over verify
blocks, `pack_host_view` and `pack_spec_host_view` (the same int32 vector
as gabby_tpu's, and the engine's unpacking bit for bit), `decode_loop`
with `n_top` and a `PenaltyState`; then the engine against gabby_tpu's
engine (greedy `token_logprobs` and `token_top` for every token, the first
included; a request's own k under a larger call-wide bucket), with
speculation on, on the paged pool, through burst admission, and the
server's `logprobs` / `top_logprobs` fields through the C++ front-end,
non-streamed and streamed.

Weights come from gabby_tpu's init_params (f32), and as the int4 tree of
tests/test_torch_engine.py on an int8 cache, through params_from_numpy.
Tolerances: top ids equal, top logprobs 1e-5 on the same logits and 1e-3
through the engines (as token logprobs); the packed vectors bit for bit;
token streams by equality."""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.runtime import generate as jgen
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.runtime.engine import RequestError as JRequestError
from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, RequestError
from gabby_tpu_torch.runtime.kv_cache import cache_from_numpy
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

LP_TOL = dict(rtol=0, atol=1e-3)
TOP_TOL = dict(rtol=0, atol=1e-5)
MAX_SEQ = 128
PAGED = dict(paged_pages=1 + 4 * (MAX_SEQ // 16), page_size=16)
MSGS = [{"role": "user", "content": "sample me"}]
SELF_SIMILAR = [{"role": "user", "content": "ab ab ab ab ab ab ab ab ab ab"}]
OTHER = [{"role": "user", "content": "another one"}]
SPEC = dict(speculate_tokens=4, spec_auto_breakeven=False, spec_breakeven=1.0)


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """gabby_tpu's engine takes its jnp contracts, which have no s8 form
    of decode attention: the port's s8 switch is off here too."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


def _make_model(quantized: bool):
    jc = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    if quantized:
        params = jllama.fuse_projections(jquant.quantize_tree(
            params, 4, unembed_bits=4, unembed_group=256))
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tcfg.tiny(max_seq_len=MAX_SEQ), params, tparams, quantized


@pytest.fixture(scope="module", params=["f32", "int4"])
def model(request):
    """The tiny model's f32 tree, and its int4 tree (fused stacks, the
    group-256 int4 unembed) served on an int8 cache."""
    return _make_model(request.param == "int4")


@pytest.fixture(scope="module")
def f32_model():
    return _make_model(False)


def _config(model, **kw):
    base = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
                cache_dtype="float32", kv_quantized=model[4])
    base.update(kw)
    return base


def _engine(model, **kw):
    _, tc, _, tparams, _ = model
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**_config(model, **kw)), device="cpu")


def _jengine(model, **kw):
    jc, _, params, _, _ = model
    return JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(**_config(model, **kw)))


def _drain(req, timeout=300):
    while True:
        _, fin = req.out.get(timeout=timeout)
        if fin is not None:
            return fin


def _result(req):
    return (list(req.token_ids), list(req.token_logprobs),
            [list(row) for row in req.token_top])


def _serve(eng, msgs, **kw):
    req = eng.submit(msgs, **kw)
    _drain(req)
    return _result(req)


# what each engine case serves: (messages, max_tokens, top_logprobs)
WANTED = [(MSGS, 8, 3), (OTHER, 6, 5), (SELF_SIMILAR, 16, 2)]


@pytest.fixture(scope="module")
def want(model):
    """gabby_tpu's engine's greedy token ids, logprobs and top rows, each
    request served alone, dense and paged, and with speculation on."""
    out = {}
    for label, kw in (("dense", {}), ("paged", PAGED),
                      ("dense spec", SPEC), ("paged spec", {**PAGED, **SPEC})):
        jeng = _jengine(model, **kw)
        try:
            for msgs, n, k in WANTED[2::-2] if "spec" in label else WANTED:
                out[label, repr(msgs)] = _serve(jeng, msgs, max_tokens=n,
                                                top_logprobs=k)
        finally:
            jeng.shutdown()
    return out


def _assert_matches(got, ref):
    """Token ids and top ids equal; token logprobs and top logprobs within
    1e-3."""
    ids, lps, top = got
    rids, rlps, rtop = ref
    assert ids == rids
    np.testing.assert_allclose(lps, rlps, **LP_TOL)
    assert len(top) == len(rtop) == len(ids)
    for row, rrow in zip(top, rtop):
        assert [i for i, _ in row] == [i for i, _ in rrow]
        np.testing.assert_allclose([x for _, x in row], [x for _, x in rrow],
                                   **LP_TOL)


def _assert_rows_sound(got, k):
    """Every token, the first included, carries k alternatives sorted
    descending and all <= 0, headed (greedy) by the token itself with the
    logprob the scalar path reports."""
    ids, lps, top = got
    assert len(top) == len(ids) >= 2
    for tid, lp, row in zip(ids, lps, top):
        assert len(row) == k
        xs = [x for _, x in row]
        assert xs == sorted(xs, reverse=True) and xs[0] <= 1e-6
        assert row[0][0] == tid
        assert abs(row[0][1] - lp) < 1e-3


# ---- the functions ----------------------------------------------------------


@pytest.mark.parametrize("n_top", [0, 1, 5, 20])
@pytest.mark.parametrize("shape", [(3, 256), (2, 4, 256)],
                         ids=["rows", "blocks"])
def test_top_candidates_matches_reference(n_top, shape):
    logits = (np.random.default_rng(n_top).standard_normal(shape)
              * 3).astype(np.float32)
    jl, ji = jgen.top_candidates(jnp.asarray(logits), n_top)
    tl, ti = tgen.top_candidates(torch.from_numpy(logits), n_top)
    assert tuple(tl.shape) == tuple(ti.shape) == shape[:-1] + (n_top,)
    assert tl.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOP_TOL)


def test_token_logprob_over_verify_blocks_matches_reference():
    r = np.random.default_rng(1)
    logits = (r.standard_normal((2, 5, 256)) * 3).astype(np.float32)
    ids = r.integers(0, 256, (2, 5)).astype(np.int32)
    want = np.asarray(jgen.token_logprob(jnp.asarray(logits),
                                         jnp.asarray(ids)))
    got = tgen.token_logprob(torch.from_numpy(logits), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOP_TOL)


def _floats(r, shape):
    """f32 values with the awkward ones in: -0.0, the smallest subnormal,
    large negatives."""
    x = (r.standard_normal(shape) * 10 - 5).astype(np.float32)
    flat = x.reshape(-1)
    flat[:3] = [-0.0, np.float32(1e-45), np.float32(-3.4e38)][:flat.size]
    return x


@pytest.mark.parametrize("n_top", [0, 5])
def test_pack_host_view_matches_reference_bit_for_bit(n_top):
    """The port's packed vector equals gabby_tpu's pack_host_view, and the
    engine's unpacking returns every f32 with its bits."""
    r = np.random.default_rng(n_top)
    k, b = 3, 4
    toks = r.integers(0, 256, (k, b)).astype(np.int32)
    emitted = r.random((k, b)) < 0.5
    active = r.random(b) < 0.5
    pre = r.integers(0, 256, b).astype(np.int32)
    lp, first = _floats(r, (k, b)), _floats(r, (b,))
    top_lp = _floats(r, (k, b, n_top))
    top_ids = r.integers(0, 256, (k, b, n_top)).astype(np.int32)
    args = (toks, emitted, active, pre, lp, first, top_lp, top_ids)
    want = np.asarray(jgen.pack_host_view(*[jnp.asarray(a) for a in args]))
    got = tgen.pack_host_view(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    lps, firsts, tl, ti = Engine._unpack_floats(got, 2 * k * b + 2 * b,
                                                k * b, b, n_top)
    for a, x in ((lps, lp), (firsts, first), (tl, top_lp)):
        np.testing.assert_array_equal(a.reshape(-1).view(np.int32),
                                      x.reshape(-1).view(np.int32))
    np.testing.assert_array_equal(ti.reshape(-1), top_ids.reshape(-1))


@pytest.mark.parametrize("n_top", [0, 3])
def test_pack_spec_host_view_round_trip(n_top):
    """The speculative view: the layout of gabby_tpu's speculative fetch
    (gabby_tpu/runtime/engine.py:1731-1739), every f32 back with its
    bits."""
    r = np.random.default_rng(7 + n_top)
    k, b, t = 2, 3, 5
    em = r.integers(0, 256, (k, b, t)).astype(np.int32)
    counts = r.integers(0, t + 1, (k, b)).astype(np.int32)
    active = r.random(b) < 0.5
    pre = r.integers(0, 256, b).astype(np.int32)
    lp, first = _floats(r, (k, b, t)), _floats(r, (b,))
    top_lp = _floats(r, (k, b, t, n_top))
    top_ids = r.integers(0, 256, (k, b, t, n_top)).astype(np.int32)
    want = np.asarray(jnp.concatenate([
        jnp.asarray(em).reshape(-1), jnp.asarray(counts).reshape(-1),
        jnp.asarray(active).astype(jnp.int32), jnp.asarray(pre),
        jax.lax.bitcast_convert_type(jnp.asarray(lp).reshape(-1), jnp.int32),
        jax.lax.bitcast_convert_type(jnp.asarray(first), jnp.int32),
        jax.lax.bitcast_convert_type(jnp.asarray(top_lp).reshape(-1),
                                     jnp.int32),
        jnp.asarray(top_ids).reshape(-1)]))
    got = tgen.pack_spec_host_view(
        *[torch.from_numpy(a) for a in (em, counts, active, pre, lp, first,
                                        top_lp, top_ids)]).numpy()
    np.testing.assert_array_equal(got, want)
    kbt = k * b * t
    lps, firsts, tl, ti = Engine._unpack_floats(got, kbt + k * b + 2 * b,
                                                kbt, b, n_top)
    np.testing.assert_array_equal(lps.view(np.int32),
                                  lp.reshape(-1).view(np.int32))
    np.testing.assert_array_equal(firsts.view(np.int32), first.view(np.int32))
    np.testing.assert_array_equal(tl.reshape(-1).view(np.int32),
                                  top_lp.reshape(-1).view(np.int32))
    np.testing.assert_array_equal(ti.reshape(-1), top_ids.reshape(-1))


def test_decode_loop_logprobs_and_penalties_match_reference(f32_model):
    """Four decode steps from the same prefilled cache on both sides (the
    f32 tree; the engine cases hold the int4 tree too), slot 0 penalized
    (presence, frequency, a bias, repetition), slot 1 plain, slot 2
    parked: tokens and top ids equal, logprobs 1e-3, the penalty counts
    equal."""
    jc, tc, params, tparams, _ = f32_model
    b, steps, n_top, v = 3, 4, 5, jc.vocab_size
    jcache = jcreate_cache(jc, b, MAX_SEQ, dtype=jnp.float32)
    prompts = [[5, 9, 77, 31, 5, 9], [40, 41, 42, 43, 44, 45]]
    tokens = np.zeros((b,), np.int32)
    for slot, ids in enumerate(prompts):
        chunk = np.zeros((16,), np.int32)
        chunk[:6] = ids
        logits, jcache = jllama.prefill_slot(
            params, jc, jnp.asarray(chunk), jnp.int32(6), jnp.int32(slot),
            jnp.int32(0), jcache)
        tokens[slot] = int(jnp.argmax(logits))
    tcache = cache_from_numpy(np.asarray(jcache.k), np.asarray(jcache.v),
                              device="cpu")
    positions = np.asarray([6, 6, MAX_SEQ - 1], np.int32)
    active = np.asarray([True, True, False])
    bias = np.zeros((b, v), np.float32)
    bias[0, 7] = 4.0
    prompt_mask = np.zeros((b, v), bool)
    prompt_mask[0, prompts[0]] = True
    pen = dict(counts=np.zeros((b, v), np.int32),
               presence=np.asarray([0.8, 0, 0], np.float32),
               frequency=np.asarray([0.7, 0, 0], np.float32), bias=bias,
               rep=np.asarray([1.3, 1, 1], np.float32),
               prompt_mask=prompt_mask)
    jstate = jgen.SamplingState.greedy(b)
    (j_tok, j_act, j_lp, _, _, _, _, _, j_tl, j_ti, j_pen) = jgen.decode_loop(
        params, jc, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(active), jcache, jstate, steps,
        eos_ids=jnp.asarray([1], jnp.int32), n_top=n_top,
        pstate=jgen.PenaltyState(**{k: jnp.asarray(a)
                                    for k, a in pen.items()}))
    tpen = tgen.PenaltyState(**{k: torch.from_numpy(a.copy())
                                for k, a in pen.items()})
    (t_tok, t_act, t_lp, _, _, _, t_tl, t_ti) = tgen.decode_loop(
        tparams, tc, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(active), tcache, tgen.SamplingState.greedy(b, "cpu"),
        steps, eos_ids=torch.tensor([1], dtype=torch.int32), n_top=n_top,
        pstate=tpen)
    live = np.asarray(j_act)
    assert live[:, :2].all()
    np.testing.assert_array_equal(t_act.numpy(), live)
    np.testing.assert_array_equal(t_tok.numpy()[live], np.asarray(j_tok)[live])
    np.testing.assert_allclose(t_lp.numpy()[live], np.asarray(j_lp)[live],
                               **LP_TOL)
    np.testing.assert_array_equal(t_ti.numpy()[live], np.asarray(j_ti)[live])
    np.testing.assert_allclose(t_tl.numpy()[live], np.asarray(j_tl)[live],
                               **LP_TOL)
    np.testing.assert_array_equal(tpen.counts.numpy(),
                                  np.asarray(j_pen.counts))
    assert tpen.counts[0].sum() == steps and not tpen.counts[2].any()


# ---- the engine -------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_logprobs_and_top_rows_match_reference_engine(model, want, paged):
    """Two requests at once, each with its own top_logprobs: token ids,
    logprobs and top rows (the first token's included) of gabby_tpu's
    engine serving each alone."""
    label = "paged" if paged else "dense"
    eng = _engine(model, **(PAGED if paged else {}))
    try:
        reqs = [eng.submit(m, max_tokens=n, top_logprobs=k)
                for m, n, k in WANTED[:2]]
        for r in reqs:
            _drain(r)
    finally:
        eng.shutdown()
    for r, (m, _, k) in zip(reqs, WANTED[:2]):
        _assert_matches(_result(r), want[label, repr(m)])
        _assert_rows_sound(_result(r), k)


def test_request_k_under_a_larger_bucket(model):
    """tests/test_engine.py:432-485 against the port: k rows for every
    token, the first included, each headed by the token; two requests at
    once cut their own k (7 and 2) out of the call-wide bucket (10)."""
    eng = _engine(model)
    try:
        got = _serve(eng, MSGS, max_tokens=6, top_logprobs=3)
        _assert_rows_sound(got, 3)
        r1 = eng.submit(MSGS, max_tokens=4, top_logprobs=7)
        r2 = eng.submit(MSGS, max_tokens=4, top_logprobs=2)
        _drain(r1)
        _drain(r2)
    finally:
        eng.shutdown()
    _assert_rows_sound(_result(r1), 7)
    _assert_rows_sound(_result(r2), 2)
    for a, b in zip(r1.token_top, r2.token_top):
        assert [i for i, _ in a[:2]] == [i for i, _ in b]
    assert r1.token_ids == r2.token_ids == got[0][:4]
    plain = _engine(model)
    try:
        ids, lps, top = _serve(plain, MSGS, max_tokens=6)
    finally:
        plain.shutdown()
    assert ids == got[0] and top == []
    np.testing.assert_allclose(lps, got[1], **LP_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculation_keeps_greedy_logprobs(model, want, paged):
    """With speculation on (drafts accepted on the self-similar prompt),
    the accepted drafts' logprobs and top rows come from the verify
    block's rows: greedy tokens, logprobs and top rows equal gabby_tpu's
    speculative engine's within 1e-3, and on the f32 cache plain
    decode's too (an int8 cache's verify block reads its own fresh rows
    unquantized, plain decode reads them back as codes: about 5e-3
    apart)."""
    label = "paged" if paged else "dense"
    eng = _engine(model, **SPEC, **(PAGED if paged else {}))
    try:
        reqs = [eng.submit(m, max_tokens=n, top_logprobs=k)
                for m, n, k in WANTED[2::-2]]
        for r in reqs:
            _drain(r)
        stats = eng.stats_snapshot()
    finally:
        eng.shutdown()
    assert stats["spec_macro_steps"] > 0
    assert stats["spec_tokens"] > stats["spec_macro_steps"]  # accepted
    for r, (m, _, k) in zip(reqs, WANTED[2::-2]):
        _assert_matches(_result(r), want[label + " spec", repr(m)])
        if not model[4]:
            _assert_matches(_result(r), want[label, repr(m)])
        _assert_rows_sound(_result(r), k)


def _drive(eng, reqs, limit=400):
    """Loop iterations of an engine whose loop is stopped until every
    request in `reqs` has its final item."""
    done = set()
    admitting = None
    for _ in range(limit):
        _, admitting = eng._iteration(admitting)
        for r in reqs:
            while not r.out.empty():
                if r.out.get_nowait()[1] is not None:
                    done.add(id(r))
        if admitting is None and len(done) == len(reqs):
            return
    raise AssertionError("requests did not finish")


def test_burst_admission_carries_logprobs_top_rows_and_seeds(model, want):
    """Three requests of one chunk schedule submitted together into an
    idle engine admit as one burst (admit_slots): the first token's
    logprob and top rows come with it, greedy streams equal the
    reference's, and a seeded sampled request gives what it gives when
    admitted alone (both fold the prompt's last position)."""
    seeded = dict(max_tokens=6, temperature=1.0, seed=11, top_logprobs=4)
    eng = _engine(model, batch_slots=4)
    eng.shutdown()  # driven an iteration at a time
    eng._shutdown = False
    reqs = [eng.submit(m, max_tokens=n, top_logprobs=k)
            for m, n, k in WANTED[:2]]
    reqs.append(eng.submit(OTHER, **seeded))
    _drive(eng, reqs)
    assert eng.stats["burst_admissions"] == 3
    for r, (m, _, k) in zip(reqs, WANTED[:2]):
        _assert_matches(_result(r), want["dense", repr(m)])
    alone = _engine(model, batch_slots=4)
    try:
        single = alone.submit(OTHER, **seeded)
        _drain(single)
        assert alone.stats_snapshot()["burst_admissions"] == 0
    finally:
        alone.shutdown()
    assert reqs[2].token_ids == single.token_ids
    np.testing.assert_allclose(reqs[2].token_logprobs,
                               single.token_logprobs, **LP_TOL)
    assert all(len(row) == 4 for row in reqs[2].token_top)


@pytest.fixture(scope="module")
def stopped(model):
    jeng, eng = _jengine(model, batch_slots=1), _engine(model, batch_slots=1)
    jeng.shutdown()
    eng.shutdown()
    return jeng, eng


@pytest.mark.parametrize("k", [21, -1, 100])
def test_top_logprobs_validation_matches_reference(stopped, k):
    jeng, eng = stopped
    with pytest.raises(JRequestError) as jerr:
        jeng.submit_ids([2, 3], top_logprobs=k)
    with pytest.raises(RequestError) as err:
        eng.submit_ids([2, 3], top_logprobs=k)
    assert str(err.value) == str(jerr.value)
    assert eng.submit_ids([2, 3], top_logprobs=20).top_logprobs == 20


# ---- the server -------------------------------------------------------------

CHAT = {"model": "tiny", "max_tokens": 6,
        "messages": [{"role": "system", "content": "s"},
                     {"role": "user", "content": "hello"}]}


@pytest.fixture(scope="module")
def port():
    from test_torch_server import _serving
    with _serving(["--preset", "tiny", "--random-weights"]) as p:
        yield p


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def _events(body):
    return [json.loads(line[len("data: "):]) for line in body.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_logprobs_in_response(port):
    """tests/test_server.py:144-163 against the port: per generated token
    its string and log-probability; without the flag the field stays
    null."""
    status, body = _post(port, {**CHAT, "logprobs": True})
    assert status == 200, body
    out = json.loads(body)
    lp = out["choices"][0]["logprobs"]
    assert lp is not None and "content" in lp
    entries = lp["content"]
    assert len(entries) == out["usage"]["completion_tokens"] > 0
    for e in entries:
        assert isinstance(e["token"], str)
        assert e["logprob"] <= 1e-6
        assert "top_logprobs" not in e
    status, body = _post(port, CHAT)
    assert json.loads(body)["choices"][0]["logprobs"] is None


def test_top_logprobs_in_response_streamed_and_not(port):
    """top_logprobs: k alternatives for every token, headed (greedy) by the
    token itself; streamed, each chunk carries the entries of the tokens
    it delivered, and together they are the non-streamed reply's."""
    req = {**CHAT, "logprobs": True, "top_logprobs": 3}
    status, body = _post(port, req)
    assert status == 200, body
    out = json.loads(body)
    entries = out["choices"][0]["logprobs"]["content"]
    assert len(entries) == out["usage"]["completion_tokens"] > 0
    for e in entries:
        alts = e["top_logprobs"]
        assert len(alts) == 3
        assert alts[0]["token"] == e["token"]
        assert abs(alts[0]["logprob"] - e["logprob"]) < 1e-3
        xs = [a["logprob"] for a in alts]
        assert xs == sorted(xs, reverse=True)
    status, body = _post(port, {**req, "stream": True})
    assert status == 200, body
    streamed = []
    for ev in _events(body):
        lp = ev["choices"][0].get("logprobs")
        if lp:
            streamed += lp["content"]
    assert streamed == entries
    status, body = _post(port, {**CHAT, "top_logprobs": 3})
    assert status == 400, body  # needs logprobs: true (OpenAI)
