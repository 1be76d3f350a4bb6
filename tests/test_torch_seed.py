"""The per-request seed (OpenAI `seed`) in the port, on the CPU. The
reference draws a seeded lane from threefry's fold_in(PRNGKey(seed),
position); the port hashes (seed, position, rank) into Gumbel noise over
the filtered candidates (`sampling.lane_gumbel`), so its tokens differ
from the reference's by design while the contract is the same, and these
tests hold that contract: the five cases of tests/test_seed.py against the
port's engine (reproducible across batch company and in a warm engine,
different seeds diverge, independent of the engine's global seed, an
unseeded replay unchanged, validation message for message against
gabby_tpu's engine), the same seeded output at steps_per_call 1 and 4, on
the paged pool and with speculation on, and the server accepting `seed`.

Function level: the hash against an exact integer mirror in Python (no
int64 overflow, so the CPU and the card compute the same integers), the
draw's distribution, a seeded lane independent of its neighbours' logits
and of the global generator, unseeded lanes unchanged by seeded
neighbours, greedy lanes unaffected, and admit_slot / admit_slots folding
the prompt's last position as decode folds `positions`."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.runtime.engine import RequestError as JRequestError
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import sampling
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, RequestError
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

MAX_SEQ = 128
MSGS = [{"role": "user", "content": "sample me"}]
NOISE = [{"role": "user", "content": "noise noise"}]
SAMPLED = dict(max_tokens=10, temperature=1.0, top_k=0, top_p=1.0)
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def model():
    jc = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tcfg.tiny(max_seq_len=MAX_SEQ), params, tparams


def _engine(model, **kw):
    _, tc, _, tparams = model
    base = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
                default_max_tokens=10, cache_dtype="float32")
    base.update(kw)
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**base), device="cpu")


def _text(eng, msgs, **kw):
    return eng.generate_sync(msgs, **kw)[0]


def _ids(eng, msgs, **kw):
    req = eng.submit(msgs, **kw)
    while req.out.get(timeout=300)[1] is None:
        pass
    return list(req.token_ids)


# ---- the functions ----------------------------------------------------------


def _mix(x):
    x ^= x >> 16
    x = (x * 0x45D9F3B) & M32
    x ^= x >> 16
    x = (x * 0x45D9F3B) & M32
    return x ^ (x >> 16)


def _mirror(seed, position, k):
    """lane_gumbel's integers in Python ints (which cannot overflow), then
    its uniforms in f32."""
    h = _mix(_mix(seed & M32) ^ (position & M32))
    hs = [_mix((h + r * 0x9E3779B9) & M32) for r in range(k)]
    return np.asarray([((x >> 8) + 0.5) / (1 << 24) for x in hs], np.float32)


@pytest.mark.parametrize("seed,position", [
    (0, 0), (1, 1), (42, 17), (2 ** 31 - 1, 2047), (123456789, 131071),
    (2 ** 31 - 1, 2 ** 31 - 1)])
def test_lane_gumbel_matches_an_exact_integer_mirror(seed, position):
    got = sampling.lane_gumbel(torch.tensor([seed]), torch.tensor([position]),
                               128)[0]
    u = _mirror(seed, position, 128)
    assert (u > 0).all() and (u < 1).all()
    want = -np.log(-np.log(u.astype(np.float64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got).all()


def test_lane_gumbel_depends_on_seed_and_position_alone():
    seeds = torch.tensor([7, 7, 8, 7])
    pos = torch.tensor([3, 4, 3, 3])
    g = sampling.lane_gumbel(seeds, pos, 128)
    assert torch.equal(g[0], g[3])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert len(set(g[0].tolist())) == 128  # ranks draw apart


def test_seeded_draws_follow_the_filtered_distribution():
    """Over 20000 positions one seed's draws from a three-candidate
    distribution match its probabilities (a tenth of the smallest share,
    about 12 standard errors), as top-k leaves it."""
    n = 20000
    logits = torch.full((n, 256), -30.0)
    logits[:, 10], logits[:, 40], logits[:, 20] = 2.0, 1.5, 1.0
    logits[:, 30] = 0.0  # cut by top_k = 3
    probs = torch.softmax(torch.tensor([2.0, 1.5, 1.0]), 0)
    out = sampling.sample(
        logits, torch.Generator().manual_seed(0),
        temperature=torch.ones(n), top_k=torch.full((n,), 3),
        top_p=torch.ones(n), lane_seeds=torch.full((n,), 99),
        lane_positions=torch.arange(n))
    freq = torch.stack([(out == t).float().mean() for t in (10, 40, 20)])
    assert set(out.tolist()) <= {10, 20, 40}
    torch.testing.assert_close(freq, probs, rtol=0, atol=0.015)


def test_seeded_lane_ignores_neighbours_and_the_generator():
    r = np.random.default_rng(0)
    logits = torch.from_numpy(r.standard_normal((3, 256)).astype(np.float32))
    kw = dict(temperature=torch.ones(3),
              top_k=torch.zeros(3, dtype=torch.int32),
              top_p=torch.full((3,), 0.9))
    seeds = torch.tensor([5, -1, -1])
    pos = torch.tensor([12, 12, 12])
    a = sampling.sample(logits, torch.Generator().manual_seed(1),
                        lane_seeds=seeds, lane_positions=pos, **kw)
    other = logits.clone()
    other[1:] = torch.from_numpy(
        r.standard_normal((2, 256)).astype(np.float32))
    b = sampling.sample(other, torch.Generator().manual_seed(2),
                        lane_seeds=seeds, lane_positions=pos, **kw)
    assert a[0] == b[0]
    # unseeded lanes draw exactly what they draw with no seeded neighbour
    plain = sampling.sample(logits, torch.Generator().manual_seed(1), **kw)
    assert torch.equal(a[1:], plain[1:])
    # greedy lanes take the argmax whatever their seed
    g = sampling.sample(logits, None, temperature=torch.zeros(3),
                        top_k=kw["top_k"], top_p=kw["top_p"],
                        lane_seeds=torch.tensor([5, 6, -1]),
                        lane_positions=pos)
    assert torch.equal(g, logits.argmax(-1).to(torch.int32))


def test_admission_folds_the_prompt_s_last_position():
    """admit_slot and admit_slots draw a seeded first token from (seed,
    prompt_len - 1), the convention decode keeps by folding `positions`
    for the token that lands at positions + 1; both write the lane seed
    and the first logprob."""
    r = np.random.default_rng(3)
    logits = torch.from_numpy(r.standard_normal((2, 256)).astype(np.float32))
    one = dict(temperature=torch.ones(1),
               top_k=torch.zeros(1, dtype=torch.int32), top_p=torch.ones(1))
    want = sampling.sample(logits[1:], None, lane_seeds=torch.tensor([9]),
                           lane_positions=torch.tensor([6]), **one)[0]
    state = tgen.SamplingState.greedy(2, "cpu")
    tokens = torch.zeros(2, dtype=torch.int32)
    positions = torch.zeros(2, dtype=torch.int32)
    active = torch.zeros(2, dtype=torch.bool)
    first_lp = torch.zeros(2)
    tgen.admit_slot(logits[1], 1, 7, 1.0, 0, 1.0, tokens, positions, active,
                    state, first_lp=first_lp, seed=9)
    assert tokens[1] == want and state.seed.tolist() == [-1, 9]
    assert first_lp[1] == tgen.token_logprob(logits[1], want)
    state2 = tgen.SamplingState.greedy(2, "cpu")
    tokens2 = torch.zeros(2, dtype=torch.int32)
    first2 = torch.zeros(2)
    tgen.admit_slots(logits, torch.tensor([5, 7]), torch.ones(2),
                     torch.zeros(2, dtype=torch.int32), torch.ones(2),
                     torch.tensor([False, True]), tokens2,
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.bool), state2,
                     torch.zeros((2, 16), dtype=torch.int32),
                     first_lp=first2, seeds=torch.tensor([3, 9]))
    assert tokens2.tolist() == tokens.tolist()
    assert state2.seed.tolist() == [-1, 9]
    torch.testing.assert_close(first2, first_lp)


# ---- the engine: tests/test_seed.py's five cases ----------------------------


def test_seeded_output_reproduces_across_batch_compositions(model):
    """The same seeded request gives the same output alone, again in a
    warm engine whose global stream has moved, and beside an unseeded
    neighbour that draws from that stream."""
    eng = _engine(model)
    try:
        alone = _text(eng, MSGS, seed=42, **SAMPLED)
        assert _text(eng, MSGS, seed=42, **SAMPLED) == alone
        res = {}

        def run(name, msgs, **kw):
            res[name] = _text(eng, msgs, **kw)

        ts = [threading.Thread(target=run, args=("noise", NOISE),
                               kwargs=SAMPLED),
              threading.Thread(target=run, args=("seeded", MSGS),
                               kwargs=dict(seed=42, **SAMPLED))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        eng.shutdown()
    assert res["seeded"] == alone


def test_different_seeds_diverge(model):
    eng = _engine(model)
    try:
        outs = {_text(eng, MSGS, seed=s, **SAMPLED) for s in (1, 2, 3)}
    finally:
        eng.shutdown()
    assert len(outs) >= 2


def test_seed_independent_of_engine_global_seed(model):
    outs = []
    for global_seed in (0, 999):
        eng = _engine(model, seed=global_seed)
        try:
            outs.append(_text(eng, MSGS, seed=7, **SAMPLED))
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]


def test_unseeded_requests_replay_after_a_seeded_one(model):
    """A fresh engine with the same global seed and the same submission
    order (a seeded request, then an unseeded one) replays the unseeded
    request exactly."""
    outs = []
    for _ in range(2):
        eng = _engine(model, seed=5)
        try:
            _text(eng, MSGS, seed=9, **SAMPLED)
            outs.append(_text(eng, MSGS, **SAMPLED))
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]


@pytest.fixture(scope="module")
def stopped(model):
    jc, _, params, _ = model
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(batch_slots=1, max_seq=MAX_SEQ,
                                 cache_dtype="float32"))
    eng = _engine(model, batch_slots=1)
    jeng.shutdown()
    eng.shutdown()
    return jeng, eng


@pytest.mark.parametrize("seed", ["not-an-int", [3], object()],
                         ids=["str", "list", "object"])
def test_seed_validation_matches_reference(stopped, seed):
    jeng, eng = stopped
    with pytest.raises(JRequestError) as jerr:
        jeng.submit_ids([2, 3], seed=seed)
    with pytest.raises(RequestError) as err:
        eng.submit_ids([2, 3], seed=seed)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [2 ** 40 + 17, -5, 0, 2 ** 31 - 1, "12"])
def test_seed_normalization_matches_reference(stopped, seed):
    jeng, eng = stopped
    assert eng.submit_ids([2, 3], seed=seed).seed == \
        jeng.submit_ids([2, 3], seed=seed).seed
    assert 0 <= eng.submit_ids([2, 3], seed=seed).seed < 2 ** 31


def test_big_seed_is_served(model):
    eng = _engine(model)
    try:
        req = eng.submit_ids([2, 3], seed=2 ** 40 + 17, max_tokens=1,
                             temperature=1.0)
        assert req.seed == (2 ** 40 + 17) & 0x7FFFFFFF
        while True:
            _, fin = req.out.get(timeout=120)
            if fin is not None:
                break
    finally:
        eng.shutdown()
    assert fin in ("stop", "length")


# ---- the engine: fusion, the paged pool, speculation ------------------------


@pytest.fixture(scope="module")
def seeded_alone(model):
    """A seeded request's token ids served alone at steps_per_call 4."""
    eng = _engine(model)
    try:
        return _ids(eng, MSGS, seed=31, **SAMPLED)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("steps", [1, 4])
def test_same_output_at_any_steps_per_call(model, seeded_alone, steps):
    """How decode steps are fused into bursts does not move a seeded
    lane's stream (its noise depends on the position, not the step)."""
    eng = _engine(model, steps_per_call=steps, steps_per_call_busy=steps)
    try:
        assert _ids(eng, MSGS, seed=31, **SAMPLED) == seeded_alone
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [
    dict(paged_pages=1 + 2 * (MAX_SEQ // 16), page_size=16),
    dict(speculate_tokens=4, spec_auto_breakeven=False, spec_breakeven=1.0),
], ids=["paged", "speculate"])
def test_same_output_on_the_paged_pool_and_with_speculation(
        model, seeded_alone, kw):
    """The paged pool computes the same logits, and the speculative loop
    draws a sampled lane's token 0 from (seed, positions) as decode does:
    the seeded stream is the dense plain engine's, beside a greedy
    neighbour."""
    eng = _engine(model, **kw)
    try:
        other = eng.submit(NOISE, max_tokens=10)
        got = _ids(eng, MSGS, seed=31, **SAMPLED)
        while other.out.get(timeout=300)[1] is None:
            pass
    finally:
        eng.shutdown()
    assert got == seeded_alone


def test_server_accepts_seed():
    """`seed` reaches the engine through the C++ front-end: 200, and the
    same seeded sampled reply twice."""
    from test_torch_logprobs import CHAT, _post
    from test_torch_server import _serving
    req = {**CHAT, "temperature": 1.0, "seed": 1234, "max_tokens": 8}
    with _serving(["--preset", "tiny", "--random-weights"]) as port:
        replies = []
        for _ in range(2):
            status, body = _post(port, req)
            assert status == 200, body
            replies.append(json.loads(body)["choices"][0]["message"])
    assert replies[0] == replies[1]
