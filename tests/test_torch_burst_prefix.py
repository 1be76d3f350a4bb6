"""Burst admission and prefix KV reuse of the port held against gabby_tpu on
the `tiny` preset, on the CPU: the batched, lane-masked chunk prefill
(`llama.prefill_hidden` with `lane_mask`, dense and paged, int8 and bf16
caches, paired and not, at offset 0 and past it), `paged.write_batch_chunk`,
`generate.prefill_chunk`, `prefill_batch_chunk`, `admit_slots` and
`copy_slot_prefix`, `KVCache.batch` and `nbytes`, the engine's
`_find_donor` and `_pop_next_admission` called on one stub in both
packages, and the engine's
burst, partial-burst and prefix-reuse paths (dense row copies, paged page
adoption, a donor that is the destination itself), whose greedy token
streams must equal gabby_tpu's engine's on the same weights.

Weights come from gabby_tpu's init_params (f32) through params_from_numpy;
caches cross as numpy arrays, filled with random rows so that a row the
port must not touch has a value to keep. Model-level JAX calls take the
jnp contracts (kernels off); the port takes its kernels' plain versions
(CPU tensors).

Tolerances: hidden states 1e-4 (f32 summation order through two layers);
logits 2e-4, as tests/test_torch_spec_paged.py holds the model steps;
written f32 scales 1e-4; int8 codes within one code and bf16 rows within
one bf16 step, where the f32 value they were rounded from lies on a
rounding boundary (tests/test_torch_bf16_model.py); rows the port must not
touch, bit for bit; token streams by equality."""

import collections
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.runtime import generate as jgen
from gabby_tpu.runtime import kv_cache as jkv
from gabby_tpu.runtime import paged as jpaged
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime import paged as tpaged
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, Request
from gabby_tpu_torch.runtime.kv_cache import cache_from_numpy
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

HIDDEN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_ROW_TOL = dict(rtol=2 ** -7, atol=1e-4)  # one bf16 step of a stored row
BF, TBF = jnp.bfloat16, torch.bfloat16
MAX_SEQ = 128
PS = 16
MASK = [True, False, True]


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """Model-level JAX calls and gabby_tpu's engine take the jnp contracts,
    which have no s8 form of decode attention: the port's s8 switch is off
    here too (tests/test_torch_pair_s8.py holds the s8 form)."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.tiny(max_seq_len=1024), tcfg.tiny(max_seq_len=1024)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _to_port(jcache):
    """A JAX KVCache / PagedKVCache as the port's, through numpy (bf16
    leaves cross as f32, which holds them exactly)."""
    def leaf(x):
        if x is None:
            return None
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype == BF else a

    leaves = [leaf(x) for x in (jcache.k, jcache.v, jcache.k_scale,
                                jcache.v_scale)]
    if isinstance(jcache, jpaged.PagedKVCache):
        out = tpaged.paged_cache_from_numpy(
            *leaves, np.asarray(jcache.page_table), device="cpu")
    else:
        out = cache_from_numpy(*leaves, device="cpu")
    if jcache.k_scale is None:
        out = dataclasses.replace(out, k=out.k.to(TBF), v=out.v.to(TBF))
    return out


def _random_caches(jc, paged, quantized, paired, batch=3, seed=0):
    """The same cache on both sides, every row random: int8 codes with
    scales, or bf16 rows; paged tables map slot b's logical pages onto a
    scattered run of the pool (page 0 is the scratch page)."""
    r = np.random.default_rng(seed)
    dtype = jnp.float32 if quantized else BF
    if paged:
        mp = MAX_SEQ // PS
        jcache = jpaged.create_paged_cache(
            jc, batch, MAX_SEQ, 1 + batch * mp, dtype=dtype,
            quantized=quantized, page_size=PS, paired=paired)
        table = 1 + r.permutation(batch * mp).reshape(batch, mp)
        jcache = dataclasses.replace(
            jcache, page_table=jnp.asarray(table.astype(np.int32)))
    else:
        jcache = jkv.create_cache(jc, batch, MAX_SEQ, dtype=dtype,
                                  quantized=quantized, paired=paired)

    def fill(x):
        if x is None:
            return None
        if x.dtype == jnp.int8:
            return jnp.asarray(r.integers(-127, 128, x.shape, np.int8))
        if quantized:  # scales
            return jnp.asarray(r.uniform(0.005, 0.02, x.shape)
                               .astype(np.float32))
        return jnp.asarray((r.standard_normal(x.shape) * 0.5)
                           .astype(np.float32)).astype(x.dtype)

    jcache = dataclasses.replace(jcache, k=fill(jcache.k), v=fill(jcache.v),
                                 k_scale=fill(jcache.k_scale),
                                 v_scale=fill(jcache.v_scale))
    return jcache, _to_port(jcache)


def _leaves(cache):
    return [(name, getattr(cache, name))
            for name in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, name) is not None]


def _assert_rows_close(t, j):
    """A written cache leaf of the port against the reference's."""
    if t.dtype == torch.int8:
        diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
        assert diff.max() <= 1  # a code on a rounding boundary
    elif t.dtype == TBF:
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **BF16_ROW_TOL)
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **HIDDEN_TOL)


def _written_pages(tcache, offset, t, mask):
    """The physical pages a masked chunk [offset, offset + t) writes."""
    lo, hi = offset // PS, (offset + t) // PS
    return {int(p) for b, m in enumerate(mask) if m
            for p in tcache.page_table[b, lo:hi]}


# ---- the batched chunk prefill --------------------------------------------


@pytest.mark.parametrize("offset", [0, 32], ids=["offset0", "offset32"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_hidden_with_lane_mask(model, paged, quantized, paired,
                                       offset):
    """The masked lanes' chunk rows and every lane's hidden states against
    the reference's prefill_hidden / _prefill_hidden_paged; the unmasked
    lane's rows (dense) or every page but the masked lanes' chunk pages
    (paged, the scratch page among them) keep their bits."""
    jc, tc, params, tparams = model
    jcache, tcache = _random_caches(jc, paged, quantized, paired)
    before = [x.clone() for _, x in _leaves(tcache)]
    tokens = np.random.default_rng(offset + 1).integers(
        2, jc.vocab_size, (3, 16)).astype(np.int32)
    jh, jcache = jllama.prefill_hidden(params, jc, jnp.asarray(tokens),
                                       jcache, offset=offset,
                                       lane_mask=jnp.asarray(MASK))
    th, tcache = tllama.prefill_hidden(tparams, tc, _t(tokens), tcache,
                                       offset=offset, lane_mask=_t(MASK))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HIDDEN_TOL)
    if paged:
        written = sorted(_written_pages(tcache, offset, 16, MASK))
        for (_, t), (_, j), old in zip(_leaves(tcache), _leaves(jcache),
                                       before):
            # the reference routes the masked-out lane to the scratch page
            _assert_rows_close(t[1:], j[1:])
            kept = [p for p in range(t.shape[0]) if p not in written]
            assert torch.equal(t[kept], old[kept])
            assert not torch.equal(t[written], old[written])
    else:
        for (_, t), (_, j), old in zip(_leaves(tcache), _leaves(jcache),
                                       before):
            _assert_rows_close(t, j)
            assert torch.equal(t[:, 1], old[:, 1])  # the unmasked lane
            assert not torch.equal(t[:, 0], old[:, 0])


def test_prefill_without_a_cache_is_the_full_forward(model):
    """prefill(cache=None) at offset 0 against the reference's prefill and
    the port's own cache-free forward."""
    jc, tc, params, tparams = model
    tokens = np.random.default_rng(5).integers(
        2, jc.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = jllama.prefill(params, jc, jnp.asarray(tokens), None)
    tl, none = tllama.prefill(tparams, tc, _t(tokens), None)
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    torch.testing.assert_close(tl, tllama.forward(tparams, tc, _t(tokens)))
    with pytest.raises(ValueError, match="needs a cache"):
        tllama.prefill(tparams, tc, _t(tokens), None, offset=16)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_chunk_and_prefill_batch_chunk(model, paged):
    """Two chunks of a two-chunk schedule (offsets 0 and 16) on an int8
    cache: prefill_chunk's last-position logits on every lane, and
    prefill_batch_chunk's logits at each masked lane's last valid row,
    against the reference's; their caches agree."""
    jc, tc, params, tparams = model
    r = np.random.default_rng(11)
    tokens = r.integers(2, jc.vocab_size, (3, 32)).astype(np.int32)
    lengths = np.array([20, 1, 29], np.int32)
    for batch in (False, True):
        jcache, tcache = _random_caches(jc, paged, True, False, seed=3)
        for offset in (0, 16):
            chunk = tokens[:, offset:offset + 16]
            if batch:
                jl, jcache = jgen.prefill_batch_chunk(
                    params, jc, jnp.asarray(chunk), jnp.asarray(lengths),
                    jnp.asarray(MASK), jcache, offset)
                tl, tcache = tgen.prefill_batch_chunk(
                    tparams, tc, _t(chunk), _t(lengths), _t(MASK), tcache,
                    offset)
            else:
                jl, jcache = jgen.prefill_chunk(params, jc,
                                                jnp.asarray(chunk), jcache,
                                                offset)
                tl, tcache = tgen.prefill_chunk(tparams, tc, _t(chunk),
                                                tcache, offset)
        rows = [0, 2] if batch else [0, 1, 2]
        assert tl.shape == (3, jc.vocab_size)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   **LOGIT_TOL)
        for (_, t), (_, j) in zip(_leaves(tcache), _leaves(jcache)):
            if paged and batch:
                t, j = t[1:], j[1:]  # the reference's scratch-page writes
            _assert_rows_close(t, j)


def test_admit_slots_matches_reference():
    """Greedy first tokens of the masked lanes, their positions, active
    flags, history and sampling state; unmasked lanes keep theirs."""
    r = np.random.default_rng(2)
    b, v, s = 4, 64, 32
    logits = r.standard_normal((b, v)).astype(np.float32)
    lengths = np.array([5, 1, 17, 31], np.int32)
    mask = np.array([True, False, True, True])
    temp = np.array([0.0, 0.7, 0.0, 0.0], np.float32)
    topk = np.array([0, 5, 3, 0], np.int32)
    topp = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    tokens = r.integers(0, v, b).astype(np.int32)
    positions = np.array([3, 9, 127, 127], np.int32)
    active = np.array([False, True, False, False])
    history = r.integers(0, v, (b, s)).astype(np.int32)
    st = jgen.SamplingState(temperature=jnp.full((b,), 0.3),
                            top_k=jnp.full((b,), 7, jnp.int32),
                            top_p=jnp.full((b,), 0.8),
                            key=jax.random.PRNGKey(0),
                            seed=jnp.full((b,), -1, jnp.int32))
    (jt, jp, ja, jst, jh, _) = jgen.admit_slots(
        jnp.asarray(logits), jnp.asarray(lengths), jnp.asarray(temp),
        jnp.asarray(topk), jnp.asarray(topp), jax.random.PRNGKey(1),
        jnp.asarray(mask), jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(active), st, jnp.asarray(history),
        jnp.zeros((b,), jnp.float32), seeds=jnp.full((b,), -1, jnp.int32))
    tst = tgen.SamplingState.greedy(b, "cpu")
    tst.temperature.fill_(0.3)
    tst.top_k.fill_(7)
    tst.top_p.fill_(0.8)
    tt, tp, ta, th = (_t(tokens), _t(positions), _t(active), _t(history))
    tgen.admit_slots(_t(logits), _t(lengths), _t(temp), _t(topk), _t(topp),
                     _t(mask), tt, tp, ta, tst, th)
    live = mask  # the greedy lanes sampled; lane 1 kept its token
    np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
    assert tt[1] == tokens[1]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for name in ("temperature", "top_k", "top_p"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_copy_slot_prefix_matches_reference(model, quantized, paired):
    jc = model[0]
    jcache, tcache = _random_caches(jc, False, quantized, paired)
    jcache = jgen.copy_slot_prefix(jcache, jnp.int32(2), jnp.int32(0))
    out = tgen.copy_slot_prefix(tcache, 2, 0)
    assert out is tcache
    for (_, t), (_, j) in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
        assert torch.equal(t[:, 0], t[:, 2])


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_cache_batch_and_nbytes_match_reference(model, quantized, paired):
    jcache, tcache = _random_caches(model[0], False, quantized, paired,
                                    batch=5)
    assert tcache.batch == jcache.batch == 5
    assert tcache.nbytes() == jcache.nbytes()


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("offset", [0, 32])
def test_write_batch_chunk_matches_reference(model, quantized, offset):
    """Every layer's [B, Nk, T, H] chunk: the masked lanes' pages equal the
    reference's, every other page (the scratch page among them, which the
    reference writes for the masked-out lane) keeps its bits."""
    jc = model[0]
    jcache, tcache = _random_caches(jc, True, quantized, True, seed=9)
    before = [x.clone() for _, x in _leaves(tcache)]
    r = np.random.default_rng(4)
    t = 32
    lanes = tcache.k.shape[-1]
    kn = r.integers(-127, 128, (jc.num_layers, 3, 1, t, lanes)).astype(
        np.int8) if quantized else r.standard_normal(
        (jc.num_layers, 3, 1, t, lanes)).astype(np.float32)
    vn = -kn if quantized else kn * 0.5
    ks = r.uniform(0.005, 0.02, (jc.num_layers, 3, 2, t)).astype(np.float32)
    vs = ks * 2
    jn = (lambda a: jnp.asarray(a)) if quantized else (
        lambda a: jnp.asarray(a).astype(BF))
    jcache = jpaged.write_batch_chunk(
        jcache, offset, jn(kn), jn(vn), jnp.asarray(ks) if quantized
        else None, jnp.asarray(vs) if quantized else None,
        jnp.asarray(MASK))
    for layer in range(jc.num_layers):
        tpaged.write_batch_chunk(
            tcache, offset, _t(kn[layer]), _t(vn[layer]),
            _t(ks[layer]) if quantized else None,
            _t(vs[layer]) if quantized else None, _t(MASK), layer=layer)
    written = sorted(_written_pages(tcache, offset, t, MASK))
    assert len(written) == 4
    for (_, tl), (_, jl), old in zip(_leaves(tcache), _leaves(jcache),
                                     before):
        np.testing.assert_array_equal(tl[written].float().numpy(),
                                      np.asarray(jl[np.asarray(written)],
                                                 np.float32))
        kept = [p for p in range(tl.shape[0]) if p not in written]
        assert torch.equal(tl[kept], old[kept])
    with pytest.raises(ValueError, match="page size"):
        tpaged.write_batch_chunk(tcache, 8, _t(kn[0]), _t(vn[0]), None, None,
                                 None, layer=0)


# ---- the engine's host-side choices, on one stub in both packages ---------


class _Stub:
    """The fields `_find_donor` and `_pop_next_admission` read; `config` is
    the engine config class of the package whose method is called."""

    _slack = staticmethod(Engine._slack)

    def __init__(self, buckets, max_seq, prompts, backlog=(),
                 config=EngineConfig):
        self._buckets = buckets
        self.ec = config(max_seq=max_seq)
        self._slot_prompts = prompts
        self._backlog = list(backlog)

    def _drain_ingress(self):
        pass


@pytest.mark.parametrize("case", [
    # (buckets, max_seq, resident prompts, the new prompt)
    ((16, 64), 1024, [list(range(100)), None], list(range(90)) + [7]),
    ((16, 64), 1024, [list(range(70)), list(range(200))], list(range(300))),
    ((16, 64), 1024, [list(range(63))], list(range(100))),      # < 64
    ((16, 64), 1024, [list(range(80))], list(range(80))),       # n - 1 cap
    ((16, 64), 128, [list(range(127))], list(range(127))),      # room cap
    ((512,), 2048, [list(range(700)), None], list(range(700)) + [1] * 40),
    ((512,), 2048, [list(range(1100))], list(range(1100))),
    ((16,), 256, [None, None], list(range(50))),
], ids=["rounding", "longest", "threshold", "one-left", "room", "page-grid",
        "page-two", "none"])
def test_find_donor_matches_reference(case):
    buckets, max_seq, prompts, ids = case
    stub = _Stub(buckets, max_seq, prompts)
    got = Engine._find_donor(stub, ids)
    assert got == JEngine._find_donor(stub, ids)
    if prompts[0] is not None and got[1]:
        assert got[1] % buckets[0] == 0 and got[1] >= 64


def test_pop_next_admission_matches_reference():
    """Priority strata, then shortest prompt first (the reference's
    default policy, the one the port serves); the oldest waiter first past
    the age limit."""
    def req(n, priority=0, age=0.0):
        r = Request(prompt_ids=[1] * n, max_tokens=1, temperature=0.0,
                    top_k=0, top_p=1.0, priority=priority)
        r.submit_ts -= age
        return r

    backlog = [req(30), req(10), req(20, priority=1), req(5, priority=1)]
    order = {}
    for engine, config in ((Engine, EngineConfig), (JEngine, JEngineConfig)):
        stub = _Stub((16,), 128, [], backlog, config=config)
        order[engine] = [engine._pop_next_admission(stub).prompt_ids
                         for _ in backlog]
        assert engine._pop_next_admission(stub) is None
    assert order[Engine] == order[JEngine]
    lens = [len(p) for p in order[Engine]]
    assert lens == [5, 20, 10, 30]
    stub = _Stub((16,), 128, [], [req(5), req(9, age=60.0)])
    assert len(Engine._pop_next_admission(stub).prompt_ids) == 9


# ---- the engine -------------------------------------------------------------


BURST = [[{"role": "user", "content": f"burst {i}"}] for i in range(4)]
LIVE = [{"role": "user", "content": "keep decoding for a while"}]
SHARED = " ".join(f"ctx{i}" for i in range(40))
PREFIX = [[{"role": "system", "content": SHARED},
           {"role": "user", "content": q}]
          for q in ("first question", "second, different question")]
UNRELATED = [{"role": "user", "content": "totally unrelated"}]
PAGE_SHARED = " ".join(f"tok{i}" for i in range(30))
ADOPT = [[{"role": "system", "content": PAGE_SHARED},
          {"role": "user", "content": q}]
         for q in ("alpha", "beta and different")]
P96 = [2 + (i % 200) for i in range(96)]
IDS_A = P96 + [210 + (i % 40) for i in range(16)]
IDS_B = P96 + [150 + (i % 40) for i in range(16)]
IDS_C = P96[:64] + [100 + (i % 40) for i in range(32)]
# (request, max_tokens): what each engine case serves
WANTED = ([(m, 5) for m in BURST] + [(m, 6) for m in BURST[:3]]
          + [(LIVE, 40), (PREFIX[0], 4), (PREFIX[1], 4), (UNRELATED, 4),
             (ADOPT[0], 24), (ADOPT[1], 4), (IDS_A, 64), (IDS_B, 64),
             (IDS_C, 4)])


def _key(request, n):
    return repr((request, n))


def _submit(eng, request, n):
    if isinstance(request[0], int):
        return eng.submit_ids(request, max_tokens=n)
    return eng.submit(request, max_tokens=n)


def _drain(req, timeout=300):
    while req.out.get(timeout=timeout)[1] is None:
        pass
    return list(req.token_ids)


@pytest.fixture(scope="module")
def want(model):
    """gabby_tpu's engine's greedy streams for every request of the engine
    cases, each request served alone."""
    jc, _, params, _ = model
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(batch_slots=2, max_seq=512,
                                 steps_per_call=8, cache_dtype="float32"))
    try:
        return {_key(r, n): _drain(_submit(jeng, r, n)) for r, n in WANTED}
    finally:
        jeng.shutdown()


def _engine(model, **kw):
    _, tc, _, tparams = model
    base = dict(batch_slots=4, max_seq=MAX_SEQ, steps_per_call=4,
                cache_dtype="float32")
    base.update(kw)
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**base), device="cpu")


def _paged(slots, max_seq=MAX_SEQ, pages=None):
    return dict(paged_pages=pages or 1 + slots * (max_seq // PS),
                page_size=PS)


def _assert_pool_adds_up(eng):
    """Every page a slot holds is referenced once per holder; the free
    pages and the held ones make up the pool less the scratch page; each
    slot's table row points at its pages, then at the scratch page."""
    held = collections.Counter(p for pages in eng._slot_pages for p in pages)
    assert all(eng._alloc.refs[p] == n for p, n in held.items())
    assert eng._alloc.available() + len(held) == len(eng._alloc.refs) - 1
    table = eng._cache.page_table.numpy()
    for slot_ix, pages in enumerate(eng._slot_pages):
        assert list(table[slot_ix, :len(pages)]) == pages
        assert not table[slot_ix, len(pages):].any()


def _wait(cond, seconds=60):
    end = time.monotonic() + seconds
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    assert cond()


def _serve_together(eng, requests):
    """Submit the requests back to back and drain them all."""
    reqs = [_submit(eng, r, n) for r, n in requests]
    return [_drain(r) for r in reqs]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_burst_admission(model, want, mode):
    """Four same-schedule requests into an idle engine batch-prefill
    (tests/test_engine.py:594, tests/test_paged.py:313); each stream is the
    reference engine's; a burst is counted per request."""
    eng = _engine(model, **(_paged(4) if mode == "paged" else {}))
    try:
        for _ in range(3):
            got = _serve_together(eng, [(m, 5) for m in BURST])
            assert got == [want[_key(m, 5)] for m in BURST]
            if eng.stats_snapshot()["burst_admissions"] >= 2:
                break
        assert eng.stats_snapshot()["burst_admissions"] >= 2
    finally:
        eng.shutdown()
    if mode == "paged":
        _assert_pool_adds_up(eng)


def test_short_decode_after_a_burst_while_requests_wait(model):
    """After a burst admission the decode burst is the short one
    (`steps_per_call_busy`) while a request still waits and a slot is
    free, as after a single admission's chunk; the long one once nothing
    waits. (A designed divergence: the reference decodes the long burst
    after every burst admission.) Driven an iteration at a time on an
    engine whose loop is stopped."""
    eng = _engine(model, steps_per_call=16, steps_per_call_busy=2)
    eng.shutdown()

    def req(n, k):
        return Request(prompt_ids=[(k * 31 + j) % 200 + 3 for j in range(n)],
                       max_tokens=20, temperature=0.0, top_k=0, top_p=1.0)

    # two prompts on the 16-token bucket burst; the 40-token one waits
    eng._backlog = [req(10, 0), req(12, 1), req(40, 2)]
    _, admitting = eng._iteration(None)
    assert admitting is None and eng.stats["burst_admissions"] == 2
    assert eng.stats["decode_steps"] == 2
    while admitting is not None or eng._backlog:
        before = eng.stats["decode_steps"]
        _, admitting = eng._iteration(admitting)
        assert eng.stats["decode_steps"] - before == 2
    assert sum(s is not None for s in eng._slots) == 3
    before = eng.stats["decode_steps"]
    eng._iteration(None)
    assert eng.stats["decode_steps"] - before == 16


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_partial_burst_with_a_live_slot(model, want, paged):
    """A burst into the free slots while one slot decodes
    (tests/test_engine.py:167, tests/test_paged.py:350): the live stream
    and the burst's are the reference engine's."""
    eng = _engine(model, steps_per_call=2, **(_paged(4) if paged else {}))
    try:
        for _ in range(3):
            live = _submit(eng, LIVE, 40)
            _wait(lambda: eng.stats_snapshot()["active_slots"] >= 1)
            before = eng.stats_snapshot()["burst_admissions"]
            got = _serve_together(eng, [(m, 6) for m in BURST[:3]])
            assert _drain(live) == want[_key(LIVE, 40)]
            assert got == [want[_key(m, 6)] for m in BURST[:3]]
            if eng.stats_snapshot()["burst_admissions"] - before >= 2:
                break
        assert eng.stats_snapshot()["burst_admissions"] - before >= 2
    finally:
        eng.shutdown()
    if paged:
        _assert_pool_adds_up(eng)


@pytest.mark.parametrize("donor", ["other slot", "same slot"])
def test_dense_prefix_reuse(model, want, monkeypatch, donor):
    """The second request starts past the first one's resident prompt
    (tests/test_engine.py:320): copied from the donor's slot when the
    request lands in another (a long request held slot 0 of two while the
    first was served), read in place when it lands in the donor's own; a
    third, unrelated request is unaffected."""
    copies = []
    copy = tgen.copy_slot_prefix
    monkeypatch.setattr(tgen, "copy_slot_prefix",
                        lambda cache, src, dst: copies.append((src, dst))
                        or copy(cache, src, dst))
    eng = _engine(model, batch_slots=2, max_seq=512)
    try:
        if donor == "other slot":
            live = _submit(eng, LIVE, 40)
            _wait(lambda: eng.stats_snapshot()["active_slots"] >= 1)
        assert _drain(_submit(eng, PREFIX[0], 4)) == want[_key(PREFIX[0], 4)]
        if donor == "other slot":
            assert _drain(live) == want[_key(LIVE, 40)]
        for m in PREFIX[1:] + [UNRELATED]:
            assert _drain(_submit(eng, m, 4)) == want[_key(m, 4)]
        stats = eng.stats_snapshot()
        assert stats["prefix_hits"] == 1
        assert stats["prefix_tokens_reused"] >= 64
        assert stats["burst_admissions"] == 0
    finally:
        eng.shutdown()
    assert copies == ([(1, 0)] if donor == "other slot" else [])


def test_paged_prefix_adoption_is_zero_copy(model, want):
    """With the first request still decoding, the second lands in the
    other slot and adopts its whole prefix pages by reference
    (tests/test_paged.py:172): a page is held twice while both live."""
    eng = _engine(model, batch_slots=2, max_seq=256,
                  **_paged(2, 256, pages=1 + 24))
    try:
        first = _submit(eng, ADOPT[0], 24)
        _wait(lambda: eng.stats_snapshot()["active_slots"] >= 1)
        second = _submit(eng, ADOPT[1], 4)
        assert _drain(second) == want[_key(ADOPT[1], 4)]
        peak = max(eng._alloc.refs)
        assert _drain(first) == want[_key(ADOPT[0], 24)]
        stats = eng.stats_snapshot()
        assert stats["prefix_hits"] >= 1 and peak >= 2
        assert stats["prefix_tokens_reused"] >= 64
    finally:
        eng.shutdown()
    _assert_pool_adds_up(eng)


def test_paged_donor_is_the_destination(model, want):
    """A live in slot 0, B adopts A's prefix pages into slot 1, A is
    cancelled (its rows stay resident), C lands in slot 0 with a prompt
    that leaves A's prefix inside the pages B shares
    (tests/test_paged.py:239): C's suffix must go to fresh pages, so B's
    stream is the reference's; the refcounts add up before and after."""
    eng = _engine(model, batch_slots=2, max_seq=256,
                  **_paged(2, 256, pages=1 + 30))
    try:
        req_a = _submit(eng, IDS_A, 64)
        _wait(lambda: eng.stats_snapshot()["active_slots"] >= 1)
        req_b = _submit(eng, IDS_B, 64)
        _wait(lambda: eng.stats_snapshot()["prefix_hits"] >= 1)
        shared = eng._slot_pages[1][:96 // PS]
        assert shared == eng._slot_pages[0][:96 // PS]
        assert all(eng._alloc.refs[p] == 2 for p in shared)
        eng.cancel(req_a)
        req_c = _submit(eng, IDS_C, 4)
        assert _drain(req_c) == want[_key(IDS_C, 4)]
        assert _drain(req_b) == want[_key(IDS_B, 64)]
        _drain(req_a)
        stats = eng.stats_snapshot()
        assert stats["prefix_hits"] == 2
        assert stats["prefix_tokens_reused"] == 96 + 64
    finally:
        eng.shutdown()
    # C kept A's first 64 rows (4 pages, still shared with B) and took
    # fresh pages for its suffix
    assert eng._slot_pages[0][:4] == shared[:4]
    assert not set(eng._slot_pages[0][4:]) & set(eng._slot_pages[1])
    _assert_pool_adds_up(eng)


def test_burst_precheck_counts_pages_not_chunks(model):
    """With pages smaller than the bucket a chunk spans several pages: the
    burst precheck counts pages, 2 spare (tests/test_paged.py:467)."""
    _, tc, _, tparams = model

    def stopped(pages):
        eng = Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                     EngineConfig(batch_slots=2, max_seq=1024,
                                  cache_dtype="float32", paged_pages=pages,
                                  page_size=256), device="cpu")
        eng.shutdown()  # stop the loop; drive _select_burst directly
        eng._backlog.extend(
            Request(prompt_ids=list(range(2, 302)), max_tokens=2,
                    temperature=0.0, top_k=0, top_p=1.0) for _ in range(2))
        return eng

    eng = stopped(6)  # 1 scratch + 5 usable
    assert eng._chunk_schedule(300) == ((0, 512),)
    # 2 slots x 2 pages + 2 spare = 6 > 5 available: no burst
    assert eng._select_burst() is None and len(eng._backlog) == 2
    eng = stopped(10)  # 2 x 2 + 2 <= 9: the burst forms
    sched, slots, group = eng._select_burst()
    assert sched == ((0, 512),) and slots == [0, 1] and len(group) == 2
    assert not eng._backlog


def test_resident_pages_are_evicted_under_pressure(model, want):
    """Finished requests' pages stay resident as prefix donors; an
    admission the free pages cannot back evicts them (here slot 1's: the
    admission lands in slot 0 and drops its own) before it would fail."""
    eng = _engine(model, batch_slots=2, **_paged(2, pages=1 + 8))
    try:
        pair = [(m, 5) for m in BURST[:2]]
        assert _serve_together(eng, pair) == [want[_key(*r)] for r in pair]
        assert all(eng._slot_prompts) and all(eng._slot_pages)
        _assert_pool_adds_up(eng)
        # 112 prompt rows, then decode to the cache's 128: all 8 pages
        assert eng._alloc.available() + len(eng._slot_pages[0]) < 8
        got = _drain(_submit(eng, IDS_A, 64))
        assert len(got) >= 8 and got == want[_key(IDS_A, 64)][:len(got)]
        assert not eng._slot_pages[1] and eng._slot_prompts[1] is None
    finally:
        eng.shutdown()
    _assert_pool_adds_up(eng)
