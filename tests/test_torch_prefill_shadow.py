"""The int8 prefill shadow of int4 weights (`quant.promote_int4_to_int8`,
`EngineConfig.prefill_int8_shadow`, the server's `--prefill-int8-shadow`)
held against gabby_tpu on the CPU.

The shadow is a repack, not a requantization: the same codes and the same
scale tensors, so the port's prefill through it gives the bits of the int4
path (both plain versions take bf16(x) @ f32 codes * scale), and the
engine's greedy streams are equal with and without it, dense and paged,
through a burst admission and a prefix hit, and equal to gabby_tpu's
engine's with the shadow on. Where the shadow is on, a chunk of at most 64
tokens takes the stacked int8 product (K5 on the card) and a longer one
the int8-codes product; decode keeps the int4 stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.runtime.kv_cache import create_cache
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

MAX_SEQ = 512


@pytest.fixture(autouse=True)
def _jnp_contracts():
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


@pytest.fixture(scope="module")
def model():
    """The reference's shadow test model (tests/test_pallas_kernels.py:922):
    tiny, hidden 64, int4 weights, fused; carried across to the port."""
    jc = jcfg.tiny(hidden_size=64, intermediate_size=128, max_seq_len=MAX_SEQ)
    tc = tcfg.tiny(hidden_size=64, intermediate_size=128, max_seq_len=MAX_SEQ)
    params = jllama.fuse_projections(jquant.quantize_tree(
        jllama.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32), 4))
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def _rand(seed, *shape):
    return jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)


def test_promote_int4_to_int8_matches_reference():
    """tests/test_pallas_kernels.py:897-920 on both packages, on one tree:
    a 2-D int4 weight, a stacked one, a group-scaled int4 unembed, an int8
    weight and a dense leaf."""
    w = _rand(7, 256, 128) * 0.3
    tree = {"a": jquant.quantize(w, 4), "embed": w,
            "stacked": jquant.quantize_tree(
                {"blocks": {"w": jnp.stack([w, w * 0.5])}}, 4
            )["blocks"]["w"],
            "lm_head": jquant.quantize_unembed_table(w, bits=4, group=64,
                                                     pad_to=128),
            "i8": jquant.quantize(w, 8)}
    jshadow = jquant.promote_int4_to_int8(tree)
    ttree = tllama.params_from_numpy(to_numpy_tree(tree), device="cpu")
    shadow = tquant.promote_int4_to_int8(ttree)
    for name in ("a", "stacked"):
        got, src = shadow[name], ttree[name]
        assert got.bits == 8 and got.group == 0
        assert got.scale is src.scale  # the same tensor, not a copy
        np.testing.assert_array_equal(got.q.numpy(),
                                      np.asarray(jshadow[name].q))
    assert shadow["stacked"].q.shape == (2, 256, 128)
    for i in range(2):
        np.testing.assert_array_equal(
            shadow["stacked"].q[i].numpy(),
            tquant.unpack_int4(ttree["stacked"].q[i]).numpy())
    np.testing.assert_array_equal(
        tquant.dequantize(shadow["a"], torch.float32).numpy(),
        tquant.dequantize(ttree["a"], torch.float32).numpy())
    for name in ("embed", "lm_head", "i8"):
        assert shadow[name] is ttree[name]


def test_promote_a_model_tree_matches_reference(model):
    """The fused stacks (wqkv, wo, w_gup, w_down) of the tiny int4 model:
    codes [L, K, N] equal to the reference's shadow; norms, the embedding
    and the int8 unembed untouched."""
    _, _, params, tparams = model
    jshadow = jquant.promote_int4_to_int8(params)
    shadow = tquant.promote_int4_to_int8(tparams)
    for name in ("wqkv", "wo", "w_gup", "w_down"):
        got, src = shadow["blocks"][name], tparams["blocks"][name]
        assert got.bits == 8 and got.scale is src.scale
        assert got.q.shape[1] == 2 * src.q.shape[1]
        np.testing.assert_array_equal(
            got.q.numpy(), np.asarray(jshadow["blocks"][name].q))
    assert shadow["embed"] is tparams["embed"]
    assert shadow["lm_head"] is tparams["lm_head"]
    assert shadow["blocks"]["attn_norm"] is tparams["blocks"]["attn_norm"]


@pytest.fixture
def products(monkeypatch):
    """The stacked products each call takes, by name and M."""
    seen = []
    for name in ("qmatmul_int4_stacked", "qmatmul_int8_stacked",
                 "qmatmul_int4"):
        real = getattr(cqm, name)

        def spy(x, *a, _real=real, _name=name, **k):
            seen.append((_name, x.shape[0]))
            return _real(x, *a, **k)

        monkeypatch.setattr(cqm, name, spy)
    return seen


@pytest.mark.parametrize("bucket,take", [(16, 11), (64, 50), (256, 200)])
def test_prefill_through_the_shadow_is_exact(model, products, bucket, take):
    """A chunk through the shadow gives the int4 path's logits and cache
    rows bit for bit; at most 64 tokens it takes the stacked int8 product,
    above it neither stacked int4 product."""
    _, tc, _, tparams = model
    shadow = tquant.promote_int4_to_int8(tparams)
    ids = torch.from_numpy(
        np.random.default_rng(bucket).integers(2, 250, bucket))
    out = []
    for p in (tparams, shadow):
        cache = create_cache(tc, 2, MAX_SEQ, dtype=torch.float32,
                             quantized=True, device="cpu")
        logits, cache = tllama.prefill_slot(p, tc, ids, take, 1, 0, cache)
        out.append((logits, cache))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1].k, out[1][1].k)
    assert torch.equal(out[0][1].v, out[1][1].v)
    names = [n for n, _ in products]
    if bucket <= 64:
        # four stacks a layer: the int4 run's through K1's plain version,
        # the shadow's through K5's
        n = 4 * tc.num_layers
        assert names == ["qmatmul_int4_stacked"] * n + [
            "qmatmul_int8_stacked"] * n
    else:
        assert names == []  # both unpack-or-codes products, no kernel


def _engine(model, **kw):
    _, tc, _, tparams = model
    base = dict(batch_slots=4, max_seq=MAX_SEQ, steps_per_call=4,
                cache_dtype="float32")
    base.update(kw)
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**base), device="cpu")


def _ids(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(2, 250, n)]


BURST = [_ids(10 + i, 10 + i) for i in range(3)]  # one 16-token chunk each
LONG = _ids(20, 200)                                # a 256-token chunk
PREFIX = LONG[:192] + _ids(21, 30)                  # LONG's first 192 tokens
SHORT = _ids(22, 70)                                # a 64 and a 16 chunk
N_NEW = 6


def _drain(req):
    while req.out.get(timeout=300)[1] is None:
        pass
    return list(req.token_ids)


def _serve(eng):
    """The burst, together; then LONG, then PREFIX (a prefix hit on
    LONG's resident rows) and SHORT. The streams and the engine's
    counters."""
    reqs = [eng.submit_ids(p, max_tokens=N_NEW) for p in BURST]
    streams = [_drain(r) for r in reqs]
    for p in (LONG, PREFIX, SHORT):
        streams.append(_drain(eng.submit_ids(p, max_tokens=N_NEW)))
    return streams, eng.stats_snapshot()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_shadow_engine_streams_equal_the_plain_engine(model, products,
                                                      paged):
    """tests/test_pallas_kernels.py:922-946, dense and paged (pages of 16),
    with a burst admission and a prefix hit: equal greedy streams with the
    shadow on and off; with it on, prefill takes the int8 stack and decode
    (M = 4 slots) the int4 one."""
    kw = dict(paged_pages=1 + 4 * MAX_SEQ // 16, page_size=16) if paged \
        else {}
    got = {}
    for shadow in (False, True):
        products.clear()
        eng = _engine(model, prefill_int8_shadow=shadow, **kw)
        try:
            got[shadow], stats = _serve(eng)
        finally:
            eng.shutdown()
        assert stats["burst_admissions"] >= 2 and stats["prefix_hits"] >= 1
        int8_ms = {m for n, m in products if n == "qmatmul_int8_stacked"}
        assert bool(int8_ms) == shadow
        if shadow:
            assert int8_ms <= {16, 64}  # single-slot chunks of at most 64
            assert {m for n, m in products
                    if n == "qmatmul_int4_stacked"} == {4}  # decode
    assert got[True] == got[False]
    assert all(len(s) >= 1 for s in got[True])


def test_shadow_engine_matches_the_reference_shadow_engine(model):
    """The port's shadow engine against gabby_tpu's engine with
    prefill_int8_shadow=True, each request alone there: equal greedy
    streams."""
    jc, _, params, _ = model
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(batch_slots=2, max_seq=MAX_SEQ,
                                 steps_per_call=4, cache_dtype="float32",
                                 prefill_int8_shadow=True))
    try:
        want = [_drain(jeng.submit_ids(p, max_tokens=N_NEW))
                for p in BURST + [LONG, PREFIX, SHORT]]
    finally:
        jeng.shutdown()
    eng = _engine(model, prefill_int8_shadow=True)
    try:
        got, _ = _serve(eng)
    finally:
        eng.shutdown()
    assert got == want
