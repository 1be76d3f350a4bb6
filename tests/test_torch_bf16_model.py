"""The model steps and the engine of the port on an unquantized (bf16) KV
cache held against gabby_tpu on the CPU, and a tiny model with
Llama-3.2-3B's heads (head_dim 128, group 3): `prefill_slot`,
`decode_step` and `verify_step` on bf16 caches (dense and paged, paired and
unpaired), the same on the head_dim-128 model over bf16 and int8 caches,
its decode steps in the s8 form against the reference's Pallas s8 kernel,
and the engine with `kv_quantized=False` (the reference server's literal
defaults) giving the reference engine's greedy tokens.
tests/test_torch_bf16_cache.py holds the attention functions alone.

Weights come from gabby_tpu's init_params through params_from_numpy (f32);
caches cross as numpy arrays. Model-level JAX calls take the jnp contracts
(kernels off), except where a test turns them on to reach the s8 kernel
(interpret mode); the port takes its kernels' plain versions (CPU
tensors).

Tolerances: model steps in f32 with a bf16 cache 2e-4 against JAX (both
sides round the stored rows to bf16 the same way, so what is left is
summation order through two layers, as tests/test_torch_spec_paged.py
states it; a stored bf16 row within one bf16 step, 2^-7 relative, where
the f32 value it was rounded from lies on a rounding boundary), with an
int8 cache 1e-2 + 3e-2 (a code on a rounding boundary, as
tests/test_torch_pair_s8.py states it); token streams by equality."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.runtime import kv_cache as jkv
from gabby_tpu.runtime import paged as jpaged
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime import paged as tpaged
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.runtime.kv_cache import cache_from_numpy
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

JAX_TOL = dict(rtol=2e-4, atol=2e-4)
INT8_TOL = dict(rtol=1e-2, atol=3e-2)
BF16_ROW_TOL = dict(rtol=2 ** -7, atol=2e-4)  # one bf16 step of a stored row
BF, TBF = jnp.bfloat16, torch.bfloat16
MAX_SEQ = 128


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    """Model-level JAX calls take the jnp contracts; every switch starts
    from its default."""
    for name in ("GABBY_ATTN_S8", "GABBY_ATTN_MULTI", "GABBY_ATTN_CHUNK"):
        monkeypatch.delenv(name, raising=False)
    pk.set_kernels(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


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


def _caches(jc, paged, quantized, paired, batch=2, ps=16):
    """The same empty cache on both sides: bf16 rows or int8 codes; paged
    tables map slot b's logical pages onto a scattered run of the pool."""
    dtype = jnp.float32 if quantized else BF
    if not paged:
        jcache = jkv.create_cache(jc, batch, MAX_SEQ, dtype=dtype,
                                  quantized=quantized, paired=paired)
        return jcache, _to_port(jcache)
    mp = MAX_SEQ // ps
    jcache = jpaged.create_paged_cache(jc, batch, MAX_SEQ, 1 + batch * mp,
                                       dtype=dtype, quantized=quantized,
                                       page_size=ps, paired=paired)
    table = 1 + np.random.default_rng(7).permutation(batch * mp).reshape(
        batch, mp).astype(np.int32)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(table))
    return jcache, _to_port(jcache)


def _model(**kw):
    jc = jcfg.tiny(max_seq_len=MAX_SEQ, **kw)
    tc = tcfg.tiny(max_seq_len=MAX_SEQ, **kw)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    return jc, tc, params, tllama.params_from_numpy(to_numpy_tree(params),
                                                     device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model_128():
    """Llama-3.2-3B's heads on the tiny model: 6 query heads over 2 kv
    heads of 128 dims."""
    return _model(num_heads=6, num_kv_heads=2, head_dim=128)


def _drive(model, jcache, tcache, tol, s8=False):
    """A 40-token prompt in two chunks (32, then 16 at offset 32), three
    decode steps, then a verify block of three, on both sides; the port's
    logits and cache against the reference's after every step. Lane 0 is
    parked. With `s8` the reference's decode steps take its kernels (the
    s8 form exists only there)."""
    jc, tc, params, tparams = model
    ids = np.arange(2, 42)
    for offset, bucket in ((0, 32), (32, 16)):
        take = min(bucket, len(ids) - offset)
        chunk = np.zeros((bucket,), np.int32)
        chunk[:take] = ids[offset:offset + take]
        tl, _ = tllama.prefill_slot(tparams, tc, _t(chunk), take, 1, offset,
                                    tcache)
        jl, jcache = jllama.prefill_slot(
            params, jc, jnp.asarray(chunk), jnp.int32(take), jnp.int32(1),
            jnp.int32(offset), jcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    tok = np.asarray([0, int(tl.argmax())], np.int32)
    pos = np.asarray([MAX_SEQ - 1, len(ids)], np.int32)
    read = np.asarray([1, len(ids)], np.int32)
    for _ in range(3):
        tl, _ = tllama.decode_step(tparams, tc, _t(tok), _t(pos), tcache,
                                   attn_positions=_t(read))
        pk.set_kernels(True if s8 else False)
        try:
            jl, jcache = jllama.decode_step(
                params, jc, jnp.asarray(tok), jnp.asarray(pos), jcache,
                attn_positions=jnp.asarray(read))
        finally:
            pk.set_kernels(False)
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **tol)
        assert int(tl[1].argmax()) == int(np.argmax(np.asarray(jl)[1]))
        tok = np.asarray([0, int(tl[1].argmax())], np.int32)
        pos = pos + np.asarray([0, 1], np.int32)
        read = read + np.asarray([0, 1], np.int32)
    vb = np.asarray([[0, 0, 0], [int(tok[1]), 7, 9]], np.int32)
    tl, _ = tllama.verify_step(tparams, tc, _t(vb), _t(pos), tcache,
                               attn_positions=_t(read))
    jl, jcache = jllama.verify_step(params, jc, jnp.asarray(vb),
                                    jnp.asarray(pos), jcache,
                                    attn_positions=jnp.asarray(read))
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **tol)
    for name in ("k", "v"):
        got, want = getattr(tcache, name), getattr(jcache, name)
        if got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(np.int32)
                          - np.asarray(want).astype(np.int32))
            assert diff.max() <= 1  # a code on a rounding boundary
        else:  # a bf16 step where an f32 value lies on a rounding boundary
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **BF16_ROW_TOL)


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_steps_on_a_bf16_cache(model, paged, paired):
    """prefill_slot, decode_step and verify_step on a bf16 cache against
    gabby_tpu's on its bf16 cache: f32 weights, the rows stored in bf16."""
    jcache, tcache = _caches(model[0], paged, False, paired)
    assert tcache.k.dtype == TBF and not tcache.quantized
    _drive(model, jcache, tcache, JAX_TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_steps_at_head_dim_128(model_128, paged, quantized):
    """The same steps on Llama-3.2-3B's heads (G = 3, head_dim 128) on the
    paired cache, bf16 or int8 (s8 form off: the jnp contracts have none)."""
    ck.set_attn_s8(False)
    jcache, tcache = _caches(model_128[0], paged, quantized, True)
    _drive(model_128, jcache, tcache, INT8_TOL if quantized else JAX_TOL)


def test_s8_decode_steps_at_head_dim_128(model_128):
    """The s8 form (the default over an int8 cache) in the model's decode
    steps at head_dim 128, group 3, against the reference's decode steps
    through its Pallas s8 kernel (interpret mode), on the paired cache."""
    assert ck.attn_s8()
    jcache, tcache = _caches(model_128[0], False, True, True)
    _drive(model_128, jcache, tcache, INT8_TOL, s8=True)


# ---- the engine on a bf16 cache --------------------------------------------

PROMPTS = [
    [{"role": "user", "content": "hello there"}],
    # > 64 tokens: admitted in two chunks (64-bucket, then the rest)
    [{"role": "user", "content": "a fairly long prompt " * 4}],
    [{"role": "user", "content": "xyz"}],
]
MAX_TOKENS = 12


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_on_a_bf16_cache_matches_the_reference_engine(model, paged):
    """The reference server's literal defaults at the tiny size: f32
    weights, a bf16 paired cache (kv_quantized False), greedy tokens equal
    to gabby_tpu's engine in the same configuration."""
    jc, tc, params, tparams = model
    kw = dict(batch_slots=4, max_seq=MAX_SEQ, kv_quantized=False,
              cache_dtype="bfloat16", pair_kv_heads=True)
    if paged:
        kw.update(paged_pages=1 + 4 * (MAX_SEQ // 16), page_size=16)
    streams = []
    for eng in (JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                        JEngineConfig(**kw)),
                Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                       EngineConfig(**kw), device="cpu")):
        try:
            out = []
            for msgs in PROMPTS:
                req = eng.submit(msgs, max_tokens=MAX_TOKENS)
                while req.out.get(timeout=120)[1] is None:
                    pass
                out.append(list(req.token_ids))
            streams.append(out)
        finally:
            eng.shutdown()
    assert len(streams[1][1]) == MAX_TOKENS
    assert streams[1] == streams[0]
