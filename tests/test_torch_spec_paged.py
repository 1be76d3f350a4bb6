"""Speculative decoding and the paged KV cache of the port held against
gabby_tpu on the `tiny` preset, on the CPU: the attention contracts behind
the verify and paged kernels (K9-K11), `PageAllocator`, `verify_step`, the
paged `decode_step` / `prefill_slot`, `spec_decode_loop`, and the engine
with `speculate_tokens` and `paged_pages`.

Inputs are made with numpy from a seed and go through both packages;
weights come from gabby_tpu's init_params through params_from_numpy, and
caches cross as numpy arrays (cache_from_numpy, paged_cache_from_numpy).
The Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them; the port takes its kernels' plain versions (CPU tensors).

Tolerances: attention contracts 3e-2 (the Pallas kernels round their big
operands to bf16: the reference's own tolerance, tests/test_pallas_kernels
.py:322); model steps in f32 2e-4 against JAX (summation order through two
layers) and 2e-5 against the port's own sequential decode (the reference's
bound, tests/test_speculative.py:61); token streams by equality."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import attention as jattn
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu.runtime import generate as jgen
from gabby_tpu.runtime import paged as jpaged
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import attention as tattn
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime import paged as tpaged
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.runtime.kv_cache import (cache_from_numpy,
                                              create_cache, quantize_kv)
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

ATTN_TOL = dict(rtol=3e-2, atol=3e-2)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
SEQ_TOL = dict(rtol=2e-5, atol=2e-5)
MAX_SEQ = 128


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """Model-level JAX calls take the jnp contracts; the attention tests
    call the Pallas kernels directly (interpret mode on the CPU). The jnp
    contracts have no s8 form of decode attention, so the port's s8 switch
    is off here; tests/test_torch_pair_s8.py holds the s8 form against the
    JAX kernel."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _j(t):
    return jnp.asarray(t.numpy())


# ---- attention contracts --------------------------------------------------


def _attention_inputs(seed, t, b=3, nk=2, g=4, h=64):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((b, nk, t, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((b, nk, t, h)).astype(np.float32) * 0.5
    return r, q, fk, fv


def _dense_masked(q, kd, vd, fk, fv, positions):
    """The dense masked reference of gabby_tpu/models/llama.py:833-862 in
    jnp: cache rows j < positions[b], then the block causally."""
    b, t, _, h = q.shape
    s = kd.shape[2]
    kk = jnp.concatenate([jnp.swapaxes(kd, 1, 2), jnp.swapaxes(fk, 1, 2)],
                         axis=1)
    vv = jnp.concatenate([jnp.swapaxes(vd, 1, 2), jnp.swapaxes(fv, 1, 2)],
                         axis=1)
    cache_mask = jnp.broadcast_to(
        jnp.arange(s)[None, None, :] < positions[:, None, None], (b, t, s))
    self_mask = jnp.broadcast_to(
        jnp.arange(t)[None, :, None] >= jnp.arange(t)[None, None, :],
        (b, t, t))
    mask = jnp.concatenate([cache_mask, self_mask], axis=2)
    return jattn._gqa_core(jattn._split_groups(q, kd.shape[1]), kk, vv, mask,
                           h ** -0.5)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t", [2, 5, 8])
def test_verify_attention(quantized, t):
    """K9's plain version against pattn.verify_attention and against the
    dense masked reference; slot 0 sits at position 0 (the block alone)."""
    nl, s, layer = 2, 64, 1
    r, q, fk, fv = _attention_inputs(10 + t, t)
    b, nk = fk.shape[:2]
    kf = r.standard_normal((nl, b, nk, s, 64)).astype(np.float32) * 0.5
    vf = r.standard_normal((nl, b, nk, s, 64)).astype(np.float32) * 0.5
    pos = np.asarray([0, 37, 64], np.int32)
    bf, tbf = jnp.bfloat16, torch.bfloat16
    jq, jfk, jfv = (jnp.asarray(x, bf) for x in (q, fk, fv))
    if quantized:
        kc, ks = quantize_kv(_t(kf))
        vc, vs = quantize_kv(_t(vf))
        ref = pattn.verify_attention(jq, _j(kc), _j(vc), jnp.asarray(pos),
                                     _j(ks), _j(vs), layer=jnp.int32(layer),
                                     fresh_k=jfk, fresh_v=jfv)
        kd = (_j(kc[layer]).astype(jnp.float32)
              * _j(ks[layer])[..., None]).astype(bf)
        vd = (_j(vc[layer]).astype(jnp.float32)
              * _j(vs[layer])[..., None]).astype(bf)
        out = cattn.verify_attention(_t(q, tbf), kc, vc, ks, vs, _t(pos),
                                     layer=layer, fresh_k=_t(fk, tbf),
                                     fresh_v=_t(fv, tbf))
    else:
        kc, vc = _t(kf, tbf), _t(vf, tbf)
        ref = pattn.verify_attention(jq, jnp.asarray(kf, bf),
                                     jnp.asarray(vf, bf), jnp.asarray(pos),
                                     layer=jnp.int32(layer), fresh_k=jfk,
                                     fresh_v=jfv)
        kd, vd = jnp.asarray(kf[layer], bf), jnp.asarray(vf[layer], bf)
        out = tattn.verify_attention(_t(q, tbf), kc, vc, _t(pos),
                                     layer=layer, fresh_k=_t(fk, tbf),
                                     fresh_v=_t(fv, tbf))
    dense = _dense_masked(jq, kd, vd, jfk, jfv, jnp.asarray(pos))
    assert out.shape == q.shape and out.dtype == tbf
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(dense, np.float32), **ATTN_TOL)


def _pool_inputs(seed, t, quantized):
    """A pool of 10 pages of 16 rows behind a scattered table (page 0, the
    scratch page, holds large values and is in no table row)."""
    nl, nk, page = 2, 2, 16
    r, q, fk, fv = _attention_inputs(seed, t, b=2, nk=nk)
    kp = r.standard_normal((10, nl, nk, page, 64)).astype(np.float32) * 0.5
    vp = r.standard_normal((10, nl, nk, page, 64)).astype(np.float32) * 0.5
    kp[0] = vp[0] = 50.0
    table = np.asarray([[3, 5, 1, 7], [2, 8, 9, 4]], np.int32)
    pos = np.asarray([19, 55], np.int32)
    tbf = torch.bfloat16
    if quantized:
        kc, ks = quantize_kv(_t(kp))
        vc, vs = quantize_kv(_t(vp))
    else:
        kc, vc, ks, vs = _t(kp, tbf), _t(vp, tbf), None, None
    return q, fk, fv, kc, vc, ks, vs, table, pos


def _jscale(x):
    return None if x is None else _j(x)


def _jpool(x):
    return (_j(x) if x.dtype == torch.int8
            else jnp.asarray(x.float().numpy(), jnp.bfloat16))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t", [3, 8])
def test_paged_verify_attention(quantized, t):
    """K11's plain version against pattn.paged_verify_attention on a
    scattered table, and against the port's dense verify contract on the
    gathered rows."""
    q, fk, fv, kc, vc, ks, vs, table, pos = _pool_inputs(30 + t, t,
                                                         quantized)
    bf, tbf = jnp.bfloat16, torch.bfloat16
    args = (_t(q, tbf), kc, vc, _t(table), _t(pos), ks, vs)
    kw = dict(layer=1, fresh_k=_t(fk, tbf), fresh_v=_t(fv, tbf))
    out = tattn.paged_attention(*args, **kw)
    ref = pattn.paged_verify_attention(
        jnp.asarray(q, bf), _jpool(kc), _jpool(vc), jnp.asarray(table),
        jnp.asarray(pos), _jscale(ks), _jscale(vs), layer=jnp.int32(1),
        fresh_k=jnp.asarray(fk, bf), fresh_v=jnp.asarray(fv, bf))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    gathered = [None if p is None else tattn.gather_pages(p, _t(table), 1)
                for p in (kc, vc, ks, vs)]
    dense = tattn.verify_attention_reference(
        _t(q, tbf), gathered[0], gathered[1], _t(pos), gathered[2],
        gathered[3], fresh_k=kw["fresh_k"], fresh_v=kw["fresh_v"])
    assert torch.equal(out, dense)
    if quantized:
        assert torch.equal(out, cpaged.paged_verify_attention(*args, **kw))


# ---- the allocator and the pool's device ops ------------------------------


def test_page_allocator_matches_reference():
    """The same alloc/share/release sequence hands out the same pages."""
    ours, ref = tpaged.PageAllocator(12), jpaged.PageAllocator(12)
    r = np.random.default_rng(5)
    held_o, held_r = [], []
    assert ours.alloc(1) == ref.alloc(1) == [0]
    for _ in range(200):
        op = r.integers(0, 3)
        if op == 0:
            n = int(r.integers(1, 4))
            a, b = ours.alloc(n), ref.alloc(n)
            assert a == b
            if a is not None:
                held_o.append(a)
                held_r.append(b)
        elif op == 1 and held_o:
            i = int(r.integers(0, len(held_o)))
            a, b = ours.share(held_o[i][:2]), ref.share(held_r[i][:2])
            assert a == b
            held_o.append(a)
            held_r.append(b)
        elif held_o:
            i = int(r.integers(0, len(held_o)))
            ours.release(held_o.pop(i))
            ref.release(held_r.pop(i))
        assert ours.free == ref.free and ours.refs == ref.refs
        assert ours.available() == ref.available()
    with pytest.raises(ValueError, match="double free"):
        tpaged.PageAllocator(2).release([1])
    # the paired pool keeps the reference's shapes
    tc = tcfg.tiny()
    ours_p = tpaged.create_paged_cache(tc, 1, 32, 4, quantized=True,
                                       page_size=16, paired=True,
                                       device="cpu")
    ref_p = jpaged.create_paged_cache(jcfg.tiny(), 1, 32, 4, quantized=True,
                                      page_size=16, paired=True)
    for name in ("k", "v", "k_scale", "v_scale", "page_table"):
        assert tuple(getattr(ours_p, name).shape) == getattr(ref_p,
                                                             name).shape


def test_gather_and_chunk_write_match_reference():
    """write_slot_chunk then gather_slot_rows: the same pool and the same
    dense view as gabby_tpu's, through a scattered table."""
    jc, tc = jcfg.tiny(max_seq_len=64), tcfg.tiny(max_seq_len=64)
    ps = 16
    jcache = jpaged.create_paged_cache(jc, 2, 64, 9, dtype=jnp.float32,
                                       quantized=True, page_size=ps)
    table = np.asarray([[4, 2, 7, 0], [1, 8, 3, 0]], np.int32)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(table))
    tcache = tpaged.paged_cache_from_numpy(
        np.asarray(jcache.k), np.asarray(jcache.v),
        np.asarray(jcache.k_scale), np.asarray(jcache.v_scale), table,
        device="cpu")
    r = np.random.default_rng(6)
    nl, nk, h = jc.num_layers, jc.num_kv_heads, jc.head_dim
    kn = r.integers(-127, 128, (nl, nk, 32, h)).astype(np.int8)
    vn = r.integers(-127, 128, (nl, nk, 32, h)).astype(np.int8)
    ksn = r.random((nl, nk, 32)).astype(np.float32)
    vsn = r.random((nl, nk, 32)).astype(np.float32)
    jcache = jpaged.write_slot_chunk(jcache, jnp.int32(1), jnp.int32(16),
                                     *(jnp.asarray(x)
                                       for x in (kn, vn, ksn, vsn)))
    for layer in range(nl):
        tpaged.write_slot_chunk(tcache, 1, 16, _t(kn[layer]), _t(vn[layer]),
                                _t(ksn[layer]), _t(vsn[layer]), layer=layer)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)))
    want = jpaged.gather_slot_rows(jcache, jnp.int32(1), 48)
    got = tpaged.gather_slot_rows(tcache, 1, 48)
    one = tpaged.gather_slot_rows(tcache, 1, 48, layer=1)
    for g, w, o in zip(got, want, one):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(o, g[1])
    with pytest.raises(ValueError, match="page size"):
        tpaged.write_slot_chunk(tcache, 1, 8, _t(kn[0]), _t(vn[0]),
                                _t(ksn[0]), _t(vsn[0]), layer=0)


# ---- model steps ----------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.tiny(max_seq_len=MAX_SEQ), tcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def _np_cache(jcache):
    """A JAX KVCache / PagedKVCache as the port's, through numpy."""
    leaves = [None if x is None else np.asarray(x)
              for x in (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)]
    if isinstance(jcache, jpaged.PagedKVCache):
        return tpaged.paged_cache_from_numpy(
            *leaves, np.asarray(jcache.page_table), device="cpu")
    return cache_from_numpy(*leaves, device="cpu")


def _new_caches(jc, paged: bool, quantized: bool, batch: int = 2,
                max_seq: int = MAX_SEQ, ps: int = 16, paired: bool = False):
    """The same empty cache on both sides; paged tables map slot b's
    logical pages onto a scattered run of the pool (page 0 is scratch)."""
    if not paged:
        jcache = jcreate_cache(jc, batch, max_seq, dtype=jnp.float32,
                               quantized=quantized, paired=paired)
        return jcache, _np_cache(jcache)
    mp = max_seq // ps
    jcache = jpaged.create_paged_cache(jc, batch, max_seq, 1 + batch * mp,
                                       dtype=jnp.float32,
                                       quantized=quantized, page_size=ps,
                                       paired=paired)
    table = 1 + np.random.default_rng(7).permutation(batch * mp).reshape(
        batch, mp).astype(np.int32)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(table))
    return jcache, _np_cache(jcache)


def _prefill_both(model, jcache, tcache, ids, slot: int, bucket: int):
    jc, tc, params, tparams = model
    chunk = np.zeros((bucket,), np.int32)
    chunk[:len(ids)] = ids
    jl, jcache = jllama.prefill_slot(
        params, jc, jnp.asarray(chunk), jnp.int32(len(ids)), jnp.int32(slot),
        jnp.int32(0), jcache)
    tl, tcache = tllama.prefill_slot(tparams, tc, _t(chunk), len(ids), slot,
                                     0, tcache)
    return jl, tl, jcache, tcache


def _assert_caches_close(tcache, jcache, tol=JAX_TOL):
    for name in ("k", "v", "k_scale", "v_scale"):
        t, j = getattr(tcache, name), getattr(jcache, name)
        if t is None:
            assert j is None
        elif t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32)
                          - np.asarray(j).astype(np.int32))
            assert diff.max() <= 1  # a code on a rounding boundary
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_step_matches_reference_and_sequential_decode(model, paged,
                                                             quantized):
    """One verify pass over [t0, d1, d2] against gabby_tpu's verify_step
    from the same cache, and against three sequential decode_steps of the
    port whose greedy tokens the drafts are. Slot 1 is a parked lane."""
    jc, tc, params, tparams = model
    ids = list(range(2, 34))  # 32 tokens: two pages of 16
    n = len(ids)
    jcache, tcache = _new_caches(jc, paged, quantized)
    jl, tl, jcache, tcache = _prefill_both(model, jcache, tcache, ids, 0, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **JAX_TOL)
    _assert_caches_close(tcache, jcache)
    t0 = int(tl.argmax())

    # sequential ground truth on a second copy of the port's cache
    seq_cache = _np_cache(jcache)
    park = MAX_SEQ - 1
    tok = torch.tensor([t0, 0], dtype=torch.int32)
    pos = torch.tensor([n, park], dtype=torch.int32)
    read = torch.tensor([n, 1], dtype=torch.int32)
    seq_logits = []
    for i in range(3):
        lg, seq_cache = tllama.decode_step(tparams, tc, tok, pos, seq_cache,
                                           attn_positions=read)
        seq_logits.append(lg[0].numpy())
        tok = torch.tensor([int(lg[0].argmax()), 0], dtype=torch.int32)
        pos = pos + torch.tensor([1, 0], dtype=torch.int32)
        read = read + torch.tensor([1, 0], dtype=torch.int32)
    drafts = [int(np.argmax(seq_logits[0])), int(np.argmax(seq_logits[1]))]

    vb = np.asarray([[t0] + drafts, [0, 0, 0]], np.int32)
    p0 = np.asarray([n, park], np.int32)
    rp = np.asarray([n, 1], np.int32)
    jv, jcache = jllama.verify_step(params, jc, jnp.asarray(vb),
                                    jnp.asarray(p0), jcache,
                                    attn_positions=jnp.asarray(rp))
    tv, tcache = tllama.verify_step(tparams, tc, _t(vb), _t(p0), tcache,
                                    attn_positions=_t(rp))
    assert tv.shape == (2, 3, tc.vocab_size) and tv.dtype == torch.float32
    # int8 rows that round one code apart move a logit by ~1e-2 (see
    # test_torch_model.py); f32 caches hold the f32 bound
    tol = dict(rtol=1e-2, atol=3e-2) if quantized else JAX_TOL
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    _assert_caches_close(tcache, jcache, tol)
    seq_tol = tol if quantized else SEQ_TOL
    for i in range(3):
        np.testing.assert_allclose(tv[0, i].numpy(), seq_logits[i],
                                   **seq_tol)
    # the rows verify wrote equal the sequential ones (slot 0's first n+3)
    if paged:
        got = tpaged.gather_slot_rows(tcache, 0, 48)
        want = tpaged.gather_slot_rows(seq_cache, 0, 48)
    else:
        got = [None if x is None else x[:, 0] for x in
               (tcache.k, tcache.v, tcache.k_scale, tcache.v_scale)]
        want = [None if x is None else x[:, 0] for x in
                (seq_cache.k, seq_cache.v, seq_cache.k_scale,
                 seq_cache.v_scale)]
    for g, w in zip(got, want):
        if g is None:
            continue
        if g.dtype == torch.int8:
            assert (g[:, :, :n + 3].int() - w[:, :, :n + 3].int()
                    ).abs().max() <= 1
        else:
            np.testing.assert_allclose(g[:, :, :n + 3].numpy(),
                                       w[:, :, :n + 3].numpy(), **seq_tol)


def test_verify_step_write_near_the_cap_preserves_history(model):
    """A T = 4 block at position 30 of a 32-row cache: rows [0, 30) stay
    byte-identical, rows 30 and 31 hold the block's first two rows (equal
    to what an unclamped verify writes in a roomier cache), and a lane
    elsewhere is written at its own position only."""
    jc, tc, params, tparams = model
    max_seq, n = 32, 30
    ids = [(i % 90) + 2 for i in range(n)]
    small = create_cache(tc, 2, max_seq, dtype=torch.float32, device="cpu")
    big = create_cache(tc, 2, 64, dtype=torch.float32, device="cpu")
    chunk = np.zeros((32,), np.int64)
    chunk[:n] = ids
    for cache in (small, big):
        tllama.prefill_slot(tparams, tc, _t(chunk), n, 0, 0, cache)
    k_before = small.k.clone()
    vb = _t(np.asarray([[7, 5, 6, 7], [1, 1, 1, 1]], np.int32))
    p0 = _t(np.asarray([n, 1], np.int32))
    lg_small, _ = tllama.verify_step(tparams, tc, vb, p0, small)
    lg_big, _ = tllama.verify_step(tparams, tc, vb, p0, big)
    assert torch.equal(small.k[:, 0, :, :n], k_before[:, 0, :, :n])
    np.testing.assert_allclose(small.k[:, 0, :, n:n + 2].numpy(),
                               big.k[:, 0, :, n:n + 2].numpy(), **SEQ_TOL)
    assert not torch.equal(small.k[:, 0, :, n:], k_before[:, 0, :, n:])
    np.testing.assert_allclose(small.k[:, 1, :, 1:5].numpy(),
                               big.k[:, 1, :, 1:5].numpy(), **SEQ_TOL)
    assert torch.equal(small.k[:, 1, :, 5:], k_before[:, 1, :, 5:])
    np.testing.assert_allclose(lg_small.numpy(), lg_big.numpy(), **SEQ_TOL)
    # gabby_tpu's blended write leaves the same rows
    jcache = jcreate_cache(jc, 2, max_seq, dtype=jnp.float32)
    _, jcache = jllama.prefill_slot(
        params, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(n), jnp.int32(0),
        jnp.int32(0), jcache)
    _, jcache = jllama.verify_step(params, jc, _j(vb), _j(p0), jcache)
    np.testing.assert_allclose(small.k[:, 0].numpy(),
                               np.asarray(jcache.k)[:, 0], **JAX_TOL)


def test_paged_writes_past_the_cap_land_on_the_scratch_page(model):
    """Verify rows at positions >= max_seq, and a decode row of a lane
    frozen at max_seq, go to physical page 0, not into the slot's last
    page (tests/test_paged.py:425)."""
    _, tc, _, tparams = model
    ps, max_seq = 8, 32
    cache = tpaged.create_paged_cache(tc, 1, max_seq, 6, dtype=torch.float32,
                                      page_size=ps, device="cpu")
    cache.k.fill_(7.0)
    cache.v.fill_(7.0)
    cache.page_table.copy_(torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
    pre = cache.k.clone()
    tllama.verify_step(tparams, tc, _t(np.asarray([[5, 6, 7]], np.int32)),
                       _t(np.asarray([30], np.int32)), cache)
    assert not torch.equal(cache.k[4, :, :, 6], pre[4, :, :, 6])  # row 30
    assert not torch.equal(cache.k[4, :, :, 7], pre[4, :, :, 7])  # row 31
    assert torch.equal(cache.k[4, :, :, 0], pre[4, :, :, 0])      # no wrap
    assert torch.equal(cache.k[1:4], pre[1:4])
    assert not torch.equal(cache.k[0, :, :, 0], pre[0, :, :, 0])  # scratch
    cache.k.copy_(pre)
    tllama.decode_step(tparams, tc, torch.tensor([9], dtype=torch.int32),
                       torch.tensor([max_seq], dtype=torch.int32), cache)
    assert torch.equal(cache.k[1:], pre[1:])
    assert not torch.equal(cache.k[0, :, :, 0], pre[0, :, :, 0])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_prefill_and_decode_match_dense_and_reference(model,
                                                            quantized):
    """A 40-token prompt in page-aligned chunks (32, then 16 at offset 32),
    then greedy decode: the port's paged path against its dense path and
    against gabby_tpu's paged path (tests/test_paged.py:63)."""
    jc, tc, params, tparams = model
    ids = np.arange(2, 42)
    jcache, pcache = _new_caches(jc, True, quantized)
    dcache = create_cache(tc, 2, MAX_SEQ, dtype=torch.float32,
                          quantized=quantized, device="cpu")
    for offset, bucket in ((0, 32), (32, 16)):
        take = min(bucket, len(ids) - offset)
        chunk = np.zeros((bucket,), np.int32)
        chunk[:take] = ids[offset:offset + take]
        jl, jcache = jllama.prefill_slot(
            params, jc, jnp.asarray(chunk), jnp.int32(take), jnp.int32(1),
            jnp.int32(offset), jcache)
        pl, _ = tllama.prefill_slot(tparams, tc, _t(chunk), take, 1, offset,
                                    pcache)
        dl, _ = tllama.prefill_slot(tparams, tc, _t(chunk), take, 1, offset,
                                    dcache)
    tol = dict(rtol=1e-2, atol=3e-2) if quantized else JAX_TOL
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(pl.numpy(), dl.numpy(), **SEQ_TOL)
    tok = np.asarray([0, int(pl.argmax())], np.int32)
    pos = np.asarray([MAX_SEQ - 1, len(ids)], np.int32)
    read = np.asarray([1, len(ids)], np.int32)
    for _ in range(6):
        jl, jcache = jllama.decode_step(params, jc, jnp.asarray(tok),
                                        jnp.asarray(pos), jcache,
                                        attn_positions=jnp.asarray(read))
        pl, _ = tllama.decode_step(tparams, tc, _t(tok), _t(pos), pcache,
                                   attn_positions=_t(read))
        dl, _ = tllama.decode_step(tparams, tc, _t(tok), _t(pos), dcache,
                                   attn_positions=_t(read))
        np.testing.assert_allclose(pl[1].numpy(), np.asarray(jl)[1], **tol)
        np.testing.assert_allclose(pl[1].numpy(), dl[1].numpy(), **SEQ_TOL)
        assert int(pl[1].argmax()) == int(np.argmax(np.asarray(jl)[1]))
        tok = np.asarray([0, int(pl[1].argmax())], np.int32)
        pos = pos + np.asarray([0, 1], np.int32)
        read = read + np.asarray([0, 1], np.int32)
    _assert_caches_close(pcache, jcache, tol)
    # the pool holds the dense cache's rows behind the table
    rows = tpaged.gather_slot_rows(pcache, 1, 48)
    for g, name in zip(rows, ("k", "v", "k_scale", "v_scale")):
        if g is not None:
            assert torch.equal(g[:, :, :46],
                               getattr(dcache, name)[:, 1, :, :46])


# ---- the speculative loop -------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_decode_loop_matches_reference(model, paged):
    """Three macro-steps of draft length 4 from the same tokens, positions
    and history: slot 0 carries a self-similar prompt, slot 1 a
    non-repeating one, slot 2 is parked. Candidate tokens, counts, final
    state and history equal gabby_tpu's (greedy, f32), and the emitted
    tokens' logprobs agree within 1e-3."""
    jc, tc, params, tparams = model
    b, d, steps = 3, 4, 3
    prompts = [[5, 9, 5, 9, 5, 9, 5, 9, 5, 9, 5, 9, 5, 9, 5, 9],
               list(range(20, 36))]
    jcache, tcache = _new_caches(jc, paged, False, batch=b)
    history = np.zeros((b, MAX_SEQ), np.int32)
    tokens = np.zeros((b,), np.int32)
    for slot, ids in enumerate(prompts):
        jl, tl, jcache, tcache = _prefill_both(model, jcache, tcache, ids,
                                               slot, 16)
        history[slot, :16] = ids
        tokens[slot] = int(tl.argmax())
        assert tokens[slot] == int(jnp.argmax(jl))
        history[slot, 16] = tokens[slot]
    positions = np.asarray([16, 16, MAX_SEQ - 1], np.int32)
    active = np.asarray([True, True, False])
    eos = np.asarray([1], np.int32)
    jstate = jgen.SamplingState(
        temperature=jnp.zeros((b,), jnp.float32),
        top_k=jnp.zeros((b,), jnp.int32), top_p=jnp.ones((b,), jnp.float32),
        key=jax.random.PRNGKey(0), seed=jnp.full((b,), -1, jnp.int32))
    (j_em, j_n, j_lp, j_tok, j_pos, j_act, jcache, _, j_hist, _, _) = \
        jgen.spec_decode_loop(params, jc, jnp.asarray(tokens),
                              jnp.asarray(positions), jnp.asarray(active),
                              jcache, jstate, jnp.asarray(history), steps, d,
                              jnp.asarray(eos))
    thist = _t(history)
    t_em, t_n, t_lp, t_tok, t_pos, t_act, _, _ = tgen.spec_decode_loop(
        tparams, tc, _t(tokens), _t(positions), _t(active), tcache,
        tgen.SamplingState.greedy(b, "cpu"), thist, steps, d, _t(eos))
    j_n = np.asarray(j_n)
    np.testing.assert_array_equal(t_n.numpy(), j_n)
    assert j_n[:, 0].sum() > steps  # the self-similar slot accepted drafts
    for k in range(steps):
        for slot in range(b):
            n = j_n[k, slot]
            np.testing.assert_array_equal(t_em[k, slot, :n].numpy(),
                                          np.asarray(j_em)[k, slot, :n])
            np.testing.assert_allclose(t_lp[k, slot, :n].numpy(),
                                       np.asarray(j_lp)[k, slot, :n],
                                       rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    for slot in range(2):
        upto = int(t_pos[slot]) + 1
        np.testing.assert_array_equal(thist[slot, :upto].numpy(),
                                      np.asarray(j_hist)[slot, :upto])
    _assert_caches_close(tcache, jcache)


def test_sampled_lanes_draft_nothing(model):
    """A lane with temperature > 0 emits one token per macro-step through
    the sampler, whatever its history repeats."""
    _, tc, _, tparams = model
    cache = create_cache(tc, 1, MAX_SEQ, dtype=torch.float32, device="cpu")
    ids = np.asarray([5, 9] * 8, np.int64)
    logits, _ = tllama.prefill_slot(tparams, tc, _t(ids), 16, 0, 0, cache)
    history = torch.zeros((1, MAX_SEQ), dtype=torch.int32)
    history[0, :16] = _t(ids)
    history[0, 16] = 5
    state = tgen.SamplingState.greedy(1, "cpu", seed=3)
    state.temperature[0] = 0.8
    em, n, _, tok, pos, act, _, _ = tgen.spec_decode_loop(
        tparams, tc, torch.tensor([5], dtype=torch.int32),
        torch.tensor([16], dtype=torch.int32), torch.tensor([True]), cache,
        state, history, 4, 4, torch.tensor([1], dtype=torch.int32))
    assert n.tolist() == [[1]] * 4 and int(pos[0]) == 20
    assert history[0, 17:21].tolist() == em[:, 0, 0].tolist()


def test_write_history_and_admit_slot_place_the_first_token():
    history = torch.full((2, 8), 9, dtype=torch.int32)
    tgen.write_history(history, 1, torch.tensor([4, 5, 6, 0, 0, 0, 0, 0]), 3)
    assert history.tolist() == [[9] * 8, [4, 5, 6, 0, 0, 0, 0, 0]]
    state = tgen.SamplingState.greedy(2, "cpu")
    tokens = torch.zeros(2, dtype=torch.int32)
    positions = torch.zeros(2, dtype=torch.int32)
    active = torch.zeros(2, dtype=torch.bool)
    logits = torch.zeros(16)
    logits[11] = 1.0
    tgen.admit_slot(logits, 1, 3, 0.0, 0, 1.0, tokens, positions, active,
                    state, history=history)
    assert history[1].tolist() == [4, 5, 6, 11, 0, 0, 0, 0]
    assert tokens.tolist() == [0, 11] and positions.tolist() == [0, 3]


# ---- the engine -----------------------------------------------------------

SELF_SIMILAR = "ab ab ab ab ab ab ab ab ab ab"
NON_REPEATING = "the quick brown fox jumps over it"


def _engine(model, **kw):
    _, tc, _, tparams = model
    base = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
                default_max_tokens=24, cache_dtype="float32")
    base.update(kw)
    stop_ids = base.pop("stop_ids", None)
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**base), device="cpu", stop_ids=stop_ids)


def _run(eng, prompt, max_tokens=24, ids=None):
    req = (eng.submit_ids(ids, max_tokens=max_tokens) if ids is not None
           else eng.submit([{"role": "user", "content": prompt}],
                           max_tokens=max_tokens))
    while True:
        _, fin = req.out.get(timeout=120)
        if fin is not None:
            return list(req.token_ids), fin


@pytest.fixture(scope="module")
def plain_streams(model):
    eng = _engine(model)
    try:
        return {p: _run(eng, p) for p in (SELF_SIMILAR, NON_REPEATING)}
    finally:
        eng.shutdown()


PAGED = dict(paged_pages=1 + 2 * (MAX_SEQ // 16), page_size=16)


@pytest.mark.parametrize("prompt", [SELF_SIMILAR, NON_REPEATING],
                         ids=["self-similar", "non-repeating"])
@pytest.mark.parametrize("mode", ["spec", "paged", "paged-spec"])
def test_engine_output_equals_the_plain_engine(model, plain_streams, mode,
                                               prompt):
    kw = {"spec": dict(speculate_tokens=4), "paged": PAGED,
          "paged-spec": dict(speculate_tokens=4, **PAGED)}[mode]
    eng = _engine(model, **kw)
    try:
        assert _run(eng, prompt) == plain_streams[prompt]
        stats = eng.stats_snapshot()
        if "spec" in mode:
            assert stats["spec_macro_steps"] >= 1 and stats["spec_on"] == 1
            assert stats["spec_tokens"] >= stats["spec_macro_steps"]
        if "paged" in mode:
            # the finished request's pages stay resident as a prefix donor
            held = eng._slot_pages[0]
            assert held and eng._slot_prompts[0] is not None
            assert eng._cache.page_table[0, :len(held)].tolist() == held
            assert not eng._cache.page_table[1].any()
            _assert_pool_adds_up(eng, kw["paged_pages"])
    finally:
        eng.shutdown()


@pytest.mark.parametrize("mode", ["spec", "paged"])
def test_engine_output_equals_the_reference_engine(model, plain_streams,
                                                   mode):
    """The same greedy request through gabby_tpu's engine with
    speculate_tokens=4, and with paged_pages set."""
    jc, _, params, _ = model
    kw = dict(speculate_tokens=4) if mode == "spec" else PAGED
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(batch_slots=2, max_seq=MAX_SEQ,
                                 steps_per_call=4, default_max_tokens=24,
                                 cache_dtype="float32", **kw))
    try:
        req = jeng.submit([{"role": "user", "content": SELF_SIMILAR}],
                          max_tokens=24)
        while req.out.get(timeout=300)[1] is None:
            pass
        want = list(req.token_ids)
    finally:
        jeng.shutdown()
    eng = _engine(model, **kw)
    try:
        got, _ = _run(eng, SELF_SIMILAR)
    finally:
        eng.shutdown()
    assert got == want == plain_streams[SELF_SIMILAR][0]


def test_spec_eos_inside_a_draft(model, plain_streams):
    """With the stream's 4th token made an EOS, the speculative engine
    stops exactly there, as the plain one does."""
    stream, _ = plain_streams[SELF_SIMILAR]
    assert len(stream) >= 4
    eos = stream[3]
    want = stream[:stream.index(eos)]
    for kw in (dict(), dict(speculate_tokens=5)):
        eng = _engine(model, batch_slots=1, stop_ids={eos}, **kw)
        try:
            assert _run(eng, SELF_SIMILAR, 10) == (want[:10], "stop")
        finally:
            eng.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_engine_reaches_full_context_capacity(model, paged):
    """Near max_seq the loop stops drafting but keeps emitting single
    verified tokens to the plain engine's exact capacity bound."""
    kw = dict(batch_slots=1, max_seq=64, default_max_tokens=60)
    if paged:
        kw.update(paged_pages=5, page_size=16)
    prompt = list(range(2, 50))  # 48 tokens: the cap leaves 16 rows
    plain = _engine(model, **kw)
    try:
        want = _run(plain, None, 60, ids=prompt)
    finally:
        plain.shutdown()
    spec = _engine(model, speculate_tokens=5, **kw)
    try:
        got = _run(spec, None, 60, ids=prompt)
        assert spec.stats_snapshot()["spec_macro_steps"] >= 1
    finally:
        spec.shutdown()
    # the first token from the prefill, then one per free row
    assert got == want and got[1] == "length" and len(got[0]) == 17


def _assert_pool_adds_up(eng, pages):
    """The free pages and those the slots hold as resident prefix donors
    make up the pool less the scratch page, each held page once."""
    held = [p for slot_pages in eng._slot_pages for p in slot_pages]
    assert len(set(held)) == len(held)
    assert all(eng._alloc.refs[p] == 1 for p in held)
    assert eng._alloc.available() + len(held) == pages - 1


def test_paged_pool_exhaustion(model):
    """A prompt the pool cannot back gets an error finish; a request whose
    decode outgrows the pool finishes with `length` and its text so far
    (its pages stay resident as a prefix donor); the engine keeps serving
    and the pool adds up again."""
    eng = _engine(model, paged_pages=3, page_size=16)  # 2 usable pages
    try:
        _, fin = _run(eng, None, 4, ids=list(range(2, 62)))  # 4 pages
        assert fin == "error: kv page pool exhausted"
        assert eng._alloc.available() == 2
        toks, fin = _run(eng, None, 40, ids=list(range(2, 12)))
        assert fin == "length" and 0 < len(toks) < 22
        assert eng._slot_pages[0] == [1, 2]
        _assert_pool_adds_up(eng, 3)
        toks, fin = _run(eng, None, 2, ids=list(range(2, 18)))
        assert fin in ("stop", "length") and len(toks) <= 2
        _assert_pool_adds_up(eng, 3)
        assert not eng._failed
    finally:
        eng.shutdown()


def test_spec_autodisable_and_reprobe(model):
    """The acceptance state machine, driven through its counters as a
    serving run evolves them (tests/test_speculative.py:301)."""
    eng = _engine(model, speculate_tokens=4, spec_breakeven=1.2,
                  spec_reprobe_steps=16, default_max_tokens=8)
    try:
        assert eng._spec_enabled
        with eng._lock:
            eng.stats.update(spec_macro_steps=200, spec_tokens=210,
                             decode_steps=1000)
        eng._maybe_disable_spec()
        assert not eng._spec_enabled and eng._spec_off_since == 1000
        snap = eng.stats_snapshot()
        assert snap["spec_on"] == 0 and snap["spec_disables"] == 1
        assert snap["spec_breakeven_derived"] == 1.2
        with eng._lock:
            eng.stats["decode_steps"] = 1010
        eng._maybe_reprobe_spec()
        assert not eng._spec_enabled
        with eng._lock:
            eng.stats["decode_steps"] = 1016
        eng._maybe_reprobe_spec()
        assert eng._spec_enabled and eng.stats["spec_on"] == 1
        # a healthy NEW window keeps it on though the cumulative mean is poor
        with eng._lock:
            eng.stats.update(spec_macro_steps=350, spec_tokens=660)
        eng._maybe_disable_spec()
        assert eng._spec_enabled
        with eng._lock:
            eng.stats.update(spec_macro_steps=600, spec_tokens=630)
        eng._maybe_disable_spec()
        assert not eng._spec_enabled and eng.stats["spec_disables"] == 2
        _, fin = _run(eng, "ab ab ab ab", 6)  # still serves, on the plain loop
        assert fin in ("stop", "length")
    finally:
        eng.shutdown()


def test_spec_sticky_disable_and_breakeven_from_timings(model):
    eng = _engine(model, speculate_tokens=3, spec_reprobe_steps=0,
                  spec_breakeven=1.7)
    try:
        assert eng._spec_breakeven_now() == 1.7  # windows empty: the prior
        eng._plain_step_s.extend([0.010] * 8)
        eng._spec_step_s.extend([0.013] * 8)
        assert abs(eng._spec_breakeven_now() - 1.3) < 1e-9
        eng._spec_step_s.clear()
        eng._spec_step_s.extend([0.004] * 8)
        assert eng._spec_breakeven_now() == 1.0  # floored
        eng.ec.spec_auto_breakeven = False
        assert eng._spec_breakeven_now() == 1.7
        with eng._lock:
            eng.stats.update(spec_macro_steps=200, spec_tokens=200,
                             decode_steps=1000)
        eng._maybe_disable_spec()
        assert not eng._spec_enabled
        with eng._lock:
            eng.stats["decode_steps"] = 10 ** 9
        eng._maybe_reprobe_spec()
        assert not eng._spec_enabled  # spec_reprobe_steps=0: off for good
    finally:
        eng.shutdown()


def test_plain_probe_bursts_and_a_disable_under_traffic(model,
                                                        plain_streams):
    """With a break-even no stream can reach, real traffic switches
    speculation off after 128 slot-macro-steps, every 16th burst before
    that ran plain for the timing window, and the output is unchanged."""
    eng = _engine(model, speculate_tokens=2, spec_breakeven=99.0,
                  spec_auto_breakeven=False, spec_reprobe_steps=0,
                  steps_per_call=8, default_max_tokens=100)
    try:
        for _ in range(3):
            _run(eng, NON_REPEATING, 100)
        snap = eng.stats_snapshot()
        assert snap["spec_disables"] == 1 and snap["spec_on"] == 0
        assert 128 <= snap["spec_macro_steps"] < snap["decode_steps"]
        assert _run(eng, SELF_SIMILAR) == plain_streams[SELF_SIMILAR]
    finally:
        eng.shutdown()
    probing = _engine(model, speculate_tokens=2, steps_per_call=1)
    try:
        _run(probing, NON_REPEATING, 40)
        assert len(probing._plain_step_s) >= 1  # every 16th burst ran plain
        assert len(probing._spec_step_s) > len(probing._plain_step_s)
    finally:
        probing.shutdown()


def test_warmup_keeps_the_speculation_state(model):
    eng = _engine(model, speculate_tokens=3, spec_breakeven=99.0,
                  **PAGED)
    try:
        eng.warmup(concurrency=3)
        assert eng._spec_enabled is True
        snap = eng.stats_snapshot()
        assert snap["spec_on"] == 1 and snap["requests"] == 0
        assert not eng._spec_step_s and not eng._plain_step_s
        _assert_pool_adds_up(eng, PAGED["paged_pages"])
    finally:
        eng.shutdown()


def test_engine_config_is_validated(model):
    _, tc, _, tparams = model
    tok = Tokenizer.byte_fallback(tc.vocab_size)
    with pytest.raises(ValueError, match=r"\[0, 15\]"):
        Engine(tc, tparams, tok, EngineConfig(speculate_tokens=16,
                                              max_seq=MAX_SEQ), device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        Engine(tc, tparams, tok, EngineConfig(paged_pages=4, page_size=48,
                                              max_seq=MAX_SEQ), device="cpu")
    ec = EngineConfig()
    assert (ec.paged_pages, ec.page_size, ec.speculate_tokens,
            ec.spec_breakeven, ec.spec_auto_breakeven,
            ec.spec_reprobe_steps) == (0, 512, 0, 1.2, True, 8192)
    jec = JEngineConfig()
    for name in ("paged_pages", "page_size", "speculate_tokens",
                 "spec_breakeven", "spec_auto_breakeven",
                 "spec_reprobe_steps"):
        assert getattr(ec, name) == getattr(jec, name)
