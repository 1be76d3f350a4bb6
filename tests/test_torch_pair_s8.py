"""The paired kv-head cache layout, s8 decode attention and slot-batched
decode of the port held against gabby_tpu, on the CPU: the plain versions
behind K12-K21, the storage transforms, `decode_step` / `prefill_slot` /
`verify_step` on paired dense and paged caches, a paired cache carried
across mid-sequence, and the s8 NLL gate on the tiny model.

Inputs are made with numpy from a seed and go through both packages. The
Pallas kernels run in interpret mode, called directly as
tests/test_pallas_kernels.py calls them; the port takes its kernels' plain
versions (CPU tensors). GABBY_ATTN_CHUNK is read when the JAX kernel is
traced, so the small-chunk cases use shapes no other test uses.

Tolerances: bf16-form attention 3e-2 (the Pallas kernels round their big
operands to bf16: tests/test_pallas_kernels.py:322); the s8 form against the
JAX s8 kernel 1e-2 abs + rel (the same integer codes on both sides; what is
left is f32 summation order and bf16 output rounding) and against the
dequantized contract 6e-2 (tests/test_pallas_kernels.py:665-686); paired
against unpaired in the port by equality (the plain versions un-pair and
then run the same arithmetic); model steps against JAX as
tests/test_torch_spec_paged.py states them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu.ops.pallas import prefill_attention as ppfa
from gabby_tpu.runtime import kv_cache as jkv
from gabby_tpu.runtime import paged as jpaged
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.eval import ppl as tppl
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import attention as tattn
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.runtime import paged as tpaged
from gabby_tpu_torch.runtime.kv_cache import (cache_is_paired, create_cache,
                                              pair_heads, quantize_kv,
                                              unpair_heads)
from test_torch_model import to_numpy_tree
from test_torch_spec_paged import (_assert_caches_close, _new_caches,
                                   _np_cache)

ATTN_TOL = dict(rtol=3e-2, atol=3e-2)
S8_TOL = dict(rtol=1e-2, atol=1e-2)
S8_CONTRACT_TOL = dict(rtol=6e-2, atol=6e-2)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
INT8_TOL = dict(rtol=1e-2, atol=3e-2)
BF, TBF = jnp.bfloat16, torch.bfloat16
MAX_SEQ = 128


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    """Model-level JAX calls take the jnp contracts (the attention tests
    call the Pallas kernels directly); every switch starts from its
    default."""
    for name in ("GABBY_ATTN_S8", "GABBY_ATTN_MULTI", "GABBY_ATTN_CHUNK"):
        monkeypatch.delenv(name, raising=False)
    pk.set_kernels(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)
    ck.set_attn_multi(None)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _j(t):
    return jnp.asarray(t.numpy())


def _jb(a):
    return jnp.asarray(a, BF)


# ---- the storage transforms and the switches ------------------------------


@pytest.mark.parametrize("t", [1, 5])
def test_pair_heads_matches_reference_and_round_trips(t):
    x = np.random.default_rng(t).integers(-127, 128, (2, 3, 4, t, 8)
                                          ).astype(np.int8)
    ours = pair_heads(_t(x))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jkv.pair_heads(jnp.asarray(x))))
    assert ours.shape == (2, 3, 2, t, 16)
    # head 2p fills lanes [0, H), head 2p + 1 lanes [H, 2H)
    assert torch.equal(ours[..., 1, :, :8], _t(x)[..., 2, :, :])
    assert torch.equal(ours[..., 1, :, 8:], _t(x)[..., 3, :, :])
    assert torch.equal(unpair_heads(ours), _t(x))
    np.testing.assert_array_equal(
        unpair_heads(ours).numpy(),
        np.asarray(jkv.unpair_heads(jnp.asarray(ours.numpy()))))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paired_cache_has_the_reference_shapes(paged, quantized):
    jc, tc = jcfg.tiny(), tcfg.tiny()
    if paged:
        ours = tpaged.create_paged_cache(tc, 2, 64, 5, dtype=torch.float32,
                                         quantized=quantized, page_size=16,
                                         paired=True, device="cpu")
        ref = jpaged.create_paged_cache(jc, 2, 64, 5, dtype=jnp.float32,
                                        quantized=quantized, page_size=16,
                                        paired=True)
    else:
        ours = create_cache(tc, 2, 64, dtype=torch.float32,
                            quantized=quantized, paired=True, device="cpu")
        ref = jkv.create_cache(jc, 2, 64, dtype=jnp.float32,
                               quantized=quantized, paired=True)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None and b is None) or tuple(a.shape) == b.shape
    assert cache_is_paired(ours, tc) and jkv.cache_is_paired(ref, jc)
    assert ours.k.shape[-1] == 2 * tc.head_dim
    assert ours.max_seq == 64
    odd = tcfg.tiny(num_heads=3, num_kv_heads=3)
    with pytest.raises(ValueError, match="even kv-head count"):
        create_cache(odd, 1, 16, paired=True, device="cpu")
    with pytest.raises(ValueError, match="even kv-head count"):
        tpaged.create_paged_cache(odd, 1, 32, 3, page_size=16, paired=True,
                                  device="cpu")


def test_switches_have_the_reference_defaults(monkeypatch):
    assert ck.attn_s8() is True and pattn.s8_attention() is True
    assert ck.attn_multi() is False
    assert ck.attn_chunk() == pattn.attn_chunk() == 1024
    monkeypatch.setenv("GABBY_ATTN_S8", "0")
    monkeypatch.setenv("GABBY_ATTN_MULTI", "1")
    monkeypatch.setenv("GABBY_ATTN_CHUNK", "64")
    assert ck.attn_s8() is False and pattn.s8_attention() is False
    assert ck.attn_multi() is True and ck.attn_chunk() == 64
    ck.set_attn_s8(True)
    ck.set_attn_multi(False)
    assert ck.attn_s8() is True and ck.attn_multi() is False
    ck.set_attn_s8(None)
    assert ck.attn_s8() is False
    assert [cattn.pick_slot_block(b) for b in (1, 2, 3, 4, 6, 8)] == [
        1, 2, 1, 4, 2, 8]


# ---- attention: the bf16/f32 form on the paired layout --------------------


def _dense_inputs(seed, t, b=3, nk=4, g=2, s=96, nl=2, h=64):
    """q [B, T, Nq, H], fresh k/v [B, Nk, T, H], an int8 cache
    [L, B, Nk, S, H] with its scales, as numpy / torch."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((b, nk, t, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((b, nk, t, h)).astype(np.float32) * 0.5
    kc, ks = quantize_kv(_t(r.standard_normal((nl, b, nk, s, h))
                            .astype(np.float32) * 0.5))
    vc, vs = quantize_kv(_t(r.standard_normal((nl, b, nk, s, h))
                            .astype(np.float32) * 0.5))
    return q, fk, fv, kc, vc, ks, vs


def test_paired_decode_attention_bf16_form(monkeypatch):
    """K12's plain version against the JAX paired kernel with bf16 dots,
    and equal to the unpaired plain version (K3's) in f32."""
    monkeypatch.setenv("GABBY_ATTN_S8", "0")
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(1, 1)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([0, 32, 95], np.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    ref = pattn.decode_attention(
        _jb(q), _j(kp), _j(vp), jnp.asarray(pos), _j(ks), _j(vs),
        layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = cattn.decode_attention(_t(q, TBF), kp, vp, ks, vs, _t(pos), **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    kw32 = dict(layer=1, fresh_k=_t(fk), fresh_v=_t(fv))
    assert torch.equal(
        cattn.decode_attention(_t(q), kp, vp, ks, vs, _t(pos), **kw32),
        cattn.decode_attention(_t(q), kc, vc, ks, vs, _t(pos), **kw32))
    # the contract itself takes the paired layout, with and without scales
    assert torch.equal(
        tattn.cache_attention_quantized(_t(q), kp[1], vp[1], ks[1], vs[1],
                                        _t(pos), **{**kw32, "layer": None}),
        tattn.cache_attention_quantized(_t(q), kc[1], vc[1], ks[1], vs[1],
                                        _t(pos), **{**kw32, "layer": None}))
    assert torch.equal(
        tattn.cache_attention(_t(q), kp[1].float(), vp[1].float(), _t(pos),
                              fresh_k=_t(fk), fresh_v=_t(fv)),
        tattn.cache_attention(_t(q), kc[1].float(), vc[1].float(), _t(pos),
                              fresh_k=_t(fk), fresh_v=_t(fv)))


@pytest.mark.parametrize("t", [3, 8])
def test_paired_verify_attention(t):
    """K13's plain version against the JAX paired verify kernel, and equal
    to the unpaired plain version in f32."""
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(10 + t, t)
    pos = np.asarray([0, 37, 96 - t], np.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    ref = pattn.verify_attention(
        _jb(q), _j(kp), _j(vp), jnp.asarray(pos), _j(ks), _j(vs),
        layer=jnp.int32(0), fresh_k=_jb(fk), fresh_v=_jb(fv))
    out = tattn.verify_attention(_t(q, TBF), kp, vp, _t(pos), ks, vs,
                                 layer=0, fresh_k=_t(fk, TBF),
                                 fresh_v=_t(fv, TBF))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    kw32 = dict(layer=0, fresh_k=_t(fk), fresh_v=_t(fv))
    assert torch.equal(
        cattn.verify_attention(_t(q), kp, vp, ks, vs, _t(pos), **kw32),
        cattn.verify_attention(_t(q), kc, vc, ks, vs, _t(pos), **kw32))


@pytest.mark.parametrize("offset", [0, 48])
def test_paired_prefill_attention(offset):
    """K21's plain version against the JAX paired prefill kernel, and equal
    to the unpaired plain version (K4's) in f32."""
    t, slot = 16, 1
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(20 + offset, t, b=2)
    q, fk, fv = q[:1], fk[0], fv[0]
    kp, vp = pair_heads(kc), pair_heads(vc)
    ref = ppfa.prefill_attention(
        _jb(q), _j(kp), _j(vp), jnp.int32(slot), jnp.int32(offset), _j(ks),
        _j(vs), fresh_k=_jb(fk), fresh_v=_jb(fv), layer=jnp.int32(1))
    out = tattn.slot_prefill_attention(
        _t(q, TBF), kp, vp, slot, offset, ks, vs, fresh_k=_t(fk, TBF),
        fresh_v=_t(fv, TBF), layer=1)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    kw32 = dict(layer=1, fresh_k=_t(fk), fresh_v=_t(fv))
    assert torch.equal(
        cpfa.prefill_attention(_t(q), kp, vp, ks, vs, slot, offset, **kw32),
        cpfa.prefill_attention(_t(q), kc, vc, ks, vs, slot, offset, **kw32))


def _pool_inputs(seed, t, nk=4, g=2, page=16, h=64):
    """A pool of 10 pages of 16 rows behind a scattered table; page 0, the
    scratch page, holds large codes and scales and is in no table row."""
    nl = 2
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, t, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((2, nk, t, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((2, nk, t, h)).astype(np.float32) * 0.5
    kp = r.standard_normal((10, nl, nk, page, h)).astype(np.float32) * 0.5
    vp = r.standard_normal((10, nl, nk, page, h)).astype(np.float32) * 0.5
    kp[0] = vp[0] = 50.0
    kc, ks = quantize_kv(_t(kp))
    vc, vs = quantize_kv(_t(vp))
    table = np.asarray([[3, 5, 1, 7], [2, 8, 9, 4]], np.int32)
    return q, fk, fv, kc, vc, ks, vs, table


def test_paired_paged_decode_attention_bf16_form(monkeypatch):
    """K17's plain version against the JAX paired paged kernel with bf16
    dots, and equal to the unpaired plain version (K10's) in f32."""
    monkeypatch.setenv("GABBY_ATTN_S8", "0")
    q, fk, fv, kc, vc, ks, vs, table = _pool_inputs(31, 1)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([19, 55], np.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    ref = pattn.paged_decode_attention(
        _jb(q), _j(kp), _j(vp), jnp.asarray(table), jnp.asarray(pos), _j(ks),
        _j(vs), layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    out = cpaged.paged_decode_attention(
        _t(q, TBF), kp, vp, _t(table), _t(pos), ks, vs, layer=1,
        fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    kw32 = dict(layer=1, fresh_k=_t(fk), fresh_v=_t(fv))
    assert torch.equal(
        cpaged.paged_decode_attention(_t(q), kp, vp, _t(table), _t(pos), ks,
                                      vs, **kw32),
        cpaged.paged_decode_attention(_t(q), kc, vc, _t(table), _t(pos), ks,
                                      vs, **kw32))


@pytest.mark.parametrize("t", [3, 8])
def test_paired_paged_verify_attention(t):
    """K18's plain version against the JAX paired paged verify kernel, and
    equal to the unpaired plain version (K11's) in f32."""
    q, fk, fv, kc, vc, ks, vs, table = _pool_inputs(40 + t, t)
    pos = np.asarray([19, 55], np.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    ref = pattn.paged_verify_attention(
        _jb(q), _j(kp), _j(vp), jnp.asarray(table), jnp.asarray(pos), _j(ks),
        _j(vs), layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    out = tattn.paged_attention(
        _t(q, TBF), kp, vp, _t(table), _t(pos), ks, vs, layer=1,
        fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    kw32 = dict(layer=1, fresh_k=_t(fk), fresh_v=_t(fv))
    assert torch.equal(
        cpaged.paged_verify_attention(_t(q), kp, vp, _t(table), _t(pos), ks,
                                      vs, **kw32),
        cpaged.paged_verify_attention(_t(q), kc, vc, _t(table), _t(pos), ks,
                                      vs, **kw32))


# ---- attention: the s8 form ------------------------------------------------


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("chunk", [None, 64], ids=["one-chunk", "chunk-64"])
def test_s8_decode_attention(monkeypatch, paired, chunk):
    """K14/K15's plain version against the JAX s8 kernel and against the
    dequantized contract: positions 0 (the fresh row alone), inside a
    chunk, on a chunk boundary, and several chunks in."""
    if chunk is None:
        s, b, g, pos = 96, 3, 2, [0, 32, 95]
    else:
        monkeypatch.setenv("GABBY_ATTN_CHUNK", "64")
        s, b, g, pos = 320, 4, 3, [0, 63, 64, 257]
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(50 + s, 1, b=b, g=g, s=s)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray(pos, np.int32)
    kk, vv = (pair_heads(kc), pair_heads(vc)) if paired else (kc, vc)
    ref = pattn.decode_attention(
        _jb(q), _j(kk), _j(vv), jnp.asarray(pos), _j(ks), _j(vs),
        layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    args = (_t(q, TBF), kk, vv, ks, vs, _t(pos))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = cattn.decode_attention_s8(*args, **kw)
    assert out.shape == q.shape and out.dtype == TBF
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **S8_TOL)
    contract = cattn.decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(out.float().numpy(), contract.float().numpy(),
                               **S8_CONTRACT_TOL)
    # the s8 form is a different function, not the contract again
    assert not torch.equal(out, contract)
    # the dispatch takes it by default and drops it with the switch
    assert torch.equal(out, tattn.cache_attention_quantized(*args, **kw))
    ck.set_attn_s8(False)
    assert torch.equal(contract,
                       tattn.cache_attention_quantized(*args, **kw))
    if paired:
        ck.set_attn_s8(True)
        assert torch.equal(out, tattn.cache_attention_quantized(
            _t(q, TBF), kc, vc, ks, vs, _t(pos), **kw))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_s8_paged_decode_attention(paired):
    """K19/K20's plain version (one quantization chunk per page) against
    the JAX paged s8 kernel and the dequantized contract: positions 0,
    inside a page, on a page boundary, several pages in; stale table
    entries point at the scratch page."""
    q, fk, fv, kc, vc, ks, vs, _ = _pool_inputs(61, 1)
    q, fk, fv = (np.concatenate([x, x[::-1]]) for x in (q, fk, fv))
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    table = np.asarray([[3, 0, 0, 0], [5, 1, 0, 0], [2, 8, 0, 0],
                        [6, 9, 4, 7]], np.int32)
    pos = np.asarray([0, 21, 32, 55], np.int32)
    kk, vv = (pair_heads(kc), pair_heads(vc)) if paired else (kc, vc)
    ref = pattn.paged_decode_attention(
        _jb(q), _j(kk), _j(vv), jnp.asarray(table), jnp.asarray(pos), _j(ks),
        _j(vs), layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    args = (_t(q, TBF), kk, vv, _t(table), _t(pos), ks, vs)
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = cpaged.paged_decode_attention_s8(*args, **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **S8_TOL)
    contract = cpaged.paged_decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(out.float().numpy(), contract.float().numpy(),
                               **S8_CONTRACT_TOL)
    assert torch.equal(out, tattn.paged_attention(*args, **kw))
    ck.set_attn_s8(False)
    assert torch.equal(contract, tattn.paged_attention(*args, **kw))
    if paired:
        ck.set_attn_s8(True)
        assert torch.equal(out, tattn.paged_attention(
            _t(q, TBF), kc, vc, _t(table), _t(pos), ks, vs, **kw))


def test_verify_and_prefill_never_take_the_s8_form():
    """With the switch on, T > 1 and prefill still compute the bf16/f32
    contract, dense and paged."""
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(70, 3)
    pos = _t(np.asarray([5, 37, 90], np.int32))
    kw = dict(layer=1, fresh_k=_t(fk), fresh_v=_t(fv))
    assert ck.attn_s8()
    assert torch.equal(
        tattn.verify_attention(_t(q), kc, vc, pos, ks, vs, **kw),
        cattn.verify_attention_plain(_t(q), kc, vc, ks, vs, pos, **kw))
    pq, pfk, pfv, pkc, pvc, pks, pvs, table = _pool_inputs(71, 3)
    ppos = _t(np.asarray([19, 55], np.int32))
    pkw = dict(layer=0, fresh_k=_t(pfk), fresh_v=_t(pfv))
    assert torch.equal(
        tattn.paged_attention(_t(pq), pkc, pvc, _t(table), ppos, pks, pvs,
                              **pkw),
        cpaged.paged_verify_attention_plain(_t(pq), pkc, pvc, _t(table),
                                            ppos, pks, pvs, **pkw))
    assert torch.equal(
        tattn.slot_prefill_attention(_t(q[:1]), kc, vc, 1, 16, ks, vs,
                                     fresh_k=_t(fk[0]), fresh_v=_t(fv[0]),
                                     layer=1),
        cpfa.prefill_attention_plain(_t(q[:1]), kc, vc, ks, vs, 1, 16,
                                     layer=1, fresh_k=_t(fk[0]),
                                     fresh_v=_t(fv[0])))


# ---- attention: the slot-batched launch -----------------------------------


@pytest.mark.parametrize("s8", ["0", None], ids=["s8-off", "s8-default"])
def test_slot_batched_decode_attention(monkeypatch, s8):
    """K16's plain version against the JAX slot-batched kernel
    (GABBY_ATTN_MULTI=1, bf16 dots, B = 4 so that its slot block is 4),
    and the dispatch: on the unpaired cache the switch is taken before the
    s8 switch is looked at, as in the reference, so both sides run the
    bf16/f32 form with GABBY_ATTN_S8 at its default too; the paired cache
    and a slot count no block divides are not moved by it."""
    monkeypatch.setenv("GABBY_ATTN_MULTI", "1")
    if s8 is not None:
        monkeypatch.setenv("GABBY_ATTN_S8", s8)
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(80, 1, b=4, s=128)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([0, 3, 77, 127], np.int32)
    assert pattn._pick_slot_block(4, 4, 64, 1) == 4
    assert ck.attn_multi() and ck.attn_s8() == (s8 is None)
    assert pattn.s8_attention() == (s8 is None)
    ref = pattn.decode_attention(
        _jb(q), _j(kc), _j(vc), jnp.asarray(pos), _j(ks), _j(vs),
        layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    args = (_t(q, TBF), kc, vc, ks, vs, _t(pos))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = cattn.decode_attention_multi(*args, **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_TOL)
    assert torch.equal(out, cattn.decode_attention(*args, **kw))
    # through the dispatch: the bf16/f32 form, not the s8 one
    assert torch.equal(out, tattn.cache_attention_quantized(*args, **kw))
    s8_out = cattn.decode_attention_s8(*args, **kw)
    assert not torch.equal(out, s8_out)
    calls = []
    monkeypatch.setattr(
        cattn, "decode_attention_multi",
        lambda *a, **k: calls.append("multi") or out)
    tattn.cache_attention_quantized(*args, **kw)
    assert calls == ["multi"]
    paired = tattn.cache_attention_quantized(
        _t(q, TBF), pair_heads(kc), pair_heads(vc), ks, vs, _t(pos), **kw)
    assert torch.equal(paired, s8_out if s8 is None else out)
    tattn.cache_attention_quantized(  # 3 slots: no slot block divides them
        _t(q[:3], TBF), kc[:, :3].contiguous(), vc[:, :3].contiguous(),
        ks[:, :3].contiguous(), vs[:, :3].contiguous(), _t(pos[:3]), layer=1,
        fresh_k=_t(fk[:3], TBF), fresh_v=_t(fv[:3], TBF))
    assert calls == ["multi"]


# ---- model steps on paired caches -----------------------------------------


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.tiny(max_seq_len=MAX_SEQ), tcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def _drive(tparams, tc, cache):
    """A 40-token prompt in two chunks (32, then 16 at offset 32), three
    decode steps, then a verify block of three, on the port. Returns
    (kind, inputs, logits) of every step, for the JAX side to replay."""
    ids = np.arange(2, 42)
    outs = []
    for offset, bucket in ((0, 32), (32, 16)):
        take = min(bucket, len(ids) - offset)
        chunk = np.zeros((bucket,), np.int32)
        chunk[:take] = ids[offset:offset + take]
        lg, _ = tllama.prefill_slot(tparams, tc, _t(chunk), take, 1, offset,
                                    cache)
        outs.append(("prefill", (chunk, take, offset), lg))
    tok = np.asarray([0, int(outs[-1][2].argmax())], np.int32)
    pos = np.asarray([MAX_SEQ - 1, len(ids)], np.int32)
    read = np.asarray([1, len(ids)], np.int32)
    for _ in range(3):
        lg, _ = tllama.decode_step(tparams, tc, _t(tok), _t(pos), cache,
                                   attn_positions=_t(read))
        outs.append(("decode", (tok, pos, read), lg))
        tok = np.asarray([0, int(lg[1].argmax())], np.int32)
        pos = pos + np.asarray([0, 1], np.int32)
        read = read + np.asarray([0, 1], np.int32)
    vb = np.asarray([[0, 0, 0], [int(tok[1]), 7, 9]], np.int32)
    lg, _ = tllama.verify_step(tparams, tc, _t(vb), _t(pos), cache,
                               attn_positions=_t(read))
    outs.append(("verify", (vb, pos, read), lg))
    return outs


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_steps_on_a_paired_cache(model, paged, quantized):
    """prefill_slot, decode_step and verify_step on a paired cache: against
    gabby_tpu's functions on its paired cache (the jnp contracts, which
    have no s8 form: the port's switch is off for this comparison), and
    equal to the port's unpaired results, with the s8 form off and on."""
    jc, tc, params, tparams = model
    ck.set_attn_s8(False)
    jcache, pcache = _new_caches(jc, paged, quantized, paired=True)
    _, ucache = _new_caches(jc, paged, quantized, paired=False)
    assert cache_is_paired(pcache, tc) and not cache_is_paired(ucache, tc)
    tol = INT8_TOL if quantized else JAX_TOL
    got = _drive(tparams, tc, pcache)
    plain = _drive(tparams, tc, ucache)
    for (kind, args, lg), (_, _, want) in zip(got, plain):
        assert torch.equal(lg, want), kind
        if kind == "prefill":
            chunk, take, offset = args
            jl, jcache = jllama.prefill_slot(
                params, jc, jnp.asarray(chunk), jnp.int32(take), jnp.int32(1),
                jnp.int32(offset), jcache)
        elif kind == "decode":
            tok, pos, read = args
            jl, jcache = jllama.decode_step(
                params, jc, jnp.asarray(tok), jnp.asarray(pos), jcache,
                attn_positions=jnp.asarray(read))
            assert int(lg[1].argmax()) == int(np.argmax(np.asarray(jl)[1]))
        else:
            vb, pos, read = args
            jl, jcache = jllama.verify_step(
                params, jc, jnp.asarray(vb), jnp.asarray(pos), jcache,
                attn_positions=jnp.asarray(read))
        live = (slice(None) if kind == "prefill" else 1)
        np.testing.assert_allclose(lg[live].numpy(), np.asarray(jl)[live],
                                   **tol)
    _assert_caches_close(pcache, jcache, tol)
    # the paired cache holds the unpaired one's rows re-laid
    if paged:
        assert torch.equal(unpair_heads(pcache.k), ucache.k)
    else:
        assert torch.equal(unpair_heads(pcache.v), ucache.v)
    if quantized:
        assert torch.equal(pcache.k_scale, ucache.k_scale)
        ck.set_attn_s8(True)
        _, p2 = _new_caches(jc, paged, True, paired=True)
        _, u2 = _new_caches(jc, paged, True, paired=False)
        s8 = _drive(tparams, tc, p2)
        for (kind, _, lg), (_, _, want), (_, _, off) in zip(
                s8, _drive(tparams, tc, u2), got):
            assert torch.equal(lg, want), kind
            if kind == "decode":  # only decode has the s8 form
                assert not torch.equal(lg, off)
                np.testing.assert_allclose(lg.numpy(), off.numpy(),
                                           **S8_CONTRACT_TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_paired_cache_carried_across_mid_sequence(model, paged, quantized):
    """A paired cache filled by gabby_tpu's prefill_slot crosses as numpy
    arrays, unchanged, and the port's decode_step continues from it."""
    jc, tc, params, tparams = model
    ck.set_attn_s8(False)
    jcache, _ = _new_caches(jc, paged, quantized, paired=True)
    ids = np.arange(3, 35).astype(np.int32)  # 32 tokens: two pages
    jl, jcache = jllama.prefill_slot(params, jc, jnp.asarray(ids),
                                     jnp.int32(32), jnp.int32(0),
                                     jnp.int32(0), jcache)
    tcache = _np_cache(jcache)
    assert cache_is_paired(tcache, tc)
    assert tuple(tcache.k.shape) == jcache.k.shape
    tok = np.asarray([int(jnp.argmax(jl)), 0], np.int32)
    pos = np.asarray([32, MAX_SEQ - 1], np.int32)
    read = np.asarray([32, 1], np.int32)
    tol = INT8_TOL if quantized else JAX_TOL
    for _ in range(4):
        jl, jcache = jllama.decode_step(params, jc, jnp.asarray(tok),
                                        jnp.asarray(pos), jcache,
                                        attn_positions=jnp.asarray(read))
        tl, _ = tllama.decode_step(tparams, tc, _t(tok), _t(pos), tcache,
                                   attn_positions=_t(read))
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], **tol)
        assert int(tl[0].argmax()) == int(np.argmax(np.asarray(jl)[0]))
        tok = np.asarray([int(tl[0].argmax()), 0], np.int32)
        pos = pos + np.asarray([1, 0], np.int32)
        read = read + np.asarray([1, 0], np.int32)
    _assert_caches_close(tcache, jcache, tol)


# ---- the s8 NLL gate -------------------------------------------------------


def test_s8_attention_decode_nll_delta():
    """The gate of tests/test_ppl.py:144-186 on the port: teacher-forced
    decode NLL of the tiny model (int4 weights, int8 cache) with s8 decode
    attention stays within 5% of the bf16/f32 form's, and the paired cache
    gives the same value as the unpaired one."""
    kw = dict(num_heads=8, num_kv_heads=4, head_dim=64, hidden_size=256,
              intermediate_size=256, vocab_size=256, max_seq_len=128)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    params = jllama.init_params(jc, jax.random.PRNGKey(7), dtype=jnp.float32)
    tparams = tquant.quantize_tree(tllama.params_from_numpy(
        to_numpy_tree(params), dtype=torch.bfloat16, device="cpu"), 4)
    stream = np.random.RandomState(0).randint(0, 256, size=96)
    ck.set_attn_s8(False)
    base = tppl.decode_nll(tparams, tc, stream)
    ck.set_attn_s8(True)
    s8 = tppl.decode_nll(tparams, tc, stream)
    assert np.isfinite(base) and np.isfinite(s8) and s8 != base
    assert abs(s8 - base) / max(base, 1e-6) < 0.05, (base, s8)
    assert tppl.decode_nll(tparams, tc, stream, paired=True) == s8
