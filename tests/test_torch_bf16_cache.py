"""The attention of the port over an unquantized (bf16) KV cache held
against gabby_tpu on the CPU, at the 1B model's heads (head_dim 64, group
4) and at Llama-3.2-3B's (head_dim 128, group 3): the plain versions behind
K22-K32 against the Pallas kernels' k_scale=None form (prefill, decode,
verify, paged decode, paged verify and the slot-batched decode, paired and
unpaired), and the s8 form (K14/K15) at head_dim 128 against the Pallas s8
kernel. tests/test_torch_bf16_model.py holds the model steps and the engine
on such caches.

Inputs are made with numpy from a seed and go through both packages. The
Pallas kernels run in interpret mode, called directly as
tests/test_pallas_kernels.py calls them; the port takes its kernels' plain
versions (CPU tensors).

Tolerances: attention against the Pallas kernels 3e-2 abs + rel, the
reference's own for these kernels (tests/test_pallas_kernels.py:127-130:
both sides round their big operands to bf16 in other places); the s8 form
against the JAX s8 kernel 1e-2 (the same integer codes on both sides) as
tests/test_torch_pair_s8.py states it; paired against unpaired, and the
serving dispatch against the wrapper it takes, by equality (the plain
versions un-pair, then run the same arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu.ops.pallas import prefill_attention as ppfa
from gabby_tpu_torch.ops import attention as tattn
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

ATTN_TOL = dict(rtol=3e-2, atol=3e-2)
S8_TOL = dict(rtol=1e-2, atol=1e-2)
BF, TBF = jnp.bfloat16, torch.bfloat16
MAX_SEQ = 128
# (head_dim, group): the 1B model's heads, and Llama-3.2-3B's
HEADS = [(64, 4), (128, 3)]
HEAD_IDS = ["h64-g4", "h128-g3"]


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


def _jb(a):
    return jnp.asarray(a, BF)


def _close(out, ref, tol=ATTN_TOL):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _inputs(seed, t, h, g, b=3, nk=2, s=MAX_SEQ, nl=2):
    """q [B, T, Nq, H], fresh k/v [B, Nk, T, H], a bf16 cache
    [L, B, Nk, S, H], as numpy (f32 values that bf16 holds exactly)."""
    r = np.random.default_rng(seed)

    def bf(*shape):
        x = r.standard_normal(shape).astype(np.float32) * 0.5
        return torch.from_numpy(x).to(TBF).float().numpy()

    return (bf(b, t, nk * g, h), bf(b, nk, t, h), bf(b, nk, t, h),
            bf(nl, b, nk, s, h), bf(nl, b, nk, s, h))


def _pairs(k, v, paired):
    kt, vt = _t(k, TBF), _t(v, TBF)
    return (pair_heads(kt), pair_heads(vt)) if paired else (kt, vt)


# ---- attention: the k_scale=None form against the Pallas kernels ----------


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
def test_bf16_decode_attention(h, g, paired):
    """K24/K25's plain version against _decode_call with k_scale=None:
    an empty slot (the fresh row alone), a short and a full read."""
    q, fk, fv, kc, vc = _inputs(60 + h, 1, h, g)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([0, 37, MAX_SEQ], np.int32)
    kk, vv = _pairs(kc, vc, paired)
    ref = pattn.decode_attention(
        _jb(q), _jb(kk.float().numpy()), _jb(vv.float().numpy()),
        jnp.asarray(pos), None, None, layer=jnp.int32(1), fresh_k=_jb(fk),
        fresh_v=_jb(fv))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = cattn.decode_attention(_t(q, TBF), kk, vv, None, None, _t(pos),
                                 **kw)
    _close(out, ref)
    # the serving dispatch takes the same function
    assert torch.equal(tattn.cache_attention(_t(q, TBF), kk, vv, _t(pos),
                                             **kw), out)
    if paired:
        ku, vu = _pairs(kc, vc, False)
        assert torch.equal(out, cattn.decode_attention(
            _t(q, TBF), ku, vu, None, None, _t(pos), **kw))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
def test_bf16_verify_attention(h, g, paired):
    """K26/K27's plain version against _decode_call with tq > 1 and
    k_scale=None."""
    t = 5
    q, fk, fv, kc, vc = _inputs(70 + h, t, h, g)
    pos = np.asarray([0, 41, MAX_SEQ - t], np.int32)
    kk, vv = _pairs(kc, vc, paired)
    ref = pattn.verify_attention(
        _jb(q), _jb(kk.float().numpy()), _jb(vv.float().numpy()),
        jnp.asarray(pos), None, None, layer=jnp.int32(0), fresh_k=_jb(fk),
        fresh_v=_jb(fv))
    kw = dict(layer=0, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = tattn.verify_attention(_t(q, TBF), kk, vv, _t(pos), None, None,
                                 **kw)
    _close(out, ref)
    if paired:
        ku, vu = _pairs(kc, vc, False)
        assert torch.equal(out, cattn.verify_attention(
            _t(q, TBF), ku, vu, None, None, _t(pos), **kw))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("h,g,offset", [(64, 4, 48), (128, 3, 0),
                                        (128, 3, 80)],
                         ids=["h64-g4-past48", "h128-g3-past0",
                              "h128-g3-past80"])
def test_bf16_prefill_attention(h, g, offset, paired):
    """K22/K23's plain version against _prefill_call with k_scale=None."""
    t, slot = 16, 1
    q, fk, fv, kc, vc = _inputs(80 + offset, t, h, g, b=2)
    q, fk, fv = q[:1], fk[0], fv[0]
    kk, vv = _pairs(kc, vc, paired)
    ref = ppfa.prefill_attention(
        _jb(q), _jb(kk.float().numpy()), _jb(vv.float().numpy()),
        jnp.int32(slot), jnp.int32(offset), None, None, fresh_k=_jb(fk),
        fresh_v=_jb(fv), layer=jnp.int32(1))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = tattn.slot_prefill_attention(_t(q, TBF), kk, vv, slot, offset,
                                       **kw)
    _close(out, ref)
    if paired:
        ku, vu = _pairs(kc, vc, False)
        assert torch.equal(out, cpfa.prefill_attention(
            _t(q, TBF), ku, vu, None, None, slot, offset, **kw))


def _pool(seed, t, h, g, page=16):
    """A bf16 pool of 10 pages of 16 rows behind a scattered table; page 0,
    the scratch page, holds large values and is in no table row."""
    r = np.random.default_rng(seed)
    nk, nl = 2, 2

    def bf(*shape):
        x = r.standard_normal(shape).astype(np.float32) * 0.5
        return torch.from_numpy(x).to(TBF).float().numpy()

    kp, vp = bf(10, nl, nk, page, h), bf(10, nl, nk, page, h)
    kp[0] = vp[0] = 50.0
    table = np.asarray([[3, 5, 1, 7], [2, 8, 9, 4]], np.int32)
    return (bf(2, t, nk * g, h), bf(2, nk, t, h), bf(2, nk, t, h), kp, vp,
            table)


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("t", [1, 4], ids=["decode", "verify"])
@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
def test_bf16_paged_attention(h, g, t, paired):
    """K28-K31's plain versions against _paged_decode_call with
    k_scale=None, through a scattered table."""
    q, fk, fv, kp, vp, table = _pool(90 + h + t, t, h, g)
    pos = np.asarray([19, 60 - t], np.int32)
    kk, vv = _pairs(kp, vp, paired)
    jk, jv = _jb(kk.float().numpy()), _jb(vv.float().numpy())
    if t == 1:
        fk, fv = fk[:, :, 0], fv[:, :, 0]
        ref = pattn.paged_decode_attention(
            _jb(q), jk, jv, jnp.asarray(table), jnp.asarray(pos), None, None,
            layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    else:
        ref = pattn.paged_verify_attention(
            _jb(q), jk, jv, jnp.asarray(table), jnp.asarray(pos), None, None,
            layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    out = tattn.paged_attention(_t(q, TBF), kk, vv, _t(table), _t(pos),
                                None, None, **kw)
    _close(out, ref)
    if paired:
        ku, vu = _pairs(kp, vp, False)
        fn = (cpaged.paged_decode_attention if t == 1
              else cpaged.paged_verify_attention)
        assert torch.equal(out, fn(_t(q, TBF), ku, vu, _t(table), _t(pos),
                                   None, None, **kw))


@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
def test_bf16_slot_batched_decode_attention(monkeypatch, h, g):
    """K32's plain version against _decode_call_multi with k_scale=None
    (GABBY_ATTN_MULTI=1 on both sides), taken by the port's dispatch."""
    monkeypatch.setenv("GABBY_ATTN_MULTI", "1")
    q, fk, fv, kc, vc = _inputs(100 + h, 1, h, g, b=4)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([0, 1, 77, MAX_SEQ], np.int32)
    ref = pattn.decode_attention(
        _jb(q), _jb(kc), _jb(vc), jnp.asarray(pos), None, None,
        layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    kw = dict(layer=1, fresh_k=_t(fk, TBF), fresh_v=_t(fv, TBF))
    kk, vv = _t(kc, TBF), _t(vc, TBF)
    assert ck.attn_multi() and cattn.pick_slot_block(4) > 1
    out = tattn.cache_attention(_t(q, TBF), kk, vv, _t(pos), **kw)
    _close(out, ref)
    assert torch.equal(out, cattn.decode_attention_multi(
        _t(q, TBF), kk, vv, None, None, _t(pos), **kw))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_s8_decode_attention_at_head_dim_128(paired):
    """The s8 form's plain version (K14/K15) at head_dim 128, group 3
    against the JAX s8 kernel, through the serving dispatch."""
    r = np.random.default_rng(110)
    b, nk, g, h, s = 3, 2, 3, 128, MAX_SEQ
    q = r.standard_normal((b, 1, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((b, nk, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((b, nk, h)).astype(np.float32) * 0.5
    kc, ks = quantize_kv(_t(r.standard_normal((2, b, nk, s, h))
                            .astype(np.float32) * 0.5))
    vc, vs = quantize_kv(_t(r.standard_normal((2, b, nk, s, h))
                            .astype(np.float32) * 0.5))
    kk, vv = (pair_heads(kc), pair_heads(vc)) if paired else (kc, vc)
    pos = np.asarray([0, 50, s], np.int32)
    ref = pattn.decode_attention(
        _jb(q), jnp.asarray(kk.numpy()), jnp.asarray(vv.numpy()),
        jnp.asarray(pos), jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
        layer=jnp.int32(0), fresh_k=_jb(fk), fresh_v=_jb(fv))
    out = tattn.cache_attention_quantized(
        _t(q, TBF), kk, vv, ks, vs, _t(pos), layer=0, fresh_k=_t(fk, TBF),
        fresh_v=_t(fv, TBF))
    _close(out, ref, S8_TOL)
