"""The no-fresh-row forms of the port's decode attention (K34-K41) held
against gabby_tpu on the CPU: the port's public `cache_attention` and
`cache_attention_quantized` without fresh rows (the cache already holds the
current token, rows j <= positions[b] are read), stacked with `layer` and
unstacked, over int8 and bf16 caches, paired and unpaired, at head_dim 64
(group 4) and 128 (group 2), against the Pallas kernel's fresh_k=None form
(`pattn.decode_attention` in interpret mode, called directly as
tests/test_pallas_kernels.py calls it) and against the JAX jnp
`cache_attention`; the paged form (`paged_decode_attention_plain` with
fresh_k=None) against `pattn.paged_decode_attention(..., fresh_k=None)`;
and the dispatch: the plain bodies reach no kernel, a call without fresh
rows takes the no-fresh entry whatever the s8 and slot-batched switches
say, and the model's decode steps (always with fresh rows) take the entry
points they took before.

Inputs are made with numpy from a seed and go through both packages; the
port takes its kernels' plain versions (CPU tensors). Tolerance: 3e-2 abs
+ rel, the reference's own for these kernels
(tests/test_pallas_kernels.py:127-130: both sides round their operands to
bf16 in other places); paired against unpaired and the dispatch against
the wrapper it takes by equality (the plain versions un-pair, then run the
same arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops import attention as jattn
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import attention as tattn
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.runtime.kv_cache import (create_cache, pair_heads,
                                              quantize_kv)

TOL = dict(rtol=3e-2, atol=3e-2)
BF, TBF = jnp.bfloat16, torch.bfloat16
S = 128
# (head_dim, group): the 1B model's heads, and head_dim 128 at group 2
HEADS = [(64, 4), (128, 2)]
HEAD_IDS = ["h64-g4", "h128-g2"]


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    """The JAX jnp contracts stay jnp (the Pallas kernels are called
    directly); every route switch of the port starts from its default."""
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


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


def _bf(r, *shape):
    """Normal values times 0.5 that bf16 holds exactly, as f32 numpy."""
    x = r.standard_normal(shape).astype(np.float32) * 0.5
    return torch.from_numpy(x).to(TBF).float().numpy()


def _cache(seed, quant, h, g, b=3, nk=2, nl=2):
    """q [B, 1, Nq, H] and a stacked cache [L, B, Nk, S, H] as port tensors:
    int8 codes with f32 scales (quant) or bf16 rows and None."""
    r = np.random.default_rng(seed)
    q = _bf(r, b, 1, nk * g, h)
    k, v = _bf(r, nl, b, nk, S, h), _bf(r, nl, b, nk, S, h)
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(_t(k)), quantize_kv(_t(v))
        return q, kc, vc, ks, vs
    return q, _t(k, TBF), _t(v, TBF), None, None


def _j(x):
    if x is None:
        return None
    return jnp.asarray(x.float().numpy(), BF) if x.dtype == TBF \
        else jnp.asarray(x.numpy())


def _port(q, k, v, ks, vs, pos, **kw):
    if ks is None:
        return tattn.cache_attention(_t(q, TBF), k, v, _t(pos), **kw)
    return tattn.cache_attention_quantized(_t(q, TBF), k, v, ks, vs, _t(pos),
                                           **kw)


def _jnp_contract(q, k, v, ks, vs, pos, **kw):
    if ks is None:
        return jattn.cache_attention(jnp.asarray(q, BF), _j(k), _j(v),
                                     jnp.asarray(pos), **kw)
    return jattn.cache_attention_quantized(jnp.asarray(q, BF), _j(k), _j(v),
                                           _j(ks), _j(vs), jnp.asarray(pos),
                                           **kw)


def _cases(quant, paired, stacked, h, g, seed):
    """(q, k, v, ks, vs, unpaired k, v, layer kwargs) with the cache laid
    out paired or not, one layer of it or the whole stack."""
    q, k, v, ks, vs = _cache(seed, quant, h, g)
    ku, vu = k, v
    if paired:
        k, v = pair_heads(k), pair_heads(v)
    if stacked:
        return q, k, v, ks, vs, ku, vu, {"layer": 1}
    one = (lambda x: None if x is None else x[1].contiguous())
    return (q, one(k), one(v), one(ks), one(vs), one(ku), one(vu), {})


@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked", "unstacked"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_nofresh_decode_attention(quant, paired, stacked, h, g):
    """K34-K37's plain versions through the port's public ops against the
    Pallas kernel's fresh_k=None form and the jnp contract: position 0
    (one row), a short read and the last row of the cache."""
    q, k, v, ks, vs, ku, vu, kw = _cases(quant, paired, stacked, h, g,
                                         10 + h + 2 * paired + stacked)
    pos = np.asarray([0, 37, S - 1], np.int32)
    out = _port(q, k, v, ks, vs, pos, **kw)
    jkw = {"layer": jnp.int32(1)} if stacked else {}
    ref = pattn.decode_attention(jnp.asarray(q, BF), _j(k), _j(v),
                                 jnp.asarray(pos), _j(ks), _j(vs), **jkw)
    _close(out, ref)
    _close(out, _jnp_contract(q, k, v, ks, vs, pos, **jkw))
    # the dispatch took the no-fresh entry of the dense wrapper
    assert torch.equal(out, cattn.decode_attention(
        _t(q, TBF), k, v, ks, vs, _t(pos), **kw))
    if paired:
        assert torch.equal(out, _port(q, ku, vu, ks, vs, pos, **kw))


@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_nofresh_decode_attention_in_a_window(quant, h, g):
    """With a window of 64 rows (every slot's row within it: positions 0,
    31 and 63) the port reads rows j < min(pos + 1, 64), the reference's
    result; paired and unpaired, stacked and not."""
    for paired in (False, True):
        q, k, v, ks, vs, ku, vu, kw = _cases(quant, paired, True, h, g,
                                             40 + h + paired)
        pos = np.asarray([0, 31, 63], np.int32)
        out = _port(q, k, v, ks, vs, pos, window=64, **kw)
        ref = pattn.decode_attention(jnp.asarray(q, BF), _j(k), _j(v),
                                     jnp.asarray(pos), _j(ks), _j(vs),
                                     layer=jnp.int32(1), window=64)
        _close(out, ref)
        assert torch.equal(out, _port(q, k, v, ks, vs, pos, **kw))
        one = _port(q, k[1], v[1], None if ks is None else ks[1],
                    None if vs is None else vs[1], pos, window=64)
        assert torch.equal(out, one)


def _pool(seed, quant, h, g, b=2, nk=2, nl=2, page=32, npages=10):
    """q and a pool [P, L, Nk, page, H] behind a scattered table of 4 pages
    a slot; page 0, the scratch page, holds large values and is in no table
    row."""
    r = np.random.default_rng(seed)
    q = _bf(r, b, 1, nk * g, h)
    k, v = _bf(r, npages, nl, nk, page, h), _bf(r, npages, nl, nk, page, h)
    k[0] = v[0] = 50.0
    table = np.asarray([[3, 5, 1, 7], [2, 8, 9, 4]], np.int32)
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(_t(k)), quantize_kv(_t(v))
        return q, kc, vc, ks, vs, table
    return q, _t(k, TBF), _t(v, TBF), None, None, table


@pytest.mark.parametrize("h,g", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_nofresh_paged_decode_attention(quant, paired, h, g):
    """K38-K41's plain versions against the Pallas paged kernel's
    fresh_k=None form through a scattered table: position 0 and the last
    row of the table's 128."""
    q, kp, vp, ks, vs, table = _pool(70 + h + paired, quant, h, g)
    pos = np.asarray([0, 127], np.int32)
    kk, vv = (pair_heads(kp), pair_heads(vp)) if paired else (kp, vp)
    ref = pattn.paged_decode_attention(
        jnp.asarray(q, BF), _j(kk), _j(vv), jnp.asarray(table), jnp.asarray(pos),
        _j(ks), _j(vs), layer=jnp.int32(1), fresh_k=None, fresh_v=None)
    args = (_t(q, TBF), kk, vv, _t(table), _t(pos), ks, vs)
    out = cpaged.paged_decode_attention_plain(*args, layer=1)
    _close(out, ref)
    assert torch.equal(out, cpaged.paged_decode_attention(*args, layer=1))
    if paired:
        assert torch.equal(out, cpaged.paged_decode_attention(
            _t(q, TBF), kp, vp, _t(table), _t(pos), ks, vs, layer=1))
    # a short read too, against the dense contract on the gathered rows
    pos = np.asarray([40, 90], np.int32)
    ref = pattn.paged_decode_attention(
        jnp.asarray(q, BF), _j(kk), _j(vv), jnp.asarray(table), jnp.asarray(pos),
        _j(ks), _j(vs), layer=jnp.int32(1), fresh_k=None, fresh_v=None)
    _close(cpaged.paged_decode_attention(
        _t(q, TBF), kk, vv, _t(table), _t(pos), ks, vs, layer=1), ref)


_KERNELS = {cattn: ("decode_attention", "decode_attention_s8",
                    "decode_attention_multi", "verify_attention"),
            cpaged: ("paged_decode_attention", "paged_decode_attention_s8",
                     "paged_verify_attention")}


def _spy(monkeypatch, calls, *, refuse=False):
    """Every attention wrapper records its name and whether it was given
    fresh rows; with `refuse`, a call raises instead."""
    for mod, names in _KERNELS.items():
        for name in names:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **k):
                if refuse:
                    raise AssertionError(f"{_name} reached from a plain body")
                calls.append((_name, k.get("fresh_k") is not None))
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_plain_bodies_reach_no_kernel(monkeypatch, quant):
    """The kernels' plain versions and the contract bodies call no wrapper,
    with fresh rows and without (the dispatching ops do)."""
    q, k, v, ks, vs = _cache(5, quant, 64, 4)
    pos = _t(np.asarray([0, 9, S - 1], np.int32))
    qt = _t(q, TBF)
    r = np.random.default_rng(6)
    fk, fv = _t(_bf(r, 3, 2, 64), TBF), _t(_bf(r, 3, 2, 64), TBF)
    table = _t(np.asarray([[0], [1], [2]], np.int32))
    pool = tuple(None if x is None else x[1][:, None] for x in (k, v, ks, vs))
    _spy(monkeypatch, [], refuse=True)
    for fresh in ({}, {"fresh_k": fk, "fresh_v": fv}):
        cattn.decode_attention_plain(qt, k, v, ks, vs, pos, layer=1, **fresh)
        cattn.decode_attention_plain(qt, k[1], v[1],
                                     None if ks is None else ks[1],
                                     None if vs is None else vs[1], pos,
                                     **fresh)
        cpaged.paged_decode_attention_plain(qt, pool[0], pool[1], table,
                                            pos, pool[2], pool[3], layer=0,
                                            **fresh)
        tattn.cache_attention_reference(qt, k[1].float(), v[1].float(), pos,
                                        **fresh)
    with pytest.raises(AssertionError, match="reached from a plain body"):
        _port(q, k, v, ks, vs, pos.numpy(), layer=1)


@pytest.mark.parametrize("multi", [False, True], ids=["plain", "multi"])
@pytest.mark.parametrize("s8", [True, False], ids=["s8", "no-s8"])
def test_dispatch_without_fresh_rows(monkeypatch, s8, multi):
    """Without fresh rows every cache form takes the dense wrapper's
    no-fresh entry (the reference has no s8 or slot-batched form of it);
    with them the reference's order: slot-batched over an unpaired cache,
    then s8 over an int8 one, then the bf16/f32 form."""
    ck.set_attn_s8(s8)
    ck.set_attn_multi(multi)
    calls = []
    _spy(monkeypatch, calls)
    r = np.random.default_rng(8)
    fresh = {"fresh_k": _t(_bf(r, 4, 2, 64), TBF),
             "fresh_v": _t(_bf(r, 4, 2, 64), TBF)}
    pos = np.asarray([0, 5, 60, S - 1], np.int32)
    for quant in (True, False):
        q, k, v, ks, vs = _cache(9, quant, 64, 4, b=4)
        for paired in (False, True):
            kk, vv = (pair_heads(k), pair_heads(v)) if paired else (k, v)
            calls.clear()
            _port(q, kk, vv, ks, vs, pos, layer=0)
            _port(q, kk[0], vv[0], None if ks is None else ks[0],
                  None if vs is None else vs[0], pos)
            assert calls == [("decode_attention", False)] * 2
            calls.clear()
            _port(q, kk, vv, ks, vs, pos, layer=0, **fresh)
            want = ("decode_attention_multi" if multi and not paired
                    else "decode_attention_s8" if s8 and quant
                    else "decode_attention")
            assert calls == [(want, True)]


@pytest.mark.parametrize("multi", [False, True], ids=["plain", "multi"])
@pytest.mark.parametrize("s8", [True, False], ids=["s8", "no-s8"])
def test_model_decode_steps_take_the_same_entry_points(monkeypatch, s8,
                                                      multi):
    """`decode_step` passes fresh rows in every layer, so over a dense cache
    it takes the entry points of the serving path, as before the no-fresh
    forms: K16/K32 slot-batched over an unpaired cache with `attn_multi`,
    K14/K15 s8 over int8 with `attn_s8`, else K3/K12 or K24/K25."""
    ck.set_attn_s8(s8)
    ck.set_attn_multi(multi)
    cfg = tcfg.tiny(max_seq_len=64)
    params = tllama.init_params(cfg, dtype=torch.float32, device="cpu")
    calls = []
    _spy(monkeypatch, calls)
    tokens = torch.tensor([3, 4], dtype=torch.long)
    positions = torch.tensor([0, 7], dtype=torch.int32)
    for quant in (True, False):
        for paired in (False, True):
            cache = create_cache(cfg, 2, 64, dtype=torch.float32,
                                 quantized=quant, paired=paired,
                                 device="cpu")
            calls.clear()
            logits, _ = tllama.decode_step(params, cfg, tokens, positions,
                                           cache)
            assert torch.isfinite(logits).all()
            want = ("decode_attention_multi" if multi and not paired
                    else "decode_attention_s8" if s8 and quant
                    else "decode_attention")
            assert calls == [(want, True)] * cfg.num_layers
