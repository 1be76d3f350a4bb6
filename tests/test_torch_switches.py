"""The reference's three kernel switches in the port, held against
gabby_tpu on the CPU: GABBY_KERNELS / `set_kernels`
(gabby_tpu/ops/pallas/__init__.py:25-41), GABBY_PREFILL_PAIR
(gabby_tpu/ops/attention.py:177-181) and GABBY_ATTN_KERNEL
(gabby_tpu/ops/attention.py:35-40), read by
`gabby_tpu_torch.ops.cuda.kernels_enabled`, `prefill_pair` and
`attn_kernel`.

Routes: every kernel wrapper of the port and every Pallas entry of the
reference that a dispatch point reaches is spied on, and each setting
must send the same call at the same shapes to a kernel in both packages
or to a plain body in both. One designed divergence is held as such:
with GABBY_ATTN_KERNEL unset the port takes its decode kernel over a
bf16 cache at every max_seq, where the reference leaves max_seq < 4096 to
XLA. With the kernels off the model's steps reach no wrapper at all, so
no launch counter can move on the card.

Results: the switched-off routes (the plain bodies on the port's side,
the jnp path on the reference's) on the same inputs, made with numpy from
a seed, within 3e-2 absolute + relative, the tolerance of
tests/test_torch_nofresh.py and tests/test_pallas_kernels.py:127-130 (both
sides round operands to bf16 in other places). The plain prefill body
ignores stale or NaN cache rows at and past `offset`: the same bits as
with zeros there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops import attention as jattn
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu.ops.pallas import prefill_attention as pfa
from gabby_tpu.ops.pallas import quant_matmul as pqm
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import attention as tattn
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.kv_cache import (create_cache, pair_heads,
                                              quantize_kv)
from gabby_tpu_torch.runtime.paged import create_paged_cache

TOL = dict(rtol=3e-2, atol=3e-2)
BF, TBF = jnp.bfloat16, torch.bfloat16
ENV = ("GABBY_KERNELS", "GABBY_PREFILL_PAIR", "GABBY_ATTN_KERNEL",
       "GABBY_ATTN_S8", "GABBY_ATTN_MULTI", "GABBY_W4A8",
       "GABBY_INT4_RAWDOT", "GABBY_QMM_PREFILL", "GABBY_QMM_INT8")
PORT_WRAPPERS = {
    cattn: ("decode_attention", "decode_attention_s8",
            "decode_attention_multi", "verify_attention"),
    cpaged: ("paged_decode_attention", "paged_decode_attention_s8",
             "paged_verify_attention"),
    cpfa: ("prefill_attention",),
    cqm: ("qmatmul_int4_stacked", "qmatmul_int4_stacked_rawdot",
          "qmatmul_int4_w4a8_stacked", "qmatmul_int4_grouped",
          "qmatmul_int8_stacked", "qmatmul_int8", "qmatmul_int4"),
}
JAX_KERNELS = {
    pattn: ("decode_attention", "paged_decode_attention",
            "verify_attention", "paged_verify_attention"),
    pfa: ("prefill_attention",),
    pqm: ("qmatmul", "qmatmul_stacked", "qmatmul_stacked_w4a8",
          "qmatmul_grouped"),
}


class _Taken(Exception):
    """A reference call reached a Pallas kernel (named in args[0])."""


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    """Every switch from its default, in both packages, before and after."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield
    for fn in (pk.set_kernels, ck.set_kernels, ck.set_prefill_pair,
               ck.set_attn_kernel):
        fn(None)


@pytest.fixture()
def port_calls(monkeypatch):
    """The names of the port's kernel wrappers each call reaches (each
    still runs: on CPU tensors it takes its plain version)."""
    calls = []
    for mod, names in PORT_WRAPPERS.items():
        for name in names:
            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls.append(_name)
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.fixture()
def jax_route(monkeypatch):
    """Runs a reference call with its Pallas entries spied on: the name of
    the kernel it reaches (the call stops there), or "plain"."""
    for mod, names in JAX_KERNELS.items():
        for name in names:
            def spy(*a, _name=name, **kw):
                raise _Taken(_name)
            monkeypatch.setattr(mod, name, spy)

    def run(fn):
        try:
            fn()
        except _Taken as e:
            return e.args[0]
        return "plain"
    return run


def _route(calls: list, fn) -> str:
    """"kernel" if fn reached a port wrapper, else "plain"."""
    calls.clear()
    fn()
    return "kernel" if calls else "plain"


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _bf(r, *shape):
    """Normal values times 0.5 that bf16 holds exactly, as f32 numpy."""
    x = r.standard_normal(shape).astype(np.float32) * 0.5
    return torch.from_numpy(x).to(TBF).float().numpy()


def _j(x):
    if x is None:
        return None
    return (jnp.asarray(x.float().numpy(), BF) if x.dtype == TBF
            else jnp.asarray(x.numpy()))


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


class Case:
    """One layer stack's inputs for every attention contract: a cache
    [L, B, Nk, S, H] (int8 codes with scales, or bf16), its paired layout,
    a decode query, a verify block and a prefill chunk with their fresh
    rows, and a paged pool holding the same rows behind a table."""

    def __init__(self, seed, quant, h=16, g=2, nk=2, nl=2, b=3, s=128,
                 t=8, page=16):
        r = np.random.default_rng(seed)
        self.h, self.nk, self.nl, self.s, self.t = h, nk, nl, s, t
        k, v = _bf(r, nl, b, nk, s, h), _bf(r, nl, b, nk, s, h)
        if quant:
            (self.k, self.ks), (self.v, self.vs) = (quantize_kv(_t(k)),
                                                    quantize_kv(_t(v)))
        else:
            self.k, self.v = _t(k, TBF), _t(v, TBF)
            self.ks = self.vs = None
        self.kp, self.vp = pair_heads(self.k), pair_heads(self.v)
        self.q1 = _bf(r, b, 1, nk * g, h)
        self.fk1, self.fv1 = _bf(r, b, nk, h), _bf(r, b, nk, h)
        self.pos = np.array([5, 40, 100], np.int32)[:b]
        self.qv = _bf(r, b, t, nk * g, h)
        self.fkv, self.fvv = _bf(r, b, nk, t, h), _bf(r, b, nk, t, h)
        self.qp = _bf(r, 1, t, nk * g, h)
        self.fkp, self.fvp = _bf(r, nk, t, h), _bf(r, nk, t, h)
        self.slot, self.offset = 1, 37
        # the pool: page p + 1 of slot b holds its rows p * page ..
        mp = s // page
        self.table = (1 + np.arange(b * mp, dtype=np.int32)).reshape(b, mp)
        self.page = page

    def pool(self, x):
        """[L, B, heads, S, lanes] -> [P, L, heads, page, lanes] (page 0
        zero, unused); scales [L, B, Nk, S] the same way."""
        nl, b, heads = x.shape[:3]
        mp = self.s // self.page
        y = x.reshape(nl, b, heads, mp, self.page, *x.shape[4:])
        y = y.movedim(3, 2).reshape(nl, b * mp, heads, self.page,
                                    *x.shape[4:]).movedim(1, 0)
        return torch.cat([torch.zeros_like(y[:1]), y])

    # the port's public contracts, CPU tensors
    def port_decode(self, paired=False, layer=1, **kw):
        k, v = (self.kp, self.vp) if paired else (self.k, self.v)
        args = (_t(self.q1, TBF), k, v)
        fresh = dict(fresh_k=_t(self.fk1, TBF), fresh_v=_t(self.fv1, TBF))
        if self.ks is None:
            return tattn.cache_attention(*args, _t(self.pos), layer=layer,
                                         **fresh, **kw)
        return tattn.cache_attention_quantized(*args, self.ks, self.vs,
                                               _t(self.pos), layer=layer,
                                               **fresh, **kw)

    def port_prefill(self, paired=False, layer=1):
        k, v = (self.kp, self.vp) if paired else (self.k, self.v)
        return tattn.slot_prefill_attention(
            _t(self.qp, TBF), k, v, self.slot, self.offset, self.ks,
            self.vs, fresh_k=_t(self.fkp, TBF), fresh_v=_t(self.fvp, TBF),
            layer=layer)

    def port_verify(self):
        return tattn.verify_attention(
            _t(self.qv, TBF), self.k, self.v, _t(self.pos), self.ks,
            self.vs, layer=1, fresh_k=_t(self.fkv, TBF),
            fresh_v=_t(self.fvv, TBF), window=self.s)

    def port_paged(self, t: int):
        pools = (self.pool(self.k), self.pool(self.v), _t(self.table),
                 _t(self.pos),
                 None if self.ks is None else self.pool(self.ks),
                 None if self.vs is None else self.pool(self.vs))
        if t == 1:
            return tattn.paged_attention(
                _t(self.q1, TBF), *pools, layer=1,
                fresh_k=_t(self.fk1, TBF), fresh_v=_t(self.fv1, TBF))
        return tattn.paged_attention(
            _t(self.qv, TBF), *pools, layer=1, fresh_k=_t(self.fkv, TBF),
            fresh_v=_t(self.fvv, TBF))

    # the reference's, on the same values
    def jax_decode(self, paired=False, layer=1):
        k, v = (self.kp, self.vp) if paired else (self.k, self.v)
        args = (jnp.asarray(self.q1, BF), _j(k), _j(v))
        fresh = dict(fresh_k=jnp.asarray(self.fk1, BF),
                     fresh_v=jnp.asarray(self.fv1, BF))
        if self.ks is None:
            return jattn.cache_attention(*args, jnp.asarray(self.pos),
                                         layer=layer, **fresh)
        return jattn.cache_attention_quantized(
            *args, _j(self.ks), _j(self.vs), jnp.asarray(self.pos),
            layer=layer, **fresh)

    def jax_prefill(self, paired=False, layer=1):
        k, v = (self.kp, self.vp) if paired else (self.k, self.v)
        return jattn.slot_prefill_attention(
            jnp.asarray(self.qp, BF), _j(k), _j(v), self.slot, self.offset,
            _j(self.ks), _j(self.vs), fresh_k=jnp.asarray(self.fkp, BF),
            fresh_v=jnp.asarray(self.fvp, BF), layer=layer)

    def jax_paged(self):
        return jattn.paged_cache_attention(
            jnp.asarray(self.q1, BF), _j(self.pool(self.k)),
            _j(self.pool(self.v)), jnp.asarray(self.table),
            jnp.asarray(self.pos),
            None if self.ks is None else _j(self.pool(self.ks)),
            None if self.vs is None else _j(self.pool(self.vs)), layer=1,
            fresh_k=jnp.asarray(self.fk1, BF),
            fresh_v=jnp.asarray(self.fv1, BF))


def _set_kernels(on):
    pk.set_kernels(on)
    ck.set_kernels(on)


# ---- the getters -------------------------------------------------------


@pytest.mark.parametrize("value,on", [
    (None, True), ("0", False), ("false", False), ("off", False),
    ("1", True), ("true", True), ("on", True), ("", True)])
def test_kernels_enabled_reads_the_reference_values(monkeypatch, value, on):
    """GABBY_KERNELS: 0, false and off turn the kernels off
    (gabby_tpu/ops/pallas/__init__.py:27); unset, the card takes them;
    set_kernels forces either way and None restores the environment's."""
    if value is not None:
        monkeypatch.setenv("GABBY_KERNELS", value)
    assert ck.kernels_enabled() is on
    ck.set_kernels(not on)
    assert ck.kernels_enabled() is (not on)
    ck.set_kernels(None)
    assert ck.kernels_enabled() is on


@pytest.mark.parametrize("value,want", [
    (None, None), ("1", True), ("0", False), ("yes", False)])
def test_attn_kernel_and_prefill_pair_read_the_reference_values(
        monkeypatch, value, want):
    """GABBY_ATTN_KERNEL: "1" forces the kernel, any other set value the
    plain body, unset None (ops/attention.py:35-40); GABBY_PREFILL_PAIR
    is off only at "0" (:177-181)."""
    if value is not None:
        monkeypatch.setenv("GABBY_ATTN_KERNEL", value)
        monkeypatch.setenv("GABBY_PREFILL_PAIR", value)
    assert ck.attn_kernel() is want
    assert ck.prefill_pair() is (value != "0")
    ck.set_attn_kernel(True)
    ck.set_prefill_pair(False)
    assert ck.attn_kernel() is True and ck.prefill_pair() is False
    ck.set_attn_kernel(None)
    ck.set_prefill_pair(None)
    assert ck.attn_kernel() is want


# ---- the routes against the reference's ------------------------------


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernels_switch_routes_as_the_reference(monkeypatch, port_calls,
                                                jax_route, on, quant):
    """set_kernels(True/False) in both packages: decode (stacked, paired
    and not), prefill (paired and not) and paged decode take a kernel in
    both or a plain body in both. The bf16 decode case pins
    GABBY_ATTN_KERNEL=1, which the reference needs below max_seq 4096."""
    monkeypatch.setenv("GABBY_ATTN_KERNEL", "1")
    _set_kernels(on)
    c = Case(1, quant)
    want = "kernel" if on else "plain"
    for paired in (False, True):
        assert _route(port_calls, lambda: c.port_decode(paired)) == want
        assert (jax_route(lambda: c.jax_decode(paired)) != "plain") is on
        assert _route(port_calls, lambda: c.port_prefill(paired)) == want
        assert (jax_route(lambda: c.jax_prefill(paired)) != "plain") is on
    assert _route(port_calls, lambda: c.port_paged(1)) == want
    assert (jax_route(c.jax_paged) != "plain") is on


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_kernels_switch_routes_verify_and_products(monkeypatch, port_calls,
                                                   jax_route, on):
    """The other dispatch points: verify and paged verify (the reference
    chooses in its model, use_kernel = kernels_enabled(),
    gabby_tpu/models/llama.py:811, 960) and the quantized products at
    decode M (stacked int4 and int8, the grouped int4 unembed) and the
    int4 prefill product under GABBY_QMM_PREFILL, against the reference's
    qlinear. The reference takes its int8 kernel only under
    GABBY_QMM_INT8=1, which the port always does at decode M: set here."""
    monkeypatch.setenv("GABBY_QMM_INT8", "1")
    _set_kernels(on)
    want = "kernel" if on else "plain"
    c = Case(2, True)
    assert _route(port_calls, c.port_verify) == want
    assert _route(port_calls, lambda: c.port_paged(c.t)) == want
    r = np.random.default_rng(3)
    x8, x96 = _bf(r, 8, 128), _bf(r, 96, 128)
    w = _bf(r, 2, 128, 128)
    wg = _bf(r, 128, 256)
    for bits in (4, 8):
        tq = tquant.quantize(_t(w[1]), bits)
        jq = jquant.quantize(jnp.asarray(w[1]), bits)
        stack_t = tquant.QTensor(q=torch.stack([tq.q, tq.q]),
                                 scale=torch.stack([tq.scale, tq.scale]),
                                 bits=bits)
        stack_j = jquant.QTensor(q=jnp.stack([jq.q, jq.q]),
                                 scale=jnp.stack([jq.scale, jq.scale]),
                                 bits=bits)
        assert _route(port_calls, lambda: tquant.qlinear(
            _t(x8, TBF), stack_t, layer=1)) == want
        assert (jax_route(lambda: jquant.qlinear(
            jnp.asarray(x8, BF), stack_j, layer=1)) != "plain") is on
    tg = tquant.quantize(_t(wg), 4, group=32)
    jg = jquant.quantize(jnp.asarray(wg), 4, group=32)
    assert _route(port_calls, lambda: tquant.qlinear(_t(x8, TBF), tg)) \
        == want
    assert (jax_route(lambda: jquant.qlinear(jnp.asarray(x8, BF), jg))
            != "plain") is on
    # the int4 prefill product is opt-in in both packages
    monkeypatch.setenv("GABBY_QMM_PREFILL", "1")
    tq = tquant.quantize(_t(w[0]), 4)
    jq = jquant.quantize(jnp.asarray(w[0]), 4)
    assert _route(port_calls, lambda: tquant.qlinear(_t(x96, TBF), tq)) \
        == want
    assert (jax_route(lambda: jquant.qlinear(jnp.asarray(x96, BF), jq))
            != "plain") is on


@pytest.mark.parametrize("value", [None, "1", "0"], ids=["unset", "1", "0"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_prefill_pair_routes_as_the_reference(monkeypatch, port_calls,
                                              jax_route, value, quant):
    """GABBY_PREFILL_PAIR=0 sends prefill over a paired cache to the plain
    body and changes nothing else: the unpaired prefill and the paired
    decode keep their kernels, in both packages."""
    if value is not None:
        monkeypatch.setenv("GABBY_PREFILL_PAIR", value)
    monkeypatch.setenv("GABBY_ATTN_KERNEL", "1")
    _set_kernels(True)
    c = Case(4, quant)
    paired_kernel = value != "0"
    assert (_route(port_calls, lambda: c.port_prefill(True))
            == ("kernel" if paired_kernel else "plain"))
    assert (jax_route(lambda: c.jax_prefill(True)) != "plain") \
        is paired_kernel
    assert _route(port_calls, lambda: c.port_prefill(False)) == "kernel"
    assert jax_route(lambda: c.jax_prefill(False)) == "prefill_attention"
    assert _route(port_calls, lambda: c.port_decode(True)) == "kernel"
    assert jax_route(lambda: c.jax_decode(True)) == "decode_attention"


@pytest.mark.parametrize("value", [None, "1", "0", "yes"],
                         ids=["unset", "1", "0", "yes"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("layer", [1, None], ids=["stacked", "one-layer"])
def test_attn_kernel_routes_as_the_reference(monkeypatch, port_calls,
                                             jax_route, value, quant,
                                             layer):
    """GABBY_ATTN_KERNEL on the single-position calls of cache_attention
    and cache_attention_quantized (max_seq 128): "1" the kernel and any
    other set value the plain body, in both packages; unset, the int8
    cache takes the kernel in both, and the bf16 cache takes it in the
    port only (the designed divergence: the reference waits for max_seq
    4096). Prefill is not this switch's."""
    if value is not None:
        monkeypatch.setenv("GABBY_ATTN_KERNEL", value)
    _set_kernels(True)
    c = Case(5, quant)
    k_sel = (lambda x: x) if layer is not None else (lambda x: x[1])
    c.k, c.v = k_sel(c.k), k_sel(c.v)
    c.kp, c.vp = k_sel(c.kp), k_sel(c.vp)
    if quant:
        c.ks, c.vs = k_sel(c.ks), k_sel(c.vs)
    port = _route(port_calls, lambda: c.port_decode(layer=layer))
    ref = jax_route(lambda: c.jax_decode(layer=layer))
    if value is None and not quant:
        assert (port, ref) == ("kernel", "plain")
    else:
        assert port == ("kernel" if ref != "plain" else "plain")
        assert (ref != "plain") is (value == "1" or (value is None and quant))
    if layer is not None:
        assert _route(port_calls, c.port_prefill) == "kernel"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_steps_launch_nothing_with_the_kernels_off(port_calls, paged):
    """A tiny int4 model over a paired int8 cache: decode_step,
    prefill_slot and verify_step reach no kernel wrapper with the kernels
    off (so no launch counter can move on the card), and the wrappers
    they reach with them on; the logits agree (CPU tensors: the wrappers
    take the same plain bodies)."""
    cfg = tcfg.tiny(max_seq_len=64)
    params = tquant.quantize_tree(
        tllama.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu"),
        4, unembed_bits=4, unembed_group=32)
    got = {}
    for on in (True, False):
        ck.set_kernels(on)
        if paged:
            cache = create_paged_cache(cfg, 2, 64, 1 + 2 * 64 // 16,
                                       dtype=torch.float32, quantized=True,
                                       page_size=16, paired=True,
                                       device="cpu")
            cache.page_table.copy_(
                1 + torch.arange(8, dtype=torch.int32).reshape(2, 4))
        else:
            cache = create_cache(cfg, 2, 64, dtype=torch.float32,
                                 quantized=True, paired=True, device="cpu")
        port_calls.clear()
        tokens = torch.arange(5, 21, dtype=torch.long)
        logits_p, cache = tllama.prefill_slot(params, cfg, tokens, 16, 1, 0,
                                              cache)
        after_prefill = len(port_calls)
        logits_d, cache = tllama.decode_step(
            params, cfg, torch.tensor([3, 4]),
            torch.tensor([0, 16], dtype=torch.int32), cache)
        logits_v, cache = tllama.verify_step(
            params, cfg, torch.tensor([[3, 4, 5], [6, 7, 8]]),
            torch.tensor([1, 17], dtype=torch.int32), cache)
        got[on] = (logits_p, logits_d, logits_v)
        if on:
            assert after_prefill > 0 and len(port_calls) > after_prefill
            assert {"qmatmul_int4_stacked", "qmatmul_int4_grouped"} <= set(
                port_calls)
        else:
            assert port_calls == []
    for a, b in zip(got[True], got[False]):
        torch.testing.assert_close(a.float(), b.float(), **TOL)


# ---- the plain prefill body and stale rows ------------------------------


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("offset", [0, 37, 64])
def test_plain_prefill_ignores_nan_rows_past_offset(quant, paired, offset):
    """Cache rows at and past `offset` filled with NaN (an int8 cache's
    scales there): the plain prefill body, through the public
    slot_prefill_attention (the wrapper's plain version) and alone, is
    finite and gives the bits it gives with zeros there."""
    c = Case(6, quant)
    c.offset = offset

    def fill(x, value):
        x = x.clone()
        x[1, c.slot, :, offset:] = value
        return x

    outs = []
    for value in (0.0, float("nan")):
        d = Case(6, quant)
        d.offset = offset
        if quant:
            d.k, d.v = fill(d.k, 0), fill(d.v, 0)
            d.ks, d.vs = fill(d.ks, value), fill(d.vs, value)
        else:
            d.k, d.v = fill(d.k, value), fill(d.v, value)
        d.kp, d.vp = pair_heads(d.k), pair_heads(d.v)
        outs.append((d.port_prefill(paired), tattn.slot_prefill_reference(
            _t(d.qp, TBF), d.kp if paired else d.k,
            d.vp if paired else d.v, d.slot, offset, d.ks, d.vs,
            fresh_k=_t(d.fkp, TBF), fresh_v=_t(d.fvp, TBF), layer=1)))
    for zero, nan in zip(*outs):
        assert torch.isfinite(nan.float()).all()
        assert torch.equal(zero, nan)
    # rows past offset are ignored: the zeroed cache gives the same output
    # as the untouched one
    torch.testing.assert_close(outs[0][0], c.port_prefill(paired),
                               rtol=0, atol=0)


# ---- the switched-off routes against the reference's jnp path ----------


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernels_off_results_match_the_reference(quant):
    """With the kernels off in both packages: decode (stacked, paired and
    not), prefill (paired and not) and paged decode against the
    reference's jnp contracts on the same values, within TOL."""
    _set_kernels(False)
    c = Case(7, quant)
    for paired in (False, True):
        _close(c.port_decode(paired), c.jax_decode(paired))
        _close(c.port_prefill(paired), c.jax_prefill(paired))
    _close(c.port_paged(1), c.jax_paged())


def test_kernels_off_products_match_the_reference():
    """The quantized products with the kernels off: stacked int4 and int8
    at decode M and the grouped int4 unembed against the reference's
    qlinear on its jnp path, within TOL."""
    _set_kernels(False)
    r = np.random.default_rng(8)
    x = _bf(r, 8, 128)
    w = _bf(r, 128, 128)
    for bits in (4, 8):
        tq = tquant.quantize(_t(w), bits)
        jq = jquant.quantize(jnp.asarray(w), bits)
        stack_t = tquant.QTensor(q=torch.stack([tq.q, tq.q]),
                                 scale=torch.stack([tq.scale, tq.scale]),
                                 bits=bits)
        stack_j = jquant.QTensor(q=jnp.stack([jq.q, jq.q]),
                                 scale=jnp.stack([jq.scale, jq.scale]),
                                 bits=bits)
        _close(tquant.qlinear(_t(x, TBF), stack_t, layer=1),
               jquant.qlinear(jnp.asarray(x, BF), stack_j, layer=1))
    wg = _bf(r, 128, 256)
    _close(tquant.qlinear(_t(x, TBF), tquant.quantize(_t(wg), 4, group=32)),
           jquant.qlinear(jnp.asarray(x, BF),
                          jquant.quantize(jnp.asarray(wg), 4, group=32)))


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_forced_plain_routes_match_the_reference(monkeypatch, quant):
    """GABBY_PREFILL_PAIR=0 (paired prefill) and GABBY_ATTN_KERNEL=0
    (single-position decode) with the kernels on: the plain bodies the
    port takes against the reference's jnp path under the same
    settings, within TOL."""
    monkeypatch.setenv("GABBY_PREFILL_PAIR", "0")
    monkeypatch.setenv("GABBY_ATTN_KERNEL", "0")
    _set_kernels(True)
    c = Case(9, quant)
    _close(c.port_prefill(True), c.jax_prefill(True))
    for paired in (False, True):
        _close(c.port_decode(paired), c.jax_decode(paired))
