"""The plain PyTorch versions of the port's kernels (K1-K8, K10) held
against gabby_tpu's kernel-bearing ops — `qlinear` (stacked and grouped
int4, stacked and 2-D int8, int4 at prefill-sized M, W4A8),
`cache_attention_quantized`, `slot_prefill_attention` and
`paged_cache_attention` — each run
twice: with kernels off (the jnp contract) and with kernels on, which on
the CPU runs the Pallas kernels in interpret mode (as
tests/test_pallas_kernels.py does). The reference's route switches
(GABBY_QMM_INT8, GABBY_QMM_PREFILL, GABBY_W4A8) are set so that the
kernels-on run reaches the Pallas kernel each test is about. Shapes are ones the Pallas kernels
tile. The CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py). The verify kernels'
plain versions (K9, K11) are held against the Pallas verify kernels in
tests/test_torch_spec_paged.py.

Tolerance: inputs are bf16 on both sides; the Pallas kernels also round
probabilities and dequantized rows to bf16 inside, so agreement is to bf16
rounding of O(1) values (2e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops import attention as jattn
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.ops.pallas import quant_matmul as pqm
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.kv_cache import quantize_kv

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(params=[False, True], ids=["jnp", "pallas"])
def kernels(request, monkeypatch):
    # the port's K3 computes the scale-folded bf16/f32 form; the TPU
    # kernel's s8-dot form is a later port (GABBY_ATTN_S8=0 selects this
    # form there)
    monkeypatch.setenv("GABBY_ATTN_S8", "0")
    pk.set_kernels(request.param)
    yield request.param
    pk.set_kernels(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


def test_int4_stacked(kernels):
    r = np.random.default_rng(0)
    nl, k, n, m = 2, 256, 256, 8
    w = r.standard_normal((nl, k, n)).astype(np.float32) * 0.1
    qs = [jquant.quantize(jnp.asarray(w[i]), 4) for i in range(nl)]
    qt = jquant.QTensor(q=jnp.stack([q.q for q in qs]),
                        scale=jnp.stack([q.scale for q in qs]), bits=4)
    x = r.standard_normal((m, k)).astype(np.float32)
    ref = jquant.qlinear(jnp.asarray(x, jnp.bfloat16), qt, layer=1)
    out = cqm.int4_stacked_plain(_t(x).to(torch.bfloat16), _t(qt.q),
                                 _t(qt.scale), 1)
    _close(out, ref)


def test_int4_grouped(kernels):
    r = np.random.default_rng(1)
    k, n, m, group = 512, 256, 8, 256
    table = r.standard_normal((k, n)).astype(np.float32) * 0.1
    qt = jquant.quantize(jnp.asarray(table), 4, group=group)
    x = r.standard_normal((m, k)).astype(np.float32)
    ref = jquant.qlinear(jnp.asarray(x, jnp.bfloat16), qt)
    out = cqm.int4_grouped_plain(_t(x).to(torch.bfloat16), _t(qt.q),
                                 _t(qt.scale), group)
    _close(out, ref)


def _stack(w, bits):
    qs = [jquant.quantize(jnp.asarray(w[i]), bits) for i in range(len(w))]
    return jquant.QTensor(q=jnp.stack([q.q for q in qs]),
                          scale=jnp.stack([q.scale for q in qs]), bits=bits)


def test_int8_stacked(kernels, monkeypatch):
    monkeypatch.setenv("GABBY_QMM_INT8", "1")  # kernels on -> Pallas int8
    r = np.random.default_rng(4)
    nl, k, n, m = 2, 256, 256, 8
    qt = _stack(r.standard_normal((nl, k, n)).astype(np.float32) * 0.1, 8)
    x = r.standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jquant.qlinear(xb, qt, layer=1)
    if kernels:  # the dispatch above reached exactly this call
        assert pqm.supported(m, k, n, 8)
        np.testing.assert_array_equal(
            np.asarray(ref, np.float32),
            np.asarray(pqm.qmatmul_stacked(xb, qt.q, qt.scale, 1, 8),
                       np.float32))
    out = cqm.int8_stacked_plain(_t(x).to(torch.bfloat16), _t(qt.q),
                                 _t(qt.scale), 1)
    _close(out, ref)


@pytest.mark.parametrize("m", [8, 320])
def test_int8_2d(kernels, m):
    r = np.random.default_rng(5)
    k, n = 256, 384
    qt = jquant.quantize(
        jnp.asarray(r.standard_normal((k, n)).astype(np.float32) * 0.1), 8)
    x = r.standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = (pqm.qmatmul(xb, qt.q, qt.scale, 8) if kernels
           else jquant.qlinear(xb, qt))
    out = cqm.int8_plain(_t(x).to(torch.bfloat16), _t(qt.q), _t(qt.scale))
    _close(out, ref)


@pytest.mark.parametrize("m", [8, 320])
def test_int4_2d_and_prefill_sized(kernels, m):
    r = np.random.default_rng(6)
    nl, k, n = 2, 256, 256
    qt = _stack(r.standard_normal((nl, k, n)).astype(np.float32) * 0.1, 4)
    x = r.standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = (pqm.qmatmul(xb, qt.q[1], qt.scale[1], 4) if kernels
           else jquant.qlinear(xb, qt, layer=1))
    xt = _t(x).to(torch.bfloat16)
    out = cqm.int4_plain(xt, _t(qt.q), _t(qt.scale), 1)
    _close(out, ref)
    out2d = cqm.int4_plain(xt, _t(qt.q[1]), _t(qt.scale[1]))
    assert torch.equal(out, out2d)


def test_int4_prefill_switch_reaches_the_2d_kernel(kernels, monkeypatch):
    """With GABBY_QMM_PREFILL=1 the reference's qlinear takes the 2-D int4
    kernel at M > 64; the port's switch of the same name takes K7 (its
    plain version here, on the CPU)."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant as tquant
    monkeypatch.setenv("GABBY_QMM_PREFILL", "1")
    assert pk.int4_prefill_kernel() and ck.int4_prefill_kernel()
    r = np.random.default_rng(7)
    nl, k, n, m = 2, 256, 256, 96
    qt = _stack(r.standard_normal((nl, k, n)).astype(np.float32) * 0.1, 4)
    x = r.standard_normal((m, k)).astype(np.float32)
    ref = jquant.qlinear(jnp.asarray(x, jnp.bfloat16), qt, layer=0)
    tq = tquant.QTensor(q=_t(qt.q), scale=_t(qt.scale), bits=4)
    out = tquant.qlinear(_t(x).to(torch.bfloat16), tq, layer=0)
    _close(out, ref)
    ck.set_int4_prefill_kernel(False)
    try:
        assert not ck.int4_prefill_kernel()
        _close(tquant.qlinear(_t(x).to(torch.bfloat16), tq, layer=0), ref)
    finally:
        ck.set_int4_prefill_kernel(None)


def test_w4a8_stacked():
    """The Pallas W4A8 kernel in interpret mode (there is no jnp contract
    for this route), at the reference test's tolerance of 1e-2; the int32
    accumulator against exact integer arithmetic."""
    r = np.random.default_rng(8)
    nl, k, n, m = 3, 128, 256, 8
    qt = _stack(r.standard_normal((nl, k, n)).astype(np.float32) * 0.3, 4)
    x = r.standard_normal((m, k)).astype(np.float32) * 2.0
    ref = pqm.qmatmul_stacked_w4a8(jnp.asarray(x), qt.q, qt.scale,
                                   jnp.int32(1))
    out, acc = cqm.int4_w4a8_stacked_plain(_t(x), _t(qt.q), _t(qt.scale), 1,
                                           return_acc=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
    xs = np.maximum(np.abs(x).max(axis=1, keepdims=True) / 127.0, 1e-8)
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int64)
    want = xq @ np.asarray(jquant.unpack_int4(qt.q[1])).astype(np.int64)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)


def test_w4a8_switch_routes_qlinear(monkeypatch):
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant as tquant
    monkeypatch.setenv("GABBY_W4A8", "1")
    pk.set_kernels(True)
    try:
        assert pk.w4a8() and ck.w4a8()
        r = np.random.default_rng(9)
        nl, k, n, m = 2, 256, 256, 8
        qt = _stack(r.standard_normal((nl, k, n)).astype(np.float32) * 0.1,
                    4)
        x = r.standard_normal((m, k)).astype(np.float32)
        ref = jquant.qlinear(jnp.asarray(x), qt, layer=1)
        tq = tquant.QTensor(q=_t(qt.q), scale=_t(qt.scale), bits=4)
        out = tquant.qlinear(_t(x), tq, layer=1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                                   rtol=1e-2, atol=1e-2)
        # and it is a different result from the bf16-activation route
        ck.set_w4a8(False)
        plain = tquant.qlinear(_t(x), tq, layer=1)
        assert not torch.equal(out, plain)
    finally:
        ck.set_w4a8(None)
        pk.set_kernels(None)


def _int8_cache(r, nl, b, nk, s, h):
    kf = r.standard_normal((nl, b, nk, s, h)).astype(np.float32) * 0.5
    vf = r.standard_normal((nl, b, nk, s, h)).astype(np.float32) * 0.5
    kc, ks = quantize_kv(torch.from_numpy(kf))
    vc, vs = quantize_kv(torch.from_numpy(vf))
    return kc, vc, ks, vs


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("positions", [(0, 37, 64), (1, 63, 5)])
def test_decode_attention(kernels, positions):
    r = np.random.default_rng(2)
    nl, b, nk, g, h, s = 2, 3, 2, 4, 64, 64
    kc, vc, ks, vs = _int8_cache(r, nl, b, nk, s, h)
    q = r.standard_normal((b, 1, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((b, nk, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((b, nk, h)).astype(np.float32) * 0.5
    pos = np.asarray(positions, np.int32)
    bf = jnp.bfloat16
    ref = jattn.cache_attention_quantized(
        jnp.asarray(q, bf), _j(kc), _j(vc), _j(ks), _j(vs), jnp.asarray(pos),
        layer=jnp.int32(1), fresh_k=jnp.asarray(fk, bf),
        fresh_v=jnp.asarray(fv, bf))
    out = cattn.decode_attention_plain(
        _t(q).to(torch.bfloat16), kc, vc, ks, vs, _t(pos), layer=1,
        fresh_k=_t(fk).to(torch.bfloat16), fresh_v=_t(fv).to(torch.bfloat16))
    _close(out, ref)


@pytest.mark.parametrize("t,offset", [(16, 0), (16, 24), (32, 32)])
def test_prefill_attention(kernels, t, offset):
    r = np.random.default_rng(3)
    nl, b, nk, g, h, s, slot = 2, 3, 2, 4, 64, 64, 1
    kc, vc, ks, vs = _int8_cache(r, nl, b, nk, s, h)
    q = r.standard_normal((1, t, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((nk, t, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((nk, t, h)).astype(np.float32) * 0.5
    bf = jnp.bfloat16
    ref = jattn.slot_prefill_attention(
        jnp.asarray(q, bf), _j(kc), _j(vc), jnp.int32(slot),
        jnp.int32(offset), _j(ks), _j(vs), fresh_k=jnp.asarray(fk, bf),
        fresh_v=jnp.asarray(fv, bf), layer=jnp.int32(1))
    out = cpfa.prefill_attention_plain(
        _t(q).to(torch.bfloat16), kc, vc, ks, vs, slot, offset, layer=1,
        fresh_k=_t(fk).to(torch.bfloat16), fresh_v=_t(fv).to(torch.bfloat16))
    _close(out, ref)


@pytest.mark.parametrize("positions", [(19, 55), (0, 64)])
def test_paged_decode_attention(kernels, positions):
    """K10's plain version against gabby_tpu's paged_cache_attention: a
    pool of 10 pages of 16 rows behind a scattered table; page 0, the
    scratch page, holds large values and is in no table row."""
    r = np.random.default_rng(11)
    nl, nk, g, h, page = 2, 2, 4, 64, 16
    kp = r.standard_normal((10, nl, nk, page, h)).astype(np.float32) * 0.5
    vp = r.standard_normal((10, nl, nk, page, h)).astype(np.float32) * 0.5
    kp[0] = vp[0] = 50.0
    kc, ks = quantize_kv(torch.from_numpy(kp))
    vc, vs = quantize_kv(torch.from_numpy(vp))
    table = np.asarray([[3, 5, 1, 7], [2, 8, 9, 4]], np.int32)
    pos = np.asarray(positions, np.int32)
    q = r.standard_normal((2, 1, nk * g, h)).astype(np.float32) * 0.5
    fk = r.standard_normal((2, nk, h)).astype(np.float32) * 0.5
    fv = r.standard_normal((2, nk, h)).astype(np.float32) * 0.5
    bf = jnp.bfloat16
    ref = jattn.paged_cache_attention(
        jnp.asarray(q, bf), _j(kc), _j(vc), jnp.asarray(table),
        jnp.asarray(pos), _j(ks), _j(vs), layer=jnp.int32(1),
        fresh_k=jnp.asarray(fk, bf), fresh_v=jnp.asarray(fv, bf))
    out = cpaged.paged_decode_attention_plain(
        _t(q).to(torch.bfloat16), kc, vc, _t(table), _t(pos), ks, vs,
        layer=1, fresh_k=_t(fk).to(torch.bfloat16),
        fresh_v=_t(fv).to(torch.bfloat16))
    _close(out, ref)
