"""The raw-byte-dot form of the stacked int4 product (K33,
GABBY_INT4_RAWDOT=1) held against the JAX package's
`_int4_stacked_rawdot_kernel`, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. The env var is read when
`_qmatmul_int4_stacked` is traced, so its jit cache (and, for the model
steps, every cache) is cleared before and after each run with it set.

The port's side is K33's plain version, which the wrapper takes for CPU
tensors; the CUDA kernel is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. The kernel and the plain version add the same exact f32
products (bf16 x bf16-exact integers) in another order and round the
output to bf16 once, so they agree to one bf16 step of the output (2^-7
relative) plus the f32 noise of sums of O(10) terms (1e-4 absolute). The
raw-byte-dot form differs from K1's two-plane form by one bf16 rounding of
x_even - x_odd / 16, which tests/test_pallas_kernels.py bounds by 4e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.ops.pallas import quant_matmul as pqm
from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.kv_cache import create_cache as tcreate_cache
from test_torch_model import build

ONE_BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-4)
FORM_TOL = dict(rtol=4e-2, atol=4e-2)  # tests/test_pallas_kernels.py:371


@pytest.fixture(autouse=True)
def _switches():
    """JAX: jnp contracts unless a test turns its kernels on. The port:
    both int4 switches off, and the bf16/f32 form of decode attention (the
    form of the JAX attention the slice test reaches)."""
    pk.set_kernels(False)
    ck.set_w4a8(False)
    ck.set_int4_rawdot(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_w4a8(None)
    ck.set_int4_rawdot(None)
    ck.set_attn_s8(None)


@pytest.fixture()
def jax_rawdot(monkeypatch):
    """GABBY_INT4_RAWDOT=1 for the JAX package, with the traces made
    without it dropped before and after."""
    pqm._qmatmul_int4_stacked.clear_cache()
    jax.clear_caches()
    monkeypatch.setenv("GABBY_INT4_RAWDOT", "1")
    yield
    monkeypatch.delenv("GABBY_INT4_RAWDOT")
    pqm._qmatmul_int4_stacked.clear_cache()
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(seed, nl=3, k=256, n=256):
    r = np.random.default_rng(seed)
    w = r.standard_normal((nl, k, n)).astype(np.float32) * 0.3
    qs = [jquant.quantize(jnp.asarray(w[i]), 4) for i in range(nl)]
    return jquant.QTensor(q=jnp.stack([q.q for q in qs]),
                          scale=jnp.stack([q.scale for q in qs]), bits=4)


def _x(seed, m, k=256):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


@pytest.mark.parametrize("m", [1, 8])
def test_plain_matches_the_pallas_rawdot_kernel(jax_rawdot, m):
    qt, x = _stack(0), _x(7, m)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = pqm.qmatmul_stacked(xb, qt.q, qt.scale, jnp.int32(1), 4)
    out = cqm.int4_stacked_rawdot_plain(_t(xb.astype(jnp.float32)).to(
        torch.bfloat16), _t(qt.q), _t(qt.scale), 1)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **ONE_BF16_STEP)


@pytest.mark.parametrize("m", [1, 8])
def test_plain_matches_the_two_plane_form(m):
    qt, x = _stack(1), _x(8, m)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    raw = cqm.int4_stacked_rawdot_plain(xb, _t(qt.q), _t(qt.scale), 2)
    two = cqm.int4_stacked_plain(xb, _t(qt.q), _t(qt.scale), 2)
    np.testing.assert_allclose(raw.float().numpy(), two.float().numpy(),
                               **FORM_TOL)


def _qlinear_case():
    qt, x = _stack(2), _x(9, 8)
    tq = tquant.QTensor(q=_t(qt.q), scale=_t(qt.scale), bits=4)
    return tq, torch.from_numpy(x).to(torch.bfloat16)


def test_switch_routes_qlinear_to_the_rawdot_form():
    tq, x = _qlinear_case()
    ck.set_int4_rawdot(True)
    out = tquant.qlinear(x, tq, layer=1)
    assert torch.equal(out, cqm.int4_stacked_rawdot_plain(x, tq.q, tq.scale,
                                                          1))
    ck.set_int4_rawdot(False)
    two = tquant.qlinear(x, tq, layer=1)
    assert torch.equal(two, cqm.int4_stacked_plain(x, tq.q, tq.scale, 1))
    assert not torch.equal(out, two)


def test_w4a8_wins_over_the_rawdot_switch():
    tq, x = _qlinear_case()
    ck.set_int4_rawdot(True)
    ck.set_w4a8(True)
    out = tquant.qlinear(x, tq, layer=1)
    assert torch.equal(out, cqm.int4_w4a8_stacked_plain(x, tq.q, tq.scale,
                                                        1))


def test_switch_reads_the_environment(monkeypatch):
    ck.set_int4_rawdot(None)
    monkeypatch.delenv("GABBY_INT4_RAWDOT", raising=False)
    assert not ck.int4_rawdot()
    monkeypatch.setenv("GABBY_INT4_RAWDOT", "1")
    assert ck.int4_rawdot()
    monkeypatch.setenv("GABBY_INT4_RAWDOT", "0")
    assert not ck.int4_rawdot()


# The slice: a tiny int4 model (dims that clear the Pallas kernels' tile
# gates, as tests/test_torch_model.py's W4A8 case uses) with the switch on
# in both packages. JAX runs every kernel in interpret mode, whose decode
# attention rounds probabilities and cache rows to bf16 where the port's
# plain attention does not: logits came out up to 0.02 apart with the
# switch off (tests/test_torch_model.py). The tolerance is that, with
# room for the raw-byte-dot form's own rounding on each side.
SLICE_TOL = dict(rtol=2e-2, atol=5e-2)
DIMS = dict(num_heads=8, num_kv_heads=4, head_dim=64, hidden_size=256,
            intermediate_size=256)


def _slice_run(jc, tc, params, tparams, steps=3):
    """One 16-bucket prefill chunk on slot 0 and a 64-bucket one on slot
    1, then greedy decode steps, in both packages; returns the logits of
    every call, JAX then port."""
    b, max_seq = 2, 128
    jcache = jcreate_cache(jc, b, max_seq, dtype=jnp.float32, quantized=True)
    tcache = tcreate_cache(tc, b, max_seq, dtype=torch.float32,
                           quantized=True, device="cpu")
    r = np.random.default_rng(3)
    prompts = [r.integers(2, 250, 11), r.integers(2, 250, 40)]
    got, last = [], {}
    for slot, bucket in ((0, 16), (1, 64)):
        ids = np.zeros(bucket, np.int32)
        take = len(prompts[slot])
        ids[:take] = prompts[slot]
        jl, jcache = jllama.prefill_slot(
            params, jc, jnp.asarray(ids), jnp.int32(take), jnp.int32(slot),
            jnp.int32(0), jcache)
        tl, tcache = tllama.prefill_slot(tparams, tc, torch.from_numpy(ids),
                                         take, slot, 0, tcache)
        got.append((np.asarray(jl), tl.numpy()))
        last[slot] = np.asarray(jl)
    tokens = np.array([np.argmax(last[0]), np.argmax(last[1])], np.int32)
    positions = np.array([11, 40], np.int32)
    for _ in range(steps):
        jl, jcache = jllama.decode_step(params, jc, jnp.asarray(tokens),
                                        jnp.asarray(positions), jcache)
        tl, tcache = tllama.decode_step(tparams, tc,
                                        torch.from_numpy(tokens),
                                        torch.from_numpy(positions), tcache)
        got.append((np.asarray(jl), tl.numpy()))
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        positions = positions + 1
    return got


def test_slice_decode_matches_the_jax_rawdot_steps(jax_rawdot, monkeypatch):
    """prefill_slot and decode_step with the switch on in both packages:
    logits within SLICE_TOL, greedy tokens equal; and the switch reached
    both sides (each differs from its own run with the switch off)."""
    monkeypatch.setenv("GABBY_ATTN_S8", "0")  # the port's attention form
    built = build(quantized=True, seed=4, **DIMS)
    jc, tc, params, tparams = built
    assert pqm.supported(2, DIMS["hidden_size"],
                         params["blocks"]["wqkv"].q.shape[2], 4)
    pk.set_kernels(True)
    ck.set_int4_rawdot(True)
    try:
        on = _slice_run(*built)
        ck.set_int4_rawdot(False)
        monkeypatch.delenv("GABBY_INT4_RAWDOT")
        pqm._qmatmul_int4_stacked.clear_cache()
        jax.clear_caches()
        off = _slice_run(*built)
        monkeypatch.setenv("GABBY_INT4_RAWDOT", "1")
    finally:
        pk.set_kernels(False)
    for (jl, tl) in on:
        np.testing.assert_allclose(tl, jl, **SLICE_TOL)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(on, off))
    assert any(not np.array_equal(a[1], b[1]) for a, b in zip(on, off))
