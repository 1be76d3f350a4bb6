"""The port's Llama forward held against gabby_tpu's on the `tiny` preset:
the same weights (made by gabby_tpu's init_params, quantized and fused
there, then carried across by params_from_numpy), the same tokens.

JAX runs its jnp contracts (kernels off) at highest precision; the port
runs its plain PyTorch paths in f32 on the CPU. Differences come from
summation order (f32 noise, ~1e-7), and from int8 KV codes that can
round one step apart when a value sits on a code boundary: one such code
moved a logit by ~1e-2 in this test's decode. The tolerance admits a few
such flips and stays far below the logit spread (~1); greedy tokens must
agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime.kv_cache import create_cache as tcreate_cache

LOGIT_TOL = dict(rtol=1e-2, atol=3e-2)


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """The JAX side runs its jnp contracts, which have no s8 form of decode
    attention, so the port's s8 switch is off here; the s8 form is held
    against the JAX kernel in tests/test_torch_pair_s8.py."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


def to_numpy_tree(tree):
    """A JAX params tree as nested dicts of numpy arrays, quantized leaves
    flattened to {"q", "scale", "bits", "group"} (params_from_numpy's
    input: the port never sees a JAX type)."""
    if tree is None:
        return None
    if isinstance(tree, jquant.QTensor):
        return {"q": np.array(tree.q), "scale": np.array(tree.scale),
                "bits": tree.bits, "group": tree.group}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def build(quantized, seed: int = 0, **dims):
    """quantized: False, True (int4 with the grouped int4 unembed) or 8
    (int8 with the per-channel int8 unembed, the loader's tree)."""
    jc = jcfg.tiny(max_seq_len=128, **dims)
    tc = tcfg.tiny(max_seq_len=128, **dims)
    params = jllama.init_params(jc, jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    if quantized == 8:
        params = jquant.quantize_tree(params, 8)
    elif quantized == "int4-int8-unembed":
        params = jquant.quantize_tree(params, 4)
    elif quantized:
        params = jquant.quantize_tree(params, 4, unembed_bits=4,
                                      unembed_group=256)
    params = jllama.fuse_projections(params)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def test_params_from_numpy_carries_quantized_leaves():
    _, _, params, tparams = build(quantized=True)
    wqkv = tparams["blocks"]["wqkv"]
    assert wqkv.bits == 4 and wqkv.q.dtype == torch.int8
    np.testing.assert_array_equal(wqkv.q.numpy(),
                                  np.asarray(params["blocks"]["wqkv"].q))
    assert tparams["lm_head"].group == params["lm_head"].group


def test_forward_matches():
    jc, tc, params, tparams = build(quantized=False)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12))
    ref = np.asarray(jllama.forward(params, jc, jnp.asarray(tokens,
                                                            jnp.int32)))
    out = tllama.forward(tparams, tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_on_int8_cache():
    _prefill_then_decode(*build(quantized=True, seed=1))


def test_prefill_then_decode_int8_tree():
    """The int8 configuration: fused int8 stacks and the 2-D int8 unembed
    (what the loader and tools.quantize --bits 8 produce)."""
    jc, tc, params, tparams = build(quantized=8, seed=2)
    assert tparams["blocks"]["wqkv"].bits == 8
    assert tparams["lm_head"].bits == 8 and tparams["lm_head"].q.dim() == 2
    _prefill_then_decode(jc, tc, params, tparams)


def test_prefill_then_decode_w4a8(monkeypatch):
    """The int4 tree of tools.quantize --bits 4 (int8 unembed) with W4A8
    on in both packages: the reference runs its Pallas kernels in
    interpret mode (W4A8 exists only there), on dims that clear its kernel
    gates; the port takes K8's plain version. On the same activations both
    sum the same integers (tests/test_torch_kernels_ref.py holds that to
    1e-2 and the accumulator to equality). Here the activations are not
    the same: the reference's attention kernels round probabilities and
    cache rows to bf16 (logits 0.02 apart without W4A8, measured), which
    moves activations across int8 code steps (1/127 of a row's range), so
    the two sides' activation rounding errors stop cancelling: logits came
    out up to 0.08 apart on a range of +-2.7. The tolerance is 0.15, about
    5% of that range as in the reference's own W4A8 gate, and the decode
    is teacher-forced with the reference's tokens."""
    from gabby_tpu_torch.ops import cuda as ck
    monkeypatch.setenv("GABBY_W4A8", "1")
    monkeypatch.setenv("GABBY_ATTN_S8", "0")  # the port's K3 form
    built = build(quantized="int4-int8-unembed", seed=3, num_heads=8,
                  num_kv_heads=4, head_dim=64, hidden_size=256,
                  intermediate_size=256)
    pk.set_kernels(True)
    try:
        assert pk.w4a8() and ck.w4a8()
        _prefill_then_decode(*built, steps=3, exact=False,
                             tol=dict(rtol=2e-2, atol=0.15))
    finally:
        pk.set_kernels(False)


def _prefill_then_decode(jc, tc, params, tparams, steps: int = 8,
                         exact: bool = True, tol=LOGIT_TOL):
    b, max_seq = 2, 128
    jcache = jcreate_cache(jc, b, max_seq, dtype=jnp.float32, quantized=True)
    tcache = tcreate_cache(tc, b, max_seq, dtype=torch.float32,
                           quantized=True, device="cpu")
    r = np.random.default_rng(2)
    # slot 0: one 16-bucket chunk; slot 1: a 64-bucket chunk then a 16
    # continuation (chunked prefill reads the cache at offset 64)
    prompts = [r.integers(2, 250, 11), r.integers(2, 250, 70)]
    chunks = [(0, 0, 16, 11), (1, 0, 64, 64), (1, 64, 16, 6)]
    last = {}
    for slot, offset, bucket, take in chunks:
        ids = np.zeros(bucket, np.int32)
        ids[:take] = prompts[slot][offset:offset + take]
        jl, jcache = jllama.prefill_slot(
            params, jc, jnp.asarray(ids), jnp.int32(take), jnp.int32(slot),
            jnp.int32(offset), jcache)
        tl, tcache = tllama.prefill_slot(tparams, tc, torch.from_numpy(ids),
                                         take, slot, offset, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        last[slot] = np.asarray(jl)
    tokens = np.array([np.argmax(last[0]), np.argmax(last[1])], np.int32)
    positions = np.array([11, 70], np.int32)
    for _ in range(steps):
        jl, jcache = jllama.decode_step(params, jc, jnp.asarray(tokens),
                                        jnp.asarray(positions), jcache)
        tl, tcache = tllama.decode_step(tparams, tc,
                                        torch.from_numpy(tokens),
                                        torch.from_numpy(positions), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if exact:
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        tokens, positions = nxt, positions + 1
    if not exact:
        return
    # the caches hold the same rows: codes may differ by one at a rounding
    # boundary, and the rows written after such a flip carry its ~1e-3
    # relative effect into their scales
    for name in ("k", "v"):
        diff = np.abs(getattr(tcache, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jcache, name)).astype(np.int32))
        assert diff.max() <= 1
    np.testing.assert_allclose(tcache.k_scale.numpy(),
                               np.asarray(jcache.k_scale), rtol=1e-2,
                               atol=1e-6)
