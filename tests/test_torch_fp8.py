"""FP8 activations (`quant.set_act_fp8`, the server's `--act-fp8`) of the
port held against gabby_tpu on the CPU.

`fp8_activation` must equal `jax.jit(gabby_tpu.ops.quant.fp8_activation)`
bit for bit: under jit XLA turns the reference's division by 448 into a
product by float32(1/448), which the port computes (the eager division
differs in about half the elements of an f32 input). The tiny int4 model's
prefill and decode run with fp8 on in both packages, within
tests/test_torch_model.py's tolerance for that preset, and the greedy
tokens must agree. The reference's quality gates (tests/test_big_configs.py
and tests/test_ppl.py) are ported onto the port's own functions.

Every test that turns fp8 on, in either package, turns it back off in a
`finally` (the switch is process-wide)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.eval import ppl_from_tokens
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import linear as tlinear
from gabby_tpu_torch.ops import quant as tquant
from test_torch_model import _prefill_then_decode, build, to_numpy_tree


@pytest.fixture(autouse=True)
def _jnp_contracts():
    """The JAX side takes its jnp contracts (no s8 form), as in
    tests/test_torch_model.py."""
    pk.set_kernels(False)
    ck.set_attn_s8(False)
    yield
    pk.set_kernels(None)
    ck.set_attn_s8(None)


@contextlib.contextmanager
def fp8(*, reference: bool):
    """fp8 activations on in the port (and in gabby_tpu, with its jit
    caches cleared so that the switch is traced), off again afterwards."""
    tquant.set_act_fp8(True)
    if reference:
        jquant.set_act_fp8(True)
        jax.clear_caches()
    try:
        yield
    finally:
        tquant.set_act_fp8(False)
        if reference:
            jquant.set_act_fp8(False)
            jax.clear_caches()


def _rows(kind: str) -> np.ndarray:
    """[16, 512] activations of O(3), two rows of them of the given kind."""
    x = np.random.default_rng(17).standard_normal((16, 512)) * 3.0
    if kind == "zero":
        x[[0, 9]] = 0.0
    elif kind == "tiny":
        x[[0, 9]] *= 1e-6
    else:  # one 1e4 outlier in a row
        x[0, 3] = 1e4
        x[9, 100] = -1e4
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "tiny", "outlier"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_activation_is_the_jitted_reference_bit_for_bit(dtype, kind):
    jx = jnp.asarray(_rows(kind), getattr(jnp, dtype))
    want = np.asarray(jax.jit(jquant.fp8_activation)(jx).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tquant.fp8_activation(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fp8_is_off_by_default_and_maybe_is_the_identity():
    x = torch.from_numpy(_rows("tiny"))
    assert not tquant.act_fp8_enabled()
    assert tquant.maybe_fp8_activation(x) is x


def test_linear_takes_the_fp8_grid_first():
    """`linear()` passes its input through the grid before the product, for
    a dense and for a quantized weight."""
    x = torch.from_numpy(_rows("outlier")[:4])
    w = torch.randn(512, 128, generator=torch.Generator().manual_seed(1))
    qw = tquant.quantize(w, 8)
    with fp8(reference=False):
        assert tquant.act_fp8_enabled()
        got = [tlinear.linear(x, w), tlinear.linear(x, qw)]
    xq = tquant.fp8_activation(x)
    for g, want in zip(got, [tlinear.linear(xq, w), tlinear.linear(xq, qw)]):
        assert torch.equal(g, want)
    assert not torch.equal(got[0], tlinear.linear(x, w))


def test_prefill_and_decode_with_fp8_match_reference():
    """The tiny int4 tree (grouped int4 unembed): prefill chunks and 8
    greedy decode steps with fp8 on in both packages; logits within
    tests/test_torch_model.py's LOGIT_TOL, greedy tokens equal."""
    built = build(quantized=True, seed=1)
    with fp8(reference=True):
        _prefill_then_decode(*built)


def test_fp8_activations_quality_and_exactness():
    """tests/test_big_configs.py:99-110 on the port: the grid keeps shape
    and dtype, and each element within 7% of its input (e4m3 has three
    mantissa bits)."""
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
        * 3.0)
    y = tquant.fp8_activation(x)
    assert y.shape == x.shape and y.dtype == x.dtype
    rel = (y - x).abs() / (x.abs() + 1e-6)
    assert float(rel.max()) < 0.07, float(rel.max())


def test_fp8_activation_ppl_delta():
    """tests/test_ppl.py:46-60 on the port's eval/ppl.py: fp8 activations
    move the tiny model's perplexity by less than 5%."""
    jc = jcfg.tiny(max_seq_len=256)
    tc = tcfg.tiny(max_seq_len=256)
    params = jllama.init_params(jc, jax.random.PRNGKey(7), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    stream = np.random.RandomState(0).randint(
        0, jc.vocab_size, size=4096).astype(np.int32)
    kw = dict(seq_len=64, batch=4, max_windows=16)
    base = ppl_from_tokens(tparams, tc, stream, **kw)
    with fp8(reference=False):
        p_fp8 = ppl_from_tokens(tparams, tc, stream, **kw)
    assert p_fp8 != base
    assert abs(p_fp8 - base) / base < 0.05, (p_fp8, base)
