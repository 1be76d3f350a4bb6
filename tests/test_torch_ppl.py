"""The port's perplexity harness (gabby_tpu_torch.eval.ppl) held against
gabby_tpu's on the tiny model with the same weights and token stream, and
the quantization delta gates of tests/test_ppl.py on the port.

Tolerance: both run the f32 forward (jnp contracts at highest precision,
plain PyTorch on the CPU); the mean NLL differs by summation order only,
so the perplexities agree to 1e-3 relative (quantized trees round bf16
activations at the same places in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.eval import ppl_from_tokens as jppl
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.eval import evaluate_ppl, ppl_from_tokens
from gabby_tpu_torch.eval import ppl as tppl
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

KW = dict(seq_len=64, batch=4, max_windows=16)


@pytest.fixture(autouse=True)
def _jnp_contracts():
    pk.set_kernels(False)
    yield
    pk.set_kernels(None)


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.tiny(max_seq_len=256)
    tc = tcfg.tiny(max_seq_len=256)
    params = jllama.init_params(jc, jax.random.PRNGKey(7), dtype=jnp.float32)
    stream = np.random.RandomState(0).randint(
        0, jc.vocab_size, size=4096).astype(np.int32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams, stream


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["f32", "int8", "int4"])
def test_ppl_matches_reference(setup, bits):
    jc, tc, params, tparams, stream = setup
    if bits:
        params = jquant.quantize_tree(params, bits)
        tparams = tllama.params_from_numpy(to_numpy_tree(params),
                                           device="cpu")
    ref = jppl(params, jc, stream, **KW)
    got = ppl_from_tokens(tparams, tc, stream, **KW)
    assert np.isfinite(got) and 1.0 < got < tc.vocab_size * 50
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_ppl_partial_tail_batch(setup):
    _, tc, _, tparams, stream = setup
    # 5 windows with batch 4 -> one full call + a tail call of 1
    ppl = ppl_from_tokens(tparams, tc, stream[:64 * 5], seq_len=64, batch=4)
    ref = ppl_from_tokens(tparams, tc, stream[:64 * 5], seq_len=64, batch=5)
    np.testing.assert_allclose(ppl, ref, rtol=1e-4)


def test_quantization_ppl_deltas(setup):
    """INT8 must barely move ppl; INT4 may move it more but boundedly (the
    gates of tests/test_ppl.py, on the port's own quantize_tree)."""
    _, tc, _, tparams, stream = setup
    base = ppl_from_tokens(tparams, tc, stream, **KW)
    p8 = ppl_from_tokens(tquant.quantize_tree(tparams, 8), tc, stream, **KW)
    p4 = ppl_from_tokens(tquant.quantize_tree(tparams, 4), tc, stream, **KW)
    d8, d4 = abs(p8 - base), abs(p4 - base)
    assert d8 / base < 0.02, f"int8 ppl delta {d8} vs {base}"
    assert d4 / base < 0.15, f"int4 ppl delta {d4} vs {base}"
    assert d8 <= d4 * 1.5 + 1e-3  # int8 never meaningfully worse than int4


def test_evaluate_ppl_tokenizes_without_specials(setup):
    _, tc, _, tparams, _ = setup
    tok = Tokenizer.byte_fallback(tc.vocab_size)
    text = "the quick brown fox <|eot_id|> jumps over the lazy dog. " * 12
    ids = np.asarray(tok.encode(text, allow_special=False), np.int64)
    got = evaluate_ppl(tparams, tc, text, tok, seq_len=32, batch=2)
    assert got == ppl_from_tokens(tparams, tc, ids, seq_len=32, batch=2)


def test_window_nll_counts_every_position_but_the_first(setup):
    _, tc, _, tparams, stream = setup
    tokens = torch.from_numpy(stream[:96].astype(np.int64)).reshape(3, 32)
    total, count = tppl._window_nll(tparams, tc, tokens)
    assert count == 3 * 31 and float(total) > 0
