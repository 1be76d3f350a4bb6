"""The engine on the paired kv-head cache (`EngineConfig.pair_kv_heads`)
held against its own unpaired runs and against gabby_tpu's engine, on the
CPU with the `tiny` preset: dense, paged and with `speculate_tokens`
(counterparts of tests/test_engine.py:949-968 and
tests/test_paged.py:506-538).

Weights come from gabby_tpu's init_params through params_from_numpy. Token
streams are compared by equality: greedy, f32 weights and cache. Pairing
moves where rows are stored, not what is computed, so the streams must not
move at all. gabby_tpu's engine runs its jnp contracts here, which have no
s8 form of decode attention; the int8 runs, where the port's s8 form is on
(its default), are compared between the port's two layouts only."""

import jax
import jax.numpy as jnp
import pytest

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.runtime.kv_cache import cache_is_paired
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree

MAX_SEQ = 128
PROMPT = "ab ab ab ab ab ab ab ab ab ab"
BASE = dict(batch_slots=2, max_seq=MAX_SEQ, steps_per_call=4,
            default_max_tokens=24, cache_dtype="float32")
MODES = {"dense": dict(),
         "paged": dict(paged_pages=1 + 2 * (MAX_SEQ // 16), page_size=16),
         "spec": dict(speculate_tokens=4),
         "paged-spec": dict(paged_pages=1 + 2 * (MAX_SEQ // 16),
                            page_size=16, speculate_tokens=4)}


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    monkeypatch.delenv("GABBY_ATTN_S8", raising=False)
    yield
    ck.set_attn_s8(None)


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.tiny(max_seq_len=MAX_SEQ), tcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    return jc, tc, params, tparams


def _stream(engine, prompt=PROMPT, max_tokens=24):
    try:
        req = engine.submit([{"role": "user", "content": prompt}],
                            max_tokens=max_tokens)
        while True:
            _, fin = req.out.get(timeout=300)
            if fin is not None:
                return list(req.token_ids), fin
    finally:
        engine.shutdown()


def _engine(model, **kw):
    _, tc, _, tparams = model
    return Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                  EngineConfig(**{**BASE, **kw}), device="cpu")


@pytest.fixture(scope="module")
def unpaired_stream(model):
    return _stream(_engine(model))


@pytest.mark.parametrize("mode", list(MODES))
def test_paired_engine_equals_the_unpaired_engine(model, unpaired_stream,
                                                  mode):
    eng = _engine(model, pair_kv_heads=True, **MODES[mode])
    assert cache_is_paired(eng._cache, model[1])
    assert _stream(eng) == unpaired_stream
    assert len(unpaired_stream[0]) > 4


@pytest.mark.parametrize("mode", ["dense", "paged", "spec"])
def test_paired_engine_equals_the_reference_engine(model, unpaired_stream,
                                                   mode):
    """The same greedy request through gabby_tpu's engine with
    pair_kv_heads=True."""
    jc, _, params, _ = model
    jeng = JEngine(jc, params, JTokenizer.byte_fallback(jc.vocab_size),
                   JEngineConfig(**BASE, pair_kv_heads=True, **MODES[mode]))
    want = _stream(jeng)[0]
    got = _stream(_engine(model, pair_kv_heads=True, **MODES[mode]))[0]
    assert got == want == unpaired_stream[0]


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-spec"])
@pytest.mark.parametrize("s8", [True, False], ids=["s8", "bf16-form"])
def test_paired_int8_engine_equals_the_unpaired_one(model, mode, s8):
    """Over the int8 cache, with the s8 form on (the default) and off: the
    paired engine's stream is the unpaired engine's."""
    ck.set_attn_s8(s8)
    kw = dict(kv_quantized=True, **MODES[mode])
    want = _stream(_engine(model, **kw))
    got = _stream(_engine(model, pair_kv_heads=True, **kw))
    assert got == want and len(got[0]) > 4


def test_pairing_refuses_an_odd_kv_head_count(model):
    """The reference's check and message (gabby_tpu/runtime/engine.py:377,
    :402), dense and paged; off by default in EngineConfig as there."""
    odd = tcfg.tiny(num_heads=3, num_kv_heads=1, max_seq_len=MAX_SEQ)
    tok = Tokenizer.byte_fallback(odd.vocab_size)
    for kw in (dict(), MODES["paged"]):
        with pytest.raises(ValueError,
                           match="pair_kv_heads needs an even kv-head count"):
            Engine(odd, {}, tok, EngineConfig(**BASE, pair_kv_heads=True,
                                              **kw), device="cpu")
    assert EngineConfig().pair_kv_heads is JEngineConfig().pair_kv_heads \
        is False
    jodd = jcfg.tiny(num_heads=3, num_kv_heads=1, max_seq_len=MAX_SEQ)
    with pytest.raises(ValueError,
                       match="pair_kv_heads needs an even kv-head count"):
        JEngine(jodd, {}, JTokenizer.byte_fallback(jodd.vocab_size),
                JEngineConfig(**BASE, pair_kv_heads=True))
