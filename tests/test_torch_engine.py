"""The port's continuous-batching engine held against gabby_tpu's Engine on
the `tiny` preset: int4 weights with the group-scaled int4 unembed, an int8
KV cache (gabby_tpu's default, unpaired EngineConfig otherwise), greedy
decoding. The same weights are carried across from gabby_tpu.

The reference runs each request alone; the port serves them all at once,
so the test also checks slot isolation under concurrency. Greedy token ids
must agree exactly."""

import jax
import jax.numpy as jnp
import pytest

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import quant as jquant
from gabby_tpu.runtime.engine import Engine as JEngine
from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
from gabby_tpu.tokenizer import Tokenizer as JTokenizer
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, RequestError
from gabby_tpu_torch.tokenizer import Tokenizer
from test_torch_model import to_numpy_tree


@pytest.fixture(autouse=True)
def _bf16_form_of_decode_attention():
    """gabby_tpu's engine runs its jnp contracts on the CPU, which have no
    s8 form of decode attention, so the port's s8 switch is off here;
    tests/test_torch_pair_s8.py holds the s8 form against the JAX kernel."""
    ck.set_attn_s8(False)
    yield
    ck.set_attn_s8(None)

MAX_SEQ = 128
PROMPTS = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "sys"},
     {"role": "user", "content": "hello there"}],
    # > 64 tokens: admitted in two chunks (64-bucket, then the rest)
    [{"role": "user", "content": "a fairly long prompt " * 4}],
    [{"role": "user", "content": "xyz"}],
]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def weights():
    cfg = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(cfg, jax.random.PRNGKey(3),
                                dtype=jnp.float32)
    params = jllama.fuse_projections(jquant.quantize_tree(
        params, 4, unembed_bits=4, unembed_group=256))
    return cfg, params, tllama.params_from_numpy(to_numpy_tree(params),
                                                 device="cpu")


PAGED = dict(paged_pages=1 + 4 * (MAX_SEQ // 16), page_size=16)


def _reference_tokens(weights, **kw):
    cfg, params, _ = weights
    eng = JEngine(cfg, params, JTokenizer.byte_fallback(cfg.vocab_size),
                  JEngineConfig(batch_slots=4, max_seq=MAX_SEQ,
                                kv_quantized=True, cache_dtype="float32",
                                **kw))
    try:
        out = []
        for msgs in PROMPTS:
            req = eng.submit(msgs, max_tokens=MAX_TOKENS)
            while req.out.get()[1] is None:
                pass
            out.append(list(req.token_ids))
        return out
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def reference(weights):
    """gabby_tpu's greedy token ids for each prompt, one request at a time."""
    return _reference_tokens(weights)


@pytest.fixture(scope="module")
def paged_reference(weights):
    """The same from gabby_tpu's engine on its paged cache: with pages of
    16 rows every prefill chunk is 16 tokens, so a long prompt reads more
    of itself back through int8 codes than in the dense engine's 64-token
    chunk, and the greedy streams may part."""
    return _reference_tokens(weights, **PAGED)


@pytest.fixture()
def engine(weights):
    _, _, tparams = weights
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    eng = Engine(cfg, tparams, Tokenizer.byte_fallback(cfg.vocab_size),
                 EngineConfig(batch_slots=4, max_seq=MAX_SEQ,
                              kv_quantized=True, cache_dtype="float32",
                              steps_per_call=4),
                 device="cpu")
    yield eng
    eng.shutdown()


def _drain(req):
    parts = []
    while True:
        delta, fin = req.out.get(timeout=120)
        if delta:
            parts.append(delta)
        if fin is not None:
            return "".join(parts), fin


def test_greedy_tokens_match_reference_engine(engine, reference):
    assert len(engine.chat.prompt_ids(PROMPTS[2])) > 64  # multi-chunk
    reqs = [engine.submit(m, max_tokens=MAX_TOKENS) for m in PROMPTS]
    for req, ref_ids in zip(reqs, reference):
        text, fin = _drain(req)
        assert fin in ("stop", "length")
        assert req.token_ids == ref_ids
        assert text == engine.tokenizer.decode(ref_ids)


@pytest.mark.parametrize("mode", ["spec", "paged", "paged-spec"])
def test_spec_and_paged_engines_match_reference_engine(weights, reference,
                                                       paged_reference,
                                                       mode):
    """The int4 tree on an int8 cache through the speculative loop, the
    paged pool (pages of 16 rows), and both: all four prompts at once give
    the greedy tokens of the reference engine (plain, on the same kind of
    cache)."""
    _, _, tparams = weights
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    kw = {}
    if "spec" in mode:
        kw.update(speculate_tokens=4)
    if "paged" in mode:
        kw.update(PAGED)
        reference = paged_reference
    eng = Engine(cfg, tparams, Tokenizer.byte_fallback(cfg.vocab_size),
                 EngineConfig(batch_slots=4, max_seq=MAX_SEQ,
                              kv_quantized=True, cache_dtype="float32",
                              steps_per_call=4, **kw), device="cpu")
    try:
        reqs = [eng.submit(m, max_tokens=MAX_TOKENS) for m in PROMPTS]
        for req, ref_ids in zip(reqs, reference):
            _, fin = _drain(req)
            assert fin in ("stop", "length")
            assert req.token_ids == ref_ids
        stats = eng.stats_snapshot()
        assert (stats["spec_macro_steps"] > 0) == ("spec" in mode)
    finally:
        eng.shutdown()


def test_generate_sync_matches_reference_engine(engine, reference):
    streamed: list[str] = []
    text, fin, n_prompt, n_out = engine.generate_sync(
        PROMPTS[1], on_delta=streamed.append, max_tokens=MAX_TOKENS)
    assert fin in ("stop", "length")
    assert text == "".join(streamed) == engine.tokenizer.decode(reference[1])
    assert n_out == len(reference[1])
    assert n_prompt == len(engine.chat.prompt_ids(PROMPTS[1]))


def test_max_tokens_and_stats(engine, reference):
    req = engine.submit(PROMPTS[0], max_tokens=3)
    _, fin = _drain(req)
    assert req.token_ids == reference[0][:3]
    assert fin == "length" or len(reference[0]) < 3
    s = engine.stats_snapshot()
    assert s["requests"] == 1 and s["completion_tokens"] == 3
    assert "p50_ttft_ms" in s


def test_cancel_frees_the_slot(engine):
    req = engine.submit(PROMPTS[1], max_tokens=100)
    engine.cancel(req)
    _, fin = _drain(req)
    assert fin == "cancelled"
    # the engine keeps serving
    _, fin = _drain(engine.submit(PROMPTS[0], max_tokens=2))
    assert fin in ("stop", "length")


def test_overlong_prompt_is_refused(engine):
    with pytest.raises(RequestError, match="context window"):
        engine.submit_ids(list(range(2, 2 + MAX_SEQ)))


def test_int8_tree_warms_up_and_serves(weights):
    """The int8 configuration (fused int8 stacks, 2-D int8 unembed, int8
    KV) through the engine: warm-up covers the bucket ladder, then greedy
    tokens match gabby_tpu's forward-by-forward decode of the same tree."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    cfg = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jllama.init_params(cfg, jax.random.PRNGKey(5),
                                dtype=jnp.float32)
    params = jllama.fuse_projections(jquant.quantize_tree(params, 8))
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    assert tparams["lm_head"].bits == 8 and tparams["lm_head"].group == 0
    jeng = JEngine(cfg, params, JTokenizer.byte_fallback(cfg.vocab_size),
                   JEngineConfig(batch_slots=2, max_seq=MAX_SEQ,
                                 kv_quantized=True, cache_dtype="float32"))
    try:
        req = jeng.submit(PROMPTS[1], max_tokens=MAX_TOKENS)
        while req.out.get()[1] is None:
            pass
        want = list(req.token_ids)
    finally:
        jeng.shutdown()
    tc = tcfg.tiny(max_seq_len=MAX_SEQ)
    eng = Engine(tc, tparams, Tokenizer.byte_fallback(tc.vocab_size),
                 EngineConfig(batch_slots=2, max_seq=MAX_SEQ,
                              kv_quantized=True, cache_dtype="float32",
                              steps_per_call=4), device="cpu")
    try:
        assert eng.warmup(concurrency=2) > 0
        assert eng.stats_snapshot()["requests"] == 0  # rehearsals: internal
        req = eng.submit(PROMPTS[1], max_tokens=MAX_TOKENS)
        while req.out.get()[1] is None:
            pass
        assert list(req.token_ids) == want
    finally:
        eng.shutdown()
