"""The decode layer's attention prologue (K42, csrc/decode_prologue.cu, and
its plain version `ops/cuda/decode_prologue.decode_prologue_plain`) and its
route in `models/llama.decode_step`.

On the CPU: the plain prologue equals, bit for bit, the eager ops that
`decode_step` runs from the fused q|k|v product to the attention's inputs
(the split, `apply_rope` on q and k, `quantize_kv` of the k and v rows, the
paired reshape and the four row writes at min(positions, S - 1)), paired
and unpaired, at head_dim 16, 64 and 128, over clamped positions. The
route: only a decode step over the dense int8 cache on the card, with the
tree fused at tp = 1 and a head_dim the kernel is built for, calls the
prologue's entry, once a layer; a CPU tensor, a bf16 cache, an unfused
tree, a tp = 2 fusion, head_dim 32, the kernels switched off, the paged
pool and the multi-position steps (prefill, the burst chunk, verify) keep
the eager chain. The card is stood in for by cache tensors that report
`is_cuda` (every op on them gives plain CPU tensors), so the route runs on
the CPU with the kernel's plain version, and its results equal the eager
chain's bit for bit: the fused route writes the rows before the layer's
attention, in rows the attention does not read.

Marked `cuda` (each skips without a GPU; run on the card with `python -m
pytest --noconftest tests/test_torch_decode_prologue.py -q`): the kernel
against the eager chain on the card at SmolLM2-1.7B's heads (32 = 32 of
64) and Mistral-7B's (32 over 8 of 128), paired and unpaired: q, the fresh
rows, every cache code and scale, bit for bit; an 8-step `decode_loop`
through the kernel against the same loop through the eager chain, the
active lanes' tokens and logprobs bit for bit; and a serving engine's
launches, one a layer a decode step and none in a prefill chunk.
"""

import dataclasses

import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops import quant
from gabby_tpu_torch.ops.cuda import decode_prologue as cprologue
from gabby_tpu_torch.ops.rope import apply_rope, rope_inv_freq
from gabby_tpu_torch.runtime import generate
from gabby_tpu_torch.runtime.kv_cache import create_cache
from gabby_tpu_torch.runtime.paged import create_paged_cache


def _inv_freq(h, device="cpu"):
    return torch.from_numpy(rope_inv_freq(h, 10000.0, None)).to(device)


def _random_cache(nl, b, nk, s, h, paired, g, device="cpu"):
    cfg = tcfg.tiny(num_layers=nl, num_heads=nk, num_kv_heads=nk,
                    head_dim=h)
    cache = create_cache(cfg, b, s, quantized=True, paired=paired,
                         device=device)
    for codes in (cache.k, cache.v):
        codes.copy_(torch.randint(-127, 128, codes.shape, generator=g))
    for scales in (cache.k_scale, cache.v_scale):
        scales.copy_(torch.rand(scales.shape, generator=g) * 0.02 + 0.005)
    return cache


def _eager_chain(qkv, positions, inv_freq, cache, layer, nq, nk):
    """The ops `decode_step` runs from the product to the attention's
    inputs over a dense int8 cache, and its row writes."""
    b, h = qkv.shape[0], 2 * inv_freq.shape[0]
    q, k, v = llama._split_fused(qkv, (nq * h, nk * h, nk * h), 1)
    q = apply_rope(q.reshape(b, 1, nq, h), positions[:, None], inv_freq)
    k = apply_rope(k.reshape(b, 1, nk, h), positions[:, None], inv_freq)
    fresh_k, fresh_v = k[:, 0], v.reshape(b, 1, nk, h)[:, 0]
    kr, vr, k_s, v_s = llama._quantized_rows(cache, fresh_k, fresh_v)
    write_pos = torch.clamp(positions.long(), max=cache.max_seq - 1)
    lanes = torch.arange(b, device=qkv.device)
    cache.k[layer][lanes, :, write_pos] = kr
    cache.v[layer][lanes, :, write_pos] = vr
    cache.k_scale[layer][lanes, :, write_pos] = k_s
    cache.v_scale[layer][lanes, :, write_pos] = v_s
    return q, fresh_k.contiguous(), fresh_v.contiguous()


def _copy(cache, device="cpu"):
    return dataclasses.replace(cache, **{
        f.name: (None if getattr(cache, f.name) is None
                 else getattr(cache, f.name).clone().to(device))
        for f in dataclasses.fields(cache)})


def _assert_same(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _cache_tensors(cache):
    return [cache.k, cache.v, cache.k_scale, cache.v_scale]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("h,nq,nk", [(16, 4, 2), (64, 8, 4), (128, 4, 2)])
def test_plain_prologue_is_the_eager_chain(h, nq, nk, paired, dtype):
    """Layer 1 of a 3-layer cache of 8 rows, 6 slots of a 7-slot cache at
    positions 0, 3, 6, 7 (the last row), 8 and 13 (both clamped to row 7):
    q, the fresh rows and every cache tensor equal the eager chain's."""
    g = torch.Generator().manual_seed(h + nq + int(paired))
    b, s, layer = 6, 8, 1
    qkv = (torch.randn((b, 1, (nq + 2 * nk) * h), generator=g) * 3).to(dtype)
    positions = torch.tensor([0, 3, 6, 7, 8, 13], dtype=torch.int32)
    inv_freq = _inv_freq(h)
    cache = _random_cache(3, b + 1, nk, s, h, paired, g)
    want_cache = _copy(cache)
    want = _eager_chain(qkv, positions, inv_freq, want_cache, layer, nq, nk)
    got = cprologue.decode_prologue_plain(
        qkv, positions, inv_freq, *_cache_tensors(cache), layer=layer,
        num_heads=nq, num_kv_heads=nk)
    _assert_same(got, want)
    _assert_same(_cache_tensors(cache), _cache_tensors(want_cache))
    # the wrapper takes the plain version for CPU tensors
    again = _copy(want_cache)
    before = ck.launch_counts["decode_prologue"]
    _assert_same(cprologue.decode_prologue(
        qkv, positions, inv_freq, *_cache_tensors(again), layer=layer,
        num_heads=nq, num_kv_heads=nk), want)
    assert ck.launch_counts["decode_prologue"] == before
    _assert_same(_cache_tensors(again), _cache_tensors(want_cache))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports `is_cuda`: a stand-in for a card cache in
    the route's tests. Every op on it gives plain CPU tensors, so the
    wrappers past the route see CPU tensors and take their plain
    versions."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _on_card(cache):
    return dataclasses.replace(cache, **{
        f.name: (None if getattr(cache, f.name) is None else
                 torch.Tensor._make_subclass(_OnCard, getattr(cache, f.name)))
        for f in dataclasses.fields(cache)})


@pytest.fixture()
def prologue_calls(monkeypatch):
    """Counts the calls of the prologue's entry that `decode_step` makes
    (each goes on to the real entry)."""
    calls = []
    real = cprologue.decode_prologue

    def counted(*args, **kw):
        calls.append(kw["layer"])
        return real(*args, **kw)

    monkeypatch.setattr(cprologue, "decode_prologue", counted)
    yield calls
    ck.set_kernels(None)


ROUTES = {
    # name: (card, head_dim, kv cache int8, tree, kernels on, taken)
    "card": (True, 64, True, "fused", True, True),
    "card-h128": (True, 128, True, "fused", True, True),
    "cpu": (False, 64, True, "fused", True, False),
    "card-bf16-cache": (True, 64, False, "fused", True, False),
    "card-unfused": (True, 64, True, "unfused", True, False),
    "card-fused-tp2": (True, 64, True, "fused_tp2", True, False),
    "card-h32": (True, 32, True, "fused", True, False),
    "card-kernels-off": (True, 64, True, "fused", False, False),
}


def _route_model(h, tree):
    cfg = tcfg.tiny(head_dim=h, max_seq_len=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(7),
                               dtype=torch.float32, device="cpu")
    if tree == "fused":
        params = llama.fuse_projections(params)
    elif tree == "fused_tp2":
        params = llama.fuse_projections(params, tp=2)
        cfg = dataclasses.replace(cfg, fused_tp=2)
    return cfg, params


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_route(prologue_calls, route, paired):
    """Three `decode_loop` steps over 4 slots (one parked at position 5):
    the prologue's entry is called once a layer a step exactly on the
    routes that take the kernel, never on the others, and every output and
    every cache row equals the eager chain's on a plain CPU cache."""
    card, h, int8, tree, kernels, taken = ROUTES[route]
    cfg, params = _route_model(h, tree)
    ck.set_kernels(kernels)
    b, s, steps = 4, 64, 3
    g = torch.Generator().manual_seed(11)
    if int8:
        cache = _random_cache(cfg.num_layers, b, cfg.num_kv_heads, s, h,
                              paired, g)
    else:
        cache = create_cache(cfg, b, s, dtype=torch.float32, paired=paired,
                             device="cpu")
        for x in (cache.k, cache.v):
            x.copy_(torch.randn(x.shape, generator=g) * 0.1)
    want_cache = _copy(cache)
    tokens = torch.tensor([3, 9, 17, 40], dtype=torch.int32)
    positions = torch.tensor([0, 12, 5, 62], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])

    def loop(c):
        return generate.decode_loop(
            params, cfg, tokens, positions, active, c,
            generate.SamplingState.greedy(b, "cpu"), steps)

    got = loop(_on_card(cache) if card else cache)
    assert prologue_calls == (list(range(cfg.num_layers)) * steps
                              if taken else [])
    prologue_calls.clear()
    want = loop(want_cache)  # CPU tensors: the eager chain
    assert prologue_calls == []
    _assert_same(got, want)
    for x, y in zip(_cache_tensors(cache), _cache_tensors(want_cache)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def test_other_steps_keep_the_eager_chain(prologue_calls):
    """On the stand-in card cache (dense int8, paired, the tree fused at
    tp = 1: the route that takes the kernel in `decode_step`), a prefill
    chunk, a masked burst chunk, a slot's chunk, a verify block and the
    paged pool's decode step never call the prologue's entry."""
    cfg, params = _route_model(64, "fused")
    b, s = 4, 64
    card = _on_card(create_cache(cfg, b, s, dtype=torch.float32,
                                 quantized=True, paired=True, device="cpu"))
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(2, cfg.vocab_size, (b, 16), generator=g)
    llama.prefill(params, cfg, ids, card)
    generate.prefill_batch_chunk(
        params, cfg, ids, torch.tensor([30, 20, 1, 24], dtype=torch.int32),
        torch.tensor([True, True, False, True]), card, 16)
    generate.prefill_slot(params, cfg, ids[0], 16, 2, 32, card)
    llama.verify_step(params, cfg, ids[:, :4],
                      torch.tensor([32, 20, 48, 24], dtype=torch.int32),
                      card)
    assert prologue_calls == []
    paged = create_paged_cache(cfg, b, s, 1 + b * s // 32, quantized=True,
                               page_size=32, paired=True, device="cpu")
    paged.page_table.copy_(torch.arange(b * s // 32).reshape(b, -1) + 1)
    paged = dataclasses.replace(
        paged, k=torch.Tensor._make_subclass(_OnCard, paged.k))
    logits, _ = llama.decode_step(
        params, cfg, ids[:, 0], torch.tensor([16, 16, 1, 16],
                                             dtype=torch.int32), paged)
    assert torch.isfinite(logits).all()
    assert prologue_calls == []


# on the card ---------------------------------------------------------------

# (head_dim, q heads, kv heads): SmolLM2-1.7B's and Mistral-7B-v0.3's
CARD_HEADS = {"smollm2": (64, 32, 32), "mistral7b": (128, 32, 8)}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("model", sorted(CARD_HEADS))
def test_kernel_is_the_eager_chain(dev, model, paired):
    """64 slots, layer 1 of 2 of a 512-row cache of random rows; positions
    from 0 to 511 with lanes at 0, at 511 (the last row) and at 512 and
    700 (clamped to row 511, as a lane frozen at the cap): q, the fresh
    rows, every code and every scale of the cache equal the eager chain's
    on the card bit for bit, over products of three magnitudes."""
    h, nq, nk = CARD_HEADS[model]
    b, s, layer = 64, 512, 1
    g = torch.Generator().manual_seed(5)
    positions = torch.randint(0, s, (b,), generator=g, dtype=torch.int32)
    positions[:4] = torch.tensor([0, s - 1, s, 700])
    inv_freq = _inv_freq(h, dev)
    cache = _random_cache(2, b, nk, s, h, paired, g)
    for scale in (0.01, 1.0, 40.0):
        qkv = (torch.randn((b, 1, (nq + 2 * nk) * h), generator=g)
               * scale).to(torch.bfloat16).to(dev)
        got_cache, want_cache = _copy(cache, dev), _copy(cache, dev)
        before = ck.launch_counts["decode_prologue"]
        got = cprologue.decode_prologue(
            qkv, positions.to(dev), inv_freq, *_cache_tensors(got_cache),
            layer=layer, num_heads=nq, num_kv_heads=nk)
        torch.cuda.synchronize()
        assert ck.launch_counts["decode_prologue"] == before + 1
        want = _eager_chain(qkv, positions.to(dev), inv_freq, want_cache,
                            layer, nq, nk)
        _assert_same(got, want)
        _assert_same(_cache_tensors(got_cache), _cache_tensors(want_cache))


def _card_model(model, dev, num_layers=2):
    h, nq, nk = CARD_HEADS[model]
    cfg = tcfg.tiny(num_heads=nq, num_kv_heads=nk, head_dim=h,
                    hidden_size=512, intermediate_size=1024,
                    vocab_size=4096, num_layers=num_layers,
                    max_seq_len=1024)
    params = llama.fuse_projections(quant.quantize_tree(
        llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev),
        4, unembed_bits=4, unembed_group=256))
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("model", sorted(CARD_HEADS))
def test_decode_loop_through_the_kernel(dev, monkeypatch, model, paired):
    """An 8-step greedy `decode_loop` of 8 slots over a 1024-row cache of
    random rows, int4 weights at the model's heads (2 layers of width
    512): through the kernel and through the eager chain (the route
    turned off), from the same cache, the active lanes' tokens and
    logprobs are equal bit for bit. Lanes: one parked at position 0, one
    that reaches the cap in the burst (1021: its last rows are 1023, then
    frozen), the others between. The kernel launches once a layer a
    step, the eager run never."""
    cfg, params = _card_model(model, dev)
    b, s, steps = 8, 1024, 8
    g = torch.Generator().manual_seed(9)
    base = _random_cache(cfg.num_layers, b, cfg.num_kv_heads, s,
                         cfg.head_dim, paired, g)
    tokens = torch.randint(2, cfg.vocab_size, (b,), generator=g,
                           dtype=torch.int32).to(dev)
    positions = torch.tensor([0, 1021, 17, 300, 512, 999, 64, 1],
                             dtype=torch.int32, device=dev)
    active = torch.tensor([False] + [True] * 7, device=dev)
    outs, counts = {}, {}
    for route in ("kernel", "eager"):
        if route == "eager":
            monkeypatch.setattr(llama, "_prologue_kernel",
                                lambda *a: False)
        ck.reset_launch_counts()
        outs[route] = generate.decode_loop(
            params, cfg, tokens, positions, active, _copy(base, dev),
            generate.SamplingState.greedy(b, dev), steps)
        torch.cuda.synchronize()
        counts[route] = ck.launch_counts["decode_prologue"]
    assert counts == {"kernel": cfg.num_layers * steps, "eager": 0}
    k_tok, k_act, k_lp = outs["kernel"][:3]
    e_tok, e_act, e_lp = outs["eager"][:3]
    assert torch.equal(k_act, e_act)
    assert k_act[:, 1].sum() == 3 and k_act[:, 2:].all()
    assert torch.equal(k_tok[e_act], e_tok[e_act])
    assert torch.equal(k_lp[e_act], e_lp[e_act])


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(CARD_HEADS))
def test_engine_launches_one_prologue_a_layer_a_step(dev, model):
    """A serving engine (paired int8 cache, s8, 8 slots) answers 6 requests
    of 40-300 prompt tokens: the kernel launched num_layers x the engine's
    decode steps, so none in the admissions' prefill chunks; a prefill
    chunk alone launches none."""
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    cfg, params = _card_model(model, dev, num_layers=3)
    ck.reset_launch_counts()
    eng = Engine(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size),
                 EngineConfig(batch_slots=8, max_seq=1024, kv_quantized=True,
                              pair_kv_heads=True, steps_per_call=8),
                 device=dev)
    try:
        g = torch.Generator().manual_seed(2)
        reqs = [eng.submit_ids(torch.randint(
            2, cfg.vocab_size, (n,), generator=g).tolist(), max_tokens=24)
            for n in (40, 300, 77, 130, 64, 256)]
        for req in reqs:
            while req.out.get(timeout=300)[1] is None:
                pass
        steps = eng.stats["decode_steps"]
    finally:
        eng.shutdown()
    torch.cuda.synchronize()
    assert steps > 0
    assert ck.launch_counts["decode_prologue"] == cfg.num_layers * steps
    cache = create_cache(cfg, 2, 1024, quantized=True, paired=True,
                         device=dev)
    ids = torch.randint(2, cfg.vocab_size, (64,), device=dev)
    generate.prefill_slot(params, cfg, ids, 64, 1, 0, cache)
    torch.cuda.synchronize()
    assert ck.launch_counts["decode_prologue"] == cfg.num_layers * steps
