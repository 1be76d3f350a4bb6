"""Tensor-parallel model steps of the port held against gabby_tpu on a 1 x 2
mesh: two ranks, each a process of its own joined over gloo through a
FileStore in tmp_path, each holding its shard of the same weights
(parallel.shard_params of the tree fused with tp = 2), run prefill_slot,
two decode_steps and a verify_step (fed tokens, not sampled), then a
burst admission's lane-masked prefill_batch_chunk (lane 0 re-admitted in
two chunks, at offsets 0 and 32, while lane 1 stays live) and one more
decode_step over both lanes, on a dense and on a paged int8 cache, for
int8 and int4 weights, at tiny widths (8 q heads over 4 kv heads of 8
dims). gabby_tpu runs the same calls on
the same tree, fused with tp = 2 and placed on the mesh by its own
shard_params (GSPMD inserts its collectives).

Tolerance: the f32 logits within rtol 1e-2 / atol 3e-2 of the reference,
the bound of tests/test_torch_model.py for an int8 cache (an int8 code
that rounds one step apart moves a logit by about 1e-2); both ranks'
logits bit for bit equal (the all-reduces hand every rank the same sum);
each rank's cache rows within one int8 code of the reference cache's
heads for that rank (the paged pools but the scratch page 0, where the
reference routes a masked-out lane's writes). The ranks import this module without JAX: the JAX
side is imported inside the parent's functions only."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.parallel import (bind_group, collectives,
                                      init_distributed, local_config,
                                      local_group, shard_params)
from gabby_tpu_torch.parallel.mesh import spawn_ranks
from gabby_tpu_torch.runtime import generate as tgen
from gabby_tpu_torch.runtime.kv_cache import create_cache
from gabby_tpu_torch.runtime.paged import create_paged_cache

TP = 2
DIMS = dict(num_heads=8, num_kv_heads=4, head_dim=8, hidden_size=32,
            intermediate_size=64, vocab_size=256)
MAX_SEQ, PAGE, BATCH = 64, 16, 2
LOGIT_TOL = dict(rtol=1e-2, atol=3e-2)
PROMPTS = ([(7 * j + 3) % 250 + 2 for j in range(20)],
           [(11 * j + 5) % 250 + 2 for j in range(12)])
FED = ([17, 90], [41, 133])          # the two decode steps' tokens
BLOCK = [[5, 77, 201], [64, 9, 150]]  # the verify step's block
# the burst: lane 0 re-admitted with a 50-token prompt in two chunks of 32
# while lane 1 stays live; then one decode step over both lanes
BURST_IDS = [(13 * j + 7) % 250 + 2 for j in range(50)]
BURST_MASK = np.array([True, False])
AFTER = [99, 23]
CASES = [(paged, bits) for paged in (False, True) for bits in (8, 4)]


def _table() -> np.ndarray:
    """Slot b's logical pages on a scattered run of the pool (page 0 is
    the scratch page)."""
    mp = MAX_SEQ // PAGE
    return 1 + np.random.default_rng(7).permutation(BATCH * mp).reshape(
        BATCH, mp).astype(np.int32)


def _steps(prefill, decode, verify, batch) -> list:
    """The scenario, the same on both sides: each slot's prompt through
    prefill_slot, two decode steps, one verify step, the burst's two
    lane-masked chunks, one decode step. Returns every call's logits as
    numpy (of a burst chunk, the masked lane's row only: the other rows
    are not defined)."""
    out = []
    for slot, (ids, bucket) in enumerate(zip(PROMPTS, (32, 16))):
        chunk = np.zeros((bucket,), np.int64)
        chunk[:len(ids)] = ids
        out.append(prefill(chunk, len(ids), slot))
    pos = np.asarray([len(p) for p in PROMPTS], np.int64)
    for fed in FED:
        out.append(decode(np.asarray(fed, np.int64), pos))
        pos = pos + 1
    out.append(verify(np.asarray(BLOCK, np.int64), pos))
    pos = pos + len(BLOCK[0])
    lengths = np.asarray([len(BURST_IDS), 1], np.int64)
    for offset in (0, 32):
        chunk = np.zeros((BATCH, 32), np.int64)
        take = BURST_IDS[offset:offset + 32]
        chunk[0, :len(take)] = take
        out.append(batch(chunk, lengths, offset)[BURST_MASK])
    pos[0] = len(BURST_IDS)
    out.append(decode(np.asarray(AFTER, np.int64), pos))
    return out


# ---- the port: one rank a process ----------------------------------------


def _port_steps(params, cfg, cache) -> tuple:
    def t(a):
        return torch.from_numpy(a)

    def prefill(chunk, n, slot):
        logits, _ = tllama.prefill_slot(params, cfg, t(chunk), n, slot, 0,
                                        cache)
        return logits.numpy()

    def decode(tokens, pos):
        return tllama.decode_step(params, cfg, t(tokens), t(pos),
                                  cache)[0].numpy()

    def verify(block, pos):
        return tllama.verify_step(params, cfg, t(block), t(pos),
                                  cache)[0].numpy()

    def batch(chunk, lengths, offset):
        return tgen.prefill_batch_chunk(params, cfg, t(chunk), t(lengths),
                                        t(BURST_MASK), cache,
                                        offset)[0].numpy()

    return _steps(prefill, decode, verify, batch), cache


def _new_cache(cfg, paged: bool):
    if not paged:
        return create_cache(cfg, BATCH, MAX_SEQ, dtype=torch.float32,
                            quantized=True, device="cpu")
    cache = create_paged_cache(cfg, BATCH, MAX_SEQ,
                               1 + BATCH * MAX_SEQ // PAGE,
                               dtype=torch.float32, quantized=True,
                               page_size=PAGE, device="cpu")
    cache.page_table.copy_(torch.from_numpy(_table()))
    return cache


def _cache_numpy(cache) -> dict:
    return {k: None if v is None else v.numpy()
            for k, v in dataclasses.asdict(cache).items()}


def _rank_main(rank: int, nprocs: int, store_path: str,
               trees_path: str) -> dict:
    """Rank `rank`: join the group, shard each case's tree, run the
    scenario; returns each case's logits, cache and all-reduce count."""
    import torch.distributed as dist
    from gabby_tpu_torch.ops import cuda as ck

    ck.set_attn_s8(False)  # the JAX side runs its jnp contracts
    group = init_distributed(None, nprocs, rank,
                             store=dist.FileStore(store_path, nprocs),
                             device="cpu", timeout=60)
    with open(trees_path, "rb") as f:
        trees = pickle.load(f)
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ, **DIMS)  # the rank's: local_config
    out = {}
    try:
        for (paged, bits), tree in trees.items():
            full = tllama.params_from_numpy(tree, device="cpu")
            local = bind_group(shard_params(full, rank, nprocs, fused_tp=TP),
                               group)
            collectives.reset_counts()
            logits, cache = _port_steps(local, cfg, _new_cache(
                local_config(cfg, nprocs), paged))
            out[(paged, bits)] = dict(
                logits=logits, cache=_cache_numpy(cache),
                all_reduces=collectives.counts["all_reduce"])
    finally:
        group.close()
    return out


# ---- gabby_tpu on a 1 x 2 mesh ---------------------------------------------


def _jax_tree(bits: int):
    """The JAX tree fused with tp = 2, and the same tree as numpy."""
    import jax
    import jax.numpy as jnp
    from gabby_tpu import config as jcfg
    from gabby_tpu.models import llama as jllama
    from gabby_tpu.ops import quant as jquant

    from test_torch_model import to_numpy_tree

    jc = dataclasses.replace(jcfg.tiny(max_seq_len=MAX_SEQ, **DIMS),
                             fused_tp=TP)
    params = jllama.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32)
    params = (jquant.quantize_tree(params, 8) if bits == 8 else
              jquant.quantize_tree(params, 4, unembed_bits=4,
                                   unembed_group=256))
    params = jllama.fuse_projections(params, tp=TP)
    return jc, params, to_numpy_tree(params)


def _jax_steps(jc, params, paged: bool) -> tuple:
    import jax
    import jax.numpy as jnp
    from gabby_tpu.models import llama as jllama
    from gabby_tpu.ops import pallas as pk
    from gabby_tpu.parallel import (cache_shardings, make_mesh,
                                    paged_cache_shardings)
    from gabby_tpu.parallel import shard_params as jshard_params
    from gabby_tpu.runtime import generate as jgen
    from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache
    from gabby_tpu.runtime.paged import create_paged_cache as jcreate_paged

    mesh = make_mesh(dp=1, tp=TP, devices=jax.devices()[:TP])
    sharded = jshard_params(params, mesh, fused_tp=TP)
    if paged:
        cache = jcreate_paged(jc, BATCH, MAX_SEQ, 1 + BATCH * MAX_SEQ // PAGE,
                              dtype=jnp.float32, quantized=True,
                              page_size=PAGE)
        cache = dataclasses.replace(cache, page_table=jnp.asarray(_table()))
        shardings = paged_cache_shardings(mesh, quantized=True)
    else:
        cache = jcreate_cache(jc, BATCH, MAX_SEQ, dtype=jnp.float32,
                              quantized=True)
        shardings = cache_shardings(mesh, quantized=True)
    state = {"cache": jax.device_put(cache, shardings)}

    def prefill(chunk, n, slot):
        logits, state["cache"] = jllama.prefill_slot(
            sharded, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(n),
            jnp.int32(slot), jnp.int32(0), state["cache"])
        return np.asarray(logits)

    def decode(tokens, pos):
        logits, state["cache"] = jllama.decode_step(
            sharded, jc, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(pos, jnp.int32), state["cache"])
        return np.asarray(logits)

    def verify(block, pos):
        logits, state["cache"] = jllama.verify_step(
            sharded, jc, jnp.asarray(block, jnp.int32),
            jnp.asarray(pos, jnp.int32), state["cache"])
        return np.asarray(logits)

    def batch(chunk, lengths, offset):
        logits, state["cache"] = jgen.prefill_batch_chunk(
            sharded, jc, jnp.asarray(chunk, jnp.int32),
            jnp.asarray(lengths, jnp.int32), jnp.asarray(BURST_MASK),
            state["cache"], offset)
        return np.asarray(logits)

    pk.set_kernels(False)
    try:
        return _steps(prefill, decode, verify, batch), state["cache"]
    finally:
        pk.set_kernels(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks over every case in one spawn (a process start is the
    dearest part), and the JAX trees they were given."""
    d = tmp_path_factory.mktemp("tp")
    jax_side, trees = {}, {}
    for paged, bits in CASES:
        jc, params, tree = _jax_tree(bits)
        jax_side[(paged, bits)] = (jc, params)
        trees[(paged, bits)] = tree
    with open(d / "trees.pkl", "wb") as f:
        pickle.dump(trees, f)
    ranks = spawn_ranks(_rank_main, TP, (str(d / "store"),
                                         str(d / "trees.pkl")), timeout=120)
    return jax_side, trees, ranks


@pytest.mark.parametrize("paged,bits", CASES,
                         ids=[f"{'paged' if p else 'dense'}-int{b}"
                              for p, b in CASES])
def test_tp2_steps_match_reference_on_a_1x2_mesh(runs, paged, bits):
    jax_side, _, ranks = runs
    jc, params = jax_side[(paged, bits)]
    want, jcache = _jax_steps(jc, params, paged)
    got = [r[(paged, bits)] for r in ranks]
    for a, b in zip(got[0]["logits"], got[1]["logits"]):
        np.testing.assert_array_equal(a, b)  # every rank the same sum
    for g, w in zip(got[0]["logits"], want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
    # 2 x L + 2 all-reduces a step: prefill x2, decode x2, verify, the
    # burst's chunks x2, decode
    assert got[0]["all_reduces"] == 8 * (2 * jc.num_layers + 2)
    whole = jax_cache_as_port(jcache, paged)
    for rank, r in enumerate(got):
        mine = _shard_cache(whole, rank, TP)
        for name, arr in r["cache"].items():
            ref = getattr(mine, name)
            if paged and name != "page_table" and arr is not None:
                arr, ref = arr[1:], ref[1:]  # the reference's scratch page
            if arr is None:
                assert ref is None
            elif arr.dtype == np.int8:
                diff = np.abs(arr.astype(np.int32)
                              - ref.numpy().astype(np.int32))
                assert diff.max() <= 1  # a code on a rounding boundary
            elif name == "page_table":
                np.testing.assert_array_equal(arr, ref.numpy())
            else:
                np.testing.assert_allclose(arr, ref.numpy(), rtol=1e-2,
                                           atol=1e-5)


def _shard_cache(cache, rank: int, tp: int):
    """Rank `rank`'s kv heads of a whole (unpaired) cache: axis 2 of the
    dense [L, B, K, S, H] and the paged [P, L, Nk, page, H] leaves and of
    their scales; the page table whole."""
    def mine(x):
        if x is None:
            return None
        n = x.shape[2] // tp
        return x[:, :, rank * n:(rank + 1) * n]

    return dataclasses.replace(cache, k=mine(cache.k), v=mine(cache.v),
                               k_scale=mine(cache.k_scale),
                               v_scale=mine(cache.v_scale))


def jax_cache_as_port(jcache, paged: bool):
    from gabby_tpu_torch.runtime.kv_cache import cache_from_numpy
    from gabby_tpu_torch.runtime.paged import paged_cache_from_numpy

    leaves = [np.asarray(x) for x in (jcache.k, jcache.v, jcache.k_scale,
                                      jcache.v_scale)]
    if paged:
        return paged_cache_from_numpy(*leaves, np.asarray(jcache.page_table),
                                      device="cpu")
    return cache_from_numpy(*leaves, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp2_ranks_match_the_port_at_tp1(runs, paged):
    """The two ranks against the port's own single-process steps on the
    whole tree: f32 sums in another order, nothing more."""
    _, trees, ranks = runs
    cfg = dataclasses.replace(tcfg.tiny(max_seq_len=MAX_SEQ, **DIMS),
                              fused_tp=TP)
    full = tllama.params_from_numpy(trees[(paged, 4)], device="cpu")
    from gabby_tpu_torch.ops import cuda as ck
    ck.set_attn_s8(False)
    try:
        want, _ = _port_steps(full, cfg, _new_cache(cfg, paged))
    finally:
        ck.set_attn_s8(None)
    for g, w in zip(ranks[0][(paged, 4)]["logits"], want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_tp1_takes_no_collective():
    """tp = 1 is the path it was: bind_group of the local group adds no
    group, a group of one rank calls nothing, and the logits are the
    unbound tree's bit for bit."""
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ, **DIMS)
    params = tllama.fuse_projections(tllama.init_params(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"))
    assert "tp" not in bind_group(params, local_group("cpu"))
    one = dict(params, tp=local_group("cpu"))
    collectives.reset_counts()
    outs = []
    for tree in (params, one):
        cache = _new_cache(cfg, False)
        outs.append(_port_steps(tree, cfg, cache)[0])
    assert collectives.counts["all_reduce"] == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
