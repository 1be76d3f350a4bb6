"""Sequence-parallel prefill (parallel/sp.py) and ring attention
(parallel/ring.py) of the port held against gabby_tpu's sp_prefill_slot,
the counterpart of tests/test_sp.py.

The port's replicas are gloo ranks, each a process of its own joined
through a FileStore in tmp_path (parallel.mesh.spawn_ranks): two ranks at
dp = 2, tp = 1 for the module's cases, four at dp = 2 x tp = 2 for the
composed ones, each spawn once for the module with its own timeout. The
JAX side runs the same calls on the conftest's virtual CPU devices
(make_mesh(dp=2, tp=1) and make_mesh(dp=2, tp=2)) with the same weights
(the tiny config, f32, from PRNGKey(3), carried across as numpy).

The cases of tests/test_sp.py at dp = 2: a 64-token chunk at offset 0 into
slot 1 (replica 1's) on an f32, an int8 and a paired int8 cache, by the
K/V all-gather and by the ring; two 48-token chunks at offsets 0 and 48
into slot 0 (replica 0's), whose second reads the prior cache rows, by
both routes; and, composed with tp = 2 (fused projections sharded by
shard_params), a 64-token chunk and the two chunks by both routes. Then an
engine at dp = 2 x tp = 2 whose 70-token admission takes the SP path
(spied) with greedy streams equal to the per-slot path's.

Tolerance: f32 logits within rtol 1e-4 / atol 1e-4 of the JAX
sp_prefill_slot's and within 1e-5 of the port's own single-rank
prefill_slot (the all-gather route gives its bits; the ring sums the same
terms in another order); every rank's logits bit for bit equal; the
owner's cache rows of the slot: f32 rows within 1e-4, int8 codes within
one code of the JAX rows (a code on a rounding boundary) and their scales
within 1e-4. The ranks import this module without JAX: the JAX side is
imported inside the parent's functions only."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.parallel import (bind_group, collectives,
                                      init_distributed, local_config,
                                      shard_params)
from gabby_tpu_torch.parallel.mesh import spawn_ranks
from gabby_tpu_torch.runtime.kv_cache import create_cache

DP = 2
MAX_SEQ = 128
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SHORT = list(range(2, 2 + 64))
LONG = list(range(3, 3 + 96))
# name -> (ring, quantized, paired, slot, [(offset, chunk ids, valid)])
CASES = {
    "gather, f32": (False, False, False, 1, [(0, SHORT, 64)]),
    "gather, int8": (False, True, False, 1, [(0, SHORT, 64)]),
    "gather, int8 paired": (False, True, True, 1, [(0, SHORT, 64)]),
    "ring, f32": (True, False, False, 1, [(0, SHORT, 64)]),
    "ring, int8": (True, True, False, 1, [(0, SHORT, 64)]),
    # 80 tokens: 48, then 32 and 16 of padding (the reference's chunking)
    "gather, two chunks": (False, False, False, 0,
                           [(0, LONG[:48], 48),
                            (48, LONG[48:80] + [0] * 16, 32)]),
    "ring, two chunks": (True, False, False, 0,
                         [(0, LONG[:48], 48), (48, LONG[48:96], 48)]),
}
TP_CASES = ("gather, f32", "ring, f32", "gather, two chunks",
            "ring, two chunks")
ENGINE_PROMPT = [(7 * i + 3) % 250 + 2 for i in range(70)]  # 64 + 6


def _port_cache(cfg, batch, quantized, paired):
    return create_cache(cfg, batch, MAX_SEQ, dtype=torch.float32,
                        quantized=quantized, paired=paired, device="cpu")


def _cache_rows(cache, row: int) -> dict:
    return {k: None if v is None else v[:, row].numpy()
            for k, v in dataclasses.asdict(cache).items()}


def _run_case(fn, params, cfg, case, batch, lcfg=None):
    """One case through `fn` (sp_prefill_slot's signature): every chunk's
    logits and the cache."""
    _, quantized, paired, slot, chunks = case
    cache = _port_cache(lcfg or cfg, batch, quantized, paired)
    out = []
    for offset, ids, valid in chunks:
        logits, cache = fn(params, cfg, torch.tensor(ids), valid, slot,
                           offset, cache)
        out.append(logits.numpy())
    return out, cache


# ---- the port: one rank a process ------------------------------------------


def _sp_rank(rank: int, nprocs: int, store_path: str, tree_path: str,
             names: tuple, tp: int, engine_tree_path: str = "") -> dict:
    import torch.distributed as dist
    from gabby_tpu_torch.parallel import sp

    group = init_distributed(None, nprocs, rank, dp=DP, device="cpu",
                             store=dist.FileStore(store_path, nprocs),
                             timeout=60)
    with open(tree_path, "rb") as f:
        tree = pickle.load(f)
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ, fused_tp=tp)
    full = tllama.params_from_numpy(tree, device="cpu")
    params = bind_group(shard_params(full, group.rank, tp, fused_tp=tp),
                        group)
    lcfg = local_config(cfg, tp)
    out = {}
    try:
        for name in names:
            ring = CASES[name][0]
            collectives.reset_counts()

            def fn(p, c, tokens, length, slot, offset, cache, ring=ring):
                return sp.sp_prefill_slot(p, c, tokens, length, slot, offset,
                                          cache, group=group, ring=ring)

            logits, cache = _run_case(fn, params, cfg, CASES[name],
                                      2 // DP, lcfg)
            slot = CASES[name][3]
            mine = slot // cache.batch == group.dp_rank
            out[name] = dict(logits=logits, counts=dict(collectives.counts),
                             rows=(_cache_rows(cache, slot % cache.batch)
                                   if mine else None))
        if engine_tree_path:
            with open(engine_tree_path, "rb") as f:
                out["engine"] = _engine_streams(group, pickle.load(f))
    finally:
        group.close()
    return out


def _engine_streams(group, tree) -> dict:
    """tests/test_sp.py:212-260 at dp = 2 x tp = 2: the 70-token prompt
    (a 64-token chunk, then 6) through engines with sp_prefill_tokens 64
    (all-gather and ring) and 0; the SP calls' chunk lengths spied.
    Returns, on the leader, each engine's greedy stream and the calls."""
    from gabby_tpu_torch.parallel import sp
    from gabby_tpu_torch.parallel.multihost import HostSync
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    sync = HostSync(group, timeout=60)
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    # as the server builds a rank's tree: the shard of the unfused tree,
    # then fused on its own
    params = bind_group(tllama.fuse_projections(shard_params(
        tllama.params_from_numpy(tree, device="cpu"), group.rank,
        group.size)), group)
    calls, real = [], sp.sp_prefill_slot

    def spy(*a, **kw):
        calls.append((a[2].shape[0], kw["ring"]))
        return real(*a, **kw)

    sp.sp_prefill_slot = spy
    outs = {}
    try:
        for name, tokens, ring in (("sp", 64, False), ("ring", 64, True),
                                   ("plain", 0, False)):
            eng = Engine(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size),
                         EngineConfig(batch_slots=4, max_seq=MAX_SEQ,
                                      steps_per_call=4, default_max_tokens=6,
                                      cache_dtype="float32",
                                      sp_prefill_tokens=tokens,
                                      sp_prefill_ring=ring),
                         device="cpu", stop_ids={1}, sync=sync)
            if sync.is_leader:
                req = eng.submit_ids(list(ENGINE_PROMPT), max_tokens=6)
                while req.out.get(timeout=60)[1] is None:
                    pass
                outs[name] = list(req.token_ids)
                eng.shutdown()
            else:
                eng._thread.join(timeout=60)
    finally:
        sp.sp_prefill_slot = real
    return {"streams": outs, "calls": calls}


# ---- gabby_tpu on the virtual mesh -----------------------------------------


def _jax_tree(tp: int):
    import jax
    import jax.numpy as jnp
    from gabby_tpu import config as jcfg
    from gabby_tpu.models import llama as jllama

    from test_torch_model import to_numpy_tree

    jc = dataclasses.replace(jcfg.tiny(max_seq_len=MAX_SEQ), fused_tp=tp)
    params = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    if tp > 1:
        params = jllama.fuse_projections(params, tp=tp)
    return jc, params, to_numpy_tree(params)


def _jax_case(jc, params, case, tp: int):
    import jax
    import jax.numpy as jnp
    from gabby_tpu.parallel import make_mesh
    from gabby_tpu.parallel import shard_params as jshard_params
    from gabby_tpu.parallel.sp import sp_prefill_slot as jsp
    from gabby_tpu.runtime.kv_cache import create_cache as jcreate_cache

    ring, quantized, paired, slot, chunks = case
    mesh = make_mesh(dp=DP, tp=tp, devices=jax.devices()[:DP * tp])
    cache = jcreate_cache(jc, 2, MAX_SEQ, dtype=jnp.float32,
                          quantized=quantized, paired=paired)
    if tp > 1:
        params = jshard_params(params, mesh, fused_tp=tp)
    out = []
    for offset, ids, valid in chunks:
        logits, cache = jsp(params, jc, jnp.asarray(ids, jnp.int32),
                            jnp.int32(valid), jnp.int32(slot),
                            jnp.int32(offset), cache, mesh=mesh, ring=ring)
        out.append(np.asarray(logits))
    rows = {k: None if getattr(cache, k) is None
            else np.asarray(getattr(cache, k))[:, slot]
            for k in ("k", "v", "k_scale", "v_scale")}
    return out, rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns (dp = 2, and dp = 2 x tp = 2) and the JAX trees."""
    d = tmp_path_factory.mktemp("sp")
    trees, jax_side, ranks = {}, {}, {}
    for tp in (1, 2):
        jc, params, tree = _jax_tree(tp)
        jax_side[tp] = (jc, params)
        trees[tp] = tree
        with open(d / f"tree{tp}.pkl", "wb") as f:
            pickle.dump(tree, f)
    ranks[1] = spawn_ranks(_sp_rank, DP, (
        str(d / "store1"), str(d / "tree1.pkl"), tuple(CASES), 1),
        timeout=120)
    ranks[2] = spawn_ranks(_sp_rank, DP * 2, (
        str(d / "store2"), str(d / "tree2.pkl"), TP_CASES, 2,
        str(d / "tree1.pkl")), timeout=180)
    return trees, jax_side, ranks


def _owner_rows(ranks, name):
    rows = [r[name]["rows"] for r in ranks if r[name]["rows"] is not None]
    assert len(rows) == 1, "one replica owns the slot"
    return rows[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sp_prefill_matches_the_reference_at_dp2(runs, name):
    trees, jax_side, ranks = runs
    jc, params = jax_side[1]
    want, want_rows = _jax_case(jc, params, CASES[name], 1)
    got = [r[name]["logits"] for r in ranks[1]]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)  # every rank the same logits
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
    rows = _owner_rows(ranks[1], name)
    for key, ref in want_rows.items():
        arr = rows[key]
        if ref is None:
            assert arr is None
        elif arr.dtype == np.int8:
            assert np.abs(arr.astype(np.int32)
                          - ref.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(arr, ref, rtol=1e-4, atol=1e-4)
    # the port's own single-rank prefill_slot on the whole tree
    full = tllama.params_from_numpy(trees[1], device="cpu")
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    plain, cache = _run_case(tllama.prefill_slot, full, cfg, CASES[name], 2)
    for g, w in zip(got[0], plain):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    mine = _cache_rows(cache, CASES[name][3])
    for key, ref in mine.items():
        if ref is not None and ref.dtype != np.int8:
            np.testing.assert_allclose(rows[key], ref, rtol=1e-5, atol=1e-5)


def test_sp_collectives(runs):
    """The all-gather route gathers K/V once a layer and writes from it;
    the ring rotates dp - 1 = 1 hop a layer and gathers only the rows to
    write. Prior rows cross once a layer past offset 0, the last token's
    hidden state once a chunk."""
    _, jax_side, ranks = runs
    nl = jax_side[1][0].num_layers
    for r in ranks[1]:
        one = r["gather, f32"]["counts"]
        assert one["gather_tokens"] == nl and one["rotate"] == 0
        assert one["from_replica"] == 1
        ring = r["ring, two chunks"]["counts"]
        assert ring["rotate"] == 2 * nl and ring["gather_tokens"] == 2 * nl
        assert ring["from_replica"] == nl + 2
        assert one["all_reduce"] == 0  # tp = 1: no model-axis collective


@pytest.mark.parametrize("name", TP_CASES)
def test_sp_composes_with_tp2(runs, name):
    """dp = 2 x tp = 2 (tests/test_sp.py's dp = 4 x tp = 2 case): the
    token shards and the fused column shards do not interfere; logits
    against the JAX sp_prefill_slot on the 2 x 2 mesh, equal on all four
    ranks."""
    _, jax_side, ranks = runs
    jc, params = jax_side[2]
    want, _ = _jax_case(jc, params, CASES[name], 2)
    got = [r[name]["logits"] for r in ranks[2]]
    for other in got[1:]:
        for a, b in zip(got[0], other):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
    assert ranks[2][0][name]["counts"]["all_reduce"] > 0


def test_engine_long_admission_takes_the_sp_path(runs):
    """tests/test_sp.py:212-260: under dp = 2 x tp = 2 the admission's
    64-token chunk rides sp_prefill_slot (all-gather and ring) and the
    greedy stream equals the per-slot path's; the 6-token tail and the
    engine with sp_prefill_tokens 0 take prefill_slot."""
    _, _, ranks = runs
    lead = ranks[2][0]["engine"]
    streams = lead["streams"]
    assert streams["sp"] == streams["plain"] == streams["ring"], streams
    assert len(streams["plain"]) == 6
    for r in ranks[2]:
        assert r["engine"]["calls"] == [(64, False), (64, True)]
