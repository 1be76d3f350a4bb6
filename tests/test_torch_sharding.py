"""The port's tensor-parallel partition of the weights, held against
gabby_tpu (no process group needed): `fuse_projections(tp)` and
`_split_fused` bit for bit against the JAX package's at tp 1, 2 and 4 for
bf16, int8 and int4 leaves; the indivisible-dim error; each rank's
`shard_params` block, dequantized and put back together, equal to the
whole tree's dequantized weight exactly (the int4 row shards of `wo` and
`w_down` included, which are re-packed half-split on their own);
`param_specs` over the tree; pairing refused under tp; the loader's
fused_tp rule and its sharded put hook."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import quant as jquant
from gabby_tpu.parallel import sharding as jsharding
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch import loader as tloader
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.parallel import (PARAM_RULES, TPGroup, bind_group,
                                      local_config, param_specs,
                                      shard_params, sharded_put_fn)
from gabby_tpu_torch.parallel.sharding import COL, LeafSpec
from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
from gabby_tpu_torch.tokenizer import Tokenizer

from test_torch_loader import write_hf_dir
from test_torch_model import to_numpy_tree

DIMS = dict(num_heads=8, num_kv_heads=4, head_dim=8, hidden_size=32,
            intermediate_size=64, vocab_size=256)
KINDS = ["bf16", "int8", "int4"]


def _trees(kind: str):
    """The same unfused tree in both packages: f32 from gabby_tpu's
    init_params, cast to bf16 on both sides (round to nearest even, the
    same bits) or quantized by gabby_tpu and carried across."""
    jc = jcfg.tiny(max_seq_len=64, **DIMS)
    params = jllama.init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    if kind == "int8":
        params = jquant.quantize_tree(params, 8)
    elif kind == "int4":
        params = jquant.quantize_tree(params, 4, unembed_bits=4,
                                      unembed_group=256)
    tparams = tllama.params_from_numpy(to_numpy_tree(params), device="cpu")
    if kind == "bf16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
        tparams = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
                       else {b: w.to(torch.bfloat16) for b, w in v.items()}
                       if isinstance(v, dict) else v)
                   for k, v in tparams.items()}
    return jc, params, tparams


def _bits(x) -> np.ndarray:
    """A leaf's raw bits, comparable across the packages."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_fuse_projections_bit_for_bit(kind, tp):
    _, params, tparams = _trees(kind)
    want = jllama.fuse_projections(params, tp=tp)["blocks"]
    got = tllama.fuse_projections(tparams, tp=tp)["blocks"]
    assert set(got) == set(want)
    for name in ("wqkv", "w_gup"):
        w, g = want[name], got[name]
        if kind == "bf16":
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            assert g.bits == w.bits
            np.testing.assert_array_equal(_bits(g.q), _bits(w.q))
            np.testing.assert_array_equal(_bits(g.scale), _bits(w.scale))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_fused_matches_reference(tp):
    dims = (64, 32, 32)
    y = np.random.default_rng(tp).standard_normal((2, 3, sum(dims)),
                                                  ).astype(np.float32)
    want = jllama._split_fused(jnp.asarray(y), dims, tp)
    got = tllama._split_fused(torch.from_numpy(y), dims, tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fuse_projections_refuses_an_indivisible_dim():
    _, params, tparams = _trees("int8")
    with pytest.raises(ValueError, match="does not divide") as want:
        jllama.fuse_projections(params, tp=3)
    with pytest.raises(ValueError, match="does not divide") as got:
        tllama.fuse_projections(tparams, tp=3)
    assert str(got.value) == str(want.value)


def _dense(leaf) -> torch.Tensor:
    """A leaf as an f32 weight: QTensors dequantized, stacks layer by layer."""
    if not isinstance(leaf, tquant.QTensor):
        return leaf.float()
    if leaf.q.dim() == 3:
        return torch.stack([tquant.dequantize(
            tquant.QTensor(q=leaf.q[i], scale=leaf.scale[i], bits=leaf.bits),
            torch.float32) for i in range(leaf.q.shape[0])])
    return tquant.dequantize(leaf, torch.float32)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_rank_shards_put_back_together_exactly(kind, tp):
    """Every leaf of the tree fused with tp: the ranks' blocks, dequantized
    and concatenated on the rule's axis, are the whole leaf's dequantized
    weight, bit for bit."""
    _, _, tparams = _trees(kind)
    full = tllama.fuse_projections(tparams, tp=tp)
    shards = [shard_params(full, r, tp, fused_tp=tp) for r in range(tp)]

    def check(path, leaf, parts):
        axis = PARAM_RULES[path]
        whole = _dense(leaf)
        if axis is None:
            for p in parts:
                assert torch.equal(_dense(p), whole)
            return
        assert torch.equal(torch.cat([_dense(p) for p in parts], dim=axis),
                           whole), path

    for name in ("embed", "final_norm", "lm_head"):
        check(name, full[name], [s[name] for s in shards])
    for name, leaf in full["blocks"].items():
        check(f"blocks/{name}", leaf, [s["blocks"][name] for s in shards])


def test_int4_row_shards_are_repacked():
    """A contiguous slice of half-split packed codes holds rows r K/2tp..
    and K/2 + r K/2tp.., not the rank's input rows: the shard must be the
    rank's rows re-packed, and the naive slice differs from it."""
    _, _, tparams = _trees("int4")
    wo = tparams["blocks"]["wo"]  # [L, K/2, N], K = 64
    local = shard_params(tparams, 1, 2)["blocks"]["wo"]
    kp = wo.q.shape[1]
    assert local.q.shape == (wo.q.shape[0], kp // 2, wo.q.shape[2])
    assert torch.equal(local.scale, wo.scale)  # per-channel: whole
    naive = wo.q[:, kp // 2:]
    assert not torch.equal(local.q, naive)
    for layer in range(wo.q.shape[0]):
        rows = tquant.unpack_int4(wo.q[layer])[kp:]  # input rows K/2..K
        assert torch.equal(tquant.unpack_int4(local.q[layer]), rows)


def test_param_specs_cover_the_tree():
    """Every leaf of every kind of tree has a spec, QTensors one for their
    scale too; the rule keys are the reference's."""
    assert set(PARAM_RULES) == set(jsharding.PARAM_RULES)
    for kind in KINDS:
        _, _, tparams = _trees(kind)
        for tree in (tparams, tllama.fuse_projections(tparams, tp=2)):
            specs = param_specs(tree)
            assert set(specs["blocks"]) == set(tree["blocks"])
            for name in ("embed", "final_norm", "lm_head"):
                assert isinstance(specs[name], LeafSpec)
            assert specs["embed"].axis == -2
            assert specs["lm_head"].axis == COL
            if kind != "bf16":
                assert specs["lm_head"].scale_axis == COL
                assert specs["blocks"]["wo"].scale_axis is None
                assert specs["blocks"]["wqkv" if "wqkv" in tree["blocks"]
                                      else "wq"].scale_axis == COL


def test_shard_params_refuses_a_tree_fused_for_another_tp():
    _, _, tparams = _trees("int8")
    fused = tllama.fuse_projections(tparams)
    with pytest.raises(ValueError, match="fused with tp=1"):
        shard_params(fused, 0, 2, fused_tp=1)


def test_local_config_and_its_errors():
    cfg = dataclasses.replace(tcfg.llama32_1b(), fused_tp=2)
    lc = local_config(cfg, 2)
    assert (lc.num_heads, lc.num_kv_heads, lc.intermediate_size,
            lc.vocab_size, lc.fused_tp) == (16, 4, 4096, 128256, 1)
    assert local_config(cfg, 1) is cfg
    with pytest.raises(ValueError, match="num_kv_heads"):
        local_config(tcfg.llama32_1b(), 16)


def test_pair_kv_heads_refused_under_tp():
    """As the reference refuses pairing under cache shardings
    (gabby_tpu/runtime/engine.py:364-370), with its message; and a
    rank-local tree needs the plan broadcast."""
    cfg = tcfg.tiny(max_seq_len=64, **DIMS)
    params = tllama.init_params(cfg, dtype=torch.float32, device="cpu")
    local = bind_group(tllama.fuse_projections(shard_params(params, 0, 2)),
                       TPGroup(rank=0, size=2, device=torch.device("cpu")))
    tok = Tokenizer.byte_fallback(cfg.vocab_size)
    with pytest.raises(ValueError, match="pair_kv_heads is single-device"):
        Engine(cfg, local, tok, EngineConfig(max_seq=64, pair_kv_heads=True,
                                             cache_dtype="float32"),
               device="cpu")
    with pytest.raises(ValueError, match="needs sync"):
        Engine(cfg, local, tok, EngineConfig(max_seq=64,
                                             cache_dtype="float32"),
               device="cpu")


def _rewrite_fused_tp(d, value: int) -> None:
    meta = json.loads((d / "gabby.json").read_text())
    meta["config"]["fused_tp"] = value
    (d / "gabby.json").write_text(json.dumps(meta))


def test_loader_fused_tp_and_the_sharded_put_hook(tmp_path):
    """A checkpoint fused for tp = 2 loads at tp = 2, each rank's leaves cut
    by sharded_put_fn as they are read, equal to shard_params of the whole
    tree; at tp = 1 it is refused. An unfused checkpoint (fused_tp 1)
    loads at any tp; one fused for tp = 1 is refused at tp = 2."""
    cfg = dataclasses.replace(tcfg.tiny(max_seq_len=64, **DIMS), fused_tp=2)
    params = tquant.quantize_tree(tllama.init_params(
        cfg, dtype=torch.float32, device="cpu"), 4)
    fused = tllama.fuse_projections(params, tp=2)
    d = tmp_path / "fused2"
    tloader.save_quantized(str(d), cfg, fused, 4)
    for rank in range(2):
        got_cfg, got, _ = tloader.load_quantized(
            str(d), dtype=torch.float32, device="cpu", tp=2,
            device_put_fn=sharded_put_fn(rank, 2, "cpu"))
        assert got_cfg.fused_tp == 2
        want = shard_params(fused, rank, 2, fused_tp=2)
        for name in ("wqkv", "w_gup", "wo", "w_down"):
            assert torch.equal(got["blocks"][name].q, want["blocks"][name].q)
            assert torch.equal(got["blocks"][name].scale,
                               want["blocks"][name].scale)
        assert torch.equal(got["embed"], want["embed"])
    with pytest.raises(ValueError, match="fused for tp=2"):
        tloader.load_quantized(str(d), device="cpu")

    plain = tmp_path / "unfused"
    tloader.save_quantized(str(plain), dataclasses.replace(cfg, fused_tp=1),
                           params, 4)
    tloader.load_quantized(str(plain), device="cpu", tp=2)
    fused1 = tmp_path / "fused1"
    tloader.save_quantized(str(fused1), dataclasses.replace(cfg, fused_tp=1),
                           tllama.fuse_projections(params), 4)
    with pytest.raises(ValueError, match="fused for tp=1"):
        tloader.load_quantized(str(fused1), device="cpu", tp=2)


@pytest.mark.parametrize("quant_bits", [None, 4])
def test_hf_dir_loads_sharded_layer_by_layer(tmp_path, quant_bits):
    """An HF-layout directory through load_llama_params with the sharded
    put hook: each rank's tree equals shard_params of the whole load (int4
    row shards quantized whole, then cut)."""
    jc = jcfg.tiny(max_seq_len=64, **DIMS)
    params = jllama.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    d = write_hf_dir(tmp_path / "hf", jc, params)
    cfg = tcfg.tiny(max_seq_len=64, **DIMS)
    whole = tloader.load_llama_params(str(d), cfg, dtype=torch.float32,
                                      quant_bits=quant_bits, device="cpu")
    for rank in range(2):
        got = tloader.load_llama_params(
            str(d), cfg, dtype=torch.float32, quant_bits=quant_bits,
            device="cpu", device_put_fn=sharded_put_fn(rank, 2, "cpu"))
        want = shard_params(whole, rank, 2)
        for name, leaf in want["blocks"].items():
            g = got["blocks"][name]
            if isinstance(leaf, tquant.QTensor):
                assert torch.equal(g.q, leaf.q) and torch.equal(
                    g.scale, leaf.scale), name
            else:
                assert torch.equal(g, leaf), name
        assert torch.equal(got["embed"], want["embed"])
