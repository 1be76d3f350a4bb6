"""Tensor-parallel partition rules for the Llama param tree and the KV
cache (counterpart of gabby_tpu/parallel/sharding.py), and the rank-local
slicer that applies them.

Megatron-style layout, as in the reference:

  qkv / gate / up : output-dim (column) sharded  -> heads split per rank
  o / down        : input-dim (row) sharded      -> one all-reduce a block
  embed           : vocab (row) sharded
  lm_head         : vocab (column) sharded
  norms           : replicated
  KV cache        : kv-head axis sharded (each rank's engine allocates
                    local_config's kv heads); the page table stays whole

Over the data axis (dp replicas of the tp group) the weights are
replicated, and the dense cache's slot axis is sharded: replica d holds
slots `slot_block(B, dp, d)` (the reference's P("data", "model") on the
slot and kv-head axes). The paged pool shards only its kv heads: every
replica holds the whole pool (the page axis is unsharded and the
allocator host-global) and the page table rows of its own slots. Per-slot
state (tokens, positions, sampling rows) follows the slots.

The reference expresses these as PartitionSpecs and lets GSPMD place the
leaves; here each rank holds its own slice (`shard_params`), taken as a
contiguous block of the rule's axis. A column-sharded QTensor's scale is
sliced with its codes (per channel [L, out], or the group-scaled
unembed's [K/g, N] on N); a row-sharded one's per-channel scale stays
whole. Int4 codes pack row i with row i + K/2 in one byte
(quant.pack_int4), so a contiguous slice of a row-sharded weight's packed
bytes does not hold the rank's input rows: each row shard is unpacked,
sliced and re-packed half-split on its own. The codes are the same, so
the numbers are too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.ops.quant import QTensor, pack_int4, unpack_int4

COL = -1  # output dim of [.., in, out]
ROW = -2  # input dim of [.., in, out]; the vocab rows of embed [V, D]

# the axis each leaf splits on, counted from the end (None: replicated)
PARAM_RULES: dict[str, Optional[int]] = {
    "embed": ROW,
    "lm_head": COL,
    "final_norm": None,
    "blocks/attn_norm": None,
    "blocks/mlp_norm": None,
    "blocks/wq": COL,
    "blocks/wk": COL,
    "blocks/wv": COL,
    # fused projections (llama.fuse_projections): column-shardable over tp
    # ranks ONLY when the tree was fused with that same tp (per-shard
    # column blocks); shard_params checks the match
    "blocks/wqkv": COL,
    "blocks/w_gup": COL,
    "blocks/wo": ROW,
    "blocks/w_gate": COL,
    "blocks/w_up": COL,
    "blocks/w_down": ROW,
}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Where a leaf splits: `axis` for a tensor or a QTensor's codes,
    `scale_axis` for a QTensor's scale (None: whole on every rank)."""

    axis: Optional[int]
    scale_axis: Optional[int] = None


def _leaf_spec(path: str, leaf) -> LeafSpec:
    axis = PARAM_RULES[path]
    if not isinstance(leaf, QTensor) or axis is None:
        return LeafSpec(axis)
    if axis == COL:
        return LeafSpec(COL, COL)
    return LeafSpec(ROW, ROW if leaf.group else None)


def _walk(tree, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params: dict[str, Any]) -> dict[str, Any]:
    """A tree of LeafSpecs matching `params`' structure."""
    return _walk(params, _leaf_spec)


def _block(x: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = x.shape[axis]
    if n % tp:
        raise ValueError(f"dim {n} does not divide by tp={tp}")
    return x.narrow(axis, rank * (n // tp), n // tp).contiguous()


def _int4_row_block(q: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s input rows of half-split packed codes [(L,) K/2, N],
    re-packed half-split: [(L,) K/(2 tp), N]."""
    if q.dim() == 3:
        return torch.stack([_int4_row_block(layer, rank, tp) for layer in q])
    codes = unpack_int4(q)
    if codes.shape[0] % (2 * tp):
        raise ValueError(f"int4 input dim {codes.shape[0]} does not split "
                         f"into {tp} even row blocks")
    return pack_int4(_block(codes, 0, rank, tp))


def shard_leaf(path: str, leaf, rank: int, tp: int):
    """Rank `rank`'s slice of one leaf under PARAM_RULES."""
    if leaf is None or tp == 1:
        return leaf
    spec = _leaf_spec(path, leaf)
    if spec.axis is None:
        return leaf
    if not isinstance(leaf, QTensor):
        return _block(leaf, spec.axis, rank, tp)
    if spec.axis == ROW and leaf.bits == 4:
        q = _int4_row_block(leaf.q, rank, tp)
    else:
        q = _block(leaf.q, spec.axis, rank, tp)
    scale = (leaf.scale if spec.scale_axis is None
             else _block(leaf.scale, spec.scale_axis, rank, tp))
    return QTensor(q=q, scale=scale, bits=leaf.bits, group=leaf.group)


def shard_params(params: dict[str, Any], rank: int, tp: int,
                 fused_tp: int = 1) -> dict[str, Any]:
    """Rank `rank`'s local tree of `params` over tp ranks (new tensors; the
    whole tree can be dropped afterwards)."""
    blocks = params.get("blocks") if isinstance(params, dict) else None
    if (tp > 1 and fused_tp != tp and isinstance(blocks, dict)
            and ("wqkv" in blocks or "w_gup" in blocks)):
        raise ValueError(
            f"fused projection weights (wqkv/w_gup) fused with tp={fused_tp} "
            f"cannot shard over a model axis of size {tp}: each shard "
            f"would mix q/k/v (or gate/up) columns. Re-fuse with "
            f"fuse_projections(params, tp={tp}) (and set cfg.fused_tp), "
            f"or keep the tree unfused")
    return _walk(params, lambda path, leaf: shard_leaf(path, leaf, rank, tp))


def sharded_put_fn(rank: int, tp: int, device):
    """The loader's `device_put_fn`: each leaf (or one layer of a stacked
    leaf) is sliced to rank `rank`'s block where it was read, then moved
    to `device`, so a checkpoint never lands whole on a card."""
    def put(path: tuple, leaf):
        local = shard_leaf("/".join(path), leaf, rank, tp)
        return local.to(device)

    return put


def bind_group(params: dict[str, Any], group) -> dict[str, Any]:
    """The local tree with its TPGroup under the key "tp": the model reads
    the group from there (a shard means nothing without its collectives).
    tp = 1 trees carry no group."""
    out = dict(params)
    if group is not None and group.size > 1:
        out["tp"] = group
    return out


@functools.lru_cache(maxsize=32)
def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The head counts and FFN width one rank of `tp` computes with. The
    vocab stays whole (logits are gathered); a tree fused with tp = fused_tp
    holds one plain [q|k|v] block a rank, hence fused_tp 1."""
    if tp == 1:
        return cfg
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not divide "
                             f"by tp={tp}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp, fused_tp=1)


def slot_block(batch: int, dp: int, dp_rank: int) -> tuple[int, int]:
    """Replica `dp_rank`'s slots [lo, hi) of `batch` slots over dp
    replicas, contiguous blocks in replica order."""
    if batch % dp:
        raise ValueError(f"batch_slots={batch} must be divisible by dp={dp} "
                         f"(slots shard over the data axis)")
    n = batch // dp
    return dp_rank * n, (dp_rank + 1) * n
