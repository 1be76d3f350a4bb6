"""The collectives of tensor-parallel serving. The reference's GSPMD
inserts them from its PartitionSpecs (gabby_tpu/parallel/sharding.py); the
port calls them by hand, Megatron style, at the model's seams:

  embed        the vocab-sharded embedding lookup: one all-reduce;
  all_reduce   after the row-sharded `wo` and `w_down`: one each a layer;
  gather_vocab the vocab-sharded unembed's logits: one all-reduce.

So a decode step takes 2 x L + 2 all-reduces. Gathers are all-reduces over
a zero-filled buffer in which each rank fills its own slice: x + 0 = x, so
the sum is exact, and one collective serves gloo (whose CUDA path has no
all_gather) and nccl alike. Every function is a no-op, with no launch,
when the group is None or holds one rank. `counts` counts the all-reduces
made (the smoke test reads it a decode step)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

counts: dict[str, int] = {"all_reduce": 0}


def reset_counts() -> None:
    counts["all_reduce"] = 0


def active(group) -> bool:
    return group is not None and group.size > 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group.group)
    counts["all_reduce"] += 1
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks. bf16/f16 partials (the kernels' outputs)
    are summed in f32 and rounded once."""
    if not active(group):
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return _all_reduce(x.float(), group).to(x.dtype)
    return _all_reduce(x.contiguous(), group)


def embed(ids: torch.Tensor, table: torch.Tensor, group) -> torch.Tensor:
    """Embedding rows of `ids` from a vocab-sharded table: rank r holds rows
    [r * Vs, (r + 1) * Vs). Rows outside the shard read zero, then one
    all-reduce. ids outside the whole vocab read zero on every rank."""
    if not active(group):
        return table[ids.long()]
    vs = table.shape[0]
    local = ids.long() - group.rank * vs
    inside = (local >= 0) & (local < vs)
    rows = table[local.clamp(0, vs - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))
    return _all_reduce(rows, group)


def gather_vocab(logits: torch.Tensor, group,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Logits over a vocab shard [..., Vs] -> the whole [..., Vs x size]
    (cut to `vocab` when given): each rank writes its slice of a zero
    buffer, then one all-reduce."""
    if active(group):
        vs = logits.shape[-1]
        out = logits.new_zeros(*logits.shape[:-1], vs * group.size)
        out[..., group.rank * vs:(group.rank + 1) * vs] = logits
        logits = _all_reduce(out, group)
    return logits if vocab is None else logits[..., :vocab]
