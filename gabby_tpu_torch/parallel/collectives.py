"""The collectives of tensor- and data-parallel serving. The reference's
GSPMD inserts them from its PartitionSpecs (gabby_tpu/parallel/sharding.py);
the port calls them by hand, Megatron style, at the model's seams. Over the
tp group (the model axis):

  embed        the vocab-sharded embedding lookup: one all-reduce;
  all_reduce   after the row-sharded `wo` and `w_down`: one each a layer;
  gather_vocab the vocab-sharded unembed's logits: one all-reduce.

So a decode step takes 2 x L + 2 all-reduces. Over the dp group (the data
axis: the ranks of the other replicas that hold the same model shard):

  gather_slots   each replica's packed host view put together: one a
                 decode burst;
  gather_tokens  a token-sharded activation put together (sequence-
                 parallel prefill's K/V all-gather);
  rotate         ring attention's hop to the next replica;
  from_replica   one replica's tensor to every replica (the admission
                 slot's prior cache rows, the last token's hidden state,
                 a first token's top rows).

Gathers are all-reduces over a zero-filled buffer in which each rank fills
its own slice: x + 0 = x, so the sum is exact for ints and floats alike,
and one collective serves gloo (whose CUDA path has no all_gather) and
nccl. Every function is a no-op, with no launch, when its group holds one
rank. `counts` counts each kind made (the smoke test reads them a decode
step)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

counts: dict[str, int] = {"all_reduce": 0, "gather_slots": 0,
                          "gather_tokens": 0, "rotate": 0,
                          "from_replica": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def active(group) -> bool:
    return group is not None and group.size > 1


def dp_active(group) -> bool:
    return group is not None and group.dp_size > 1


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


# ---- the data axis ---------------------------------------------------------


_WIDE = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _dp_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """The sum of every replica's `buf` (zero but for each replica's own
    part, so exact for every type: narrow types, bf16 and f16 by their
    bits, int8 and bool, travel as int32)."""
    if buf.element_size() >= 4:
        dist.all_reduce(buf, group=group.dp_group)
        return buf
    bits = _WIDE.get(buf.dtype)
    wide = (buf.view(bits) if bits is not None else buf).to(torch.int32)
    dist.all_reduce(wide, group=group.dp_group)
    return (wide.to(bits).view(buf.dtype) if bits is not None
            else wide.to(buf.dtype))


def _dp_stack(x: torch.Tensor, group) -> torch.Tensor:
    """x of every replica, [dp, *x.shape] in replica order."""
    out = x.new_zeros(group.dp_size, *x.shape)
    out[group.dp_rank] = x
    return _dp_sum(out, group)


def gather_slots(x: torch.Tensor, group) -> torch.Tensor:
    """A replica's [n] packed host view -> [dp, n], row d replica d's."""
    if not dp_active(group):
        return x[None]
    counts["gather_slots"] += 1
    return _dp_stack(x, group)


def gather_tokens(x: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """A token-sharded activation (replica d's tokens are the d-th block
    of the chunk) put together along the token `axis`."""
    if not dp_active(group):
        return x
    counts["gather_tokens"] += 1
    return torch.cat(_dp_stack(x, group).unbind(0), dim=axis)


def from_replica(x: Optional[torch.Tensor], src: int, group, shape=None,
                 dtype=None, device=None) -> torch.Tensor:
    """Replica `src`'s x on every replica: an all-reduce of a zero buffer
    that only `src` fills. The other replicas pass x None (or anything)
    and x's shape, dtype and device."""
    if not dp_active(group):
        return x
    counts["from_replica"] += 1
    if group.dp_rank == src:
        return _dp_sum(x.clone(), group)
    return _dp_sum(torch.zeros(shape, dtype=dtype, device=device), group)


def rotate(x: torch.Tensor, group) -> torch.Tensor:
    """x sent to the next replica (d + 1 mod dp) and the previous one's
    received: one hop of the ring. nccl moves it card to card by a batched
    send/recv; gloo has no point-to-point for CUDA tensors, so the hop is
    staged through host copies. The buffer is x's size: one replica's
    block."""
    if not dp_active(group):
        return x
    dp, d = group.dp_size, group.dp_rank
    nxt = group.global_rank((d + 1) % dp)
    prv = group.global_rank((d - 1) % dp)
    staged = x.is_cuda and group.backend != "nccl"
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=group.dp_group),
        dist.P2POp(dist.irecv, recv, prv, group=group.dp_group)])
    for r in reqs:
        r.wait()
    counts["rotate"] += 1
    return recv.to(x.device) if staged else recv
