"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
gabby_tpu/ops/sampling.py).

Parameters are per-slot tensors, so one decode loop serves a mix of
requests. Filtering runs over a static top-`max_candidates` slice of the
vocabulary. Designed divergence from the reference: the candidates come
from an EXACT `torch.topk`, where the TPU reference uses `approx_max_k`
(~0.95 recall); greedy decoding is an exact argmax in both, so greedy
tokens agree token for token. Random draws come from an explicit
`torch.Generator` and do not reproduce the reference's threefry stream.
Every call draws one uniform a lane of the WHOLE slot batch (`draw_total`)
and a lane picks its token by inverse CDF from its own uniform (at
`draw_offset` + its row): under data parallelism a replica holding slots
[lo, hi) draws the same vector and keeps its part, so an unseeded lane's
stream does not depend on which replica holds it, as the reference's draw
over the sharded global batch does not.

Per-request seeds (OpenAI `seed`): a lane with seed >= 0 draws from a
stream that depends only on (seed, position) and its own filtered
candidates, so its output reproduces whatever shares the batch. The
reference folds the position into a threefry key; the port hashes (seed,
position, rank) into Gumbel noise over the candidates on the device, with
integer arithmetic that stays inside int64 (so the CPU and the card
compute the same integers), no host sync and no per-lane generator. The
tokens differ from the reference's; the determinism contract is the same.

Conventions: temperature == 0 -> greedy; top_k == 0 -> disabled;
top_p >= 1.0 -> disabled (within the candidate set).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
MAX_CANDIDATES = 128


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply) on int64 tensors holding
    values in [0, 2^32): every product stays below 2^59."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def lane_gumbel(seeds: torch.Tensor, positions: torch.Tensor,
                k: int) -> torch.Tensor:
    """Gumbel noise [B, k] f32 for candidate ranks 0..k-1, a function of
    (seed, position, rank) alone: the seeded lanes' counter-hash stream."""
    s = seeds.long() & _MASK32
    p = positions.long() & _MASK32
    h = _mix32(_mix32(s) ^ p)[:, None]
    ranks = torch.arange(k, device=seeds.device, dtype=torch.int64)[None, :]
    h = _mix32((h + ranks * 0x9E3779B9) & _MASK32)
    # 24 bits to a uniform strictly inside (0, 1), exact in f32
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], *,
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor,
           max_candidates: int = MAX_CANDIDATES,
           lane_seeds: Optional[torch.Tensor] = None,
           lane_positions: Optional[torch.Tensor] = None,
           draw_offset: int = 0,
           draw_total: Optional[int] = None) -> torch.Tensor:
    """logits: [B, V] f32; temperature/top_p: [B] f32; top_k: [B] int.
    Returns sampled token ids [B] int32.

    lane_seeds [B] int (with lane_positions [B] int): lanes with seed >= 0
    draw from their own (seed, position) stream (`lane_gumbel`); lanes at
    -1 keep `generator`'s draw. The global draw is made for every lane
    whatever the seeds, so an unseeded lane's stream does not depend on
    whether a seeded one ran beside it. It is `uniforms(generator,
    draw_total)` (default B), of which row i takes entry draw_offset + i."""
    b, v = logits.shape
    k = min(max_candidates, v)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    vals, idx = torch.topk(logits, k, dim=-1)  # [B, K], descending
    scaled = vals / temp

    ranks = torch.arange(k, device=logits.device)[None, :]
    kk = torch.where(top_k > 0, torch.clamp(top_k, max=k),
                     torch.full_like(top_k, k))
    keep_k = ranks < kk[:, None]

    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]  # always keeps rank 0

    filtered = torch.where(keep_k & keep_p, scaled,
                           torch.full_like(scaled, NEG_INF))
    u = uniforms(generator, b if draw_total is None else draw_total,
                 logits.device)[draw_offset:draw_offset + b]
    choice = inverse_cdf(torch.softmax(filtered, dim=-1), u)  # [B, 1]
    if lane_seeds is not None:
        lane_choice = torch.argmax(
            filtered + lane_gumbel(lane_seeds, lane_positions, k), dim=-1)
        choice = torch.where(lane_seeds[:, None] >= 0, lane_choice[:, None],
                             choice)
    sampled = torch.gather(idx, 1, choice)[:, 0]
    greedy_ids = torch.argmax(logits, dim=-1)  # exact, not top-1 of topk
    return torch.where(temperature <= 0.0, greedy_ids,
                       sampled).to(torch.int32)


def uniforms(generator: Optional[torch.Generator], n: int,
             device) -> torch.Tensor:
    """One call's draw: n uniforms in [0, 1) from `generator`. A replica
    that samples no lane of a call draws it all the same (and drops it),
    so that every replica's stream stays where the others' are."""
    return torch.rand(n, generator=generator, device=device)


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """probs [B, K] (zero past a prefix of kept candidates), u [B] in
    [0, 1) -> [B, 1] int64: the first candidate whose cumulative
    probability passes u x the row's total, never past the last candidate
    of positive probability."""
    cum = torch.cumsum(probs, dim=-1)
    pick = torch.searchsorted(cum, (u * cum[:, -1])[:, None], right=True)
    last = (probs > 0).sum(dim=-1, keepdim=True) - 1
    return torch.minimum(pick, last.clamp(min=0))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
