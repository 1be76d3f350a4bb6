"""Ring attention for sequence-parallel prefill (counterpart of
gabby_tpu/parallel/ring.py).

parallel/sp.py shards a long admission chunk's token axis over the
data-parallel replicas and, by default, gathers the chunk's K/V heads on
every replica for attention (Ulysses). That gather puts the whole chunk's
K/V on every replica. Ring attention keeps them sharded: each replica
walks the ring in dp steps, scoring its own queries against the K/V block
it holds (the flash-attention online softmax), then passes the block to
the next replica (`collectives.rotate`). A replica's chunk K/V buffer is
O(T/dp) rather than O(T), for dp - 1 hops a layer.

Causality needs only block-relative positions: every token of the chunk
shares one offset, so query i of replica me sees key j of the block from
replica src iff src * Tl + j <= me * Tl + i. The admission's prior cache
rows, the same on every replica, are folded into the same online softmax
after the sweep, then the sum is normalised: the reference's recurrence,
in the reference's order.

No kernel runs here, as in the reference, whose shard_map region must stay
free of Pallas kernels (gabby_tpu/parallel/ring.py:27-31): plain torch on
activations, f32 scores and sums, the probabilities and values rounded to
q's type as the reference's einsums take them.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.parallel import collectives

NEG_INF = -1e30


def _fold(state, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          visible: torch.Tensor, sm_scale: float):
    """One block into the online softmax (acc, m, l): q [1, Tl, Nk, G, H],
    k/v [1, S, Nk, H], visible broadcasting against [Tl, S]."""
    acc, m, l = state
    s = torch.einsum("btngh,bsnh->ntgs", q.float(),
                     k.to(q.dtype).float()) * sm_scale  # [Nk, Tl, G, S]
    s = torch.where(visible[None, :, None, :], s,
                    torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    pv = torch.einsum("ntgs,bsnh->ntgh", p.to(q.dtype).float(),
                      v.to(q.dtype).float())
    return acc * alpha + pv, m_new, l * alpha + p.sum(dim=-1, keepdim=True)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group, sm_scale: Optional[float] = None,
                        cache_k: Optional[torch.Tensor] = None,
                        cache_v: Optional[torch.Tensor] = None,
                        cache_len: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention of a token-sharded chunk, K/V kept sharded.

    q: [1, Tl, Nq, H], k/v: [1, Tl, Nk, H]: this replica's block of the
    chunk (replica d holds tokens [d Tl, (d + 1) Tl)); `group` the rank's
    TPGroup, whose dp group is the ring (None: one replica). cache_k/v:
    optional prior rows [1, S, Nk, H], the same on every replica, of which
    rows j < cache_len are visible to every query. Returns [1, Tl, Nq, H]
    in q's type."""
    b, tl, nq, h = q.shape
    nk = k.shape[2]
    g = nq // nk
    scale = h ** -0.5 if sm_scale is None else float(sm_scale)
    dp = group.dp_size if collectives.dp_active(group) else 1
    me = group.dp_rank if dp > 1 else 0
    qg = q.reshape(b, tl, nk, g, h)
    dev = q.device
    state = (torch.zeros((nk, tl, g, h), dtype=torch.float32, device=dev),
             torch.full((nk, tl, g, 1), NEG_INF, dtype=torch.float32,
                        device=dev),
             torch.zeros((nk, tl, g, 1), dtype=torch.float32, device=dev))
    rows = torch.arange(tl, device=dev)[:, None]
    cols = torch.arange(tl, device=dev)[None, :]
    kb, vb = k, v
    for step in range(dp):
        src = (me - step) % dp  # the replica whose block this one holds
        state = _fold(state, qg, kb, vb,
                      src * tl + cols <= me * tl + rows, scale)
        if step + 1 < dp:
            # one hop for both: K and V travel as one [2, 1, Tl, Nk, H]
            kv = collectives.rotate(torch.stack([kb, vb]), group)
            kb, vb = kv[0], kv[1]
    if cache_k is not None:
        if cache_len is None:
            raise ValueError("cache_k without cache_len")
        visible = torch.arange(cache_k.shape[1], device=dev)[None, :] \
            < cache_len
        state = _fold(state, qg, cache_k, cache_v, visible, scale)
    acc, _, l = state
    out = acc / torch.clamp(l, min=1e-30)  # [Nk, Tl, G, H]
    return out.permute(1, 0, 2, 3).reshape(b, tl, nq, h).to(q.dtype)
