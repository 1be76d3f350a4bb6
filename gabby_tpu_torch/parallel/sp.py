"""Sequence-parallel prefill of one long admission chunk (counterpart of
gabby_tpu/parallel/sp.py).

Decode slots shard over the data-parallel replicas, but one prompt sits in
one slot, so a long admission leaves every replica but its owner idle.
Sequence-parallel prefill puts them to work on the chunk's TOKEN axis:
replica d takes tokens [d T/dp, (d + 1) T/dp) of the chunk, so the
embedding, the norms, the projections, RoPE and the MLP each run on T/dp
tokens (no communication: they are pointwise over tokens). Causal
attention mixes tokens across replicas: the chunk's K/V heads (GQA-narrow,
Nk x H lanes) are gathered on every replica (`collectives.gather_tokens`,
the all-gather the reference's GSPMD inserts: the Ulysses trade), or, with
ring=True, kept sharded and rotated around the ring (parallel/ring.py).
Each replica's queries also read the slot's prior cache rows [0, offset),
which live in the owner replica's cache and reach the others through
`collectives.from_replica`.

The owner replica writes the whole chunk's rows at (slot, offset), int8
codes and scales or the cache's type (under the ring it first gathers the
rows); the hidden state at the last valid token goes to every replica and
the unembed is replicated, so every rank returns the same logits. Inside a
replica the tensor-parallel seams are the model's (parallel/collectives.py
over the tp group). Projections at T/dp rows above 64 take the
dequantize-then-matmul path, as the reference's `linear` does above M = 64.
"""

from __future__ import annotations

import torch

from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops.attention import _gqa_core, _split_groups
from gabby_tpu_torch.ops.norms import rms_norm
from gabby_tpu_torch.parallel import collectives
from gabby_tpu_torch.parallel.ring import ring_self_attention
from gabby_tpu_torch.runtime.kv_cache import KVCache


def sp_prefill_slot(params, cfg: ModelConfig, tokens: torch.Tensor,
                    length: int, slot: int, offset: int, cache: KVCache, *,
                    group, ring: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Sequence-sharded counterpart of llama.prefill_slot for ONE slot of a
    slot-sharded dense cache.

    tokens: the whole [T] chunk (T divisible by dp), valid in [:length], at
    positions offset..offset+T-1; `slot` the global slot, which replica
    slot // cache.batch holds at row slot % cache.batch; `group` the rank's
    TPGroup (its dp group the replicas). Every replica of the group calls
    it with the same arguments. Returns (f32 logits [V] at the last valid
    token, the same on every rank; the cache, the owner's updated in
    place)."""
    dp = group.dp_size if collectives.dp_active(group) else 1
    d = group.dp_rank if dp > 1 else 0
    t = tokens.shape[0]
    if t % dp:
        raise ValueError(f"chunk {t} does not divide over dp={dp}")
    if offset + t > cache.max_seq:
        raise ValueError(f"chunk [{offset}, {offset + t}) overruns the "
                         f"cache ({cache.max_seq} rows)")
    tl = t // dp
    owner, local = divmod(slot, cache.batch)
    mine = d == owner
    positions = offset + d * tl + torch.arange(tl, device=tokens.device)
    h = llama._embed(params, tokens[d * tl:(d + 1) * tl][None, :])
    cfg, tp_group = llama._tp_view(params, cfg)
    nk, hd = cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    blocks = params["blocks"]
    rows = slice(offset, offset + t)
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = llama._qkv(cfg, blocks, xn, positions[None, :], layer)
        prior = None
        if offset:
            # the slot's rows [0, offset), dequantized and un-paired, from
            # the owner's cache: [2, 1, offset, Nk, H]
            if mine:
                prior = torch.stack(llama._token_major(
                    *(None if x is None else x[layer][local:local + 1, :,
                                                      :offset]
                      for x in (cache.k, cache.v, cache.k_scale,
                                cache.v_scale)), hd, q.dtype))
            prior = collectives.from_replica(
                prior, owner, group, shape=(2, 1, offset, nk, hd),
                dtype=q.dtype, device=q.device)
        if ring:
            attn = ring_self_attention(
                q, k, v, group=group, sm_scale=scale,
                cache_k=None if prior is None else prior[0],
                cache_v=None if prior is None else prior[1],
                cache_len=offset)
            chunk_kv = None
        else:
            # the chunk's K/V heads on every replica: [2, 1, T, Nk, H]
            chunk_kv = collectives.gather_tokens(torch.stack([k, v]), group,
                                                 axis=2)
            kk, vv = chunk_kv[0], chunk_kv[1]
            qi = d * tl + torch.arange(tl, device=q.device)[:, None]
            mask = torch.arange(t, device=q.device)[None, :] <= qi
            if prior is not None:
                kk = torch.cat([prior[0], kk], dim=1)
                vv = torch.cat([prior[1], vv], dim=1)
                mask = torch.cat([torch.ones((tl, offset), dtype=torch.bool,
                                             device=q.device), mask], dim=1)
            attn = _gqa_core(_split_groups(q, nk), kk, vv, mask[None],
                             scale).to(q.dtype)
        h = llama._block_tail(cfg, blocks, h, attn, layer, tp_group)
        if chunk_kv is None:
            chunk_kv = collectives.gather_tokens(torch.stack([k, v]), group,
                                                 axis=2)
        if mine:
            kt = chunk_kv[0, 0].transpose(0, 1)  # [Nk, T, H]
            vt = chunk_kv[1, 0].transpose(0, 1)
            kr, vr, k_s, v_s = llama._quantized_rows(cache, kt, vt,
                                                     head_major=True)
            cache.k[layer, local, :, rows] = kr
            cache.v[layer, local, :, rows] = vr
            if cache.quantized:
                cache.k_scale[layer, local, :, rows] = k_s
                cache.v_scale[layer, local, :, rows] = v_s
        del chunk_kv
    # the last valid token's hidden state from the replica that holds it
    holder, at = divmod(length - 1, tl)
    h_last = collectives.from_replica(
        h[:, at:at + 1] if d == holder else None, holder, group,
        shape=(1, 1, h.shape[-1]), dtype=h.dtype, device=h.device)
    return llama._unembed(params, cfg, h_last)[0, 0], cache
