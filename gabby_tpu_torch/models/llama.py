"""Llama-3 forward pass in PyTorch (counterpart of gabby_tpu/models/llama.py).

* Layer weights stay STACKED along a leading [num_layers] axis, and a Python
  loop over the layer index takes the place of the reference's `lax.scan`.
  Quantized stacks reach their kernels whole, with the layer as a pointer
  offset: no layer is ever sliced or copied out of a stack.
* Params are a plain dict of tensors; quantized leaves are ops/quant.QTensor
  and `linear()` dispatches on the leaf type.
* The KV cache (dense KVCache or PagedKVCache; `decode_step`,
  `prefill_slot`, `prefill_hidden` and `verify_step` dispatch on its type)
  is updated IN PLACE, layer by layer, around that layer's attention
  (after it, or before it where the attention reads the chunk's rows back
  from the cache, as the dense batched prefill does, or where one kernel
  writes the decode step's rows with its q, as the decode_prologue kernel
  does on the card). The reference instead collects every
  layer's new rows and writes them once after the scan (in-place writes
  inside the scan made XLA copy the cache); the read contract is the same
  either way — attention sees cache rows j < position plus the current
  token's (or chunk's) own unquantized k/v.
* A paired cache (kv heads 2p and 2p + 1 side by side on the last axis,
  detected by its lane width) changes only how rows are stored: single
  rows and verify blocks pair by a reshape (adjacent heads are adjacent in
  memory), head-major prefill chunks through `pair_heads`. Attention gets
  the fresh k/v head-major either way.
* Tensor parallelism (gabby_tpu_torch/parallel/): a rank's local tree
  (sharding.shard_params) carries its TPGroup under params["tp"]
  (sharding.bind_group), so every step reaches its collectives through the
  params it is given. Each step then computes with the rank's head counts
  and FFN width (sharding.local_config) and takes the seams the
  reference's GSPMD inserts: the vocab-sharded embedding lookup, one
  all-reduce after `wo` and one after `w_down` in every layer, and the
  vocab gather of the unembed's logits (parallel/collectives.py). A tree
  without a group (tp = 1) calls no collective.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gabby_tpu_torch import resolve_device
from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.attention import (cache_attention,
                                           cache_attention_quantized,
                                           causal_attention,
                                           paged_attention,
                                           slot_prefill_attention,
                                           verify_attention)
from gabby_tpu_torch.ops.cuda import decode_prologue as cprologue
from gabby_tpu_torch.ops.linear import linear
from gabby_tpu_torch.ops.norms import rms_norm
from gabby_tpu_torch.ops.quant import QTensor
from gabby_tpu_torch.ops.rope import apply_rope, rope_inv_freq
from gabby_tpu_torch.parallel import collectives
from gabby_tpu_torch.parallel.sharding import local_config
from gabby_tpu_torch.runtime.kv_cache import (KVCache, dequantize_kv,
                                              lane_indices, pair_heads,
                                              quantize_kv, unpaired)
from gabby_tpu_torch.runtime.paged import (PagedKVCache, gather_slot_rows,
                                           write_batch_chunk, write_rows,
                                           write_slot_chunk)

Params = dict[str, Any]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random-normal params (tests, benchmarks, random-weight serving),
    drawn from `generator` (default: seed 0 on `device`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f, v, nl = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_layers)

    def w(*shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * fan_in ** -0.5).to(dtype)

    return {
        "embed": w(v, d, fan_in=d),
        "blocks": {
            "attn_norm": torch.ones((nl, d), dtype=dtype, device=dev),
            "mlp_norm": torch.ones((nl, d), dtype=dtype, device=dev),
            "wq": w(nl, d, cfg.q_dim, fan_in=d),
            "wk": w(nl, d, cfg.kv_dim, fan_in=d),
            "wv": w(nl, d, cfg.kv_dim, fan_in=d),
            "wo": w(nl, cfg.q_dim, d, fan_in=cfg.q_dim),
            "w_gate": w(nl, d, f, fan_in=d),
            "w_up": w(nl, d, f, fan_in=d),
            "w_down": w(nl, f, d, fan_in=f),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "lm_head": None if cfg.tie_word_embeddings else w(d, v, fan_in=d),
    }


def params_from_numpy(tree, dtype=None, device=None) -> Params:
    """Carry a params tree across from numpy: nested dicts whose leaves are
    numpy arrays, None, or quantized leaves given as dicts
    {"q", "scale", "bits", "group"}. Floating arrays are cast to `dtype`
    when given; codes and scales keep their types."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            if set(node) == {"q", "scale", "bits", "group"}:
                return QTensor(
                    q=torch.from_numpy(np.ascontiguousarray(node["q"])).to(dev),
                    scale=torch.from_numpy(np.ascontiguousarray(
                        node["scale"], dtype=np.float32)).to(dev),
                    bits=int(node["bits"]), group=int(node["group"]))
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def fuse_projections(params: Params, tp: int = 1) -> Params:
    """wq|wk|wv -> wqkv and w_gate|w_up -> w_gup, concatenated along the
    output axis (codes and per-channel scales alike for QTensors), so each
    group runs as ONE product per layer. Returns a new params dict.

    tp: the number of ranks the fused tree will be column-sharded over.
    The columns are laid out per shard, [q0|k0|v0 | q1|k1|v1 | ...] where
    x_i is shard i's block of x, so rank i's contiguous block of the fused
    columns is exactly its own q/k/v (gate/up); `_split_fused` recovers
    the parts. tp = 1 is the plain concatenation. Every projection's
    output dim must divide by tp. A checkpoint of such a tree records tp
    as its config's fused_tp; a rank's own shard fuses with tp = 1."""
    def shard_cat(arrs):
        if tp == 1:
            return torch.cat(arrs, dim=-1)
        for a in arrs:
            if a.shape[-1] % tp:
                raise ValueError(
                    f"fuse_projections(tp={tp}): output dim {a.shape[-1]} "
                    f"does not divide by the model-axis size")
        parts = [a.reshape(*a.shape[:-1], tp, a.shape[-1] // tp)
                 for a in arrs]
        out = torch.cat(parts, dim=-1)  # [..., tp, block]
        return out.reshape(*out.shape[:-2], -1)

    def cat(leaves):
        if isinstance(leaves[0], QTensor):
            if len({leaf.bits for leaf in leaves}) != 1:
                raise ValueError("cannot fuse mixed-precision projections")
            return QTensor(q=shard_cat([leaf.q for leaf in leaves]),
                           scale=shard_cat([leaf.scale for leaf in leaves]),
                           bits=leaves[0].bits)
        return shard_cat(leaves)

    blocks = dict(params["blocks"])
    if "wq" in blocks:
        blocks["wqkv"] = cat([blocks.pop("wq"), blocks.pop("wk"),
                              blocks.pop("wv")])
    if "w_gate" in blocks:
        blocks["w_gup"] = cat([blocks.pop("w_gate"), blocks.pop("w_up")])
    out = dict(params)
    out["blocks"] = blocks
    return out


def _split_fused(y: torch.Tensor, dims: tuple[int, ...],
                 tp: int) -> list[torch.Tensor]:
    """Split a fused projection's output into its logical parts. For tp > 1
    the columns are [shard0: a0|b0|c0, shard1: ...] (fuse_projections):
    expose the shard axis, slice each part's block, merge the shards."""
    if tp == 1:
        return list(torch.split(y, dims, dim=-1))
    ys = y.reshape(*y.shape[:-1], tp, sum(dims) // tp)
    outs, off = [], 0
    for d in dims:
        part = ys[..., off:off + d // tp]
        outs.append(part.reshape(*part.shape[:-2], d))
        off += d // tp
    return outs


def _tp_view(params: Params, cfg: ModelConfig):
    """(the config this rank computes with, its TPGroup or None)."""
    group = params.get("tp")
    if group is None:
        return cfg, None
    return local_config(cfg, group.size), group


def _embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return collectives.embed(ids, params["embed"], params.get("tp"))


@functools.lru_cache(maxsize=16)
def _inv_freq(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_inv_freq(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device)


def _qkv(cfg: ModelConfig, blk: Params, x: torch.Tensor,
         positions: torch.Tensor, layer: int):
    b, t, _ = x.shape
    if "wqkv" in blk:
        q, k, v = _split_fused(linear(x, blk["wqkv"], layer),
                               (cfg.q_dim, cfg.kv_dim, cfg.kv_dim),
                               cfg.fused_tp)
    else:
        q = linear(x, blk["wq"], layer)
        k = linear(x, blk["wk"], layer)
        v = linear(x, blk["wv"], layer)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    inv_freq = _inv_freq(cfg, x.device)
    return (apply_rope(q, positions, inv_freq),
            apply_rope(k, positions, inv_freq), v)


def _mlp(cfg: ModelConfig, blk: Params, x: torch.Tensor,
         layer: int, group=None) -> torch.Tensor:
    if "w_gup" in blk:
        gate, up = _split_fused(linear(x, blk["w_gup"], layer).float(),
                                (cfg.intermediate_size,) * 2, cfg.fused_tp)
    else:
        gate = linear(x, blk["w_gate"], layer).float()
        up = linear(x, blk["w_up"], layer).float()
    return collectives.all_reduce_sum(
        linear((F.silu(gate) * up).to(x.dtype), blk["w_down"], layer), group)


def _unembed(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed -> f32 logits over the TRUE vocab (the int4
    table's padded columns are sliced off before sampling sees them;
    a rank's vocab shard is gathered first)."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if params.get("lm_head") is not None:
        out = linear(h, params["lm_head"]).float()
    else:
        out = torch.matmul(h.float(), params["embed"].float().T)
    return collectives.gather_vocab(out, params.get("tp"), cfg.vocab_size)


def _block_tail(cfg: ModelConfig, blocks: Params, h: torch.Tensor,
                attn: torch.Tensor, layer: int, group=None) -> torch.Tensor:
    """Output projection + residual, then the MLP half of the block."""
    b, t = h.shape[:2]
    h = h + collectives.all_reduce_sum(
        linear(attn.reshape(b, t, cfg.q_dim), blocks["wo"], layer), group)
    xn2 = rms_norm(h, blocks["mlp_norm"][layer], cfg.rms_norm_eps)
    return h + _mlp(cfg, blocks, xn2, layer, group)


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Cache-free full forward: [B, T] -> f32 logits [B, T, V]."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    h = _embed(params, tokens)
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions, layer)
        h = _block_tail(cfg, blocks, h, causal_attention(q, k, v), layer,
                        group)
    return _unembed(params, cfg, h)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache, *, offset: int = 0) -> tuple[torch.Tensor, Any]:
    """Process a [B, T] chunk of prompt tokens at positions offset..
    offset+T-1 of every slot, writing its k/v into the cache (if given).
    Returns (f32 logits [B, T, V], cache)."""
    h, cache = prefill_hidden(params, cfg, tokens, cache, offset=offset)
    return _unembed(params, cfg, h), cache


def prefill_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache, *, offset: int = 0,
                   lane_mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, Any]:
    """prefill() without the unembed: final hidden states [B, T, D] (serving
    gathers each row's last valid position first, then unembeds [B, 1, D]).

    lane_mask: optional [B] bool; cache rows are written ONLY for its lanes
    (burst admission: free slots prefill together while the other slots'
    rows, possibly live, stay as they were). The masked lanes' rows are
    written in place, before the layer's attention. At offset 0 the chunk
    attends to itself; past it, to the slot's rows [0, offset + T) read back
    from the cache (dequantized, un-paired: the chunk's own rows as stored),
    through the plain `causal_attention`, as the reference does in jnp."""
    if isinstance(cache, PagedKVCache):
        return _prefill_hidden_paged(params, cfg, tokens, cache,
                                     offset=offset, lane_mask=lane_mask)
    b, t = tokens.shape
    if cache is not None and offset + t > cache.max_seq:
        raise ValueError(f"chunk [{offset}, {offset + t}) overruns the "
                         f"cache ({cache.max_seq} rows)")
    if cache is None and offset:
        raise ValueError("a chunk past offset 0 needs a cache")
    positions = (offset + torch.arange(t, device=tokens.device)).expand(b, t)
    h = _embed(params, tokens)
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    lanes = lane_indices(lane_mask, b, tokens.device)
    rows = slice(offset, offset + t)
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions, layer)
        if cache is not None:
            kr, vr, k_s, v_s = _quantized_rows(
                cache, k.transpose(1, 2), v.transpose(1, 2), head_major=True)
            cache.k[layer][lanes, :, rows] = kr[lanes]
            cache.v[layer][lanes, :, rows] = vr[lanes]
            if cache.quantized:
                cache.k_scale[layer][lanes, :, rows] = k_s[lanes]
                cache.v_scale[layer][lanes, :, rows] = v_s[lanes]
        if offset == 0:
            kk, vv = k, v
        else:
            kk, vv = _token_major(
                *(None if x is None else x[layer][:, :, :offset + t]
                  for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)),
                cfg.head_dim, k.dtype)
        h = _block_tail(cfg, blocks, h,
                        causal_attention(q, kk, vv, q_offset=offset), layer,
                        group)
    return h, cache


def _token_major(k, v, k_scale, v_scale, head_dim: int, dtype):
    """Cache rows k, v [B, Nk, S, H] (or paired), with scales [B, Nk, S]
    when int8, as token-major [B, S, Nk, H] k and v in `dtype`: un-paired
    and dequantized, what the plain `causal_attention` takes."""
    k, v = unpaired(k, head_dim), unpaired(v, head_dim)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, dtype)
        v = dequantize_kv(v, v_scale, dtype)
    return k.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2)


def _prefill_hidden_paged(params: Params, cfg: ModelConfig,
                          tokens: torch.Tensor, cache: PagedKVCache, *,
                          offset: int = 0,
                          lane_mask: Optional[torch.Tensor] = None):
    """prefill_hidden against the paged pool: each layer's chunk rows land
    in the masked lanes' pages with one page-granular write per pool
    (`paged.write_batch_chunk`) after the layer's attention. Past offset 0,
    the rows below `offset` are gathered from every slot's pages into a
    dense view (one layer at a time, a per-chunk cost), dequantized and
    un-paired, and the chunk's own unquantized k/v follow them, as in the
    reference. Offset and chunk length must be page-aligned."""
    b, t = tokens.shape
    ps = cache.page_size
    if offset % ps or t % ps or offset + t > cache.max_seq:
        raise ValueError(f"chunk [{offset}, {offset + t}) must be aligned to "
                         f"the page size {ps} and fit {cache.max_seq} rows")
    positions = (offset + torch.arange(t, device=tokens.device)).expand(b, t)
    h = _embed(params, tokens)
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    phys = cache.page_table[:, :offset // ps].long()  # [B, pages below]

    def densify(pool, layer):
        g = pool[phys, layer].movedim(1, 2)  # [B, Nk, pages, page, ...]
        return g.reshape(b, g.shape[1], offset, *g.shape[4:])

    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions, layer)
        if offset == 0:
            kk, vv = k, v
        else:
            kp, vp = _token_major(
                *(None if x is None else densify(x, layer)
                  for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)),
                cfg.head_dim, k.dtype)
            kk, vv = torch.cat([kp, k], dim=1), torch.cat([vp, v], dim=1)
        attn = causal_attention(q, kk, vv, q_offset=offset)
        write_batch_chunk(
            cache, offset, *_quantized_rows(cache, k.transpose(1, 2),
                                            v.transpose(1, 2),
                                            head_major=True),
            lane_mask, layer=layer)
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    return h, cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: KVCache, *,
                window: Optional[int] = None,
                attn_positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, KVCache]:
    """One decode step for a batch of slots.

    tokens: [B] current token per slot; positions: [B] int32 cache index
    where its k/v land. attn_positions: [B] read bound per slot when it
    differs (the engine gives parked lanes 1, so a dead lane reads one row).
    window: upper bound on every slot's live context (attention reads at
    most `window` rows). Returns (f32 logits [B, V], cache updated in place).
    """
    if isinstance(cache, PagedKVCache):
        return _decode_step_paged(params, cfg, tokens, positions, cache,
                                  attn_positions=attn_positions)
    b = tokens.shape[0]
    read_pos = (positions if attn_positions is None
                else attn_positions).to(torch.int32)
    h = _embed(params, tokens[:, None])  # [B, 1, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    fused = _prologue_kernel(cfg, blocks, cache)
    if fused:
        inv_freq = _inv_freq(cfg, tokens.device)
    else:
        # a lane the loop deactivated at the cache cap still writes (no
        # active gating): clamp its row like the reference's
        # dynamic_update_slice
        write_pos = torch.clamp(positions.long(), max=cache.max_seq - 1)
        lanes = torch.arange(b, device=tokens.device)
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        if fused:
            # one launch from the product to the attention's inputs; the
            # layer's rows land here, in no row the attention reads
            q, fresh_k, fresh_v = cprologue.decode_prologue(
                linear(xn, blocks["wqkv"], layer), positions, inv_freq,
                cache.k, cache.v, cache.k_scale, cache.v_scale, layer=layer,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
        else:
            q, k, v = _qkv(cfg, blocks, xn, positions[:, None], layer)
            fresh_k, fresh_v = k[:, 0], v[:, 0]  # [B, Nk, H]
        if cache.quantized:
            attn = cache_attention_quantized(
                q, cache.k, cache.v, cache.k_scale, cache.v_scale, read_pos,
                layer=layer, fresh_k=fresh_k.contiguous(),
                fresh_v=fresh_v.contiguous(), window=window)
        else:
            attn = cache_attention(
                q, cache.k, cache.v, read_pos, layer=layer,
                fresh_k=fresh_k.contiguous(), fresh_v=fresh_v.contiguous(),
                window=window)
        if not fused:
            kr, vr, k_s, v_s = _quantized_rows(cache, fresh_k, fresh_v)
            cache.k[layer][lanes, :, write_pos] = kr
            cache.v[layer][lanes, :, write_pos] = vr
            if cache.quantized:
                cache.k_scale[layer][lanes, :, write_pos] = k_s
                cache.v_scale[layer][lanes, :, write_pos] = v_s
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    return _unembed(params, cfg, h)[:, 0], cache


def _prologue_kernel(cfg: ModelConfig, blocks: Params,
                     cache: KVCache) -> bool:
    """Whether `decode_step`'s layers take the decode_prologue kernel (K42)
    from the fused q|k|v product to the attention's inputs: on the card,
    with the kernels on, over the dense int8 cache, for a tree fused at tp
    = 1 (a tp > 1 fusion interleaves the shards' columns) and a head_dim
    the kernel is built for. Every other decode step takes the eager chain,
    as do the steps that never come here: the multi-position ones
    (prefill, the burst chunk, verify) and the paged pool's."""
    return (cache.k.is_cuda and cache.quantized and "wqkv" in blocks
            and cfg.fused_tp == 1 and cfg.head_dim in cprologue.HEAD_DIMS
            and ck.kernels_enabled())


def _quantized_rows(cache, k: torch.Tensor, v: torch.Tensor, *,
                    head_major: bool = False):
    """The rows to store for fresh k/v: int8 codes and f32 scales (per
    head) for a quantized cache, else the cache's dtype and no scales. k/v
    are token-major [..., Nk, H], or head-major [Nk, T, H] chunks with
    `head_major`; for a paired cache the rows come back paired
    ([..., Nk/2, 2H], a reshape, or [Nk/2, T, 2H] through pair_heads)."""
    if cache.quantized:
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
    else:
        k, v, k_s, v_s = k.to(cache.k.dtype), v.to(cache.v.dtype), None, None
    if cache.k.shape[-1] == 2 * k.shape[-1]:
        if head_major:
            k, v = pair_heads(k), pair_heads(v)
        else:
            lead, (nk, hd) = k.shape[:-2], k.shape[-2:]
            k = k.reshape(*lead, nk // 2, 2 * hd)
            v = v.reshape(*lead, nk // 2, 2 * hd)
    return k, v, k_s, v_s


def _decode_step_paged(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       cache: PagedKVCache, *,
                       attn_positions: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, PagedKVCache]:
    """decode_step against a paged pool: attention reads each slot's rows
    through the page table (K10 over int8 pools, K28 over bf16 ones), and
    each layer's fresh row is written through the table after that layer's
    attention. A lane whose position is frozen at max_seq writes to the
    scratch page."""
    read_pos = (positions if attn_positions is None
                else attn_positions).to(torch.int32)
    h = _embed(params, tokens[:, None])  # [B, 1, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions[:, None], layer)
        attn = paged_attention(
            q, cache.k, cache.v, cache.page_table, read_pos, cache.k_scale,
            cache.v_scale, layer=layer, fresh_k=k[:, 0].contiguous(),
            fresh_v=v[:, 0].contiguous())
        write_rows(cache, positions[:, None], *_quantized_rows(cache, k, v),
                   layer=layer)
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    return _unembed(params, cfg, h)[:, 0], cache


def prefill_slot(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 length: int, slot: int, offset: int,
                 cache) -> tuple[torch.Tensor, KVCache]:
    """Prefill ONE cache slot with a (padded) chunk of prompt tokens.

    tokens: [T] int, valid in [:length]; the chunk sits at global positions
    offset..offset+T-1 of row `slot` (offset + T <= max_seq). Attention
    reads cache rows j < offset plus the chunk's own k/v causally; the
    chunk's rows (padding included, as in the reference) are written after
    each layer's attention. Returns (f32 logits [V] at the last valid
    token, cache updated in place)."""
    if isinstance(cache, PagedKVCache):
        return _prefill_slot_paged(params, cfg, tokens, length, slot, offset,
                                   cache)
    t = tokens.shape[0]
    if offset + t > cache.max_seq:
        raise ValueError(f"chunk [{offset}, {offset + t}) overruns the "
                         f"cache ({cache.max_seq} rows)")
    positions = offset + torch.arange(t, device=tokens.device)
    h = _embed(params, tokens[None, :])  # [1, T, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions[None, :], layer)
        kt = k[0].transpose(0, 1).contiguous()  # [Nk, T, H]
        vt = v[0].transpose(0, 1).contiguous()
        rows = slice(offset, offset + t)
        attn = slot_prefill_attention(
            q, cache.k, cache.v, slot, offset, cache.k_scale, cache.v_scale,
            fresh_k=kt, fresh_v=vt, layer=layer)
        kr, vr, k_s, v_s = _quantized_rows(cache, kt, vt, head_major=True)
        cache.k[layer, slot, :, rows] = kr
        cache.v[layer, slot, :, rows] = vr
        if cache.quantized:
            cache.k_scale[layer, slot, :, rows] = k_s
            cache.v_scale[layer, slot, :, rows] = v_s
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    # unembed only the last valid position (one row, not T)
    logits = _unembed(params, cfg, h[:, length - 1:length])[0, 0]
    return logits, cache


def _prefill_slot_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, length: int, slot: int,
                        offset: int, cache: PagedKVCache
                        ) -> tuple[torch.Tensor, PagedKVCache]:
    """prefill_slot against a paged pool. Per layer, the slot's pages below
    `offset` are gathered into a dense one-slot view (a per-chunk cost on
    the order of the rows attention reads anyway), the chunk runs the dense
    slot-prefill attention over it (K4 over int8 pools, K22 over bf16
    ones, K21 and K23 over paired ones: the gathered view keeps the pool's
    layout), and the chunk's rows land with one page-granular write per
    pool. Chunk length and offset must be page-aligned (the engine's paged
    bucket ladder)."""
    t = tokens.shape[0]
    ps = cache.page_size
    if offset % ps or t % ps or offset + t > cache.max_seq:
        raise ValueError(f"chunk [{offset}, {offset + t}) must be aligned to "
                         f"the page size {ps} and fit {cache.max_seq} rows")
    positions = offset + torch.arange(t, device=tokens.device)
    h = _embed(params, tokens[None, :])  # [1, T, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    past = max(offset, ps)  # at least one page: the view is never empty
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions[None, :], layer)
        kt = k[0].transpose(0, 1).contiguous()  # [Nk, T, H]
        vt = v[0].transpose(0, 1).contiguous()
        gk, gv, gks, gvs = gather_slot_rows(cache, slot, past, layer=layer)
        if cache.quantized:
            gks, gvs = gks[None, None], gvs[None, None]
        attn = slot_prefill_attention(
            q, gk[None, None], gv[None, None], 0, offset, gks, gvs,
            fresh_k=kt, fresh_v=vt, layer=0)
        write_slot_chunk(cache, slot, offset,
                         *_quantized_rows(cache, kt, vt, head_major=True),
                         layer=layer)
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    logits = _unembed(params, cfg, h[:, length - 1:length])[0, 0]
    return logits, cache


def verify_step(params: Params, cfg: ModelConfig, tokens_bt: torch.Tensor,
                positions0: torch.Tensor, cache, *,
                window: Optional[int] = None,
                attn_positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, KVCache]:
    """Speculative-decoding verify pass: score T candidate tokens per slot
    in ONE forward (the weights stream once for T positions).

    tokens_bt: [B, T]; tokens_bt[:, 0] is each slot's CURRENT token (at
    cache position positions0[b]), columns 1.. are draft tokens for the
    following positions. Queries attend cache rows j < positions0[b] (or
    attn_positions[b]) plus the T-token block itself causally at full
    precision. Returns (f32 logits [B, T, V], cache with row i of the block
    written at positions0[b] + i).

    No rollback is needed: rows written for rejected drafts sit at positions
    the slot has not reached, and are overwritten before anything reads
    them. Near the cap a row at position >= max_seq is not written: the
    block's rows are gathered so that every write past the cap repeats the
    row that belongs at max_seq - 1, which leaves earlier rows untouched
    (a lane whose position is frozen at max_seq rewrites row max_seq - 1,
    as in `decode_step`)."""
    if isinstance(cache, PagedKVCache):
        return _verify_step_paged(params, cfg, tokens_bt, positions0, cache,
                                  attn_positions=attn_positions)
    b, t = tokens_bt.shape
    dev = tokens_bt.device
    read_pos = (positions0 if attn_positions is None
                else attn_positions).to(torch.int32)
    steps = torch.arange(t, device=dev)
    positions = positions0[:, None] + steps  # [B, T]
    last = cache.max_seq - 1
    src = torch.clamp(torch.minimum(steps[None, :],
                                    last - positions0[:, None].long()), min=0)
    rows = torch.clamp(positions0[:, None].long() + src, max=last)  # [B, T]
    lanes = torch.arange(b, device=dev)[:, None]
    h = _embed(params, tokens_bt)  # [B, T, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions, layer)
        attn = verify_attention(
            q, cache.k, cache.v, read_pos, cache.k_scale, cache.v_scale,
            layer=layer, fresh_k=k.transpose(1, 2).contiguous(),
            fresh_v=v.transpose(1, 2).contiguous(), window=window)
        kr, vr, k_s, v_s = _quantized_rows(cache, k[lanes, src],
                                           v[lanes, src])
        cache.k[layer][lanes, :, rows] = kr
        cache.v[layer][lanes, :, rows] = vr
        if cache.quantized:
            cache.k_scale[layer][lanes, :, rows] = k_s
            cache.v_scale[layer][lanes, :, rows] = v_s
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    return _unembed(params, cfg, h), cache


def _verify_step_paged(params: Params, cfg: ModelConfig,
                       tokens_bt: torch.Tensor, positions0: torch.Tensor,
                       cache: PagedKVCache, *,
                       attn_positions: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, PagedKVCache]:
    """verify_step against the paged pool: attention through the page table
    (K11 over int8 pools, K30 over bf16 ones); the block's rows land row
    by row through the table (a T-row block may straddle a page boundary),
    rows at positions >= max_seq or past the slot's allocation on the
    scratch page. The engine provisions pages to the verify horizon before
    each call."""
    t = tokens_bt.shape[1]
    read_pos = (positions0 if attn_positions is None
                else attn_positions).to(torch.int32)
    positions = positions0[:, None] + torch.arange(t,
                                                   device=tokens_bt.device)
    h = _embed(params, tokens_bt)  # [B, T, D]
    cfg, group = _tp_view(params, cfg)
    blocks = params["blocks"]
    for layer in range(cfg.num_layers):
        xn = rms_norm(h, blocks["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, blocks, xn, positions, layer)
        attn = paged_attention(
            q, cache.k, cache.v, cache.page_table, read_pos, cache.k_scale,
            cache.v_scale, layer=layer,
            fresh_k=k.transpose(1, 2).contiguous(),
            fresh_v=v.transpose(1, 2).contiguous())
        write_rows(cache, positions, *_quantized_rows(cache, k, v),
                   layer=layer)
        h = _block_tail(cfg, blocks, h, attn, layer, group)
    return _unembed(params, cfg, h), cache
