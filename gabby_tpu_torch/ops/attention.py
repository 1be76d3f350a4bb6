"""Grouped-query attention contracts (counterpart of gabby_tpu/ops/attention.py).

The plain PyTorch bodies here (the *_reference functions) are the
semantics the kernels are held to. `cache_attention` and
`cache_attention_quantized` (decode over a bf16 and an int8 cache, with
or without fresh rows, stacked with `layer` or not), `slot_prefill_attention`
(chunked prefill, fresh-block form), `verify_attention` (speculative
verify, T candidate positions per slot) and `paged_attention` (decode and
verify against the paged pool) dispatch to their CUDA kernels
(ops/cuda/attention.py, ops/cuda/prefill_attention.py,
ops/cuda/paged_attention.py), which take plain bodies for CPU tensors (of
any float type). On the GPU the cache is int8 with scales or bf16 without
(the reference's k_scale=None form); another type raises. Every contract
takes the paired cache layout too ([.., Nk/2, S, 2H], detected by the lane
width; scales per head) and un-pairs it for the plain bodies.
Single-position decode with fresh rows over an int8 cache takes the s8
form when `ops.cuda.attn_s8()` is on (the default), else the bf16/f32
form; verify, prefill, every bf16-cache form and the no-fresh-row forms
have no s8 form. Math runs in f32; outputs return in q's dtype. While
torch.profiler records, each of these entries and `causal_attention` is a
`gabby.attn` span (runtime/tracing.py).

The reference's kernel switches (ops/cuda/__init__.py) hold here too:
with `kernels_enabled()` off every contract takes its plain body, card
tensors included; `prefill_pair()` off sends paired prefill to it;
`attn_kernel()` forces the single-position decode route either way.

One designed divergence: at max_seq < 4096 the reference leaves dense
decode over a bf16 cache to XLA (KERNEL_ATTN_MIN_SEQ,
gabby_tpu/ops/attention.py:33, a TPU measurement). On the GPU the port
takes its kernel at every max_seq while GABBY_ATTN_KERNEL is unset: the
plain body copies the layer's whole cache to f32 in every call, the
kernel reads only the live rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.runtime import tracing
from gabby_tpu_torch.runtime.kv_cache import dequantize_kv, unpaired

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def _split_groups(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[B, T, Nq, H] -> [B, T, Nk, G, H]."""
    b, t, nq, h = q.shape
    return q.reshape(b, t, num_kv_heads, nq // num_kv_heads, h)


def _gqa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q: [B,T,Nk,G,H]; k,v: [B,S,Nk,H]; mask: [B,T,S] bool (True = attend).
    Returns [B, T, Nq, H] f32."""
    scores = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    b, t, nk, g, h = out.shape
    return out.reshape(b, t, nk * g, h)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention. q: [B, T, Nq, H] at positions q_offset..; k, v:
    [B, S, Nk, H] at positions 0..S-1. Query i attends keys j <= q_offset+i."""
    with tracing.span("attn"):
        b, t, nq, h = q.shape
        s = k.shape[1]
        scale = h ** -0.5 if scale is None else scale
        qpos = q_offset + torch.arange(t, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        mask = (kpos <= qpos).expand(b, t, s)
        return _gqa_core(_split_groups(q, k.shape[2]), k, v, mask,
                         scale).to(q.dtype)


def cache_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, positions: torch.Tensor,
                              *, scale: Optional[float] = None,
                              fresh_k: Optional[torch.Tensor] = None,
                              fresh_v: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The decode contract, plain: attention against one layer's head-major
    cache [B, Nk, S, H] (or the paired [B, Nk/2, S, 2H]), in q's dtype.

    q: [B, 1, Nq, H] at positions[b]. Without fresh rows the cache holds the
    current token and rows j <= positions[b] are attended; with fresh_k/v
    ([B, Nk, H], the current token's unquantized k/v) rows j < positions[b]
    are attended plus the fresh row. Output [B, 1, Nq, H] in q's dtype.
    The kernels' plain versions call it; it reaches no kernel."""
    b, _, _, h = q.shape
    k_cache, v_cache = unpaired(k_cache, h), unpaired(v_cache, h)
    nk, s = k_cache.shape[1], k_cache.shape[2]
    scale = h ** -0.5 if scale is None else scale
    kk = k_cache.transpose(1, 2).to(q.dtype)  # [B, S, Nk, H]
    vv = v_cache.transpose(1, 2).to(q.dtype)
    rows = torch.arange(s, device=q.device)[None, :]
    if fresh_k is not None:
        kk = torch.cat([kk, fresh_k[:, None].to(q.dtype)], dim=1)
        vv = torch.cat([vv, fresh_v[:, None].to(q.dtype)], dim=1)
        mask = torch.cat([rows < positions[:, None],
                          torch.ones((b, 1), dtype=torch.bool,
                                     device=q.device)], dim=1)[:, None, :]
    else:
        # one layout whatever the cache's strides (the paired layout's
        # rows un-paired are a strided view), as the concatenation above
        # gives the fresh-row form: the products then sum in one order
        kk, vv = kk.contiguous(), vv.contiguous()
        mask = (rows <= positions[:, None])[:, None, :]
    return _gqa_core(_split_groups(q, nk), kk, vv, mask, scale).to(q.dtype)


def _takes_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                  layer: Optional[int]) -> bool:
    """The reference's condition for its decode kernel: one position,
    query heads that the kv heads divide (paired lanes count two heads),
    the kernels on and GABBY_ATTN_KERNEL not forcing the plain body
    (unset: the kernel at every max_seq, the designed divergence)."""
    paired = k_cache.shape[-1] == 2 * q.shape[-1]
    nk = k_cache.shape[2 if layer is not None else 1] * (2 if paired else 1)
    return (q.shape[1] == 1 and q.shape[2] % nk == 0
            and ck.kernels_enabled() and ck.attn_kernel() is not False)


def _decode_kernel(q, k_cache, v_cache, k_scale, v_scale, positions, *,
                   layer: Optional[int], fresh_k, fresh_v,
                   scale: Optional[float], window: Optional[int]):
    """The decode kernel a single-position call takes, in the reference's
    order: with fresh rows, the slot-batched launch over the unpaired cache
    when `attn_multi()` is on and a slot block divides B (K16, K32), else
    over an int8 cache the s8 form when `attn_s8()` is on (K14, K15), else
    the bf16/f32 form (K3, K12, K24, K25); without fresh rows the
    bf16/f32 form's no-fresh-row kernel (K34-K37). layer=None: one layer's
    cache, viewed as a one-layer stack."""
    k_cache, v_cache, k_scale, v_scale, layer = cattn.stacked(
        k_cache, v_cache, k_scale, v_scale, layer)
    args = (q, k_cache, v_cache, k_scale, v_scale, positions)
    kw = dict(layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale,
              window=window)
    if fresh_k is not None:
        if (ck.attn_multi() and k_cache.shape[-1] == q.shape[-1]
                and cattn.pick_slot_block(q.shape[0]) > 1):
            return cattn.decode_attention_multi(*args, **kw)
        if k_scale is not None and ck.attn_s8():
            return cattn.decode_attention_s8(*args, **kw)
    return cattn.decode_attention(*args, **kw)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, positions: torch.Tensor, *,
                    scale: Optional[float] = None,
                    layer: Optional[int] = None,
                    fresh_k: Optional[torch.Tensor] = None,
                    fresh_v: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention against a head-major unquantized cache
    [B, Nk, S, H] (or the paired [B, Nk/2, S, 2H]), or the stacked
    [L, B, Nk, S, H] with `layer`: the reference's dispatching op.

    q: [B, 1, Nq, H] at positions[b]; contract as
    `cache_attention_reference` (with fresh_k/v [B, Nk, H]: rows
    j < positions[b] plus the fresh row; without: rows j <= positions[b]),
    reading at most `window` rows when given (the caller guarantees it
    covers the slot's rows). A single position whose query heads the kv
    heads divide takes the decode kernel, with or without fresh rows,
    stacked or not (`_decode_kernel`; on the GPU the cache is bf16); CPU
    tensors take the kernel's plain version. One designed divergence: the
    reference leaves a bf16 cache below KERNEL_ATTN_MIN_SEQ rows to XLA
    (see the module's docstring); the port takes the kernel at every
    max_seq."""
    with tracing.span("attn"):
        if _takes_kernel(q, k_cache, layer):
            return _decode_kernel(q, k_cache, v_cache, None, None,
                                  positions, layer=layer, fresh_k=fresh_k,
                                  fresh_v=fresh_v, scale=scale, window=window)
        if layer is not None:
            k_cache, v_cache = k_cache[layer], v_cache[layer]
        return cache_attention_reference(q, k_cache, v_cache, positions,
                                         scale=scale, fresh_k=fresh_k,
                                         fresh_v=fresh_v)


def cache_attention_quantized(q: torch.Tensor, k_codes: torch.Tensor,
                              v_codes: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, positions: torch.Tensor,
                              *, layer: Optional[int] = None,
                              fresh_k: Optional[torch.Tensor] = None,
                              fresh_v: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Decode attention straight off an int8 head-major cache.

    k/v_codes: [B, Nk, S, H] int8, or the stacked [L, B, Nk, S, H] with
    `layer` (or their paired layouts); k/v_scale: [(L,) B, Nk, S] f32.
    Contract as `cache_attention`. A single position whose query heads the
    kv heads divide goes to a flash-decode kernel, which reads only the
    slot's live rows: with fresh rows (the serving path) slot-batched in
    the bf16/f32 form when `attn_multi()` is on, the cache is unpaired and
    a slot block divides B (whatever `attn_s8()` says, as in the
    reference), else the s8 form when `attn_s8()` is on, else the bf16/f32
    form; without fresh rows the no-fresh-row kernel (K34, K35). Otherwise
    the codes are dequantized for the plain contract."""
    with tracing.span("attn"):
        if _takes_kernel(q, k_codes, layer):
            return _decode_kernel(q, k_codes, v_codes, k_scale, v_scale,
                                  positions, layer=layer, fresh_k=fresh_k,
                                  fresh_v=fresh_v, scale=scale, window=window)
        if layer is not None:
            k_codes, v_codes = k_codes[layer], v_codes[layer]
            k_scale, v_scale = k_scale[layer], v_scale[layer]
        h = q.shape[-1]
        kk = dequantize_kv(unpaired(k_codes, h), k_scale, q.dtype)
        vv = dequantize_kv(unpaired(v_codes, h), v_scale, q.dtype)
        return cache_attention_reference(q, kk, vv, positions, scale=scale,
                                         fresh_k=fresh_k, fresh_v=fresh_v)


def slot_prefill_reference(q, k_cache, v_cache, slot: int, offset: int,
                           k_scale=None, v_scale=None, *, fresh_k, fresh_v,
                           layer: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Fresh-block chunked-prefill contract for one slot: q [1, T, Nq, H]
    at positions offset..offset+T-1 attends cache row `slot` at j < offset
    (dequantized when int8) plus the chunk's own k/v ([Nk, T, H]) causally.
    Rows at and past offset are zeroed before the products, so stale or
    NaN values there never reach the output (p = 0 times NaN is NaN)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    h = q.shape[-1]
    row_k = unpaired(k_cache[slot:slot + 1], h)
    row_v = unpaired(v_cache[slot:slot + 1], h)
    if k_scale is not None:
        kk = dequantize_kv(row_k, k_scale[slot:slot + 1], q.dtype)
        vv = dequantize_kv(row_v, v_scale[slot:slot + 1], q.dtype)
    else:
        kk, vv = row_k.to(q.dtype), row_v.to(q.dtype)
    kk, vv = kk.transpose(1, 2), vv.transpose(1, 2)  # [1, S, Nk, H]
    _, t, _, h = q.shape
    sc = h ** -0.5 if scale is None else scale
    s_max = kk.shape[1]
    dev = q.device
    live = torch.arange(s_max, device=dev) < offset
    zero = torch.zeros((), dtype=kk.dtype, device=dev)
    kk = torch.where(live[None, :, None, None], kk, zero)
    vv = torch.where(live[None, :, None, None], vv, zero)
    kk = torch.cat([kk, fresh_k.transpose(0, 1)[None].to(q.dtype)], dim=1)
    vv = torch.cat([vv, fresh_v.transpose(0, 1)[None].to(q.dtype)], dim=1)
    past = live[None, :].expand(t, s_max)
    causal = (torch.arange(t, device=dev)[None, :]
              <= torch.arange(t, device=dev)[:, None])
    mask = torch.cat([past, causal], dim=1)[None]  # [1, T, S+T]
    return _gqa_core(_split_groups(q, fresh_k.shape[0]), kk, vv, mask,
                     sc).to(q.dtype)


def slot_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, slot: int, offset: int,
                           k_scale=None, v_scale=None, *, fresh_k, fresh_v,
                           layer: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention for ONE slot in the fresh-block form: the
    cache is read strictly below `offset` and the chunk attends its own
    k/v ([Nk, T, H]) causally at full precision. Over a stacked cache that
    is the serving path, which goes to the flash-prefill kernel: K4 over
    an int8 cache (K21 when paired), K22 over a bf16 one (K23 when
    paired); as in the reference, not with the kernels off, not over a
    paired cache with `prefill_pair()` off, and not where the kv heads do
    not divide the query heads."""
    with tracing.span("attn"):
        paired = k_cache.shape[-1] == 2 * q.shape[-1]
        if (layer is not None and ck.kernels_enabled()
                and (ck.prefill_pair() or not paired)
                and q.shape[2] % fresh_k.shape[0] == 0):
            return cpfa.prefill_attention(q, k_cache, v_cache, k_scale,
                                          v_scale, slot, offset, layer=layer,
                                          fresh_k=fresh_k, fresh_v=fresh_v,
                                          scale=scale)
        return slot_prefill_reference(q, k_cache, v_cache, slot, offset,
                                      k_scale, v_scale, fresh_k=fresh_k,
                                      fresh_v=fresh_v, layer=layer,
                                      scale=scale)


def verify_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               positions: torch.Tensor, k_scale=None,
                               v_scale=None, *, layer: Optional[int] = None,
                               fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Speculative-verify contract: q [B, T, Nq, H], the T candidate
    positions of every slot, attends cache rows j < positions[b] (cache
    [(L,) B, Nk, S, H], dequantized when scales are given) for every query,
    plus the block's own unquantized k/v (fresh_k/v [B, Nk, T, H]) causally.
    Returns [B, T, Nq, H] in q's dtype."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    b, t, _, h = q.shape
    k_cache, v_cache = unpaired(k_cache, h), unpaired(v_cache, h)
    if k_scale is not None:
        kk = dequantize_kv(k_cache, k_scale, q.dtype)
        vv = dequantize_kv(v_cache, v_scale, q.dtype)
    else:
        kk, vv = k_cache.to(q.dtype), v_cache.to(q.dtype)
    s = kk.shape[2]
    sc = h ** -0.5 if scale is None else scale
    kk = torch.cat([kk, fresh_k.to(q.dtype)], dim=2).transpose(1, 2)
    vv = torch.cat([vv, fresh_v.to(q.dtype)], dim=2).transpose(1, 2)
    dev = q.device
    past = (torch.arange(s, device=dev)[None, None, :]
            < positions[:, None, None]).expand(b, t, s)
    causal = (torch.arange(t, device=dev)[None, :]
              <= torch.arange(t, device=dev)[:, None]).expand(b, t, t)
    mask = torch.cat([past, causal], dim=2)  # [B, T, S+T]
    return _gqa_core(_split_groups(q, fresh_k.shape[1]), kk, vv, mask,
                     sc).to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     k_scale=None, v_scale=None, *, layer: int,
                     fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Verify attention against the stacked dense cache [L, B, Nk, S, H].
    That is the serving path, which goes to the flash-verify kernel: K9
    over an int8 cache (K13 when paired), K26 over a bf16 one (K27 when
    paired); it reads rows j < min(positions[b], window). With the kernels
    off, the plain contract (the window covers the slot's rows)."""
    with tracing.span("attn"):
        if not ck.kernels_enabled():
            return verify_attention_reference(
                q, k_cache, v_cache, positions, k_scale, v_scale,
                layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
        return cattn.verify_attention(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer, fresh_k=fresh_k,
                                      fresh_v=fresh_v, scale=scale,
                                      window=window)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor,
                 layer: int) -> torch.Tensor:
    """One layer of a paged pool [P, L, Nk, page, *] gathered through
    page_table [B, max_pages] into the dense view [B, Nk, max_pages * page,
    *] (a copy: the contracts and the tests use it, the kernels do not)."""
    g = pool[:, layer][page_table.long()]  # [B, mp, Nk, page, *]
    g = g.movedim(1, 2)                    # [B, Nk, mp, page, *]
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


def gather_layer(k_pool, v_pool, page_table, k_scale, v_scale, layer,
                 head_dim: int):
    """One layer of the pools (and scale pools, or None) as dense unpaired
    views [B, Nk, max_pages * page, H] and [B, Nk, max_pages * page]."""
    kk = unpaired(gather_pages(k_pool, page_table, layer), head_dim)
    vv = unpaired(gather_pages(v_pool, page_table, layer), head_dim)
    if k_scale is None:
        return kk, vv, None, None
    return (kk, vv, gather_pages(k_scale, page_table, layer),
            gather_pages(v_scale, page_table, layer))


def paged_cache_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          positions: torch.Tensor, k_scale=None, v_scale=None,
                          *, layer: int,
                          fresh_k: Optional[torch.Tensor] = None,
                          fresh_v: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode contract against a paged pool: q [B, 1, Nq, H]; k/v_pool
    [P, L, Nk, page, H] or paired [P, L, Nk/2, page, 2H] (+ scale pools
    [P, L, Nk, page] when int8); page_table [B, max_pages] int32. The
    layer's pages are gathered through the table, then the dense contract
    applies (`cache_attention_reference`): rows j < positions[b] plus the
    current token's unquantized fresh_k/v [B, Nk, H], or without them rows
    j <= positions[b]."""
    kk, vv, ks, vs = gather_layer(k_pool, v_pool, page_table, k_scale,
                                  v_scale, layer, q.shape[-1])
    if ks is not None:
        kk = dequantize_kv(kk, ks, q.dtype)
        vv = dequantize_kv(vv, vs, q.dtype)
    return cache_attention_reference(q, kk, vv, positions, scale=scale,
                                     fresh_k=fresh_k, fresh_v=fresh_v)


def paged_verify_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           positions: torch.Tensor, k_scale=None,
                           v_scale=None, *, layer: int,
                           fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Verify contract against a paged pool: the layer's pages gathered
    through the table, then `verify_attention_reference`."""
    kk, vv, ks, vs = gather_layer(k_pool, v_pool, page_table, k_scale,
                                  v_scale, layer, q.shape[-1])
    return verify_attention_reference(q, kk, vv, positions, ks, vs,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    positions: torch.Tensor, k_scale=None, v_scale=None, *,
                    layer: int, fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q [B, T, Nq, H] against the paged pool: decode (T = 1,
    fresh_k/v [B, Nk, H]) or verify (T > 1, fresh_k/v [B, Nk, T, H]). That
    is the serving path, which goes to the paged kernels: they read the
    page table themselves. Over int8 pools decode takes the s8 form when
    `attn_s8()` is on, else the bf16/f32 form; verify and bf16 pools have
    only the latter. With the kernels off, the plain contracts."""
    with tracing.span("attn"):
        t = q.shape[1]
        args = (q, k_pool, v_pool, page_table, positions, k_scale, v_scale)
        kw = dict(layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
        if not ck.kernels_enabled():
            return (paged_cache_attention if t == 1
                    else paged_verify_reference)(*args, **kw)
        if t == 1 and k_scale is not None and ck.attn_s8():
            return cpaged.paged_decode_attention_s8(*args, **kw)
        if t == 1:
            return cpaged.paged_decode_attention(*args, **kw)
        return cpaged.paged_verify_attention(*args, **kw)
