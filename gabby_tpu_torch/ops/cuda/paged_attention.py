"""Decode and verify attention over the paged KV pool and their plain
PyTorch versions (counterparts of
gabby_tpu/ops/pallas/attention.py:paged_decode_attention and
paged_verify_attention in all their forms).

Over the unpaired int8 pool [P, L, Nk, page, H]: K10 decode
(csrc/decode_attention.cu) and K11 verify (csrc/paged_attention.cu, the
verify form of the same kernel at `verify_plan`'s launch) in the bf16/f32
form, K19 decode in the s8 form (csrc/attention_s8.cu, the same
kernel in its s8 form at `s8_plan`'s launch). Over the
paired int8 pool [P, L, Nk/2, page, 2H] (detected by the lane width; scale
pools per head either way): K17, K18 and K20. Over a bf16 pool (no scale
pools, the reference's k_scale=None form): K28 decode and K30 verify,
paired K29 and K31. Without fresh rows (the reference's fresh_k=None
form; csrc/paged_attention.cu): K38 (int8), K39 (int8 paired), K40 (bf16)
and K41 (bf16 paired). They replace _paged_decode_call: the dense decode and
verify contracts, with row j of slot b read from
pool[page_table[b, j // page], layer, kv head, j % page]. The kernels read
the page table themselves and stop at each slot's own position, so nothing
gathers the pool and table entries past a slot's rows are never read. The
kernels are the dense ones' (csrc/decode_attention.cuh at `decode_plan`'s
or `verify_plan`'s launch for the read bound page x max_pages), so on the
same rows under the same plan they give the dense kernels' bits; the
decode forms take the dense ones' groups (1, 2, 3, 4, 8), the verify
forms any.
head_dim is 64 or 128. The wrappers keep their own launch counters. CPU
tensors take the plain versions, which gather the layer's pages into a
dense view; CUDA tensors launch or raise. On the GPU the page size must be
a multiple of 32 rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda.attention import (HEAD_DIMS,
                                                check_block_inputs,
                                                check_cache_form,
                                                check_decode_inputs,
                                                check_verify_block,
                                                decode_launch,
                                                s8_attention_core, s8_plan,
                                                scale_planes, verify_plan)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, positions,
                                 k_scale, v_scale, *, layer: int,
                                 fresh_k=None, fresh_v=None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The reference's contract: gather the layer's pages through the
    table, dequantize, attend rows j < positions[b] plus the fresh row, or
    without fresh rows rows j <= positions[b]."""
    from gabby_tpu_torch.ops.attention import paged_cache_attention
    return paged_cache_attention(q, k_pool, v_pool, page_table, positions,
                                 k_scale, v_scale, layer=layer,
                                 fresh_k=fresh_k, fresh_v=fresh_v,
                                 scale=scale)


def paged_verify_attention_plain(q, k_pool, v_pool, page_table, positions,
                                 k_scale, v_scale, *, layer: int, fresh_k,
                                 fresh_v, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The reference's contract: gather the layer's pages through the
    table, then the dense verify contract."""
    from gabby_tpu_torch.ops.attention import paged_verify_reference
    return paged_verify_reference(q, k_pool, v_pool, page_table, positions,
                                  k_scale, v_scale, layer=layer,
                                  fresh_k=fresh_k, fresh_v=fresh_v,
                                  scale=scale)


def paged_decode_attention_s8_plain(q, k_pool, v_pool, page_table, positions,
                                    k_scale, v_scale, *, layer: int, fresh_k,
                                    fresh_v, scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """The s8 form of the decode contract (`s8_attention_core`) on the
    layer's pages gathered through the table (and un-paired); the
    quantization chunk is a page."""
    from gabby_tpu_torch.ops.attention import gather_layer
    kk, vv, ks, vs = gather_layer(k_pool, v_pool, page_table, k_scale,
                                  v_scale, layer, q.shape[-1])
    return s8_attention_core(
        q, kk, vv, ks, vs, positions, fresh_k, fresh_v,
        float(scale) if scale is not None else q.shape[-1] ** -0.5,
        k_pool.shape[3])


def _check_pool(what: str, q, k_pool, v_pool, page_table, k_scale, v_scale,
                layer: int):
    """Shape and type checks of the pools (int8 with scale pools, or bf16
    with none) against q [B, T, Nq, H]. Returns (Nk, layers, page, pair)."""
    b, _, nq, h = q.shape
    if (k_pool.dim() != 5 or (k_scale is not None and k_scale.dim() != 4)
            or page_table.dim() != 2):
        raise ValueError(f"{what}: unsupported pool {tuple(k_pool.shape)}, "
                         f"table {tuple(page_table.shape)}")
    npages, nl, heads, page, lanes = k_pool.shape
    pair = int(lanes == 2 * h)
    nk = heads * 2 if pair else heads
    check_cache_form(what, k_pool, v_pool, k_scale, v_scale)
    if page_table.dtype != torch.int32:
        raise ValueError(f"{what} takes an int32 page table")
    if (h not in HEAD_DIMS or lanes not in (h, 2 * h)
            or v_pool.shape != k_pool.shape
            or (k_scale is not None
                and (k_scale.shape != (npages, nl, nk, page)
                     or v_scale.shape != k_scale.shape))
            or page_table.shape[0] != b or not 0 <= layer < nl):
        scales = None if k_scale is None else tuple(k_scale.shape)
        raise ValueError(f"{what}: unsupported pool {tuple(k_pool.shape)}, "
                         f"scales {scales}, table "
                         f"{tuple(page_table.shape)}, layer {layer}")
    if page % 32:
        raise ValueError(f"{what}: the page size must be a multiple of 32 "
                         f"rows on the GPU, got {page}")
    return nk, nl, page, pair


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           positions: torch.Tensor,
                           k_scale: Optional[torch.Tensor],
                           v_scale: Optional[torch.Tensor], *, layer: int,
                           fresh_k: Optional[torch.Tensor] = None,
                           fresh_v: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The bf16/f32 form. q [B, 1, Nq, H] bf16, H 64 or 128, Nq / Nk in
    1, 2, 3, 4, 8; k/v_pool [P, L, Nk, page, H] int8 (K10) or paired
    [P, L, Nk/2, page, 2H] (K17) with k/v_scale [P, L, Nk, page] f32, or
    bf16 pools of either layout with k/v_scale None (K28, K29); page_table
    [B, max_pages] int32; positions [B] int32 (the read bound; parked lanes
    are given 1); fresh_k/v [B, Nk, H] bf16. Without fresh rows (both None:
    the no-fresh-row form, K38 and K39 over int8 pools, K40 and K41 over
    bf16 ones; csrc/paged_attention.cu) the pool holds the current token
    and rows j <= positions[b] < page x max_pages are read. Returns
    [B, 1, Nq, H]."""
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, k_pool, v_pool, page_table, positions, k_scale, v_scale,
            layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
    what = "paged decode attention"
    if q.shape[1] != 1:
        raise ValueError(f"{what} is single-position, got q "
                         f"{tuple(q.shape)}")
    b, _, nq, h = q.shape
    nk, nl, page, pair = _check_pool(what, q, k_pool, v_pool, page_table,
                                     k_scale, v_scale, layer)
    quant = k_scale is not None
    check_decode_inputs(what, q, fresh_k, fresh_v, positions,
                        (k_pool, v_pool, *scale_planes(k_scale, v_scale),
                         page_table), nk)
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    max_pages = page_table.shape[1]
    pools = (k_pool.data_ptr(), v_pool.data_ptr())
    if quant:
        pools += (k_scale.data_ptr(), v_scale.data_ptr())
    pools += (page_table.data_ptr(),)
    if fresh_k is None:
        fn = (lib.gabby_paged_decode_attention_nofresh if quant
              else lib.gabby_paged_decode_attention_nofresh_bf16)
    else:
        fn = (lib.gabby_paged_decode_attention if quant
              else lib.gabby_paged_decode_attention_bf16)
        pools += (fresh_k.data_ptr(), fresh_v.data_ptr())
    decode_launch(fn, q, (q.data_ptr(), *pools, positions.data_ptr(),
                          out.data_ptr(), b, nq, nk, nl, layer, page,
                          max_pages, h, pair), quant, nk, page * max_pages,
                  scale, what, page=page)
    ck.launch_counts["paged_decode_attention"
                     + ("" if fresh_k is not None else "_nofresh")
                     + ("" if quant else "_bf16")
                     + ("_paired" if pair else "")] += 1
    return out


def paged_decode_attention_s8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              positions: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, *, layer: int,
                              fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The s8 form (`s8_attention_core`, one quantization chunk per page),
    inputs as `paged_decode_attention`: unpaired pool K19, paired K20, at
    `s8_plan`'s launch for the read bound page x max_pages. On the same
    rows K20 equals K19 bit for bit, and K19 equals the dense K14 where
    the dense chunk is the page and the dense read bound page x
    max_pages."""
    if not q.is_cuda:
        return paged_decode_attention_s8_plain(
            q, k_pool, v_pool, page_table, positions, k_scale, v_scale,
            layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
    what = "paged s8 decode attention"
    b, t, nq, h = q.shape
    if k_scale is None:
        raise ValueError(f"{what} takes int8 pools with f32 scale pools")
    nk, nl, page, pair = _check_pool(what, q, k_pool, v_pool, page_table,
                                     k_scale, v_scale, layer)
    check_decode_inputs(what, q, fresh_k, fresh_v, positions,
                         (k_pool, v_pool, k_scale, v_scale, page_table), nk)
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda.quant_matmul import multiprocessors
    max_pages = page_table.shape[1]
    plan = s8_plan(b, nk, h, nq // nk, page * max_pages,
                   multiprocessors(q.device.index), page, page=page)
    lib = build.library()
    out = torch.empty_like(q)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(lib.gabby_attention_s8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        fresh_k.data_ptr(), fresh_v.data_ptr(), positions.data_ptr(),
        out.data_ptr(), b, nq, nk, nl, layer, page, max_pages, h,
        page * max_pages, page, pair, *plan, sm_scale,
        build.stream_ptr(q.device)), what)
    ck.launch_counts["paged_decode_attention_s8_paired" if pair
                     else "paged_decode_attention_s8"] += 1
    return out


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           positions: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, *, layer: int,
                           fresh_k: torch.Tensor, fresh_v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, T, Nq, H] bf16, 2 <= T <= 32 candidate positions per slot;
    pools (int8: unpaired K11, paired K18; bf16: K30, K31), table and
    positions as `paged_decode_attention`; fresh_k/v [B, Nk, T, H] bf16,
    head-major in both layouts. Returns [B, T, Nq, H]. The dense verify
    form through the table (csrc/paged_attention.cu) at `verify_plan`'s
    launch for the read bound page x max_pages: on the same rows under the
    same plan the dense form's bits."""
    if not q.is_cuda:
        return paged_verify_attention_plain(
            q, k_pool, v_pool, page_table, positions, k_scale, v_scale,
            layer=layer, fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
    what = "paged verify attention"
    check_verify_block(what, q)
    b, t, nq, h = q.shape
    nk, nl, page, pair = _check_pool(what, q, k_pool, v_pool, page_table,
                                     k_scale, v_scale, layer)
    check_block_inputs(what, q, fresh_k, fresh_v, positions,
                       (k_pool, v_pool, *scale_planes(k_scale, v_scale),
                        page_table), nk)
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda.quant_matmul import multiprocessors
    lib = build.library()
    out = torch.empty_like(q)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    max_pages = page_table.shape[1]
    split, tile, nt, _ = verify_plan(b, nk, h, nq // nk, t,
                                     page * max_pages,
                                     multiprocessors(q.device.index),
                                     quant=k_scale is not None, page=page)
    rest = (page_table.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
            positions.data_ptr(), out.data_ptr(), b, t, nq, nk, nl, layer,
            page, max_pages, h, pair, split, tile, nt, sm_scale,
            build.stream_ptr(q.device))
    if k_scale is None:
        build.check(lib.gabby_paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *rest), what)
        form = "_bf16"
    else:
        build.check(lib.gabby_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), *rest), what)
        form = ""
    ck.launch_counts["paged_verify_attention" + form
                     + ("_paired" if pair else "")] += 1
    return out
