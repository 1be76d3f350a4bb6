"""Single-slot flash prefill attention over the KV cache and its plain
PyTorch version (counterpart of
gabby_tpu/ops/pallas/prefill_attention.py:prefill_attention, unpaired and
pair=True, with scales and without): K4 over an int8 cache and K21 over
the paired one; K22 over a bf16 cache and K23 over the paired one.

csrc/prefill_attention.cu (K4, K21) and csrc/prefill_attention_bf16.cu
(K22, K23: TMA and wgmma) replace _prefill_call/_kernel: the chunk's T
queries attend the slot's cache rows j < offset of one layer (pointer
offsets into the stacked cache, no copy), with the int8 scales folded in
when the cache has them, then the chunk's own unquantized k/v causally.
The paired cache [L, B, Nk/2, S, 2H] is detected by its lane width; the
fresh block stays head-major [Nk, T, H]. head_dim is 64 or 128. CPU
tensors take the plain version; CUDA tensors launch or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda.attention import HEAD_DIMS, check_cache_form


def prefill_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                            slot: int, offset: int, *, layer: int, fresh_k,
                            fresh_v, scale: Optional[float] = None):
    from gabby_tpu_torch.ops.attention import slot_prefill_reference
    return slot_prefill_reference(q, k_cache, v_cache, slot, offset,
                                  k_scale, v_scale, fresh_k=fresh_k,
                                  fresh_v=fresh_v, layer=layer, scale=scale)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, slot: int, offset: int, *,
                      layer: int, fresh_k: torch.Tensor,
                      fresh_v: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q [1, T, Nq, H] bf16, H 64 or 128; k/v_cache [L, B, Nk, S, H] int8
    (K4) or paired [L, B, Nk/2, S, 2H] (K21), S a multiple of 4, with
    k/v_scale [L, B, Nk, S] f32; or a bf16 cache of either layout with
    k/v_scale None (K22, K23); fresh_k/v [Nk, T, H] bf16. Returns
    [1, T, Nq, H]."""
    if not q.is_cuda:
        return prefill_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                       slot, offset, layer=layer,
                                       fresh_k=fresh_k, fresh_v=fresh_v,
                                       scale=scale)
    what = "prefill attention"
    one, t, nq, h = q.shape
    nl, nb, heads, s, lanes = k_cache.shape
    pair = int(lanes == 2 * h)
    nk = heads * 2 if pair else heads
    quant = k_scale is not None
    tensors = (q, k_cache, v_cache, fresh_k, fresh_v,
               *((k_scale, v_scale) if quant else ()))
    if not all(x.is_cuda and x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: tensors must be contiguous on the GPU")
    check_cache_form(what, k_cache, v_cache, k_scale, v_scale)
    if (q.dtype != torch.bfloat16 or fresh_k.dtype != torch.bfloat16
            or fresh_v.dtype != torch.bfloat16):
        raise ValueError(f"{what} takes bf16 q/fresh")
    if (one != 1 or h not in HEAD_DIMS or lanes not in (h, 2 * h) or nq % nk
            or (not quant and nq // nk > 128)
            or fresh_k.shape != (nk, t, h) or fresh_v.shape != (nk, t, h)
            or v_cache.shape != k_cache.shape
            or (quant and (k_scale.shape != (nl, nb, nk, s)
                           or v_scale.shape != k_scale.shape or s % 4))
            or not 0 <= layer < nl
            or not 0 <= slot < nb or not 0 <= offset <= s):
        raise ValueError(f"{what}: unsupported shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"layer {layer}, slot {slot}, offset {offset}")
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    row = layer * nb + slot
    kv_off = row * nk * s * h * k_cache.element_size()  # bytes
    sc_off = row * nk * s * 4   # f32 bytes
    sm_scale = float(scale) if scale is not None else h ** -0.5
    # a short chunk over a long past splits its key range across blocks;
    # the partial results (H + 4 floats a row: H outputs, the max, the sum,
    # padding; kPart in the source) are merged in a fixed order
    n_split = (lib.gabby_prefill_attention_splits if quant else
               lib.gabby_prefill_attention_bf16_splits)(t, nq, nk, offset)
    part = (torch.empty((n_split, t * nq, h + 4), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    rows = (q.data_ptr(), k_cache.data_ptr() + kv_off,
            v_cache.data_ptr() + kv_off)
    rest = (fresh_k.data_ptr(), fresh_v.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), t, nq, nk, s, h, offset,
            pair, n_split, sm_scale, build.stream_ptr(q.device))
    if quant:
        build.check(lib.gabby_prefill_attention(
            *rows, k_scale.data_ptr() + sc_off, v_scale.data_ptr() + sc_off,
            *rest), what)
        ck.launch_counts["prefill_attention_paired" if pair
                         else "prefill_attention"] += 1
    else:
        build.check(lib.gabby_prefill_attention_bf16(*rows, *rest), what)
        ck.launch_counts["prefill_attention_bf16_paired" if pair
                         else "prefill_attention_bf16"] += 1
    return out
