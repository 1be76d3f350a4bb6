"""Single-slot flash prefill attention over the int8 KV cache (K4, and K21
over the paired cache; counterpart of
gabby_tpu/ops/pallas/prefill_attention.py:prefill_attention, unpaired and
pair=True) and its plain PyTorch version.

csrc/prefill_attention.cu replaces _prefill_call/_kernel: the chunk's T
queries attend the slot's cache rows j < offset of one layer (pointer
offsets into the stacked cache, no copy) with the int8 scales folded in,
then the chunk's own unquantized k/v causally. The paired cache
[L, B, Nk/2, S, 2H] is detected by its lane width; the fresh block stays
head-major [Nk, T, H]. CPU tensors take the plain version; CUDA tensors
launch or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck


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
    """q [1, T, Nq, H] bf16; k/v_cache [L, B, Nk, S, H] int8 (K4) or paired
    [L, B, Nk/2, S, 2H] (K21); k/v_scale [L, B, Nk, S] f32; fresh_k/v
    [Nk, T, H] bf16. Returns [1, T, Nq, H]."""
    if not q.is_cuda:
        return prefill_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                       slot, offset, layer=layer,
                                       fresh_k=fresh_k, fresh_v=fresh_v,
                                       scale=scale)
    one, t, nq, h = q.shape
    nl, nb, heads, s, lanes = k_cache.shape
    pair = int(lanes == 2 * h)
    nk = heads * 2 if pair else heads
    tensors = (q, k_cache, v_cache, k_scale, v_scale, fresh_k, fresh_v)
    if not all(x.is_cuda and x.is_contiguous() for x in tensors):
        raise ValueError("prefill attention: tensors must be contiguous on "
                         "the GPU")
    if (q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8
            or v_cache.dtype != torch.int8 or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32
            or fresh_k.dtype != torch.bfloat16
            or fresh_v.dtype != torch.bfloat16):
        raise ValueError("prefill attention takes bf16 q/fresh, int8 cache "
                         "and f32 scales")
    if (one != 1 or h != 64 or lanes not in (h, 2 * h) or nq % nk
            or fresh_k.shape != (nk, t, h) or fresh_v.shape != (nk, t, h)
            or v_cache.shape != k_cache.shape
            or k_scale.shape != (nl, nb, nk, s)
            or v_scale.shape != k_scale.shape or not 0 <= layer < nl
            or not 0 <= slot < nb or not 0 <= offset <= s):
        raise ValueError(f"prefill attention: unsupported shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"layer {layer}, slot {slot}, offset {offset}")
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    row = layer * nb + slot
    kv_off = row * nk * s * h   # int8 bytes
    sc_off = row * nk * s * 4   # f32 bytes
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(lib.gabby_prefill_attention(
        q.data_ptr(), k_cache.data_ptr() + kv_off,
        v_cache.data_ptr() + kv_off, k_scale.data_ptr() + sc_off,
        v_scale.data_ptr() + sc_off, fresh_k.data_ptr(), fresh_v.data_ptr(),
        out.data_ptr(), t, nq, nk, s, h, offset, pair, sm_scale,
        build.stream_ptr(q.device)), "prefill attention")
    ck.launch_counts["prefill_attention_paired" if pair
                     else "prefill_attention"] += 1
    return out
