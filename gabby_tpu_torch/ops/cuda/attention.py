"""Flash-decode and flash-verify attention over the dense int8 KV cache (K3
and K9; counterparts of gabby_tpu/ops/pallas/attention.py:decode_attention
and verify_attention in their unpaired forms) and their plain PyTorch
versions.

csrc/decode_attention.cu replaces _decode_call/_flash_step: one block per
(slot, kv head) reads rows j < min(positions[b], window) of one layer of
the stacked cache (a pointer offset, no copy), folds the int8 scales into
scores and probabilities, and folds the current token's unquantized k/v
in last. csrc/verify_attention.cu is the same call with T > 1 query
positions per slot and the block's own T fresh rows attended causally.
CPU tensors take the plain versions; CUDA tensors launch or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck


def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, positions,
                           *, layer: int, fresh_k, fresh_v,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The reference's contract: dequantize the layer's cache in q's dtype,
    attend rows j < positions[b] plus the fresh row, in f32."""
    from gabby_tpu_torch.ops.attention import cache_attention
    from gabby_tpu_torch.runtime.kv_cache import dequantize_kv
    kk = dequantize_kv(k_cache[layer], k_scale[layer], q.dtype)
    vv = dequantize_kv(v_cache[layer], v_scale[layer], q.dtype)
    return cache_attention(q, kk, vv, positions, scale=scale,
                           fresh_k=fresh_k, fresh_v=fresh_v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor, *,
                     layer: int, fresh_k: torch.Tensor,
                     fresh_v: torch.Tensor, scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q [B, 1, Nq, H] bf16; k/v_cache [L, B, Nk, S, H] int8; k/v_scale
    [L, B, Nk, S] f32; positions [B] int32; fresh_k/v [B, Nk, H] bf16.
    Returns [B, 1, Nq, H]. `window` (when given) bounds every slot's read,
    which the caller guarantees covers positions[b]."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)
    b, t, nq, h = q.shape
    nl, _, nk, s, _ = k_cache.shape
    tensors = (q, k_cache, v_cache, k_scale, v_scale, positions, fresh_k,
               fresh_v)
    if not all(x.is_cuda and x.is_contiguous() for x in tensors):
        raise ValueError("decode attention: tensors must be contiguous on "
                         "the GPU")
    if (q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8
            or v_cache.dtype != torch.int8 or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32
            or positions.dtype != torch.int32
            or fresh_k.dtype != torch.bfloat16
            or fresh_v.dtype != torch.bfloat16):
        raise ValueError("decode attention takes bf16 q/fresh, int8 cache, "
                         "f32 scales and int32 positions")
    if (t != 1 or h != 64 or nq % nk or nq // nk not in (1, 2, 4, 8)
            or k_scale.shape != (nl, b, nk, s)
            or fresh_k.shape != (b, nk, h) or positions.shape != (b,)
            or not 0 <= layer < nl):
        raise ValueError(f"decode attention: unsupported shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"layer {layer}")
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    kv_off = layer * b * nk * s * h        # int8 bytes
    sc_off = layer * b * nk * s * 4        # f32 bytes
    limit = s if window is None else min(window, s)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(lib.gabby_decode_attention(
        q.data_ptr(), k_cache.data_ptr() + kv_off,
        v_cache.data_ptr() + kv_off, k_scale.data_ptr() + sc_off,
        v_scale.data_ptr() + sc_off, fresh_k.data_ptr(), fresh_v.data_ptr(),
        positions.data_ptr(), out.data_ptr(), b, nq, nk, s, h, limit,
        sm_scale, build.stream_ptr(q.device)), "decode attention")
    ck.launch_counts["decode_attention"] += 1
    return out


def verify_attention_plain(q, k_cache, v_cache, k_scale, v_scale, positions,
                           *, layer: int, fresh_k, fresh_v,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The reference's contract: dequantize the layer's cache in q's dtype,
    attend rows j < positions[b] for every query plus the block's own fresh
    rows causally, in f32."""
    from gabby_tpu_torch.ops.attention import verify_attention_reference
    return verify_attention_reference(q, k_cache, v_cache, positions,
                                      k_scale, v_scale, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)


def check_block_inputs(what: str, q, fresh_k, fresh_v, positions, tensors,
                       nk: int) -> None:
    """Checks shared by the kernels of csrc/flash_rows.cuh: q [B, T, Nq, 64]
    and fresh_k/v [B, Nk, T, 64] bf16, positions [B] int32, everything
    contiguous on the GPU and 16-byte aligned."""
    b, t, nq, h = q.shape
    tensors = (q, fresh_k, fresh_v, positions, *tensors)
    if not all(x.is_cuda and x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError(f"{what}: tensors must be contiguous and 16-byte "
                         f"aligned on the GPU")
    if (q.dtype != torch.bfloat16 or fresh_k.dtype != torch.bfloat16
            or fresh_v.dtype != torch.bfloat16
            or positions.dtype != torch.int32):
        raise ValueError(f"{what} takes bf16 q/fresh and int32 positions")
    if (h != 64 or nq % nk or not 1 <= t <= 32
            or fresh_k.shape != (b, nk, t, h) or fresh_v.shape != (b, nk, t, h)
            or positions.shape != (b,)):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"fresh {tuple(fresh_k.shape)}, {nk} kv heads")


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor, *,
                     layer: int, fresh_k: torch.Tensor,
                     fresh_v: torch.Tensor, scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q [B, T, Nq, H] bf16, 2 <= T <= 32 candidate positions per slot;
    k/v_cache [L, B, Nk, S, H] int8; k/v_scale [L, B, Nk, S] f32; positions
    [B] int32 (the read bound; parked lanes are given 1); fresh_k/v
    [B, Nk, T, H] bf16. Returns [B, T, Nq, H]. `window` (when given) bounds
    every slot's read, which the caller guarantees covers positions[b]."""
    if not q.is_cuda:
        return verify_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)
    b, t, nq, h = q.shape
    nl, _, nk, s, _ = k_cache.shape
    check_block_inputs("verify attention", q, fresh_k, fresh_v, positions,
                       (k_cache, v_cache, k_scale, v_scale), nk)
    if (k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError("verify attention takes an int8 cache with f32 "
                         "scales")
    if (k_cache.shape != (nl, b, nk, s, h) or v_cache.shape != k_cache.shape
            or k_scale.shape != (nl, b, nk, s)
            or v_scale.shape != k_scale.shape or not 0 <= layer < nl):
        raise ValueError(f"verify attention: unsupported cache "
                         f"{tuple(k_cache.shape)}, layer {layer}")
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    kv_off = layer * b * nk * s * h        # int8 bytes
    sc_off = layer * b * nk * s * 4        # f32 bytes
    limit = s if window is None else min(window, s)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(lib.gabby_verify_attention(
        q.data_ptr(), k_cache.data_ptr() + kv_off,
        v_cache.data_ptr() + kv_off, k_scale.data_ptr() + sc_off,
        v_scale.data_ptr() + sc_off, fresh_k.data_ptr(), fresh_v.data_ptr(),
        positions.data_ptr(), out.data_ptr(), b, t, nq, nk, s, h, limit,
        sm_scale, build.stream_ptr(q.device)), "verify attention")
    ck.launch_counts["verify_attention"] += 1
    return out
