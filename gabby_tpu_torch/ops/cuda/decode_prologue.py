"""The decode layer's attention prologue over the dense int8 KV cache (K42,
csrc/decode_prologue.cu) and its plain PyTorch version.

At one position, the fused q|k|v product of a layer ([B, 1, (Nq + 2 Nk)
H], `fuse_projections` at tp = 1) becomes what the decode attention takes:
q rotated ([B, 1, Nq, H]), the rotated k and the v rows ([B, Nk, H]), and
the layer's cache row min(positions[b], S - 1) of every slot holds the
int8 codes and f32 scales of those k/v rows (unpaired or paired layout,
told by the lane width). The plain version is the eager chain that
`models/llama.decode_step` runs for every call the kernel does not take
(`apply_rope` twice, `quantize_kv` twice, the paired reshape, the four
row writes); the kernel gives its bits in one launch. The rows land
before the layer's attention, which reads rows j < positions[b] and the
fresh row: an active lane's row min(positions[b], S - 1) is positions[b]
and is not read. CPU tensors take the plain version; CUDA tensors launch
or raise.
"""

from __future__ import annotations

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.rope import apply_rope
from gabby_tpu_torch.runtime.kv_cache import quantize_kv

HEAD_DIMS = (64, 128)  # head_dim the kernel is built for


def decode_prologue_plain(qkv, positions, inv_freq, k_cache, v_cache,
                          k_scale, v_scale, *, layer: int, num_heads: int,
                          num_kv_heads: int):
    b = qkv.shape[0]
    h = 2 * inv_freq.shape[0]
    q, k, v = torch.split(qkv, (num_heads * h, num_kv_heads * h,
                                num_kv_heads * h), dim=-1)
    q = apply_rope(q.reshape(b, 1, num_heads, h), positions[:, None],
                   inv_freq)
    k = apply_rope(k.reshape(b, 1, num_kv_heads, h), positions[:, None],
                   inv_freq)
    fresh_k, fresh_v = k[:, 0], v.reshape(b, num_kv_heads, h)
    kr, k_s = quantize_kv(fresh_k)
    vr, v_s = quantize_kv(fresh_v)
    if k_cache.shape[-1] == 2 * h:
        kr = kr.reshape(b, num_kv_heads // 2, 2 * h)
        vr = vr.reshape(b, num_kv_heads // 2, 2 * h)
    write_pos = torch.clamp(positions.long(), max=k_cache.shape[-2] - 1)
    lanes = torch.arange(b, device=qkv.device)
    k_cache[layer][lanes, :, write_pos] = kr
    v_cache[layer][lanes, :, write_pos] = vr
    k_scale[layer][lanes, :, write_pos] = k_s
    v_scale[layer][lanes, :, write_pos] = v_s
    return q, fresh_k.contiguous(), fresh_v.contiguous()


def decode_prologue(qkv: torch.Tensor, positions: torch.Tensor,
                    inv_freq: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, *, layer: int, num_heads: int,
                    num_kv_heads: int):
    """qkv [B, 1, (Nq + 2 Nk) H] bf16; positions [B] int; inv_freq [H / 2]
    f32, H 64 or 128; k/v_cache the stacked [L, B', Nk, S, H] int8, or
    paired [L, B', Nk/2, S, 2H], B' >= B, with k/v_scale [L, B', Nk, S]
    f32. Writes the cache rows of `layer`; returns (q [B, 1, Nq, H],
    fresh_k [B, Nk, H], fresh_v [B, Nk, H]) in bf16."""
    args = (qkv, positions, inv_freq, k_cache, v_cache, k_scale, v_scale)
    kw = dict(layer=layer, num_heads=num_heads, num_kv_heads=num_kv_heads)
    if not qkv.is_cuda:
        return decode_prologue_plain(*args, **kw)
    what = "decode prologue"
    b, one, n = qkv.shape
    h = 2 * inv_freq.shape[0]
    nl, nb, heads, s, lanes = k_cache.shape
    nq, nk = num_heads, num_kv_heads
    pair = int(lanes == 2 * h)
    positions = positions.to(torch.int32)
    if not all(x.is_cuda and x.is_contiguous() for x in args):
        raise ValueError(f"{what}: tensors must be contiguous on the GPU")
    if (qkv.dtype != torch.bfloat16 or inv_freq.dtype != torch.float32
            or k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError(f"{what} takes a bf16 product and an int8 cache "
                         f"with f32 scales")
    if (one != 1 or h not in HEAD_DIMS or n != (nq + 2 * nk) * h
            or heads * (1 + pair) != nk or lanes not in (h, 2 * h)
            or positions.shape != (b,) or b > nb
            or v_cache.shape != k_cache.shape
            or k_scale.shape != (nl, nb, nk, s)
            or v_scale.shape != k_scale.shape or not 0 <= layer < nl):
        raise ValueError(f"{what}: unsupported shapes qkv "
                         f"{tuple(qkv.shape)}, heads {nq}/{nk}, cache "
                         f"{tuple(k_cache.shape)}, layer {layer}")
    from gabby_tpu_torch.ops.cuda import build
    q = torch.empty((b, 1, nq, h), dtype=torch.bfloat16, device=qkv.device)
    fresh_k = torch.empty((b, nk, h), dtype=torch.bfloat16,
                          device=qkv.device)
    fresh_v = torch.empty_like(fresh_k)
    kv_off = layer * nb * nk * s * h  # int8 bytes of a layer
    sc_off = layer * nb * nk * s * 4  # f32 bytes of a layer
    build.check(build.library().gabby_decode_prologue(
        qkv.data_ptr(), positions.data_ptr(), inv_freq.data_ptr(),
        q.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
        k_cache.data_ptr() + kv_off, v_cache.data_ptr() + kv_off,
        k_scale.data_ptr() + sc_off, v_scale.data_ptr() + sc_off,
        b, nq, nk, s, h, pair, build.stream_ptr(qkv.device)), what)
    ck.launch_counts["decode_prologue"] += 1
    return q, fresh_k, fresh_v
