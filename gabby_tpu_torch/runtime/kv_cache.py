"""Fixed-shape slot KV cache, optionally int8-quantized (counterpart of
gabby_tpu/runtime/kv_cache.py).

k, v: [L, B, Nk, S, H] head-major (each (slot, kv head) owns a contiguous
[S, H] plane, the unit the decode kernel streams). int8 mode stores codes
plus a per-(token, kv-head) f32 scale [L, B, Nk, S]. The paired layout
(`create_cache(paired=True)`) stores adjacent kv heads 2p and 2p + 1 side
by side on the last axis, k, v: [L, B, Nk/2, S, 2H], while the scales stay
per head; consumers detect it by the lane width (`cache_is_paired`). The
port updates the cache IN PLACE, layer by layer, after that layer's
attention has read it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gabby_tpu_torch import resolve_device
from gabby_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def nbytes(self) -> int:
        tensors = [self.k, self.v]
        if self.quantized:
            tensors += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in tensors)


def kv_shape(cfg: ModelConfig, paired: bool) -> tuple[int, int]:
    """(heads, lanes) of a k/v array's head and last axes: (Nk, H), or
    (Nk/2, 2H) in the paired layout, which needs an even kv-head count."""
    if not paired:
        return cfg.num_kv_heads, cfg.head_dim
    if cfg.num_kv_heads % 2:
        raise ValueError("pairing needs an even kv-head count")
    return cfg.num_kv_heads // 2, 2 * cfg.head_dim


def create_cache(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype=torch.bfloat16, quantized: bool = False,
                 paired: bool = False, device=None) -> KVCache:
    """A zeroed cache on `device` (CUDA unless the caller asks for the CPU).
    paired=True: k, v [L, B, Nk/2, S, 2H], scales still [L, B, Nk, S]."""
    dev = resolve_device(device)
    heads, lanes = kv_shape(cfg, paired)
    shape = (cfg.num_layers, batch, heads, max_seq, lanes)
    if quantized:
        sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   k_scale=None, v_scale=None)


def cache_is_paired(cache, cfg: ModelConfig) -> bool:
    """True when `cache` (dense or paged) stores kv-head pairs side by side
    on the last axis. The lane width is the single source of truth."""
    return cache.k.shape[-1] == 2 * cfg.head_dim


def pair_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., Nk, T, H] -> [..., Nk/2, T, 2H]: adjacent head pairs side by
    side on the last axis (the paired cache's storage transform). For T = 1
    it is a reshape; T > 1 (prefill chunks, verify blocks) copies the chunk,
    never the cache."""
    *lead, nk, t, h = x.shape
    x = x.reshape(*lead, nk // 2, 2, t, h).movedim(-3, -2)
    return x.reshape(*lead, nk // 2, t, 2 * h)


def unpair_heads(x: torch.Tensor) -> torch.Tensor:
    """Inverse of pair_heads: [..., Nk/2, T, 2H] -> [..., Nk, T, H]."""
    *lead, np_, t, h2 = x.shape
    x = x.reshape(*lead, np_, t, 2, h2 // 2).movedim(-2, -3)
    return x.reshape(*lead, np_ * 2, t, h2 // 2)


def unpaired(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """x un-paired when its last axis is a pair's 2 * head_dim lanes, else
    x itself: what the plain attention bodies run on."""
    return unpair_heads(x) if x.shape[-1] == 2 * head_dim else x


def lane_indices(lane_mask: Optional[torch.Tensor], batch: int,
                 device) -> torch.Tensor:
    """The slots a lane-masked batched write reaches: those of `lane_mask`
    [B] bool, or every slot when it is None."""
    if lane_mask is None:
        return torch.arange(batch, device=device)
    return torch.nonzero(lane_mask)[:, 0]


def cache_from_numpy(k, v, k_scale=None, v_scale=None,
                     device=None) -> KVCache:
    """Carry a dense cache across from numpy arrays (k, v and, when int8,
    their scales), keeping their types and their layout (paired or not)."""
    dev = resolve_device(device)

    def leaf(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    return KVCache(k=leaf(k), v=leaf(v), k_scale=leaf(k_scale),
                   v_scale=leaf(v_scale))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H] -> (int8 codes [..., H], f32 scales [...])."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)
