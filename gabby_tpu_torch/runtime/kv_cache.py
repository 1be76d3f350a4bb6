"""Fixed-shape slot KV cache, optionally int8-quantized (counterpart of
gabby_tpu/runtime/kv_cache.py, unpaired layout).

k, v: [L, B, Nk, S, H] head-major (each (slot, kv head) owns a contiguous
[S, H] plane, the unit the decode kernel streams). int8 mode stores codes
plus a per-(token, kv-head) f32 scale [L, B, Nk, S]. The port updates the
cache IN PLACE, layer by layer, after that layer's attention has read it.
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
    def max_seq(self) -> int:
        return self.k.shape[3]


def create_cache(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype=torch.bfloat16, quantized: bool = False,
                 device=None) -> KVCache:
    """A zeroed cache on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    if quantized:
        sshape = shape[:-1]
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   k_scale=None, v_scale=None)


def cache_from_numpy(k, v, k_scale=None, v_scale=None,
                     device=None) -> KVCache:
    """Carry a dense cache across from numpy arrays (k, v and, when int8,
    their scales), keeping their types."""
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
