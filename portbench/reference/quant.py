"""A frozen copy of the serving recipe's weight arithmetic, in float32.

The program serves `--quant 4`: every projection int4, symmetric, one
scale per output channel (absmax / 7, at least 1e-8; codes round(w / s)
clipped to [-7, 7]), and the unembed int4 with one scale per 256 inputs
of each vocab column (the group halved until it divides the hidden size).
Fusing q|k|v and gate|up concatenates output channels, each with its own
scale, so the fused product equals the separate ones: the reference keeps
them apart. The packed nibble layout is storage and does not change a
value. Returned here are the dequantized float32 matrices [in, out].
"""

from __future__ import annotations

import torch

QMAX4 = 7.0


def int4_channel(w: torch.Tensor) -> torch.Tensor:
    """w [in, out] -> codes x scale, one scale per output channel."""
    wf = w.float()
    scale = torch.clamp(torch.amax(torch.abs(wf), dim=0) / QMAX4, min=1e-8)
    codes = torch.clamp(torch.round(wf / scale), -QMAX4, QMAX4)
    return codes * scale


def int4_grouped(w: torch.Tensor, group: int = 256) -> torch.Tensor:
    """w [in, out] -> codes x scale, one scale per (group of inputs,
    output channel)."""
    wf = w.float()
    k, n = wf.shape
    while group > 1 and k % group:
        group //= 2
    wg = wf.reshape(k // group, group, n)
    scale = torch.clamp(torch.amax(torch.abs(wg), dim=1) / QMAX4, min=1e-8)
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -QMAX4, QMAX4)
    return (codes * scale[:, None, :]).reshape(k, n)
