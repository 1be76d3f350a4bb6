"""Linear projection with dtype-aware dispatch (counterpart of
gabby_tpu/ops/linear.py): quantized weights (ops/quant.QTensor) go through
`qlinear`, dense weights through one f32-accumulated product. With fp8
activations on (`quant.set_act_fp8`), every input first passes through the
e4m3 grid. While torch.profiler records, each call is a `gabby.matmul` span
(runtime/tracing.py)."""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import quant
from gabby_tpu_torch.runtime import tracing


def linear(x: torch.Tensor, w, layer: Optional[int] = None) -> torch.Tensor:
    """x: [..., in] @ w: [in, out] -> [..., out]. `layer` selects one layer
    of a STACKED [L, in, out] weight; quantized stacks reach their kernel
    whole (the layer is a pointer offset there, never a copy)."""
    with tracing.span("matmul"):
        # a no-op unless fp8 activations are on
        x = quant.maybe_fp8_activation(x)
        if isinstance(w, quant.QTensor):
            return quant.qlinear(x, w, layer=layer)
        if layer is not None and w.dim() == 3:
            w = w[layer]
        # f32 accumulation, result in x.dtype: on the card one tensor-core
        # product; on the CPU the operands widen to f32 first, which is the
        # reference's `preferred_element_type=f32` dot exactly
        if x.is_cuda:
            return torch.matmul(x, w.to(x.dtype))
        return torch.matmul(x.float(), w.float()).to(x.dtype)
