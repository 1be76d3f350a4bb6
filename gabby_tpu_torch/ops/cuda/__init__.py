"""Hand-written Hopper kernels of the serving path and their wrappers.

Each wrapper module (quant_matmul, attention, prefill_attention,
paged_attention) holds the
kernel's plain PyTorch version beside it. A wrapper takes the plain version
ONLY for CPU tensors; for CUDA tensors it launches its kernel (built from
gabby_tpu_torch/csrc by `build.py` at first use) or raises. Each launch adds
one to its entry in `launch_counts`, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import os
from typing import Optional

launch_counts: dict[str, int] = {
    "int4_matmul_stacked": 0,
    "int4_matmul_grouped": 0,
    "decode_attention": 0,
    "prefill_attention": 0,
    "int8_matmul_stacked": 0,
    "int8_matmul": 0,
    "int4_matmul": 0,
    "int4_matmul_w4a8_stacked": 0,
    "verify_attention": 0,
    "paged_decode_attention": 0,
    "paged_verify_attention": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# The two route switches of the int4 matmuls, with the reference's names
# and defaults (gabby_tpu/ops/pallas/__init__.py). Each chooses between two
# routes that both exist; neither is a fallback: when a switch is on and
# the kernel cannot take a call, its wrapper raises.
_W4A8: Optional[bool] = None
_INT4_PREFILL: Optional[bool] = None


def w4a8() -> bool:
    """W4A8 mode: decode-sized products of stacked int4 weights quantize
    their activations to int8 per row and run integer dots (K8). Changes
    numerics; opt-in with GABBY_W4A8=1 or set_w4a8(True)."""
    if _W4A8 is not None:
        return _W4A8
    return os.environ.get("GABBY_W4A8") == "1"


def set_w4a8(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _W4A8
    _W4A8 = enabled


def int4_prefill_kernel() -> bool:
    """Whether prefill-sized products (M > 64) of per-channel int4 weights
    take the int4 kernel (K7) instead of unpacking the layer and calling
    `torch.matmul`. Default off, as in the reference; opt-in with
    GABBY_QMM_PREFILL=1 or set_int4_prefill_kernel(True)."""
    if _INT4_PREFILL is not None:
        return _INT4_PREFILL
    return os.environ.get("GABBY_QMM_PREFILL", "0") == "1"


def set_int4_prefill_kernel(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _INT4_PREFILL
    _INT4_PREFILL = enabled
