"""Hand-written Hopper kernels of the serving path and their wrappers.

Each wrapper module (quant_matmul, attention, prefill_attention,
paged_attention, decode_prologue) holds the
kernel's plain PyTorch version beside it. A wrapper takes the plain version
ONLY for CPU tensors; for CUDA tensors it launches its kernel (built from
gabby_tpu_torch/csrc by `build.py` at first use) or raises. Each launch adds
one to its entry in `launch_counts`, so a run can show that its main path
went through the kernels. The dispatch points (ops/attention.py,
ops/quant.py; models/llama.py for K42, the decode prologue) send card
tensors to the plain bodies only where a kernel switch below asks for it:
`kernels_enabled()` off, `prefill_pair()` off for paired prefill,
`attn_kernel()` False for single-position decode.
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
    "int4_matmul_stacked_rawdot": 0,
    "verify_attention": 0,
    "paged_decode_attention": 0,
    "paged_verify_attention": 0,
    "decode_attention_paired": 0,
    "verify_attention_paired": 0,
    "decode_attention_s8": 0,
    "decode_attention_s8_paired": 0,
    "decode_attention_multi": 0,
    "paged_decode_attention_paired": 0,
    "paged_verify_attention_paired": 0,
    "paged_decode_attention_s8": 0,
    "paged_decode_attention_s8_paired": 0,
    "prefill_attention_paired": 0,
    # over a bf16 cache (K22-K32)
    "prefill_attention_bf16": 0,
    "prefill_attention_bf16_paired": 0,
    "decode_attention_bf16": 0,
    "decode_attention_bf16_paired": 0,
    "verify_attention_bf16": 0,
    "verify_attention_bf16_paired": 0,
    "paged_decode_attention_bf16": 0,
    "paged_decode_attention_bf16_paired": 0,
    "paged_verify_attention_bf16": 0,
    "paged_verify_attention_bf16_paired": 0,
    "decode_attention_multi_bf16": 0,
    # the no-fresh-row forms (K34-K41)
    "decode_attention_nofresh": 0,
    "decode_attention_nofresh_paired": 0,
    "decode_attention_nofresh_bf16": 0,
    "decode_attention_nofresh_bf16_paired": 0,
    "paged_decode_attention_nofresh": 0,
    "paged_decode_attention_nofresh_paired": 0,
    "paged_decode_attention_nofresh_bf16": 0,
    "paged_decode_attention_nofresh_bf16_paired": 0,
    # the decode layer's attention prologue (K42): one a layer of a
    # decode step over the dense int8 cache
    "decode_prologue": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# The kernel switches, with the reference's names, values and defaults
# (gabby_tpu/ops/pallas/__init__.py:25-41, gabby_tpu/ops/attention.py:35-40
# and :177-181). A switch that is off is an explicit request for the plain
# bodies, not a fallback: no wrapper catches a kernel's failure.
_KERNELS: Optional[bool] = None
_PREFILL_PAIR: Optional[bool] = None
_ATTN_KERNEL: Optional[bool] = None


def kernels_enabled() -> bool:
    """Whether card tensors take the kernels at all (GABBY_KERNELS; the
    values 0, false and off turn them off, as
    gabby_tpu/ops/pallas/__init__.py:25-29 reads them). Unset: on. Off,
    every dispatch point sends card tensors to the plain bodies (the
    reference's jnp path, its A/B yardstick) and no launch counter
    moves."""
    if _KERNELS is not None:
        return _KERNELS
    return os.environ.get("GABBY_KERNELS") not in ("0", "false", "off")


def set_kernels(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _KERNELS
    _KERNELS = enabled


def prefill_pair() -> bool:
    """Whether prefill over a PAIRED cache takes its kernel (K21, K23):
    GABBY_PREFILL_PAIR=0 sends it to the plain body and changes nothing
    else, as gabby_tpu/ops/attention.py:177-181. Default on."""
    if _PREFILL_PAIR is not None:
        return _PREFILL_PAIR
    return os.environ.get("GABBY_PREFILL_PAIR", "1") != "0"


def set_prefill_pair(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _PREFILL_PAIR
    _PREFILL_PAIR = enabled


def attn_kernel() -> Optional[bool]:
    """The single-position calls of `cache_attention` and
    `cache_attention_quantized` (GABBY_ATTN_KERNEL,
    gabby_tpu/ops/attention.py:35-40): "1" forces the kernel (while
    `kernels_enabled()`), any other set value the plain body. Unset: None,
    the port's designed divergence, the kernel at every max_seq (the
    reference leaves a bf16 cache below 4096 rows to XLA; see
    ops/attention.py)."""
    if _ATTN_KERNEL is not None:
        return _ATTN_KERNEL
    forced = os.environ.get("GABBY_ATTN_KERNEL")
    return None if forced is None else forced == "1"


def set_attn_kernel(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _ATTN_KERNEL
    _ATTN_KERNEL = enabled


# The route switches, with the reference's names and defaults
# (gabby_tpu/ops/pallas/__init__.py, gabby_tpu/ops/pallas/attention.py).
# Each chooses between two routes that both exist; neither is a fallback:
# when a switch is on and the kernel cannot take a call, its wrapper raises.
_W4A8: Optional[bool] = None
_INT4_RAWDOT: Optional[bool] = None
_INT4_PREFILL: Optional[bool] = None
_ATTN_S8: Optional[bool] = None
_ATTN_MULTI: Optional[bool] = None
ATTN_CHUNK = 1024  # default rows per s8 quantization chunk (see attn_chunk)


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


def int4_rawdot() -> bool:
    """Raw-byte-dot form of the stacked int4 product at decode M (K33):
    x_odd / 16 contracts against the packed byte read as a signed value and
    x_even - x_odd / 16 (one bf16 rounding) against its low nibble, so only
    one nibble plane is unpacked. Taken after `w4a8()` and before K1, as in
    the reference; changes numerics by one bf16 rounding of that
    difference. Default off; opt-in with GABBY_INT4_RAWDOT=1 or
    set_int4_rawdot(True)."""
    if _INT4_RAWDOT is not None:
        return _INT4_RAWDOT
    return os.environ.get("GABBY_INT4_RAWDOT") == "1"


def set_int4_rawdot(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _INT4_RAWDOT
    _INT4_RAWDOT = enabled


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


def attn_s8() -> bool:
    """s8 decode attention: over an int8 cache, single-position decode
    with the fresh row quantizes q per row and the value-scaled
    probabilities per row and chunk to int8 and takes both products in
    int32 (dense and paged, paired or not). Changes numerics about as the
    int8 cache itself does. Default ON, as in the reference;
    GABBY_ATTN_S8=0 or set_attn_s8(False) restores the bf16/f32 form."""
    if _ATTN_S8 is not None:
        return _ATTN_S8
    return os.environ.get("GABBY_ATTN_S8", "1") != "0"


def set_attn_s8(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _ATTN_S8
    _ATTN_S8 = enabled


def attn_multi() -> bool:
    """Slot-batched decode attention: the bf16/f32 form over an unpaired
    dense cache (int8 or bf16) gives one thread block several slots of a
    kv head.
    Default off, as in the reference; opt-in with GABBY_ATTN_MULTI=1 or
    set_attn_multi(True). Where it applies it is taken before `attn_s8()`
    is looked at, as in the reference: such a cache then decodes in the
    bf16/f32 form."""
    if _ATTN_MULTI is not None:
        return _ATTN_MULTI
    return os.environ.get("GABBY_ATTN_MULTI", "0") == "1"


def set_attn_multi(enabled: Optional[bool]) -> None:
    """True/False force; None restores the environment's setting."""
    global _ATTN_MULTI
    _ATTN_MULTI = enabled


def attn_chunk() -> int:
    """Rows of the dense cache over which s8 decode attention takes one
    quantization scale of the probabilities (GABBY_ATTN_CHUNK, default
    1024; the chunk is min(attn_chunk(), max_seq), counted from row 0).
    Over the paged pool the chunk is a page."""
    return int(os.environ.get("GABBY_ATTN_CHUNK", str(ATTN_CHUNK)))
