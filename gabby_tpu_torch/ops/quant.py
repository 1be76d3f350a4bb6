"""Weight-only quantization: INT8 and INT4, symmetric (counterpart of
gabby_tpu/ops/quant.py).

INT4 weights are packed two per byte along the input (contraction) axis,
HALF-SPLIT: byte i of a [K/2, N] plane holds row i in its low nibble,
biased by +8, and row i + K/2 in its high nibble. The packed bytes are
byte-identical to the reference's, so a checkpoint quantized by either
package serves in the other.

`qlinear` dispatches like the reference (ops/quant.py:170-291 there).
Decode-sized products (M <= 64): stacked int4 weights go to the W4A8
kernel (K8) when `cuda.w4a8()` is on, else to the raw-byte-dot form (K33)
when `cuda.int4_rawdot()` is on, else to the stacked int4 kernel (K1), the
reference's precedence; the group-scaled int4 unembed to the grouped
kernel (K2); stacked int8 weights to K5 and a 2-D int8 weight (the int8
unembed) to K6. The reference leaves
int8 to XLA's fused dequantizing dot unless GABBY_QMM_INT8 is set; eager
PyTorch has no such fusion (a cast would write and re-read the whole
weight as bf16 at every call), so here int8 at decode M always takes its
kernel. Prefill-sized products (M > 64): per-channel int4 takes the int4
kernel (K7) when `cuda.int4_prefill_kernel()` is on; everything else
unpacks the layer's bytes and runs one `torch.matmul`, as the reference
leaves them to XLA. Activations are cast to bf16 before every product, as
in the reference.

FP8 activations (`set_act_fp8`, `GABBY_ACT_FP8=1`; the reference's
BASELINE config 5) pass every `linear()` input through the float8_e4m3
value grid with a per-token scale; the products stay whatever the weight
path uses. `promote_int4_to_int8` builds the exact int8 shadow of an int4
tree that the engine prefills through (`EngineConfig.prefill_int8_shadow`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm

# ---- FP8 activations (the reference's BASELINE config 5) ----
#
# Read once at import, as in the reference; flip with set_act_fp8 before
# any weights are built. The grid pass is plain PyTorch, as it is jnp
# outside any Pallas kernel in the reference.

_ACT_FP8 = os.environ.get("GABBY_ACT_FP8", "0") == "1"
# e4m3's largest normal is 448. The reference divides by 448.0 under
# jax.jit, and XLA rewrites that division into a product by float32(1/448):
# multiplying by the same f32 constant gives the serving reference's bits
_INV_E4M3_MAX = torch.tensor(1.0 / 448.0, dtype=torch.float32).item()


def set_act_fp8(on: bool) -> None:
    global _ACT_FP8
    _ACT_FP8 = bool(on)


def act_fp8_enabled() -> bool:
    return _ACT_FP8


def fp8_activation(x: torch.Tensor) -> torch.Tensor:
    """x on the fp8 (e4m3) value grid with a per-token (last-axis) scale,
    returned in x.dtype."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(absmax * _INV_E4M3_MAX, min=1e-12)
    xq = (xf / scale).to(torch.float8_e4m3fn)
    return (xq.float() * scale).to(x.dtype)


def maybe_fp8_activation(x: torch.Tensor) -> torch.Tensor:
    return fp8_activation(x) if _ACT_FP8 else x


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized weight of logical shape [in_dim, out_dim] (or a stack
    [L, in_dim, out_dim]).

    q: int8. bits=8: [(L,) in, out] codes in [-127, 127]. bits=4:
       [(L,) in // 2, out] half-split packed bytes (see pack_int4).
    scale: f32. Per output channel [(L,) out] when group == 0; per
       (input group, output channel) [in // group, out] when group > 0
       (the int4 unembed table).
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    group: int = 0

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[in, out] int8 in [-7, 7] -> [in // 2, out] packed bytes: byte i
    holds row i, biased by +8, in the low nibble and row i + in//2 in the
    high one."""
    if q.shape[0] % 2:
        raise ValueError("int4 packing needs an even input dim")
    kp = q.shape[0] // 2
    lo = (q[:kp].to(torch.int32) + 8) & 0xF
    hi = (q[kp:].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[in // 2, out] packed -> [in, out] int8, undoing the low-nibble bias
    (the high nibble sign-extends through the arithmetic shift)."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize(w: torch.Tensor, bits: int, group: int = 0) -> QTensor:
    """Symmetric quantization of w: [in, out]; scales per output channel
    (group=0) or per (input group, output channel)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    wf = w.float()
    if group:
        k, n = wf.shape
        if k % group:
            raise ValueError(f"group {group} does not divide {k}")
        wg = wf.reshape(k // group, group, n)
        absmax = torch.amax(torch.abs(wg), dim=1)  # [k // group, out]
        scale = torch.clamp(absmax / qmax, min=1e-8)
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
        q = q.reshape(k, n).to(torch.int8)
    else:
        absmax = torch.amax(torch.abs(wf), dim=0)  # [out]
        scale = torch.clamp(absmax / qmax, min=1e-8)
        q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return QTensor(q=q, scale=scale.float(), bits=bits, group=group)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """2-D QTensor -> dense [in, out] weight."""
    q = unpack_int4(qt.q) if qt.bits == 4 else qt.q
    if qt.group:
        scale = torch.repeat_interleave(qt.scale, qt.group, dim=0)
        return (q.float() * scale).to(dtype)
    return (q.float() * qt.scale[None, :]).to(dtype)


def _codes_matmul(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bf16(x) [M, K] @ int codes [K, N] -> f32 [M, N]. On the card one
    bf16 tensor-core product (bf16 result); on the CPU in f32, which is
    the reference's f32-accumulated dot of bf16 operands exactly."""
    xb = x.to(torch.bfloat16)
    if x.is_cuda:
        return torch.matmul(xb, q.to(torch.bfloat16)).float()
    return torch.matmul(xb.float(), q.float())


def qlinear(x: torch.Tensor, qt: QTensor,
            layer: Optional[int] = None) -> torch.Tensor:
    """x: [..., in] @ QTensor -> [..., out] in x.dtype. `layer` selects one
    layer of a stacked [L, ...] QTensor. With the kernels off
    (`ops.cuda.kernels_enabled()`) no product reaches a wrapper: the
    reference's jnp path (per-group partials for the unembed at decode M,
    else the layer's codes unpacked into one product)."""
    *lead, k_in = x.shape
    x2 = x.reshape(-1, k_in)
    m = x2.shape[0]
    kernels = ck.kernels_enabled()
    if qt.group:
        if qt.q.dim() != 2:
            raise ValueError("group-scaled QTensors are 2-D (the unembed)")
        if qt.bits == 4 and m <= 64:
            out = (cqm.qmatmul_int4_grouped if kernels else
                   cqm.int4_grouped_plain)(x2, qt.q, qt.scale, qt.group)
        else:
            # prefill-sized M: dequantize-then-multiply (the per-group
            # partials would be [G, M, N] f32)
            xb = x2.to(torch.bfloat16)
            w = dequantize(qt, torch.bfloat16)
            out = (torch.matmul(xb, w) if x.is_cuda else
                   torch.matmul(xb.float(), w.float())).to(x.dtype)
        return out.reshape(*lead, out.shape[-1])
    q, scale = qt.q, qt.scale
    stacked = layer is not None and q.dim() == 3
    if q.dim() == 3 and layer is None:
        raise ValueError("a stacked QTensor needs a layer")
    out = None
    if m <= 64 and kernels:
        if qt.bits == 4 and stacked:
            # the reference's precedence: W4A8, then the raw-byte-dot
            # form, then K1
            if ck.w4a8():
                out = cqm.qmatmul_int4_w4a8_stacked(x2, q, scale, layer)
            elif ck.int4_rawdot():
                out = cqm.qmatmul_int4_stacked_rawdot(x2, q, scale, layer)
            else:
                out = cqm.qmatmul_int4_stacked(x2, q, scale, layer)
        elif qt.bits == 8:
            out = (cqm.qmatmul_int8_stacked(x2, q, scale, layer) if stacked
                   else cqm.qmatmul_int8(x2, q, scale))
    elif qt.bits == 4 and kernels and ck.int4_prefill_kernel():
        out = cqm.qmatmul_int4(x2, q, scale, layer if stacked else None)
    if out is None:
        # prefill-sized M (or a 2-D int4 weight at decode M): slice this
        # layer's bytes, unpack, one matmul — the reference leaves this
        # product to XLA as well
        if stacked:
            q, scale = q[layer], scale[layer]
        codes = unpack_int4(q) if qt.bits == 4 else q
        out = (_codes_matmul(x2, codes) * scale).to(x.dtype)
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


def promote_int4_to_int8(params):
    """The exact int8 shadow of an int4 tree, for prefill-sized products:
    every per-channel int4 QTensor becomes int8 with the same codes
    (unpacked layer by layer for a stack [L, in // 2, out] -> [L, in,
    out]) and the same scale tensor, not a copy. Group-scaled tensors (the
    unembed), int8 tensors and unquantized leaves come back as the same
    objects. Costs twice the int4 bytes of the promoted weights."""
    def visit(leaf):
        if not (isinstance(leaf, QTensor) and leaf.bits == 4
                and not leaf.group):
            return leaf
        if leaf.q.dim() == 3:
            q8 = torch.stack([unpack_int4(leaf.q[i])
                              for i in range(leaf.q.shape[0])])
        else:
            q8 = unpack_int4(leaf.q)
        return QTensor(q=q8, scale=leaf.scale, bits=8)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return visit(tree)

    return walk(params)


def quantize_unembed_table(table: torch.Tensor, bits: Optional[int] = None,
                           group: int = 256,
                           pad_to: int = 2048) -> QTensor:
    """Quantize the [D, V] unembed table: INT8 per vocab channel (the
    default), or INT4 with group scales along D and the vocab axis
    zero-padded to a multiple of `pad_to` (consumers slice logits back to
    the true vocab). bits=None reads GABBY_UNEMBED_BITS (default 8), once,
    here at quantize time, as the reference does."""
    if bits is None:
        bits = int(os.environ.get("GABBY_UNEMBED_BITS", "8"))
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    table = table.float()
    if bits == 4:
        v = table.shape[1]
        if pad_to and v % pad_to:
            table = torch.nn.functional.pad(table, (0, pad_to - v % pad_to))
        while group > 1 and table.shape[0] % group:
            group //= 2
        return quantize(table, 4, group=group)
    return quantize(table, 8)


def quantize_tree(params, bits: int, *,
                  unembed_bits: Optional[int] = None,
                  unembed_group: int = 256):
    """Quantize every 2-D+ matmul weight of a params dict. The embedding
    and the norms stay as they are. Stacked [L, in, out] weights quantize
    per layer. The unembed is quantized by quantize_unembed_table: an
    untied `lm_head` in place, or, for tied embeddings, a separate
    quantized [D, V] copy of the embedding that becomes `lm_head`."""
    def visit(name: str, leaf):
        if "embed" in name or "norm" in name or leaf.dim() < 2:
            return leaf
        if name == "lm_head":
            return quantize_unembed_table(leaf, bits=unembed_bits,
                                          group=unembed_group)
        if leaf.dim() == 2:
            return quantize(leaf, bits)
        qs = [quantize(leaf[i], bits) for i in range(leaf.shape[0])]
        return QTensor(q=torch.stack([t.q for t in qs]),
                       scale=torch.stack([t.scale for t in qs]), bits=bits)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if tree is None:
            return None
        return visit("/".join(path), tree)

    out = walk(params, ())
    if out.get("lm_head") is None and "embed" in out:
        out["lm_head"] = quantize_unembed_table(
            out["embed"].float().T, bits=unembed_bits, group=unembed_group)
    return out
