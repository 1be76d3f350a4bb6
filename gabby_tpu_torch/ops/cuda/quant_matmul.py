"""Weight-only quantized matmul kernels (counterparts of
gabby_tpu/ops/pallas/quant_matmul.py) and their plain PyTorch versions.

K1 `qmatmul_int4_stacked`: x [M <= 64, K] @ int4 W[layer], W stacked
   [L, K/2, N] with per-channel scales [L, N] (csrc/quant_matmul.cu,
   replacing _qmatmul_int4_stacked :524 / _int4_stacked_kernel :424).
K2 `qmatmul_int4_grouped`: x [M <= 64, K] @ int4 W [K/2, N] with group
   scales [K/group, N] along K — the int4 unembed (replacing
   _qmatmul_int4_grouped :669 / _int4_grouped_kernel :640).
K5 `qmatmul_int8_stacked`: x [M <= 64, K] @ int8 W[layer], W stacked
   [L, K, N], scales [L, N] (csrc/quant_matmul.cu, replacing
   _qmatmul_int8_stacked :504 / _int8_stacked_kernel :409).
K6 `qmatmul_int8`: the same on a 2-D [K, N] weight — the int8 unembed
   (replacing _qmatmul_int8 :287 / _int8_kernel :237). K5 and K6 launch
   one kernel (a layer is a pointer offset) and count separately.
K7 `qmatmul_int4`: x [any M, K] @ per-channel int4 W [K/2, N] (2-D, or
   one layer of a stack) on the tensor cores — prefill-sized M
   (csrc/quant_matmul_prefill.cu, replacing _qmatmul_int4 :321 /
   _int4_kernel :252).
K8 `qmatmul_int4_w4a8_stacked`: x quantized per row to int8 here, then
   int8 x int4 W[layer] with integer dots and an int32 accumulator
   (csrc/quant_matmul_w4a8.cu, replacing _qmatmul_int4_w4a8_stacked :766 /
   _int4_w4a8_stacked_kernel :734).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. x is bf16 on the card; the output is in x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck

MAX_M = 64
_STRIP = 128  # output columns per block (kStrip of the decode kernels)
_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, N] half-split packed int8 -> [K, N] codes (ops/quant layout)."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, p >> 4], dim=0)


def _codes_plain(x, codes, scale) -> torch.Tensor:
    """The reference's jnp contract: bf16 x against integer codes, f32
    accumulation, per-channel scale once."""
    acc = torch.matmul(x.to(torch.bfloat16).float(), codes.float())
    return (acc * scale).to(x.dtype)


def int4_stacked_plain(x, packed, scale, layer: int) -> torch.Tensor:
    """Plain version of K1."""
    return _codes_plain(x, _unpack(packed[layer]), scale[layer])


def int4_plain(x, packed, scale, layer: Optional[int] = None) -> torch.Tensor:
    """Plain version of K7: as K1's, at any M, on a 2-D weight or one layer
    of a stack."""
    if layer is not None:
        packed, scale = packed[layer], scale[layer]
    return _codes_plain(x, _unpack(packed), scale)


def int8_stacked_plain(x, codes, scale, layer: int) -> torch.Tensor:
    """Plain version of K5."""
    return _codes_plain(x, codes[layer], scale[layer])


def int8_plain(x, codes, scale) -> torch.Tensor:
    """Plain version of K6."""
    return _codes_plain(x, codes, scale)


def int4_grouped_plain(x, packed, scale, group: int) -> torch.Tensor:
    """Plain version of K2: per-group f32 partial products, each scaled by
    its group's scale, summed over groups (the reference's decode-M
    grouped contract)."""
    m, k = x.shape
    g = scale.shape[0]
    xg = x.to(torch.bfloat16).float().reshape(m, g, group).transpose(0, 1)
    qg = _unpack(packed).float().reshape(g, group, -1)
    acc = torch.bmm(xg, qg) * scale[:, None, :]  # [G, M, N]
    return acc.sum(dim=0).to(x.dtype)


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8 quantization of x [M, K], rounding as the
    reference does (half to even, clip +-127, scale max(absmax/127, 1e-8)).
    Returns (xq int8 [M, K], xs f32 [M, 1])."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def int4_w4a8_stacked_plain(x, packed, scale, layer: int,
                            return_acc: bool = False):
    """Plain version of K8: quantize x per row, an exact integer product
    (in f64: the sums stay far below 2^53), then acc * xs * scale. With
    return_acc also the int32 accumulator."""
    xq, xs = quantize_activations(x)
    acc = torch.matmul(xq.double(), _unpack(packed[layer]).double())
    out = (acc.float() * xs * scale[layer]).to(x.dtype)
    return (out, acc.to(torch.int32)) if return_acc else out


def _n_split(n: int, rows: int, multiple: int = 1) -> int:
    """K slices per column strip: enough blocks to cover the SMs twice,
    while every slice keeps at least 16 of the weight plane's `rows` (one
    per row lane of a block) and a multiple of `multiple`."""
    strips = -(-n // _STRIP)
    split = 1
    while (strips * split < _TARGET_BLOCKS
           and rows % (2 * split * multiple) == 0
           and rows // (2 * split) >= 16):
        split *= 2
    return split


def _check(what: str, x, q, scale, k: int, n: int, *,
           max_m: Optional[int] = MAX_M, k_multiple: int = 2,
           n_multiple: int = 16) -> None:
    if not (x.is_cuda and q.is_cuda and scale.is_cuda):
        raise ValueError(f"{what}: all tensors must be on the GPU")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"{what} takes bf16 x, int8 weight bytes and "
                         f"f32 scales, got {x.dtype}, {q.dtype}, "
                         f"{scale.dtype}")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    if x.dim() != 2 or x.shape[0] < 1 or (max_m is not None
                                          and x.shape[0] > max_m):
        rows = f"1..{max_m}" if max_m is not None else ">= 1"
        raise ValueError(f"{what} takes {rows} rows, got x "
                         f"{tuple(x.shape)}")
    if x.shape[1] != k or k % k_multiple or n % n_multiple:
        raise ValueError(f"{what} shape mismatch: x {tuple(x.shape)}, "
                         f"K {k} (a multiple of {k_multiple}), N {n} "
                         f"(a multiple of {n_multiple})")


def _layer_ptrs(what: str, q, scale, layer: int):
    """Pointers to one layer of a stack [L, rows, N] and its scales [L, N]:
    the layer is a pointer offset into the stack, no slice copy."""
    nl, rows, n = q.shape
    if not 0 <= layer < nl or scale.shape != (nl, n):
        raise ValueError(f"{what}: bad layer {layer} or scale "
                         f"{tuple(scale.shape)} for weight {tuple(q.shape)}")
    return (q.data_ptr() + layer * rows * n,
            scale.data_ptr() + layer * n * 4)


def _launch(name: str, x, q_ptr: int, scale_ptr: int, k: int, n: int,
            group: int, bits: int = 4) -> torch.Tensor:
    """The decode kernel of csrc/quant_matmul.cu on int4 (K1, K2) or int8
    (K5, K6) weights, with its split-K workspace and finalize pass."""
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    split = _n_split(n, k // 2 if bits == 4 else k)
    ws = (torch.zeros((m, n), dtype=torch.float32, device=x.device)
          if split > 1 else None)
    ws_ptr = ws.data_ptr() if ws is not None else None
    stream = build.stream_ptr(x.device)
    if bits == 4:
        err = lib.gabby_int4_matmul(x.data_ptr(), q_ptr, scale_ptr,
                                    out.data_ptr(), ws_ptr, m, k, n, group,
                                    split, stream)
    else:
        err = lib.gabby_int8_matmul(x.data_ptr(), q_ptr, scale_ptr,
                                    out.data_ptr(), ws_ptr, m, k, n, split,
                                    stream)
    build.check(err, name)
    if ws is not None:
        build.check(lib.gabby_matmul_finalize(
            ws_ptr, None if group else scale_ptr, out.data_ptr(),
            m, n, stream), name + " finalize")
    ck.launch_counts[name] += 1
    return out


def qmatmul_int4_stacked(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, layer: int) -> torch.Tensor:
    """K1. x [M, K]; packed [L, K/2, N] int8; scale [L, N] f32 -> [M, N]."""
    if not x.is_cuda:
        return int4_stacked_plain(x, packed, scale, layer)
    q_ptr, s_ptr = _layer_ptrs("int4 stacked matmul", packed, scale, layer)
    _, kp, n = packed.shape
    _check("int4 stacked matmul", x, packed, scale, 2 * kp, n)
    return _launch("int4_matmul_stacked", x, q_ptr, s_ptr, 2 * kp, n, 0)


def qmatmul_int4_grouped(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, group: int) -> torch.Tensor:
    """K2. x [M, K]; packed [K/2, N] int8; scale [K/group, N] f32 -> [M, N]."""
    if not x.is_cuda:
        return int4_grouped_plain(x, packed, scale, group)
    kp, n = packed.shape
    k = 2 * kp
    if group <= 0 or kp % group or scale.shape != (k // group, n):
        raise ValueError(f"int4 grouped: group {group} must divide K/2 = "
                         f"{kp}, scale {tuple(scale.shape)}")
    _check("int4 grouped matmul", x, packed, scale, k, n)
    return _launch("int4_matmul_grouped", x, packed.data_ptr(),
                   scale.data_ptr(), k, n, group)


def qmatmul_int8_stacked(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, layer: int) -> torch.Tensor:
    """K5. x [M, K]; codes [L, K, N] int8; scale [L, N] f32 -> [M, N]."""
    if not x.is_cuda:
        return int8_stacked_plain(x, codes, scale, layer)
    q_ptr, s_ptr = _layer_ptrs("int8 stacked matmul", codes, scale, layer)
    _, k, n = codes.shape
    _check("int8 stacked matmul", x, codes, scale, k, n, k_multiple=1)
    return _launch("int8_matmul_stacked", x, q_ptr, s_ptr, k, n, 0, bits=8)


def qmatmul_int8(x: torch.Tensor, codes: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """K6. x [M, K]; codes [K, N] int8; scale [N] f32 -> [M, N]."""
    if not x.is_cuda:
        return int8_plain(x, codes, scale)
    k, n = codes.shape
    if scale.shape != (n,):
        raise ValueError(f"int8 matmul: scale {tuple(scale.shape)} for "
                         f"codes {tuple(codes.shape)}")
    _check("int8 matmul", x, codes, scale, k, n, k_multiple=1)
    return _launch("int8_matmul", x, codes.data_ptr(), scale.data_ptr(),
                   k, n, 0, bits=8)


def qmatmul_int4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 layer: Optional[int] = None) -> torch.Tensor:
    """K7. x [M, K], any M >= 1; packed [K/2, N] int8 with scale [N] f32,
    or a stack [L, K/2, N] / [L, N] with `layer` -> [M, N]."""
    if not x.is_cuda:
        return int4_plain(x, packed, scale, layer)
    what = "int4 prefill matmul"
    if (packed.dim() == 3) != (layer is not None):
        raise ValueError(f"{what}: a stacked weight needs a layer, a 2-D "
                         f"one takes none (packed {tuple(packed.shape)})")
    if layer is not None:
        q_ptr, s_ptr = _layer_ptrs(what, packed, scale, layer)
    else:
        if scale.shape != (packed.shape[1],):
            raise ValueError(f"{what}: scale {tuple(scale.shape)} for "
                             f"packed {tuple(packed.shape)}")
        q_ptr, s_ptr = packed.data_ptr(), scale.data_ptr()
    kp, n = packed.shape[-2:]
    # K and N multiples of 64 (csrc/quant_matmul_prefill.cu's TMA boxes)
    _check(what, x, packed, scale, 2 * kp, n, max_m=None, k_multiple=64,
           n_multiple=64)
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    # where the output tiles cannot fill the card, K is split in two and
    # the parts' f32 sums are merged in a fixed order by a second pass
    k_split = lib.gabby_int4_matmul_prefill_splits(m, 2 * kp, n)
    part = (torch.empty((k_split, m, n), dtype=torch.float32,
                        device=x.device) if k_split > 1 else None)
    build.check(lib.gabby_int4_matmul_prefill(
        x.data_ptr(), q_ptr, s_ptr, out.data_ptr(),
        0 if part is None else part.data_ptr(), m, 2 * kp, n, k_split,
        build.stream_ptr(x.device)), "int4_matmul")
    ck.launch_counts["int4_matmul"] += 1
    return out


def qmatmul_int4_w4a8_stacked(x: torch.Tensor, packed: torch.Tensor,
                              scale: torch.Tensor, layer: int,
                              return_acc: bool = False):
    """K8. x [M, K]; packed [L, K/2, N] int8; scale [L, N] f32 -> [M, N].
    With return_acc also the int32 accumulator [M, N] (before the scales),
    which is exact and so comparable by equality."""
    if not x.is_cuda:
        return int4_w4a8_stacked_plain(x, packed, scale, layer, return_acc)
    what = "int4 w4a8 matmul"
    q_ptr, s_ptr = _layer_ptrs(what, packed, scale, layer)
    _, kp, n = packed.shape
    # x words of 4 int8 in each half: K/2 a multiple of 4
    _check(what, x, packed, scale, 2 * kp, n, k_multiple=8)
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    m = x.shape[0]
    xq, xs = quantize_activations(x)
    acc = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    stream = build.stream_ptr(x.device)
    build.check(lib.gabby_w4a8_matmul(
        xq.data_ptr(), q_ptr, acc.data_ptr(), m, 2 * kp, n,
        _n_split(n, kp, multiple=4), stream), "int4_matmul_w4a8_stacked")
    build.check(lib.gabby_w4a8_finalize(
        acc.data_ptr(), xs.data_ptr(), s_ptr, out.data_ptr(), m, n, stream),
        "int4_matmul_w4a8_stacked finalize")
    ck.launch_counts["int4_matmul_w4a8_stacked"] += 1
    return (out, acc) if return_acc else out
