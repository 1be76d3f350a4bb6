"""Weight-only quantized matmul kernels (counterparts of
gabby_tpu/ops/pallas/quant_matmul.py) and their plain PyTorch versions.

K1 `qmatmul_int4_stacked`: x [M <= 64, K] @ int4 W[layer], W stacked
   [L, K/2, N] with per-channel scales [L, N], on the tensor cores with K
   split over a cluster of blocks (`stacked_plan`), one launch a call
   (csrc/quant_matmul_stacked.cu, replacing _qmatmul_int4_stacked :524 /
   _int4_stacked_kernel :424).
K33 `qmatmul_int4_stacked_rawdot`: K1's product in the raw-byte-dot form
   that `ck.int4_rawdot()` selects, on K1's kernel (csrc/
   quant_matmul_stacked.cu, replacing _int4_stacked_rawdot_kernel :455,
   which _qmatmul_int4_stacked takes under GABBY_INT4_RAWDOT=1).
K2 `qmatmul_int4_grouped`: x [M <= 64, K] @ int4 W [K/2, N] with group
   scales [K/group, N] along K — the int4 unembed, on the tensor cores
   (csrc/quant_matmul_unembed.cu, replacing _qmatmul_int4_grouped :669 /
   _int4_grouped_kernel :640).
K5 `qmatmul_int8_stacked`: x [M <= 64, K] @ int8 W[layer], W stacked
   [L, K, N], scales [L, N], on K1's kernel in an int8 form (each code
   converted to bf16 exactly through f32, bf16 products on the tensor
   cores), one launch a call (csrc/quant_matmul_int8_stacked.cu, replacing
   _qmatmul_int8_stacked :504 / _int8_stacked_kernel :409).
K6 `qmatmul_int8`: x [M <= 64, K] @ a 2-D int8 W [K, N] with scales [N]
   — the int8 unembed, on K2's persistent kernel in an int8 form (each
   code converted to bf16 exactly through f32), one launch a call
   (csrc/quant_matmul_int8_unembed.cu, replacing _qmatmul_int8 :287 /
   _int8_kernel :237); on the card K a multiple of 64, N of 16
   (`int8_unembed_launch`).
K7 `qmatmul_int4`: x [any M, K] @ per-channel int4 W [K/2, N] (2-D, or
   one layer of a stack) on the tensor cores — prefill-sized M
   (csrc/quant_matmul_prefill.cu, replacing _qmatmul_int4 :321 /
   _int4_kernel :252).
K8 `qmatmul_int4_w4a8_stacked`: x quantized per row to int8 inside the
   launch, then int8 x int4 W[layer] on the int8 tensor cores with an
   int32 accumulator, on K1's kernel in an s8 form, one launch a call
   (csrc/quant_matmul_w4a8.cu, replacing _qmatmul_int4_w4a8_stacked :766 /
   _int4_w4a8_stacked_kernel :734); the plain version's bits.

The stacked forms (K1, K33, K5, K8: csrc/quant_matmul_stacked.cuh) take on
the card a weight plane of a multiple of 64 rows (K/2 for the packed int4
stacks, K for int8), N a multiple of 128 and 1 <= M <= 64, and raise
ValueError otherwise (`stacked_launch`).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. x is bf16 on the card; the output is in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck

MAX_M = 64
_STRIP = 128  # output channels a strip of the tensor-core kernels
_STAGE_ROWS = 64  # weight rows per stage of the stacked kernel (kBKP)
MAX_SPLIT = 8  # blocks a strip's K is split over: the portable cluster size
# codes a weight byte holds, by the stacked kernels' counters: a packed int4
# byte two (its plane has K/2 rows), an int8 byte one (K rows)
CODES_A_BYTE = {"int4_matmul_stacked": 2, "int4_matmul_stacked_rawdot": 2,
                "int4_matmul_w4a8_stacked": 2, "int8_matmul_stacked": 1}


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


def int4_stacked_rawdot_plain(x, packed, scale, layer: int) -> torch.Tensor:
    """Plain version of K33, the reference's raw-byte-dot arithmetic
    (_qmatmul_int4_stacked with GABBY_INT4_RAWDOT=1): xo16 = x_odd / 16
    (exact), xc = x_even - xo16 rounded once to bf16, contracted against
    the packed byte b read as a signed value and against lo8 = b & 15, the
    +8 bias taken out by the row sums: acc = xo16 . b + xc . lo8 - 8
    (rowsum(xc) + rowsum(xo16)) in f32, then the per-channel scale."""
    kp = packed.shape[1]
    xb = x.to(torch.bfloat16).float()
    xo16 = (xb[:, kp:] * 0.0625).to(torch.bfloat16).float()
    xc = (xb[:, :kp] - xo16).to(torch.bfloat16).float()
    b = packed[layer].to(torch.int32)
    acc = (torch.matmul(xo16, b.float()) + torch.matmul(xc, (b & 15).float())
           - 8.0 * (xc.sum(dim=1, keepdim=True)
                    + xo16.sum(dim=1, keepdim=True)))
    return (acc * scale[layer]).to(x.dtype)


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
    Both quotients are correctly rounded f32 divisions on every device (a
    tensor divisor: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal instead), as K8's kernel computes them. Returns (xq
    int8 [M, K], xs f32 [M, 1])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    xs = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
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


def int8_unembed_launch(m: int, k: int, n: int,
                        sms: int) -> tuple[int, int]:
    """The launch of K6 (csrc/quant_matmul_int8_unembed.cu) for x [m, k]
    against an int8 [k, n] plane on a card of `sms` multiprocessors: (bt,
    blocks). bt is the token tile, 8 for m <= 8 (wgmma n8, two blocks a
    multiprocessor) and 64 above (one); blocks, the persistent grid, is the
    strips of 128 channels (the last one may pass n) or that many blocks
    a multiprocessor, whichever is fewer. The kernel takes K a multiple of
    64 (a stage's rows) and N a multiple of 16 (TMA's 16-byte row stride);
    it raises ValueError otherwise."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"int8 unembed takes 1..{MAX_M} rows, got {m}")
    if k <= 0 or k % _STAGE_ROWS or n <= 0 or n % 16:
        raise ValueError(f"int8 unembed takes K a multiple of "
                         f"{_STAGE_ROWS} and N a multiple of 16, got K {k}, "
                         f"N {n}")
    bt = 8 if m <= 8 else 64
    strips = -(-n // _STRIP)
    return bt, min(strips, sms * (2 if bt == 8 else 1))


def stacked_plan(m: int, kp: int, n: int, sms: int) -> tuple[int, int]:
    """The launch of a stacked kernel (csrc/quant_matmul_stacked.cuh: K1,
    K33, K8 on a packed [kp = K/2, n] plane; K5 on an int8 [kp = K, n]
    one) for x [m, K] on a card of `sms` multiprocessors: (bt, split). bt
    is the token tile: 8 for m <= 8 (wgmma n8, two blocks a
    multiprocessor), 64 above (one). split is the number of blocks in the
    cluster that shares one 128-channel strip's kp / 64 stages: the largest
    power of two that divides the stages, stays within `split_cap(bt)` and
    keeps the grid (strips x split) within one wave of blocks; at least 1.
    (The cross-block reduction of a [64, 128] f32 partial costs more than
    the idle multiprocessors it saves beyond 4 blocks, so the M = 64 form
    leaves some idle at the 1B shapes.)"""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"stacked matmul takes 1..{MAX_M} rows, got {m}")
    if kp <= 0 or kp % _STAGE_ROWS or n <= 0 or n % _STRIP:
        raise ValueError(f"stacked matmul takes a weight plane of a "
                         f"multiple of {_STAGE_ROWS} rows and N a multiple "
                         f"of {_STRIP}, got {kp} rows, N {n}")
    bt = 8 if m <= 8 else 64
    stages, strips = kp // _STAGE_ROWS, n // _STRIP
    slots = sms * (2 if bt == 8 else 1)
    split = 1
    while (2 * split <= split_cap(bt) and stages % (2 * split) == 0
           and strips * 2 * split <= slots):
        split *= 2
    return bt, split


def split_cap(bt: int) -> int:
    """The most blocks stacked_plan splits a strip's K over at token tile
    bt: the portable cluster size at bt = 8, half of it at bt = 64."""
    return MAX_SPLIT if bt == 8 else MAX_SPLIT // 2


def stacked_launch(name: str, m: int, k: int, n: int,
                   sms: int) -> tuple[int, int]:
    """stacked_plan for the stacked kernel counted as `name` (a key of
    CODES_A_BYTE) at x [m, k] and n channels: its weight plane has k /
    CODES_A_BYTE[name] rows, so K must be a multiple of 64 (K5) or 128
    (K1, K33, K8); raises ValueError otherwise."""
    per = CODES_A_BYTE[name]
    if k <= 0 or k % (per * _STAGE_ROWS):
        raise ValueError(f"{name} takes K a multiple of "
                         f"{per * _STAGE_ROWS}, got {k}")
    return stacked_plan(m, k // per, n, sms)


@functools.lru_cache(maxsize=None)
def multiprocessors(index: int) -> int:
    """The multiprocessor count of CUDA device `index` (cached)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# the tensor maps of the stacks the stacked kernels have seen, by
# (data_ptr, shape, strides): a map of a stack of byte planes depends on
# nothing else, so a call encodes only x's
_STACK_MAPS: dict = {}


def _stack_map(planes: torch.Tensor):
    key = (planes.data_ptr(), tuple(planes.shape), planes.stride())
    wmap = _STACK_MAPS.get(key)
    if wmap is None:
        from gabby_tpu_torch.ops.cuda import build
        nl, rows, n = planes.shape
        wmap = ctypes.create_string_buffer(128)  # sizeof(CUtensorMap)
        build.check(build.library().gabby_int4_stacked_map(
            planes.data_ptr(), nl, 2 * rows, n, ctypes.addressof(wmap)),
            "stacked matmul: the weight's tensor map")
        if len(_STACK_MAPS) >= 64:
            _STACK_MAPS.clear()
        _STACK_MAPS[key] = wmap
    return wmap


def _launch_stacked(name: str, entry: str, what: str, x, planes, scale,
                    layer: int, with_acc: bool = False):
    """A stacked kernel (K1, K33, K5, K8; `name` its counter) through its C
    entry point `entry`: one launch, no workspace. planes: the stack [L,
    rows, N] of packed int4 (rows K/2) or int8 (rows K) codes. Returns
    (out, K8's int32 accumulator or None); with_acc: K8 also writes it."""
    _, s_ptr = _layer_ptrs(what, planes, scale, layer)
    _, rows, n = planes.shape
    k = CODES_A_BYTE[name] * rows
    # 64 weight rows a stage, 128 channels a strip
    _check(what, x, planes, scale, k, n,
           k_multiple=CODES_A_BYTE[name] * _STAGE_ROWS, n_multiple=_STRIP)
    m = x.shape[0]
    bt, split = stacked_launch(name, m, k, n,
                               multiprocessors(x.device.index))
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    wmap = _stack_map(planes)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    acc = (torch.empty((m, n), dtype=torch.int32, device=x.device)
           if with_acc else None)
    head = [x.data_ptr(), ctypes.addressof(wmap), s_ptr, out.data_ptr()]
    if name == "int4_matmul_w4a8_stacked":
        head.append(None if acc is None else acc.data_ptr())
    build.check(getattr(lib, entry)(
        *head, m, k, n, layer, bt, split, build.stream_ptr(x.device)), name)
    ck.launch_counts[name] += 1
    return out, acc


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


def qmatmul_int4_stacked(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, layer: int) -> torch.Tensor:
    """K1. x [M, K]; packed [L, K/2, N] int8; scale [L, N] f32 -> [M, N].
    On the card K/2 must be a multiple of 64 and N of 128; the plain
    version takes any even K."""
    if not x.is_cuda:
        return int4_stacked_plain(x, packed, scale, layer)
    return _launch_stacked("int4_matmul_stacked", "gabby_int4_matmul",
                           "int4 stacked matmul", x, packed, scale,
                           layer)[0]


def qmatmul_int4_stacked_rawdot(x: torch.Tensor, packed: torch.Tensor,
                                scale: torch.Tensor,
                                layer: int) -> torch.Tensor:
    """K33, K1's raw-byte-dot form (`ck.int4_rawdot()`), on K1's kernel and
    shape rules. x [M, K]; packed [L, K/2, N] int8; scale [L, N] f32 ->
    [M, N]."""
    if not x.is_cuda:
        return int4_stacked_rawdot_plain(x, packed, scale, layer)
    return _launch_stacked("int4_matmul_stacked_rawdot",
                           "gabby_int4_matmul_rawdot",
                           "int4 stacked raw-byte-dot matmul", x, packed,
                           scale, layer)[0]


def qmatmul_int4_grouped(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, group: int) -> torch.Tensor:
    """K2. x [M, K]; packed [K/2, N] int8; scale [K/group, N] f32 -> [M, N].
    On the card (csrc/quant_matmul_unembed.cu): K/2 and `group` multiples
    of 64, N a multiple of 128; the plain version takes any group that
    divides K/2."""
    if not x.is_cuda:
        return int4_grouped_plain(x, packed, scale, group)
    what = "int4 grouped matmul"
    kp, n = packed.shape
    k = 2 * kp
    if group <= 0 or kp % group or scale.shape != (k // group, n):
        raise ValueError(f"{what}: group {group} must divide K/2 = {kp}, "
                         f"scale {tuple(scale.shape)}")
    if group % 64:
        raise ValueError(f"{what}: group {group} is no multiple of 64 (a "
                         f"stage of 64 packed rows lies in one group)")
    _check(what, x, packed, scale, k, n, k_multiple=128, n_multiple=128)
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    build.check(lib.gabby_int4_unembed(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m,
        k, n, group, build.stream_ptr(x.device)), "int4_matmul_grouped")
    ck.launch_counts["int4_matmul_grouped"] += 1
    return out


def qmatmul_int8_stacked(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, layer: int) -> torch.Tensor:
    """K5. x [M, K]; codes [L, K, N] int8; scale [L, N] f32 -> [M, N].
    On the card K must be a multiple of 64 and N of 128; the plain version
    takes any shape."""
    if not x.is_cuda:
        return int8_stacked_plain(x, codes, scale, layer)
    return _launch_stacked("int8_matmul_stacked",
                           "gabby_int8_matmul_stacked",
                           "int8 stacked matmul", x, codes, scale, layer)[0]


def qmatmul_int8(x: torch.Tensor, codes: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """K6. x [M, K]; codes [K, N] int8; scale [N] f32 -> [M, N]. On the
    card 1 <= M <= 64, K a multiple of 64 and N of 16
    (`int8_unembed_launch`); the plain version takes any shape."""
    if not x.is_cuda:
        return int8_plain(x, codes, scale)
    what = "int8 unembed"
    k, n = codes.shape
    if scale.shape != (n,):
        raise ValueError(f"{what}: scale {tuple(scale.shape)} for codes "
                         f"{tuple(codes.shape)}")
    _check(what, x, codes, scale, k, n, k_multiple=1, n_multiple=1)
    m = x.shape[0]
    int8_unembed_launch(m, k, n, multiprocessors(x.device.index))
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    build.check(lib.gabby_int8_unembed(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(), m,
        k, n, build.stream_ptr(x.device)), "int8_matmul")
    ck.launch_counts["int8_matmul"] += 1
    return out


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
    which is exact and so comparable by equality. On the card K/2 must be
    a multiple of 64 and N of 128 (K1's shapes); the kernel quantizes x
    itself and gives the plain version's bits. The plain version takes any
    even K."""
    if not x.is_cuda:
        return int4_w4a8_stacked_plain(x, packed, scale, layer, return_acc)
    out, acc = _launch_stacked("int4_matmul_w4a8_stacked",
                               "gabby_w4a8_matmul", "int4 w4a8 matmul", x,
                               packed, scale, layer, with_acc=return_acc)
    return (out, acc) if return_acc else out
