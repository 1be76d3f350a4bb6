"""Plain mirrors of the arithmetic of the stacked kernels' int8 forms
(csrc/quant_matmul_stacked.cuh), held here on the CPU because the kernels
run only on the card (tests/test_torch_cuda.py, chip_smoke.py):

- K5 (`qmatmul_int8_stacked`): an int8 code c becomes bf16 through f32
  (c + 128 as the low byte of 2^23's f32 bits, less 2^23 + 128; the f32's
  high half is the bf16) exactly, for every byte value, and the product
  through that conversion against the JAX Pallas kernel in interpret mode
  and the plain version;
- K8 (`qmatmul_int4_w4a8_stacked`): the activation codes as the kernel
  computes them (absmax / 127 correctly rounded; x / xs as the product with
  the correctly rounded reciprocal, corrected once by its remainder through
  two FMAs, emulated exactly; rounded half to even by adding 1.5 2^23 and
  taking the low byte) bit for bit against `quantize_activations` (IEEE
  division, round, clip +-127) over every finite bf16 value at several row
  maxima; the kernel's data layout (ldmatrix.x4.trans
  of the packed stage, one byte permute a register, the nibbles as int8
  16 w, x's codes laid out in the same order of K through the 128-byte
  swizzle) emulated lane by lane into the s8 products, whose sums shifted
  right by 4 equal the plain version's int32 accumulator and give its
  output bits; and that output against the JAX Pallas kernel in interpret
  mode at its test's tolerance (1e-2: the reference divides absmax by 127
  through XLA, which may round xs one step apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops import quant as jquant
from gabby_tpu.ops.pallas import quant_matmul as pqm
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(bits):
    """bf16 bit patterns (integers) -> their f32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _stack(r, nl, k, n, bits, scale=0.1):
    w = r.standard_normal((nl, k, n)).astype(np.float32) * scale
    qs = [jquant.quantize(jnp.asarray(w[i]), bits) for i in range(nl)]
    return (np.stack([np.asarray(q.q) for q in qs]),
            np.stack([np.asarray(q.scale) for q in qs]))


# ---- K5: an int8 code as bf16 -----------------------------------------------

def _codes_bf16(b):
    """codes_bf16x2 for code bytes b (uint8): the f32 whose bits are 2^23's
    with c + 128 in the low byte, less 2^23 + 128 (exact: both are
    integers below 2^24), and the bf16 bits its high half. Returns (the
    f32 values, the bf16 bits)."""
    u = np.asarray(b, np.uint32) ^ 0x80
    f = (u | 0x4B000000).view(np.float32) - np.float32(8388736)
    bits = f.view(np.uint32)
    assert np.all(bits & 0xFFFF == 0)  # the high half is the whole value
    return f, bits >> 16


def test_int8_codes_through_f32_give_every_code():
    b = np.arange(256, dtype=np.uint32)
    f, bits = _codes_bf16(b)
    codes = b.astype(np.uint8).view(np.int8)
    assert np.array_equal(f, codes.astype(np.float32))
    assert np.array_equal(_bf16(bits), codes.astype(np.float32))


@pytest.mark.parametrize("m", [1, 8, 13])
def test_int8_codes_product_against_the_jax_kernel(m):
    """K5's product of bf16 x and the codes as the kernel converts them, in
    f32, against the JAX Pallas int8 stacked kernel in interpret mode and
    the plain version."""
    r = np.random.default_rng(40 + m)
    nl, k, n = 2, 256, 256
    q, s = _stack(r, nl, k, n, 8)
    x = jnp.asarray(r.standard_normal((m, k)).astype(np.float32),
                    jnp.bfloat16)
    xf = np.asarray(x, np.float32)
    _, bits = _codes_bf16(q[1].view(np.uint8))
    acc = xf @ _bf16(bits)
    out = torch.from_numpy(acc * s[1]).bfloat16().float().numpy()
    ref = np.asarray(pqm.qmatmul_stacked(x, jnp.asarray(q),
                                         jnp.asarray(s), 1, 8), np.float32)
    np.testing.assert_allclose(out, ref, **BF16_TOL)
    plain = cqm.int8_stacked_plain(torch.from_numpy(xf).bfloat16(),
                                   torch.from_numpy(q), torch.from_numpy(s),
                                   1)
    np.testing.assert_allclose(out, plain.float().numpy(), **BF16_TOL)


# ---- K8: the activation codes ---------------------------------------------

def _fma32(a, b, c):
    """f32 fma(a, b, c) rounded once, as the card's __fmaf_rn: a * b is
    exact in f64 and so is the f64 sum's error (TwoSum); a sum that lands
    on the midpoint of two f32 neighbours is sent the error's way."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(c, p.shape).astype(np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    t = s.astype(np.float32)
    below = np.where(t.astype(np.float64) <= s, t,
                     np.nextafter(t, np.float32(-np.inf)))
    above = np.where(t.astype(np.float64) >= s, t,
                     np.nextafter(t, np.float32(np.inf)))
    mid = (below.astype(np.float64) + above.astype(np.float64)) / 2 == s
    mid &= below != above
    return np.where(mid & (err > 0), above,
                    np.where(mid & (err < 0), below, t))


def _kernel_quotient_codes(xf, xs):
    """K8's codes of xf at row scales xs, in numpy f32 as the kernel
    computes them (x_code): rs = 1 / xs (__frcp_rn), q0 = x rs, q =
    fma(fma(-q0, xs, x), rs, q0), the code the low byte of q + 1.5 2^23."""
    rs = np.float32(1) / xs
    q0 = xf * rs
    q = _fma32(_fma32(-q0, xs, xf), rs, q0)
    rounded = (q + np.float32(12582912)).astype(np.float32)
    return (rounded.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _kernel_codes(xf):
    """K8's quantization of rows xf [M, K] (f32 values of bf16): xs =
    max(absmax / 127, 1e-8) (__fdiv_rn), then _kernel_quotient_codes."""
    absmax = np.abs(xf).max(axis=1, keepdims=True)
    xs = np.maximum(absmax / np.float32(127), np.float32(1e-8))
    return _kernel_quotient_codes(xf, xs), xs


_ALL = np.arange(1 << 16)
FINITE = _ALL[(_ALL >> 7) & 0xFF != 0xFF]  # every finite bf16 bit pattern


def _against_quantize_activations(rows):
    xb = torch.from_numpy(rows).bfloat16()
    xq, xs = cqm.quantize_activations(xb)
    codes, want_xs = _kernel_codes(xb.float().numpy())
    np.testing.assert_array_equal(xq.numpy(), codes)
    np.testing.assert_array_equal(xs.numpy().view(np.uint32),
                                  want_xs.view(np.uint32))


def test_w4a8_codes_where_each_value_is_its_rows_maximum():
    """Every finite bf16 value alone in its row (its code is +-127, or 0),
    and an all-zero row."""
    rows = np.concatenate([_bf16(FINITE), np.zeros(1, np.float32)])
    _against_quantize_activations(rows[:, None])
    _against_quantize_activations(np.zeros((1, 64), np.float32))


@pytest.mark.parametrize("top", [0x7F7F, 0x4480, 0x3F80, 0x3E2A, 0x35AB,
                                 0x35AA, 0x0080, 0x0003])
def test_w4a8_codes_at_a_rows_maximum(top):
    """Every finite bf16 value of magnitude up to a row maximum (the
    largest finite bf16, 1024, 1, 0.166, just above and below the 1e-8
    floor of xs at 1.27e-6, the smallest normal, a subnormal) in one row
    with that maximum: the kernel's codes are quantize_activations'."""
    x = _bf16(FINITE)
    amax = _bf16(top)
    row = np.concatenate([x[np.abs(x) <= amax], [amax]])
    _against_quantize_activations(row[None, :])


def test_w4a8_codes_at_random_row_maxima():
    """128 rows, each every finite bf16 value up to a maximum drawn from
    the normal bf16 values (the rest of the row zero): the kernel's codes
    are quantize_activations'. Here the quotient's remainder correction
    matters: the product with the reciprocal alone gives another code at
    some values (checked)."""
    r = np.random.default_rng(70)
    tops = r.choice(FINITE[(FINITE & 0x7FFF) >= 0x0080], 128, replace=False)
    x = _bf16(FINITE)
    rows = np.zeros((len(tops), len(x) + 1), np.float32)
    for i, top in enumerate(tops):
        amax = np.abs(_bf16(top))
        keep = x[np.abs(x) <= amax]
        rows[i, :len(keep)] = keep
        rows[i, -1] = amax
    _against_quantize_activations(rows)
    xs = np.maximum(np.abs(rows).max(axis=1, keepdims=True)
                    / np.float32(127), np.float32(1e-8))
    rough = np.rint(rows * (np.float32(1) / xs))
    assert (rough != np.rint(rows / xs)).any()


# ---- K8: the data layout of the s8 products --------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) on uint32 (selector bits 0-2 of each
    nibble)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _swz(n, byte):
    """The 128-byte swizzle: byte `byte` of 128-byte row n of a tile."""
    return n * 128 + (((byte >> 4) ^ (n & 7)) << 4) + (byte & 15)


def _a_fragments(stage, chunk):
    """unpack_stage_s8: for the warp whose 16 channels are `chunk` of the
    [64 rows, 128 channels] byte stage, [lane][k32 step][reg] uint32."""
    a = np.zeros((32, 4, 4), np.uint64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q in range(2):
            # ldmatrix.x4.trans: matrix i is rows 32q + 8i .. + 7 (their
            # addresses from lanes 8i ..); a lane gets b16 element g of
            # rows 2t and 2t + 1 of each
            m = []
            for i in range(4):
                r0 = 32 * q + 8 * i + 2 * t
                c = 16 * chunk + 2 * g
                m.append(int(stage[r0, c]) | int(stage[r0, c + 1]) << 8
                         | int(stage[r0 + 1, c]) << 16
                         | int(stage[r0 + 1, c + 1]) << 24)
            b = [_byte_perm(m[0], m[1], 0x6420), _byte_perm(m[0], m[1], 0x7531),
                 _byte_perm(m[2], m[3], 0x6420), _byte_perm(m[2], m[3], 0x7531)]
            for i in range(4):
                # stored w + 8: flipping bit 3 gives w's two's complement
                a[lane, q, i] = ((b[i] ^ 0x08080808) << 4) & 0xF0F0F0F0
                a[lane, q + 2, i] = b[i] & 0xF0F0F0F0
    return a


def _a_matrix(frags, j):
    """The [16 rows, 32 k] int8 A of k32 step j from the warp's fragments:
    register i of lane (g, t) holds rows g + 8 (i & 1), k 16 (i >> 1) + 4t
    .. + 3."""
    a = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            w = int(frags[lane, j, i])
            for byte in range(4):
                v = (w >> (8 * byte)) & 0xFF
                a[g + 8 * (i & 1), 16 * (i >> 1) + 4 * t + byte] = \
                    v - 256 if v > 127 else v
    return a


def _codes_tile(xlo, xhi, xs, m_rows, bt):
    """quant_stage: x's codes for one stage from the bf16 tiles as TMA
    lays them (xlo, xhi [bt, 64] f32 values of bf16, 128-byte swizzled),
    written through the swizzle as the kernel does; returns the logical
    [bt, 128] tile the wgmma reads."""
    tiles = []
    for half in (xlo, xhi):
        bits = (torch.from_numpy(half).bfloat16().view(torch.int16).numpy()
                .view(np.uint16))
        phys = np.zeros(bt * 128, np.uint8)
        for n in range(bt):
            for c in range(64):
                for byte in range(2):
                    phys[_swz(n, 2 * c + byte)] = (bits[n, c] >> (8 * byte)) & 0xFF
        tiles.append(phys)
    out = np.zeros(bt * 128, np.uint8)
    for n in range(m_rows):
        for w in range(32):
            j, u = w // 8, w % 8
            c = 32 * (j & 1) + 16 * (u >> 2) + 2 * (u & 3)
            phys = tiles[j >> 1]
            vals = []
            for col in (c, c + 1, c + 8, c + 9):
                lo_b, hi_b = phys[_swz(n, 2 * col)], phys[_swz(n, 2 * col + 1)]
                vals.append(_bf16(int(lo_b) | int(hi_b) << 8))
            q = _kernel_quotient_codes(np.array(vals, np.float32),
                                       xs[n]).view(np.uint8)
            for byte in range(4):
                out[_swz(n, 4 * w + byte)] = q[byte]
    return np.array([[out[_swz(n, p)] for p in range(128)]
                     for n in range(bt)], np.uint8).view(np.int8)


@pytest.mark.parametrize("m", [1, 8, 13])
def test_w4a8_layout_gives_the_plain_accumulator(m):
    """The s8 products as the kernel's lanes hold them, stage by stage (K =
    256: two stages of 64 packed rows; 128 channels: the strip's eight
    warps): the int32 sums shifted right by 4 are the plain version's
    accumulator, and (f32(acc) * xs) * scale its output, bit for bit."""
    r = np.random.default_rng(50 + m)
    nl, k, n = 2, 256, 128
    bt = 8 if m <= 8 else 64
    packed = r.integers(-128, 128, (nl, k // 2, n)).astype(np.int8)
    scale = (r.random((nl, n)) * 0.02).astype(np.float32)
    xb = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)
                          * 2).bfloat16()
    xf = np.zeros((bt, k), np.float32)
    xf[:m] = xb.float().numpy()
    _, xs = _kernel_codes(xf[:m])
    xs = np.concatenate([xs[:, 0], np.full(bt - m, 1e-8, np.float32)])
    acc16 = np.zeros((n, bt), np.int64)  # [channel, token]
    kp = k // 2
    for st in range(kp // 64):
        stage = packed[1, 64 * st:64 * st + 64].view(np.uint8)
        b_tile = _codes_tile(xf[:, 64 * st:64 * st + 64],
                             xf[:, kp + 64 * st:kp + 64 * st + 64], xs, m,
                             bt).astype(np.int64)
        for chunk in range(8):
            frags = _a_fragments(stage, chunk)
            channels = [16 * chunk + (2 * r_ if r_ < 8 else 2 * (r_ - 8) + 1)
                        for r_ in range(16)]
            for j in range(4):
                acc16[channels] += _a_matrix(frags, j) @ \
                    b_tile[:, 32 * j:32 * j + 32].T
    assert np.all(acc16 % 16 == 0)
    acc = (acc16 >> 4).T[:m].astype(np.int32)
    out, ref_acc = cqm.int4_w4a8_stacked_plain(
        xb, torch.from_numpy(packed), torch.from_numpy(scale), 1,
        return_acc=True)
    np.testing.assert_array_equal(acc, ref_acc.numpy())
    mine = torch.from_numpy(acc.astype(np.float32) * xs[:m, None]
                            * scale[1]).bfloat16()
    assert torch.equal(mine, out)


@pytest.mark.parametrize("m", [1, 8])
def test_w4a8_mirror_against_the_jax_kernel(m):
    """The kernel's quantization and exact integer product, (f32(acc) * xs)
    * scale, against the JAX Pallas W4A8 kernel in interpret mode at its
    test's tolerance."""
    r = np.random.default_rng(60 + m)
    nl, k, n = 3, 128, 256
    q, s = _stack(r, nl, k, n, 4, scale=0.3)
    x = np.asarray(jnp.asarray(r.standard_normal((m, k)).astype(np.float32)
                               * 2.0, jnp.bfloat16), np.float32)
    codes, xs = _kernel_codes(x)
    w = np.asarray(jquant.unpack_int4(jnp.asarray(q[1]))).astype(np.int64)
    acc = (codes.astype(np.int64) @ w).astype(np.float32)
    out = torch.from_numpy(acc * xs * s[1]).bfloat16().float().numpy()
    ref = pqm.qmatmul_stacked_w4a8(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(q), jnp.asarray(s),
                                   jnp.int32(1))
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)
