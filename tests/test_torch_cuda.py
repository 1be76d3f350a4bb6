"""The port's CUDA kernels (K1-K33) held against their plain PyTorch versions
on the card, at the serving path's shapes and at the edges (ragged
positions, position 0, M = 1 and 64, M = 65..512 for the prefill matmul,
multi-chunk offsets, every prefill bucket over a long past, verify blocks
of 2..32 rows, page sizes 128..512 through a shuffled table, parked lanes,
a window, group sizes 1..8), the paired kernels also against the unpaired
ones on the same rows re-laid, by equality, and every single-position form
of csrc/decode_attention.cuh (the s8 forms too) also against its unpaired
dense form on the same rows under the same launch plan, by equality.
Marked `cuda`: each
test skips without a GPU. Run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
lacks.)

Tolerances: both sides see the same bf16 inputs; the kernels accumulate in
f32 in another order and round their output to bf16 (2^-8 relative), and
the plain attention versions round dequantized cache rows to bf16 first.
Outputs are O(1), so 2e-2 absolute + relative covers both. The W4A8
kernel's int32 accumulator is exact and is held to equality.

The paired, s8 and slot-batched kernels read up to 2047 rows, where a row
of the output has an RMS near 0.05 and 2e-2 absolute would be half a value:
they are held to 2e-2 relative plus a share of the plain row's RMS
(`_close`): 5e-2 for the bf16/f32 forms (the plain version's bf16 rounding
of the dequantized rows shifts f32 sums by about 0.003 of the RMS), 1e-2
for the s8 forms, whose integer products are exact on both sides, so that
only a bf16 step or one probability code on a rounding boundary (1/127 of
its chunk's largest) is left. The s8 form lies 0.1-0.3 of the RMS from the
bf16/f32 form on long rows, so the s8 tests also hold the kernel apart from
the bf16/f32 kernel by the same tolerance (`_apart`): a kernel that
computed the other form would fail. Against the dequantized contract the
s8 form is held to 6e-2, as tests/test_pallas_kernels.py:665-686 holds the
TPU kernel."""

import dataclasses

import pytest
import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _packed(dev, g, *shape):
    return torch.randint(-128, 128, shape, generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)


# the four projections (wqkv, wo, w_gup, w_down: K -> N) of Llama-3.2-1B,
# Llama-3.2-3B and Llama-3-8B
PROJECTIONS = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
               (3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
               (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]


def _stack(dev, g, m, k, n):
    packed = _packed(dev, g, 3, k // 2, n)
    scale = torch.rand((3, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return x, packed, scale


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", PROJECTIONS)
def test_int4_stacked(dev, m, k, n):
    x, packed, scale = _stack(dev, _gen(dev, 0), m, k, n)
    before = ck.launch_counts["int4_matmul_stacked"]
    out = cqm.qmatmul_int4_stacked(x, packed, scale, 2)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul_stacked"] == before + 1
    ref = cqm.int4_stacked_plain(x, packed, scale, 2)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", PROJECTIONS)
def test_int4_stacked_rawdot(dev, m, k, n):
    """K33 on layer 2 of a stack against its plain version, and against
    K1 within the two forms' distance (one bf16 rounding of x_even -
    x_odd / 16; 4e-2, as tests/test_pallas_kernels.py:371 holds them)."""
    x, packed, scale = _stack(dev, _gen(dev, 30), m, k, n)
    before = ck.launch_counts["int4_matmul_stacked_rawdot"]
    out = cqm.qmatmul_int4_stacked_rawdot(x, packed, scale, 2)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul_stacked_rawdot"] == before + 1
    ref = cqm.int4_stacked_rawdot_plain(x, packed, scale, 2)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    torch.testing.assert_close(
        out.float(), cqm.qmatmul_int4_stacked(x, packed, scale, 2).float(),
        rtol=4e-2, atol=4e-2)


STACKED_KERNELS = {"int4_matmul_stacked": cqm.qmatmul_int4_stacked,
                   "int4_matmul_stacked_rawdot":
                       cqm.qmatmul_int4_stacked_rawdot}


@pytest.mark.parametrize("name", sorted(STACKED_KERNELS))
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 8192, 2048),
                                   (64, 2048, 16384), (13, 3072, 5120)])
def test_int4_stacked_repeats_its_bits(dev, name, m, k, n):
    """K split over a cluster is summed in one fixed order (rank order, no
    atomics): a repeat on the same inputs gives the same bits."""
    x, packed, scale = _stack(dev, _gen(dev, 31), m, k, n)
    fn = STACKED_KERNELS[name]
    assert torch.equal(fn(x, packed, scale, 1), fn(x, packed, scale, 1))


@pytest.mark.parametrize("name", sorted(STACKED_KERNELS))
def test_int4_stacked_is_one_kernel_a_call(dev, name):
    """No workspace memset and no finalize pass: one CUDA kernel a call."""
    x, packed, scale = _stack(dev, _gen(dev, 32), 8, 8192, 2048)
    fn = STACKED_KERNELS[name]
    fn(x, packed, scale, 0)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn(x, packed, scale, 0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels


# the int4 unembeds of Llama-3.2-1B, 3B (6 groups a nibble plane) and
# Llama-3-8B: hidden size -> the vocabulary padded to a multiple of 2048
UNEMBED_SHAPES = [(2048, 129024), (3072, 129024), (4096, 129024)]


def _unembed(dev, g, m, k, n, group=256):
    packed = _packed(dev, g, k // 2, n)
    scale = torch.rand((k // group, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return x, packed, scale


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", UNEMBED_SHAPES)
def test_int4_grouped_unembed(dev, m, k, n):
    """K2 (csrc/quant_matmul_unembed.cu) at M = 1 and 8 (the m64n8 tile),
    13 and 64 (the m64n64 tile; the speculative verify's unembed) against
    its plain version; one launch a call."""
    x, packed, scale = _unembed(dev, _gen(dev, 1), m, k, n)
    before = ck.launch_counts["int4_matmul_grouped"]
    out = cqm.qmatmul_int4_grouped(x, packed, scale, 256)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul_grouped"] == before + 1
    ref = cqm.int4_grouped_plain(x, packed, scale, 256)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("m", [8, 64])
def test_int4_grouped_unembed_repeats_its_bits(dev, m):
    """Each output is summed in one fixed order (no split, no atomics)."""
    x, packed, scale = _unembed(dev, _gen(dev, 31), m, 2048, 129024)
    assert torch.equal(cqm.qmatmul_int4_grouped(x, packed, scale, 256),
                       cqm.qmatmul_int4_grouped(x, packed, scale, 256))


def test_int4_grouped_unembed_refuses_what_its_kernel_does_not_take(dev):
    x, packed, scale = _unembed(dev, _gen(dev, 32), 8, 256, 384, group=32)
    with pytest.raises(ValueError, match="multiple of 64"):
        cqm.qmatmul_int4_grouped(x, packed, scale, 32)
    x, packed, scale = _unembed(dev, _gen(dev, 33), 8, 256, 320, group=64)
    with pytest.raises(ValueError, match="multiple of 128"):
        cqm.qmatmul_int4_grouped(x, packed, scale, 64)
    x, packed, scale = _unembed(dev, _gen(dev, 34), 65, 256, 384, group=64)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int4_grouped(x, packed, scale, 64)
    with pytest.raises(ValueError, match="bf16"):
        cqm.qmatmul_int4_grouped(x[:8].float(), packed, scale, 64)


def _cache(dev, g, nl, b, nk, s, h=64):
    kc, ks = quantize_kv(torch.randn((nl, b, nk, s, h), generator=g,
                                     device=dev))
    vc, vs = quantize_kv(torch.randn((nl, b, nk, s, h), generator=g,
                                     device=dev))
    return kc, vc, ks, vs


def test_decode_attention(dev):
    g = _gen(dev, 2)
    nl, b, nk, nq, s, h = 2, 8, 8, 32, 1024, 64
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q = torch.randn((b, 1, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    # ragged: empty slot, parked lane (1 row), chunk edges, full cache
    pos = torch.tensor([0, 1, 31, 32, 33, 500, 1023, 1024], device=dev,
                       dtype=torch.int32)
    out = cattn.decode_attention(q, kc, vc, ks, vs, pos, layer=1, fresh_k=fk,
                                 fresh_v=fv)
    ref = cattn.decode_attention_plain(q, kc, vc, ks, vs, pos, layer=1,
                                       fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


# every engine bucket; short chunks over a long past (a split key range);
# chunks at offset 0 (at T = 256 one part of the split is empty)
PREFILL_CASES = [(16, 0), (64, 100), (512, 512), (256, 1792), (16, 1792),
                 (64, 1024), (512, 0), (256, 0)]


def _prefill_inputs(dev, g, t, offset):
    nl, b, nk, nq, s, h, slot = 2, 4, 8, 32, 2048, 64, 3
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q = torch.randn((1, t, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    return (q, kc, vc, ks, vs, slot, offset), dict(layer=1, fresh_k=fk,
                                                   fresh_v=fv)


@pytest.mark.parametrize("t,offset", PREFILL_CASES)
def test_prefill_attention(dev, t, offset):
    args, kw = _prefill_inputs(dev, _gen(dev, 3), t, offset)
    out = cpfa.prefill_attention(*args, **kw)
    ref = cpfa.prefill_attention_plain(*args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


STACKED_SHAPES = [(2048, 3072), (2048, 2048), (8192, 2048), (2048, 16384)]
# Llama-3.2-3B's four projections (K = 3072 and 8192)
STACKED_SHAPES_3B = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072)]


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", STACKED_SHAPES + STACKED_SHAPES_3B)
def test_int8_stacked(dev, m, k, n):
    g = _gen(dev, 5)
    codes = _packed(dev, g, 3, k, n)
    scale = torch.rand((3, n), generator=g, device=dev) * 0.002
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = ck.launch_counts["int8_matmul_stacked"]
    out = cqm.qmatmul_int8_stacked(x, codes, scale, 2)
    torch.cuda.synchronize()
    assert ck.launch_counts["int8_matmul_stacked"] == before + 1
    ref = cqm.int8_stacked_plain(x, codes, scale, 2)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def _int8_unembed(dev, seed, m, k, n):
    g = _gen(dev, seed)
    codes = _packed(dev, g, k, n)
    scale = torch.rand((n,), generator=g, device=dev) * 0.002
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return x, codes, scale


# the int8 unembeds of Llama-3.2-1B, 3B and Llama-3-8B (the vocabulary not
# padded: 1002 strips of 128), and a vocabulary whose last strip passes N
INT8_UNEMBED_SHAPES = [(2048, 128256), (3072, 128256), (4096, 128256),
                       (2048, 32016)]


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", INT8_UNEMBED_SHAPES)
def test_int8_unembed(dev, m, k, n):
    """K6 (csrc/quant_matmul_int8_unembed.cu) at M = 1 and 8 (the m64n8
    tile), 13 and 64 (the m64n64 tile) against its plain version; one
    launch a call; the same bits on a repeat."""
    x, codes, scale = _int8_unembed(dev, 6, m, k, n)
    before = ck.launch_counts["int8_matmul"]
    out = cqm.qmatmul_int8(x, codes, scale)
    torch.cuda.synchronize()
    assert ck.launch_counts["int8_matmul"] == before + 1
    ref = cqm.int8_plain(x, codes, scale)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert torch.equal(out, cqm.qmatmul_int8(x, codes, scale))


def test_int8_unembed_refuses_what_its_kernel_does_not_take(dev):
    x, codes, scale = _int8_unembed(dev, 7, 8, 96, 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        cqm.qmatmul_int8(x, codes, scale)
    x, codes, scale = _int8_unembed(dev, 8, 8, 128, 120)
    with pytest.raises(ValueError, match="multiple of 16"):
        cqm.qmatmul_int8(x, codes, scale)
    x, codes, scale = _int8_unembed(dev, 9, 65, 128, 128)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int8(x, codes, scale)


# M = 129 and 320 cut the 64- and 128-token tiles raggedly
@pytest.mark.parametrize("m", [1, 8, 64, 65, 129, 256, 320, 512])
@pytest.mark.parametrize("k,n", STACKED_SHAPES)
def test_int4_prefill(dev, m, k, n):
    g = _gen(dev, 7)
    packed = _packed(dev, g, 3, k // 2, n)
    scale = torch.rand((3, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = ck.launch_counts["int4_matmul"]
    out = cqm.qmatmul_int4(x, packed, scale, 2)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul"] == before + 1
    ref = cqm.int4_plain(x, packed, scale, 2)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    # the 2-D form on the same layer, and K1 on the same inputs at its M
    out2 = cqm.qmatmul_int4(x, packed[2].contiguous(), scale[2].contiguous())
    assert torch.equal(out, out2)
    if m <= cqm.MAX_M:
        k1 = cqm.qmatmul_int4_stacked(x, packed, scale, 2)
        torch.testing.assert_close(out.float(), k1.float(), **TOL)


@pytest.mark.parametrize("kernel", ["int4_matmul", "prefill_attention",
                                    "prefill_attention_paired"])
def test_prefill_kernel_repeats_its_bits(dev, kernel):
    """Two calls on the same inputs are equal bit for bit: K7 sums each
    output in one fixed order (here K is split in two, the parts merged in
    part order; no atomics); K4/K21 walk the keys in one order, and a split
    key range (T = 64 over 1024 rows) is merged in part order."""
    g = _gen(dev, 29)
    if kernel == "int4_matmul":
        packed = _packed(dev, g, 2, 4096, 2048)
        scale = torch.rand((2, 2048), generator=g, device=dev) * 0.02
        x = torch.randn((320, 8192), generator=g, device=dev).bfloat16()
        calls = [lambda: cqm.qmatmul_int4(x, packed, scale, 1)]
    else:
        calls = []
        for t, offset in ((512, 512), (64, 1024)):
            args, kw = _prefill_inputs(dev, g, t, offset)
            if kernel.endswith("paired"):
                args = (args[0], pair_heads(args[1]), pair_heads(args[2]),
                        *args[3:])
            calls.append(lambda args=args, kw=kw: _counted(
                kernel, cpfa.prefill_attention, *args, **kw))
    for call in calls:
        assert torch.equal(call(), call())


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", STACKED_SHAPES + STACKED_SHAPES_3B)
def test_int4_w4a8_stacked(dev, m, k, n):
    g = _gen(dev, 8)
    packed = _packed(dev, g, 3, k // 2, n)
    scale = torch.rand((3, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = ck.launch_counts["int4_matmul_w4a8_stacked"]
    out, acc = cqm.qmatmul_int4_w4a8_stacked(x, packed, scale, 2,
                                             return_acc=True)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul_w4a8_stacked"] == before + 1
    ref, ref_acc = cqm.int4_w4a8_stacked_plain(x, packed, scale, 2,
                                               return_acc=True)
    assert torch.equal(acc, ref_acc)  # integer sums: exact in any order
    # the kernel quantizes x and scales the sums as the plain version does
    assert torch.equal(out, ref)
    assert torch.equal(cqm.qmatmul_int4_w4a8_stacked(x, packed, scale, 2),
                       out)


def _int8_form(dev, name, g, m, k, n):
    """The inputs of K5 (int8 stack [3, K, N]) or K8 (packed [3, K/2, N])
    and the kernel."""
    if name == "int8_matmul_stacked":
        w = _packed(dev, g, 3, k, n)
        scale = torch.rand((3, n), generator=g, device=dev) * 0.002
        fn = cqm.qmatmul_int8_stacked
    else:
        w = _packed(dev, g, 3, k // 2, n)
        scale = torch.rand((3, n), generator=g, device=dev) * 0.02
        fn = cqm.qmatmul_int4_w4a8_stacked
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return fn, (x, w, scale, 1)


INT8_FORMS = ["int8_matmul_stacked", "int4_matmul_w4a8_stacked"]


@pytest.mark.parametrize("name", INT8_FORMS)
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 8192, 2048),
                                   (64, 2048, 16384), (13, 3072, 5120),
                                   (64, 8192, 3072)])
def test_int8_forms_repeat_their_bits(dev, name, m, k, n):
    """K5 sums its f32 partials over the cluster in rank order (no
    atomics), K8 its int32 ones: a repeat gives the same bits."""
    fn, args = _int8_form(dev, name, _gen(dev, 33), m, k, n)
    assert torch.equal(fn(*args), fn(*args))


@pytest.mark.parametrize("name", INT8_FORMS)
def test_int8_forms_are_one_kernel_a_call(dev, name):
    """No workspace memset, no finalize pass and (K8) no quantization of x
    outside the launch: one CUDA kernel a call."""
    fn, args = _int8_form(dev, name, _gen(dev, 34), 8, 8192, 2048)
    fn(*args)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("name", INT8_FORMS)
def test_int8_forms_refuse_what_their_kernel_does_not_take(dev, name):
    """The tensor-core kernel's tiles: N a multiple of 128 and a weight
    plane of a multiple of 64 rows (K5: K % 64; K8: K % 128)."""
    g = _gen(dev, 35)
    bf = dict(device=dev, dtype=torch.bfloat16)
    per = 1 if name == "int8_matmul_stacked" else 2
    fn = (cqm.qmatmul_int8_stacked if per == 1
          else cqm.qmatmul_int4_w4a8_stacked)
    with pytest.raises(ValueError, match="multiple of 128"):
        fn(torch.ones((2, 128 * per), **bf), _packed(dev, g, 2, 128, 192),
           torch.ones((2, 192), device=dev), 0)
    with pytest.raises(ValueError, match=f"multiple of {64 * per}"):
        fn(torch.ones((2, 96 * per), **bf), _packed(dev, g, 2, 96, 128),
           torch.ones((2, 128), device=dev), 0)


def test_new_wrappers_refuse_what_their_kernels_do_not_take(dev):
    g = _gen(dev, 9)
    bf = dict(device=dev, dtype=torch.bfloat16)
    codes = _packed(dev, g, 2, 128, 128)
    scale = torch.ones((2, 128), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        cqm.qmatmul_int8_stacked(torch.ones((2, 128), device=dev), codes,
                                 scale, 0)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int8_stacked(torch.ones((65, 128), **bf), codes, scale, 0)
    with pytest.raises(ValueError, match="layer"):
        cqm.qmatmul_int8_stacked(torch.ones((2, 128), **bf), codes, scale, 2)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int8(torch.ones((65, 128), **bf), codes[0], scale[0])
    with pytest.raises(ValueError, match="multiple of 16"):
        cqm.qmatmul_int8(torch.ones((2, 128), **bf),
                         codes[0, :, :120].contiguous(),
                         scale[0, :120].contiguous())
    # K7: K must be a multiple of 64 (here 2 * 64 = 128 is; 2 * 48 is not)
    with pytest.raises(ValueError, match="multiple of 64"):
        cqm.qmatmul_int4(torch.ones((80, 96), **bf),
                         codes[:, :48].contiguous(), scale, 0)
    with pytest.raises(ValueError, match="layer"):
        cqm.qmatmul_int4(torch.ones((80, 256), **bf), codes, scale)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int4_w4a8_stacked(torch.ones((65, 256), **bf), codes,
                                      scale, 0)
    with pytest.raises(ValueError, match="GPU"):
        cqm.qmatmul_int4_w4a8_stacked(torch.ones((2, 256), **bf), codes,
                                      scale.cpu(), 0)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = _gen(dev, 4)
    packed = _packed(dev, g, 2, 64, 128)
    scale = torch.ones((2, 128), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        cqm.qmatmul_int4_stacked(torch.ones((2, 128), device=dev), packed,
                                 scale, 0)
    with pytest.raises(ValueError, match="rows"):
        cqm.qmatmul_int4_stacked(
            torch.ones((65, 128), device=dev, dtype=torch.bfloat16), packed,
            scale, 0)
    with pytest.raises(ValueError, match="bf16"):
        cqm.qmatmul_int4_stacked_rawdot(torch.ones((2, 128), device=dev),
                                        packed, scale, 0)
    with pytest.raises(ValueError, match="layer"):
        cqm.qmatmul_int4_stacked_rawdot(
            torch.ones((2, 128), device=dev, dtype=torch.bfloat16), packed,
            scale, 2)
    # the tensor-core kernel's tiles: N a multiple of 128, K/2 of 64
    bf = dict(device=dev, dtype=torch.bfloat16)
    for fn in STACKED_KERNELS.values():
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(torch.ones((2, 128), **bf), _packed(dev, g, 2, 64, 192),
               torch.ones((2, 192), device=dev), 0)
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(torch.ones((2, 192), **bf), _packed(dev, g, 2, 96, 128),
               scale, 0)
        with pytest.raises(ValueError, match="rows"):
            fn(torch.ones((65, 128), **bf), packed, scale, 0)


# ragged read bounds: empty slot, parked lane (1 row), chunk and page
# edges, the full cache
RAGGED = [0, 1, 31, 32, 33, 500, 1023, 1024]


def _block(dev, g, b, t, nq, nk, h=64):
    q = torch.randn((b, t, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((b, nk, t, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((b, nk, t, h), generator=g, device=dev).bfloat16()
    return q, fk, fv


@pytest.mark.parametrize("t", [2, 5, 8, 16])
@pytest.mark.parametrize("nq", [32, 8, 64])
def test_verify_attention(dev, t, nq):
    g = _gen(dev, 10)
    nl, b, nk, s = 2, 8, 8, 1024
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _block(dev, g, b, t, nq, nk)
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    before = ck.launch_counts["verify_attention"]
    out = cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=1, fresh_k=fk,
                                 fresh_v=fv)
    torch.cuda.synchronize()
    assert ck.launch_counts["verify_attention"] == before + 1
    ref = cattn.verify_attention_plain(q, kc, vc, ks, vs, pos, layer=1,
                                       fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_verify_attention_window_bounds_the_read(dev):
    """With window = 512 a slot at position 1024 reads rows j < 512 only:
    equal to the plain version at positions clamped to the window."""
    g = _gen(dev, 11)
    nl, b, nk, nq, s, t = 2, 8, 8, 32, 1024, 8
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _block(dev, g, b, t, nq, nk)
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    out = cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=0, fresh_k=fk,
                                 fresh_v=fv, window=512)
    ref = cattn.verify_attention_plain(q, kc, vc, ks, vs,
                                       torch.clamp(pos, max=512), layer=0,
                                       fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_verify_attention_first_row_is_the_decode_kernel(dev):
    """Row 0 of a verify block sees the cache and fresh row 0 only: the
    decode kernel's contract on the same inputs."""
    g = _gen(dev, 12)
    nl, b, nk, nq, s, t = 2, 8, 8, 32, 1024, 4
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _block(dev, g, b, t, nq, nk)
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    out = cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=1, fresh_k=fk,
                                 fresh_v=fv)
    dec = cattn.decode_attention(q[:, :1].contiguous(), kc, vc, ks, vs, pos,
                                 layer=1, fresh_k=fk[:, :, 0].contiguous(),
                                 fresh_v=fv[:, :, 0].contiguous())
    torch.testing.assert_close(out[:, :1].float(), dec.float(), **TOL)


def _pool(dev, g, nl, b, nk, page, max_pages, h=64):
    """Pools of b * max_pages + 1 pages (page 0 the scratch page, filled
    with large values so a stray read shows) and a shuffled table."""
    npages = b * max_pages + 1
    kp, ks = quantize_kv(torch.randn((npages, nl, nk, page, h), generator=g,
                                     device=dev))
    vp, vs = quantize_kv(torch.randn((npages, nl, nk, page, h), generator=g,
                                     device=dev))
    for pool in (ks, vs):
        pool[0] = 1e4
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    table = perm.reshape(b, max_pages).to(torch.int32).contiguous()
    return kp, vp, ks, vs, table


def _unallocate_past(table, pos, page):
    """Table entries past each slot's rows point at the scratch page, as
    the engine keeps them."""
    table = table.clone()
    for i, p in enumerate(pos.tolist()):
        table[i, (p + page - 1) // page:] = 0
    return table


@pytest.mark.parametrize("page", [128, 256, 512])
@pytest.mark.parametrize("nq", [32, 8])
def test_paged_decode_attention(dev, page, nq):
    g = _gen(dev, 13)
    nl, b, nk, s = 2, 8, 8, 1024
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page)
    q = torch.randn((b, 1, nq, 64), generator=g, device=dev).bfloat16()
    fk = torch.randn((b, nk, 64), generator=g, device=dev).bfloat16()
    fv = torch.randn((b, nk, 64), generator=g, device=dev).bfloat16()
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    table = _unallocate_past(table, pos, page)
    before = ck.launch_counts["paged_decode_attention"]
    out = cpaged.paged_decode_attention(q, kp, vp, table, pos, ks, vs,
                                        layer=1, fresh_k=fk, fresh_v=fv)
    torch.cuda.synchronize()
    assert ck.launch_counts["paged_decode_attention"] == before + 1
    ref = cpaged.paged_decode_attention_plain(q, kp, vp, table, pos, ks, vs,
                                              layer=1, fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("page", [128, 256, 512])
@pytest.mark.parametrize("t", [2, 8, 16])
def test_paged_verify_attention(dev, page, t):
    g = _gen(dev, 14)
    nl, b, nk, nq, s = 2, 8, 8, 32, 1024
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page)
    q, fk, fv = _block(dev, g, b, t, nq, nk)
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    table = _unallocate_past(table, pos, page)
    before = ck.launch_counts["paged_verify_attention"]
    out = cpaged.paged_verify_attention(q, kp, vp, table, pos, ks, vs,
                                        layer=1, fresh_k=fk, fresh_v=fv)
    torch.cuda.synchronize()
    assert ck.launch_counts["paged_verify_attention"] == before + 1
    ref = cpaged.paged_verify_attention_plain(q, kp, vp, table, pos, ks, vs,
                                              layer=1, fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_paged_kernels_equal_the_dense_ones_on_the_same_rows(dev):
    """The pool gathered through the table into a dense cache gives the
    dense kernels the same rows: K10 against K3, K11 against K9."""
    from gabby_tpu_torch.ops.attention import gather_pages
    g = _gen(dev, 15)
    nl, b, nk, nq, s, page, t = 2, 8, 8, 32, 1024, 256, 8
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page)
    pos = torch.tensor(RAGGED, device=dev, dtype=torch.int32)
    dense = [torch.stack([gather_pages(p, table, i) for i in range(nl)])
             for p in (kp, vp, ks, vs)]
    q, fk, fv = _block(dev, g, b, t, nq, nk)
    out = cpaged.paged_verify_attention(q, kp, vp, table, pos, ks, vs,
                                        layer=1, fresh_k=fk, fresh_v=fv)
    ref = cattn.verify_attention(q, dense[0], dense[1], dense[2], dense[3],
                                 pos, layer=1, fresh_k=fk, fresh_v=fv)
    assert torch.equal(out, ref)  # the same arithmetic in the same order
    q1, fk1, fv1 = (q[:, :1].contiguous(), fk[:, :, 0].contiguous(),
                    fv[:, :, 0].contiguous())
    out = cpaged.paged_decode_attention(q1, kp, vp, table, pos, ks, vs,
                                        layer=1, fresh_k=fk1, fresh_v=fv1)
    ref = cattn.decode_attention(q1, dense[0], dense[1], dense[2], dense[3],
                                 pos, layer=1, fresh_k=fk1, fresh_v=fv1)
    # one kernel, and the pool's read bound (4 pages of 256) is the dense
    # cache's (1024 rows): the same plan, the same bits
    assert torch.equal(out, ref)


def test_block_wrappers_refuse_what_their_kernels_do_not_take(dev):
    g = _gen(dev, 16)
    nl, b, nk, nq = 1, 2, 2, 8
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, 64)
    q, fk, fv = _block(dev, g, b, 4, nq, nk)
    pos = torch.ones(b, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        cattn.verify_attention(q.float(), kc, vc, ks, vs, pos, layer=0,
                               fresh_k=fk, fresh_v=fv)
    with pytest.raises(ValueError, match="shapes"):
        cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=0,
                               fresh_k=fk[:, :, :3].contiguous(),
                               fresh_v=fv[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="layer"):
        cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=1, fresh_k=fk,
                               fresh_v=fv)
    # the verify form stages whole tiles of 32 rows
    k48, v48, ks48, vs48 = _cache(dev, g, nl, b, nk, 48)
    with pytest.raises(ValueError, match="whole tiles"):
        cattn.verify_attention(q, k48, v48, ks48, vs48, pos, layer=0,
                               fresh_k=fk, fresh_v=fv)
    kp, vp, kps, vps, table = _pool(dev, g, nl, b, nk, 48, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        cpaged.paged_verify_attention(q, kp, vp, table, pos, kps, vps,
                                      layer=0, fresh_k=fk, fresh_v=fv)
    kp, vp, kps, vps, table = _pool(dev, g, nl, b, nk, 64, 2)
    with pytest.raises(ValueError, match="int32 page table"):
        cpaged.paged_verify_attention(q, kp, vp, table.long(), pos, kps, vps,
                                      layer=0, fresh_k=fk, fresh_v=fv)
    with pytest.raises(ValueError, match="single-position"):
        cpaged.paged_decode_attention(q, kp, vp, table, pos, kps, vps,
                                      layer=0, fresh_k=fk, fresh_v=fv)


# ---- the paired layout, the s8 form and the slot-batched launch ------------

# ragged read bounds around warp chunks (32), the s8 chunk (1024) and the
# end of a 2048-row cache
LONG = [0, 1, 31, 32, 1023, 1024, 1025, 2047]
LONG_ROWS = [4, 5, 6, 7]  # the slots of LONG that read 1023 rows or more
ATTN_TOL = dict(rtol=2e-2, atol_rms=5e-2)
S8_TOL = dict(rtol=2e-2, atol_rms=1e-2)
S8_CONTRACT_TOL = dict(rtol=6e-2, atol=6e-2)


def _beyond(out, ref, tol):
    """Elements of out [B, T, Nq, H] further from ref than rtol * |ref| +
    atol_rms * (RMS of ref's row, the last axis)."""
    out, ref = out.float(), ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return (out - ref).abs() > tol["atol_rms"] * rms + tol["rtol"] * ref.abs()


def _close(out, ref, tol):
    assert torch.isfinite(out.float()).all()
    bad = _beyond(out, ref, tol)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} elements beyond {tol}, the worst "
        f"by {(out.float() - ref.float()).abs()[bad].max().item()}")


def _apart(out, other, tol, slots):
    """Each of `slots` holds elements of `out` beyond `tol` from `other`:
    the tolerance tells the two functions apart there."""
    far = _beyond(out, other, tol).flatten(1).any(1)
    assert far[slots].all(), f"slots {slots} within {tol}: {far.tolist()}"


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    monkeypatch.delenv("GABBY_ATTN_CHUNK", raising=False)


def _decode_inputs(dev, g, b, nq, nk, h=64):
    q = torch.randn((b, 1, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    return q, fk, fv


def _counted(name, fn, *args, **kw):
    before = ck.launch_counts[name]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert ck.launch_counts[name] == before + 1, name
    return out


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paired_decode_attention(dev, group):
    g = _gen(dev, 20)
    nl, b, nk, s = 2, 8, 8, 2048
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("decode_attention_paired", cattn.decode_attention, q, kp,
                   vp, ks, vs, pos, **kw)
    ref = cattn.decode_attention_plain(q, kp, vp, ks, vs, pos, **kw)
    _close(out, ref, ATTN_TOL)
    # K12 is K3's kernel on the same rows re-laid, at K3's plan
    k3 = cattn.decode_attention(q, kc, vc, ks, vs, pos, **kw)
    assert torch.equal(out, k3)
    win = cattn.decode_attention(q, kp, vp, ks, vs, pos, window=512, **kw)
    ref = cattn.decode_attention_plain(q, kp, vp, ks, vs,
                                       torch.clamp(pos, max=512), **kw)
    _close(win, ref, ATTN_TOL)


@pytest.mark.parametrize("t", [2, 8, 32])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_paired_verify_attention(dev, t, group):
    g = _gen(dev, 21)
    nl, b, nk, s = 2, 8, 8, 2048
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _block(dev, g, b, t, nk * group, nk)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("verify_attention_paired", cattn.verify_attention, q, kp,
                   vp, ks, vs, pos, **kw)
    ref = cattn.verify_attention_plain(q, kp, vp, ks, vs, pos, **kw)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, cattn.verify_attention(q, kc, vc, ks, vs, pos,
                                                   **kw))


@pytest.mark.parametrize("t,offset", PREFILL_CASES)
def test_paired_prefill_attention(dev, t, offset):
    (q, kc, vc, ks, vs, slot, _), kw = _prefill_inputs(dev, _gen(dev, 22), t,
                                                       offset)
    kp, vp = pair_heads(kc), pair_heads(vc)
    out = _counted("prefill_attention_paired", cpfa.prefill_attention, q, kp,
                   vp, ks, vs, slot, offset, **kw)
    ref = cpfa.prefill_attention_plain(q, kp, vp, ks, vs, slot, offset, **kw)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, cpfa.prefill_attention(q, kc, vc, ks, vs, slot,
                                                   offset, **kw))


@pytest.mark.parametrize("page", [128, 512])
@pytest.mark.parametrize("t", [1, 2, 8, 32])
def test_paired_paged_attention(dev, page, t):
    """K17 (T = 1) and K18 (T > 1) through a shuffled table whose stale
    entries point at the scratch page."""
    g = _gen(dev, 23)
    nl, b, nk, nq, s = 2, 8, 8, 32, 2048
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    table = _unallocate_past(table, pos, page)
    kpp, vpp = pair_heads(kp), pair_heads(vp)
    if t == 1:
        q, fk, fv = _decode_inputs(dev, g, b, nq, nk)
        fn, plain = (cpaged.paged_decode_attention,
                     cpaged.paged_decode_attention_plain)
        name = "paged_decode_attention_paired"
    else:
        q, fk, fv = _block(dev, g, b, t, nq, nk)
        fn, plain = (cpaged.paged_verify_attention,
                     cpaged.paged_verify_attention_plain)
        name = "paged_verify_attention_paired"
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted(name, fn, q, kpp, vpp, table, pos, ks, vs, **kw)
    ref = plain(q, kpp, vpp, table, pos, ks, vs, **kw)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, fn(q, kp, vp, table, pos, ks, vs, **kw))


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_s8_decode_attention(dev, paired, group):
    g = _gen(dev, 24)
    nl, b, nk, s = 2, 8, 8, 2048
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    kk, vv = (pair_heads(kc), pair_heads(vc)) if paired else (kc, vc)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    name = "decode_attention_s8_paired" if paired else "decode_attention_s8"
    out = _counted(name, cattn.decode_attention_s8, q, kk, vv, ks, vs, pos,
                   **kw)
    ref = cattn.decode_attention_s8_plain(q, kk, vv, ks, vs, pos, **kw)
    _close(out, ref, S8_TOL)
    # not the bf16/f32 form, which the same tolerance would refuse
    _apart(out, cattn.decode_attention(q, kk, vv, ks, vs, pos, **kw), S8_TOL,
           LONG_ROWS)
    contract = cattn.decode_attention_plain(q, kk, vv, ks, vs, pos, **kw)
    torch.testing.assert_close(out.float(), contract.float(),
                               **S8_CONTRACT_TOL)
    if paired:
        assert torch.equal(out, cattn.decode_attention_s8(q, kc, vc, ks, vs,
                                                          pos, **kw))
    # a window still counts its chunks from row 0
    win = cattn.decode_attention_s8(q, kk, vv, ks, vs, pos, window=1536,
                                    **kw)
    ref = cattn.decode_attention_s8_plain(q, kk, vv, ks, vs,
                                          torch.clamp(pos, max=1536), **kw)
    _close(win, ref, S8_TOL)


@pytest.mark.parametrize("chunk", [64, 100, 4096])
def test_s8_decode_attention_chunk_sizes(dev, monkeypatch, chunk):
    """GABBY_ATTN_CHUNK fixes the rows per quantization scale: several
    chunks, a chunk that is no multiple of 32, and one larger than the
    cache (then the cache is one chunk)."""
    monkeypatch.setenv("GABBY_ATTN_CHUNK", str(chunk))
    g = _gen(dev, 25)
    nl, b, nk, nq, s = 1, 8, 2, 8, 640
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _decode_inputs(dev, g, b, nq, nk)
    pos = torch.tensor([0, 1, 63, 64, 65, 160, 321, 640], device=dev,
                       dtype=torch.int32)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fv)
    out = cattn.decode_attention_s8(q, kc, vc, ks, vs, pos, **kw)
    ref = cattn.decode_attention_s8_plain(q, kc, vc, ks, vs, pos, **kw)
    _close(out, ref, S8_TOL)
    if chunk == 64:
        # nor the s8 form at another chunk size: the slot that reads 640
        # rows takes ten probability scales a row here, two with 320
        other = cattn.s8_attention_core(q, kc[0], vc[0], ks[0], vs[0], pos,
                                        fk, fv, 64 ** -0.5, 320)
        _apart(out, other, S8_TOL, [7])


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("page", [128, 512])
@pytest.mark.parametrize("group", [1, 4])
def test_s8_paged_decode_attention(dev, paired, page, group):
    g = _gen(dev, 26)
    nl, b, nk, s = 2, 8, 8, 2048
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    table = _unallocate_past(table, pos, page)
    kk, vv = (pair_heads(kp), pair_heads(vp)) if paired else (kp, vp)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    name = ("paged_decode_attention_s8_paired" if paired
            else "paged_decode_attention_s8")
    out = _counted(name, cpaged.paged_decode_attention_s8, q, kk, vv, table,
                   pos, ks, vs, **kw)
    ref = cpaged.paged_decode_attention_s8_plain(q, kk, vv, table, pos, ks,
                                                 vs, **kw)
    _close(out, ref, S8_TOL)
    _apart(out, cpaged.paged_decode_attention(q, kk, vv, table, pos, ks, vs,
                                              **kw), S8_TOL, LONG_ROWS)
    contract = cpaged.paged_decode_attention_plain(q, kk, vv, table, pos, ks,
                                                   vs, **kw)
    torch.testing.assert_close(out.float(), contract.float(),
                               **S8_CONTRACT_TOL)
    if paired:
        assert torch.equal(out, cpaged.paged_decode_attention_s8(
            q, kp, vp, table, pos, ks, vs, **kw))


@pytest.mark.parametrize("b,sb", [(8, 8), (6, 2), (4, 4), (2, 2)])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_slot_batched_decode_attention(dev, b, sb, group):
    """K16 equals K3 bit for bit: the slot-batched entry point takes K3's
    launch where a slot block divides B."""
    g = _gen(dev, 27)
    nl, nk, s = 2, 8, 2048
    assert cattn.pick_slot_block(b) == sb
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk)
    pos = torch.tensor(LONG[:b], device=dev, dtype=torch.int32)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("decode_attention_multi", cattn.decode_attention_multi, q,
                   kc, vc, ks, vs, pos, **kw)
    assert torch.equal(out, cattn.decode_attention(q, kc, vc, ks, vs, pos,
                                                   **kw))
    ref = cattn.decode_attention_plain(q, kc, vc, ks, vs, pos, **kw)
    _close(out, ref, ATTN_TOL)


def test_new_wrappers_refuse_what_their_kernels_do_not_take(dev):
    """No silent fallback: a CUDA tensor the kernel cannot take raises."""
    g = _gen(dev, 28)
    nl, b, nk, nq = 1, 3, 4, 8
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, 64)
    q, fk, fv = _decode_inputs(dev, g, b, nq, nk)
    pos = torch.ones(b, device=dev, dtype=torch.int32)
    kp, vp = pair_heads(kc), pair_heads(vc)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fv)
    with pytest.raises(ValueError, match="unpaired cache"):
        cattn.decode_attention_multi(q, kc, vc, ks, vs, pos, **kw)  # B = 3
    with pytest.raises(ValueError, match="unpaired cache"):
        cattn.decode_attention_multi(q[:2].contiguous(), kp[:, :2].contiguous(),
                                     vp[:, :2].contiguous(),
                                     ks[:, :2].contiguous(),
                                     vs[:, :2].contiguous(), pos[:2],
                                     layer=0, fresh_k=fk[:2].contiguous(),
                                     fresh_v=fv[:2].contiguous())
    with pytest.raises(ValueError, match="shapes"):
        cattn.decode_attention_s8(q, kp, vp, ks[:, :, :2].contiguous(),
                                  vs[:, :, :2].contiguous(), pos, **kw)
    with pytest.raises(ValueError, match="int8 cache"):
        cattn.decode_attention_s8(q, kc.float(), vc.float(), ks, vs, pos,
                                  **kw)
    with pytest.raises(ValueError, match="shapes"):
        cattn.decode_attention_s8(
            torch.cat([q, q], dim=1).contiguous(), kc, vc, ks, vs, pos, **kw)
    with pytest.raises(ValueError, match="bf16"):
        cattn.decode_attention(q.float(), kp, vp, ks, vs, pos, **kw)
    with pytest.raises(ValueError, match="shapes"):
        cpfa.prefill_attention(q[:1].contiguous(), kp, vp, ks, vs, 0, 0,
                               layer=0, fresh_k=fk[0, :2, None].contiguous(),
                               fresh_v=fv[0, :2, None].contiguous())
    pk_, pv_, pks, pvs, table = _pool(dev, g, nl, b, nk, 48, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        cpaged.paged_decode_attention_s8(q, pair_heads(pk_), pair_heads(pv_),
                                         table, pos, pks, pvs, **kw)
    pk_, pv_, pks, pvs, table = _pool(dev, g, nl, b, nk, 64, 2)
    with pytest.raises(ValueError, match="shapes"):
        cpaged.paged_decode_attention_s8(
            torch.cat([q, q], dim=1).contiguous(), pk_, pv_, table, pos, pks,
            pvs, **kw)


# ---- the bf16-cache forms (K22-K32) and head_dim 128 -----------------------

# (head_dim, group size): the 1B model's (64, 4), Llama-3.2-3B's (128, 3),
# Llama-3-8B's (128, 4), and the other groups the kernels are built for
HEAD_GROUPS = [(64, 4), (128, 3), (128, 4), (64, 3), (64, 1), (128, 8)]


def _bf16(dev, g, *shape):
    return torch.randn(shape, generator=g, device=dev).bfloat16()


def _bf16_pool(dev, g, nl, b, nk, page, max_pages, h):
    """bf16 pools of b * max_pages + 1 pages (page 0 the scratch page, all
    100s so a stray read shows) and a shuffled table."""
    npages = b * max_pages + 1
    kp = _bf16(dev, g, npages, nl, nk, page, h)
    vp = _bf16(dev, g, npages, nl, nk, page, h)
    kp[0] = vp[0] = 100.0
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    return kp, vp, perm.reshape(b, max_pages).to(torch.int32).contiguous()


@pytest.mark.parametrize("h,group", HEAD_GROUPS)
def test_bf16_decode_attention(dev, h, group):
    """K24 and K25 against the plain contract, the paired one equal to the
    unpaired one bit for bit, and a window bounding the read."""
    g = _gen(dev, 40)
    nl, b, nk, s = 2, 8, 8, 2048
    kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk, s, h)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("decode_attention_bf16", cattn.decode_attention, q, kc,
                   vc, None, None, pos, **kw)
    ref = cattn.decode_attention_plain(q, kc, vc, None, None, pos, **kw)
    _close(out, ref, ATTN_TOL)
    kp, vp = pair_heads(kc), pair_heads(vc)
    paired = _counted("decode_attention_bf16_paired", cattn.decode_attention,
                      q, kp, vp, None, None, pos, **kw)
    assert torch.equal(paired, out)
    win = cattn.decode_attention(q, kc, vc, None, None, pos, window=512, **kw)
    ref = cattn.decode_attention_plain(q, kc, vc, None, None,
                                       torch.clamp(pos, max=512), **kw)
    _close(win, ref, ATTN_TOL)


@pytest.mark.parametrize("t", [2, 8, 32])
@pytest.mark.parametrize("h,group", HEAD_GROUPS[:3])
def test_bf16_verify_attention(dev, t, h, group):
    """K26 and K27: a block of t candidate rows, paired equal to unpaired."""
    g = _gen(dev, 41)
    nl, b, nk, s = 2, 8, 8, 2048
    kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk, s, h)
    q, fk, fv = _block(dev, g, b, t, nk * group, nk, h)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("verify_attention_bf16", cattn.verify_attention, q, kc,
                   vc, None, None, pos, **kw)
    ref = cattn.verify_attention_plain(q, kc, vc, None, None, pos, **kw)
    _close(out, ref, ATTN_TOL)
    paired = _counted("verify_attention_bf16_paired", cattn.verify_attention,
                      q, pair_heads(kc), pair_heads(vc), None, None, pos,
                      **kw)
    assert torch.equal(paired, out)
    # row 0 of the block is the decode contract (the decode kernel, on the
    # tensor cores, sums in another order)
    dec = cattn.decode_attention(q[:, :1].contiguous(), kc, vc, None, None,
                                 pos, layer=1,
                                 fresh_k=fk[:, :, 0].contiguous(),
                                 fresh_v=fv[:, :, 0].contiguous())
    _close(out[:, :1], dec, ATTN_TOL)


# every bucket, a T that is no multiple of 64, offset 0, offsets that
# straddle a 64-row tile, long pasts (the key range split across blocks)
BF16_PREFILL_CASES = [(16, 0), (64, 100), (256, 100), (512, 0), (512, 512),
                      (100, 37), (16, 1792), (64, 1024), (256, 1792)]


@pytest.mark.parametrize("t,offset", BF16_PREFILL_CASES)
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_bf16_prefill_attention(dev, t, offset, h, group):
    """K22 and K23 (TMA + wgmma) at every bucket and at a T that is no
    multiple of 64, at offset 0, at offsets that straddle a 64-row tile
    and over long pasts, every group size 1-8 at head_dim 64 and 128: the
    paired kernel equal to the unpaired one, a repeat bit for bit, and
    cache rows at and past offset filled with NaN give the bits that zeros
    there give, finite (the tensor map ends at offset)."""
    g = _gen(dev, 42)
    nl, b, nk, s, slot = 2, 4, 8, 2048, 3
    kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk, s, h)
    q = _bf16(dev, g, 1, t, nk * group, h)
    kw = dict(layer=1, fresh_k=_bf16(dev, g, nk, t, h),
              fresh_v=_bf16(dev, g, nk, t, h))
    out = _counted("prefill_attention_bf16", cpfa.prefill_attention, q, kc,
                   vc, None, None, slot, offset, **kw)
    ref = cpfa.prefill_attention_plain(q, kc, vc, None, None, slot, offset,
                                       **kw)
    _close(out, ref, ATTN_TOL)
    paired = _counted("prefill_attention_bf16_paired", cpfa.prefill_attention,
                      q, pair_heads(kc), pair_heads(vc), None, None, slot,
                      offset, **kw)
    assert torch.equal(paired, out)
    assert torch.equal(out, cpfa.prefill_attention(q, kc, vc, None, None, slot,
                                                   offset, **kw))
    for fill in (0.0, float("nan")):
        kf, vf = kc.clone(), vc.clone()
        kf[1, slot, :, offset:] = fill
        vf[1, slot, :, offset:] = fill
        for k_, v_ in ((kf, vf), (pair_heads(kf), pair_heads(vf))):
            got = cpfa.prefill_attention(q, k_, v_, None, None, slot, offset,
                                         **kw)
            assert torch.isfinite(got.float()).all()
            assert torch.equal(got, out)


@pytest.mark.parametrize("page", [128, 512])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("h,group", HEAD_GROUPS[:3])
def test_bf16_paged_attention(dev, page, t, h, group):
    """K28-K31 through a shuffled table whose stale entries point at the
    scratch page; paired equal to unpaired, and the pool's rows gathered
    into a dense cache give the dense kernels' result bit for bit."""
    from gabby_tpu_torch.ops.attention import gather_pages
    g = _gen(dev, 43)
    nl, b, nk, s = 2, 8, 8, 2048
    kp, vp, table = _bf16_pool(dev, g, nl, b, nk, page, s // page, h)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    table = _unallocate_past(table, pos, page)
    nq = nk * group
    if t == 1:
        q, fk, fv = _decode_inputs(dev, g, b, nq, nk, h)
        fn, plain, dense_fn = (cpaged.paged_decode_attention,
                               cpaged.paged_decode_attention_plain,
                               cattn.decode_attention)
        name = "paged_decode_attention_bf16"
    else:
        q, fk, fv = _block(dev, g, b, t, nq, nk, h)
        fn, plain, dense_fn = (cpaged.paged_verify_attention,
                               cpaged.paged_verify_attention_plain,
                               cattn.verify_attention)
        name = "paged_verify_attention_bf16"
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted(name, fn, q, kp, vp, table, pos, None, None, **kw)
    _close(out, plain(q, kp, vp, table, pos, None, None, **kw), ATTN_TOL)
    paired = _counted(name + "_paired", fn, q, pair_heads(kp), pair_heads(vp),
                      table, pos, None, None, **kw)
    assert torch.equal(paired, out)
    dense = [torch.stack([gather_pages(p, table, i) for i in range(nl)])
             for p in (kp, vp)]
    assert torch.equal(out, dense_fn(q, *dense, None, None, pos, **kw))


@pytest.mark.parametrize("b,sb,h", [(8, 8, 64), (6, 2, 64), (8, 8, 128),
                                    (2, 2, 128)])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_bf16_slot_batched_decode_attention(dev, b, sb, h, group):
    """K32 against the plain contract, and K16 at head_dim 128 against K3
    bit for bit (the same launch)."""
    g = _gen(dev, 44)
    nl, nk, s = 2, 8, 2048
    assert cattn.pick_slot_block(b) == sb
    kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk, s, h)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    pos = torch.tensor(LONG[:b], device=dev, dtype=torch.int32)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted("decode_attention_multi_bf16",
                   cattn.decode_attention_multi, q, kc, vc, None, None, pos,
                   **kw)
    ref = cattn.decode_attention_plain(q, kc, vc, None, None, pos, **kw)
    _close(out, ref, ATTN_TOL)
    kq, vq, ks, vs = _cache(dev, g, nl, b, nk, s, h)
    multi = _counted("decode_attention_multi", cattn.decode_attention_multi,
                     q, kq, vq, ks, vs, pos, **kw)
    assert torch.equal(multi, cattn.decode_attention(q, kq, vq, ks, vs, pos,
                                                     **kw))


# ---- the dense flash-decode kernel (K3, K16, K32) at every head shape -------

# 8 unequal slots: empty, a parked lane, a tile's edge (32 rows) + 1, the
# edge where every warp of a cluster of 8 holds one tile (1024 rows) - 1
# and + 1, a 1500-row window's last row, the cache's last row and a slot
# past the window
DENSE_POS = [0, 1, 33, 1023, 1025, 1499, 2047, 1700]


def _dense_case(dev, seed, h, group, quant):
    g = _gen(dev, seed)
    nl, b, nk, s = 2, 8, 8, 2048
    if quant:
        kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s, h)
    else:
        kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk, s, h)
        ks = vs = None
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    pos = torch.tensor(DENSE_POS, device=dev, dtype=torch.int32)
    return (q, kc, vc, ks, vs, pos), dict(layer=1, fresh_k=fk, fresh_v=fv)


@pytest.mark.parametrize("window", [None, 1500], ids=["limit=S", "limit<S"])
@pytest.mark.parametrize("group", cattn.GROUPS)
@pytest.mark.parametrize("h", cattn.HEAD_DIMS)
def test_dense_decode_kernel(dev, h, group, window):
    """K3 and K16 (int8) and K32 (bf16) against the plain contract on
    unequal positions around the tile and split edges, with the read bound
    at the cache's end and inside it; K16 equal to K3 bit for bit, and a
    repeat of each giving the same bits."""
    for quant in (True, False):
        args, kw = _dense_case(dev, 60 + h + group, h, group, quant)
        q, kc, vc, ks, vs, pos = args
        seen = torch.clamp(pos, max=window) if window else pos
        ref = cattn.decode_attention_plain(q, kc, vc, ks, vs, seen, **kw)
        multi = _counted("decode_attention_multi" if quant
                         else "decode_attention_multi_bf16",
                         cattn.decode_attention_multi, *args, window=window,
                         **kw)
        _close(multi, ref, ATTN_TOL)
        assert torch.equal(multi, cattn.decode_attention_multi(
            *args, window=window, **kw))
        if quant:
            k3 = _counted("decode_attention", cattn.decode_attention, *args,
                          window=window, **kw)
            assert torch.equal(k3, multi)
            assert torch.equal(k3, cattn.decode_attention(
                *args, window=window, **kw))


@pytest.mark.parametrize("kernel", ["decode_attention",
                                    "decode_attention_multi",
                                    "decode_attention_multi_bf16"])
def test_dense_decode_is_one_kernel_a_call(dev, kernel):
    """The cluster's merge runs inside the launch: no workspace memset, no
    second kernel."""
    args, kw = _dense_case(dev, 70, 64, 4, not kernel.endswith("_bf16"))
    fn = (cattn.decode_attention if kernel == "decode_attention"
          else cattn.decode_attention_multi)
    fn(*args, **kw)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        _counted(kernel, fn, *args, **kw)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels


# the head shapes of the larger models the reference serves: (Nq, Nk, H)
LLAMA_HEADS = {"3b": (24, 8, 128), "8b": (32, 8, 128)}
INT8_KERNELS = ["decode", "decode_paired", "decode_s8", "decode_s8_paired",
                "decode_multi", "verify", "verify_paired", "paged_decode",
                "paged_decode_paired", "paged_verify", "paged_verify_paired",
                "paged_decode_s8", "paged_decode_s8_paired", "prefill",
                "prefill_paired"]


@pytest.mark.parametrize("kernel", INT8_KERNELS)
@pytest.mark.parametrize("model", list(LLAMA_HEADS))
def test_int8_attention_at_larger_head_shapes(dev, kernel, model):
    """Every attention entry point over an int8 cache (K3, K4, K9-K21) at
    the head shapes of Llama-3.2-3B (G = 3, H = 128) and Llama-3-8B
    (G = 4, H = 128) against its plain version; the paired kernels equal
    to the unpaired ones where the body is the same."""
    g = _gen(dev, 45)
    nq, nk, h = LLAMA_HEADS[model]
    nl, b, s, page = 2, 8, 2048, 512
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    paired = kernel.endswith("_paired")
    base = kernel[:-len("_paired")] if paired else kernel
    s8 = base.endswith("_s8")
    tol = S8_TOL if s8 else ATTN_TOL
    counter = {"decode": "decode_attention",
               "decode_s8": "decode_attention_s8",
               "decode_multi": "decode_attention_multi",
               "verify": "verify_attention",
               "paged_decode": "paged_decode_attention",
               "paged_verify": "paged_verify_attention",
               "paged_decode_s8": "paged_decode_attention_s8",
               "prefill": "prefill_attention"}[base]
    counter += "_paired" if paired else ""
    lay = pair_heads if paired else (lambda x: x)
    if base.startswith("paged"):
        kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page, h)
        table = _unallocate_past(table, pos, page)
        if base == "paged_verify":
            q, fk, fv = _block(dev, g, b, 8, nq, nk, h)
            fn, plain = (cpaged.paged_verify_attention,
                         cpaged.paged_verify_attention_plain)
        else:
            q, fk, fv = _decode_inputs(dev, g, b, nq, nk, h)
            fn, plain = ((cpaged.paged_decode_attention_s8,
                          cpaged.paged_decode_attention_s8_plain) if s8 else
                         (cpaged.paged_decode_attention,
                          cpaged.paged_decode_attention_plain))
        args = (q, lay(kp), lay(vp), table, pos, ks, vs)
        unpaired_args = (q, kp, vp, table, pos, ks, vs)
    elif base == "prefill":
        kc, vc, ks, vs = _cache(dev, g, nl, 4, nk, s, h)
        q = _bf16(dev, g, 1, 512, nq, h)
        fk, fv = _bf16(dev, g, nk, 512, h), _bf16(dev, g, nk, 512, h)
        fn, plain = cpfa.prefill_attention, cpfa.prefill_attention_plain
        args = (q, lay(kc), lay(vc), ks, vs, 3, 512)
        unpaired_args = (q, kc, vc, ks, vs, 3, 512)
    else:
        kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s, h)
        if base == "verify":
            q, fk, fv = _block(dev, g, b, 8, nq, nk, h)
            fn, plain = cattn.verify_attention, cattn.verify_attention_plain
        else:
            q, fk, fv = _decode_inputs(dev, g, b, nq, nk, h)
            fn, plain = {
                "decode": (cattn.decode_attention,
                           cattn.decode_attention_plain),
                "decode_s8": (cattn.decode_attention_s8,
                              cattn.decode_attention_s8_plain),
                "decode_multi": (cattn.decode_attention_multi,
                                 cattn.decode_attention_plain)}[base]
        args = (q, lay(kc), lay(vc), ks, vs, pos)
        unpaired_args = (q, kc, vc, ks, vs, pos)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    out = _counted(counter, fn, *args, **kw)
    _close(out, plain(*args, **kw), tol)
    if paired:
        assert torch.equal(out, fn(*unpaired_args, **kw))


def test_bf16_wrappers_refuse_what_their_kernels_do_not_take(dev):
    """No silent fallback: a cache of another type without scales, a head
    width the kernels are not built for, the s8 form without scales and a
    bf16 pool of pages that are no multiple of 32 rows all raise."""
    g = _gen(dev, 46)
    nl, b, nk, nq, s = 1, 2, 2, 8, 64
    kc, vc = _bf16(dev, g, nl, b, nk, s, 64), _bf16(dev, g, nl, b, nk, s, 64)
    q, fk, fv = _decode_inputs(dev, g, b, nq, nk)
    pos = torch.ones(b, device=dev, dtype=torch.int32)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fv)
    with pytest.raises(ValueError, match="bf16 cache"):
        cattn.decode_attention(q, kc.float(), vc.float(), None, None, pos,
                               **kw)
    with pytest.raises(ValueError, match="int8 cache"):
        cattn.decode_attention_s8(q, kc, vc, None, None, pos, **kw)
    with pytest.raises(ValueError, match="bf16 cache"):
        cpfa.prefill_attention(q[:1].contiguous(), kc.half(), vc.half(),
                               None, None, 0, 0, layer=0,
                               fresh_k=fk[0, :, None].contiguous(),
                               fresh_v=fv[0, :, None].contiguous())
    q96, fk96, fv96 = _decode_inputs(dev, g, b, nq, nk, 96)
    k96, v96 = _bf16(dev, g, nl, b, nk, s, 96), _bf16(dev, g, nl, b, nk, s, 96)
    with pytest.raises(ValueError, match="shapes"):
        cattn.decode_attention(q96, k96, v96, None, None, pos, layer=0,
                               fresh_k=fk96, fresh_v=fv96)
    kp, vp, table = _bf16_pool(dev, g, nl, b, nk, 48, 2, 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        cpaged.paged_decode_attention(q, kp, vp, table, pos, None, None, **kw)


# ---- every single-position form on csrc/decode_attention.cu ----------------

SINGLE_PAGES = [32, 64, 128, 256, 512]


@pytest.mark.parametrize("group", cattn.GROUPS)
@pytest.mark.parametrize("h", cattn.HEAD_DIMS)
def test_single_position_dense_forms(dev, h, group):
    """K3, K12 (int8) and K24, K25 (bf16) against the plain contract at
    ragged positions, a repeat of each giving the same bits; the paired
    forms equal the unpaired ones (K12 = K3, K25 = K24) and K24 equals the
    slot-batched K32 (one kernel, one plan)."""
    g = _gen(dev, 80 + h + group)
    nl, b, nk, s = 2, 8, 8, 2048
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    for quant in (True, False):
        if quant:
            kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s, h)
        else:
            kc, vc = _bf16(dev, g, nl, b, nk, s, h), _bf16(dev, g, nl, b, nk,
                                                          s, h)
            ks = vs = None
        base = "decode_attention" + ("" if quant else "_bf16")
        ref = cattn.decode_attention_plain(q, kc, vc, ks, vs, pos, **kw)
        outs = []
        for kk, vv, name in ((kc, vc, base),
                             (pair_heads(kc), pair_heads(vc),
                              base + "_paired")):
            out = _counted(name, cattn.decode_attention, q, kk, vv, ks, vs,
                           pos, **kw)
            _close(out, ref, ATTN_TOL)
            assert torch.equal(out, cattn.decode_attention(q, kk, vv, ks, vs,
                                                           pos, **kw))
            outs.append(out)
        assert torch.equal(outs[1], outs[0])
        if not quant:
            assert torch.equal(outs[0], cattn.decode_attention_multi(
                q, kc, vc, None, None, pos, **kw))


@pytest.mark.parametrize("page", SINGLE_PAGES)
@pytest.mark.parametrize("group", cattn.GROUPS)
@pytest.mark.parametrize("h", cattn.HEAD_DIMS)
def test_single_position_paged_forms(dev, h, group, page):
    """K10, K17 (int8) and K28, K29 (bf16) through a shuffled table whose
    entries past each slot's rows point at the scratch page, against the
    plain contract at ragged positions; a repeat of each gives the same
    bits, the paired forms equal the unpaired ones (K17 = K10, K29 = K28),
    and the unpaired ones equal the dense kernels (K10 = K3, K28 = K24) on
    the pool's rows gathered into a dense cache as long as the pool's read
    bound, where both take the same plan."""
    from gabby_tpu_torch.ops.attention import gather_pages
    g = _gen(dev, 90 + h + group + page)
    nl, b, nk, s = 2, 8, 8, 2048
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    for quant in (True, False):
        if quant:
            kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page,
                                          h)
        else:
            kp, vp, table = _bf16_pool(dev, g, nl, b, nk, page, s // page, h)
            ks = vs = None
        table = _unallocate_past(table, pos, page)
        base = "paged_decode_attention" + ("" if quant else "_bf16")
        ref = cpaged.paged_decode_attention_plain(q, kp, vp, table, pos, ks,
                                                  vs, **kw)
        outs = []
        for kk, vv, name in ((kp, vp, base),
                             (pair_heads(kp), pair_heads(vp),
                              base + "_paired")):
            out = _counted(name, cpaged.paged_decode_attention, q, kk, vv,
                           table, pos, ks, vs, **kw)
            _close(out, ref, ATTN_TOL)
            assert torch.equal(out, cpaged.paged_decode_attention(
                q, kk, vv, table, pos, ks, vs, **kw))
            outs.append(out)
        assert torch.equal(outs[1], outs[0])
        dense = [None if x is None else torch.stack(
            [gather_pages(x, table, i) for i in range(nl)])
            for x in (kp, vp, ks, vs)]
        assert torch.equal(outs[0], cattn.decode_attention(q, *dense, pos,
                                                           **kw))


def test_verify_entries_refuse_a_single_position(dev):
    """The verify form of csrc/decode_attention.cuh serves T > 1 only: the
    verify wrappers raise on one position a slot, and the four C entries
    return an error for T = 1 where they launch for T = 2 (at verify_plan's
    launch for T = 2)."""
    from gabby_tpu_torch.ops.cuda import build
    g = _gen(dev, 48)
    nl, b, nk, nq, s, page = 1, 2, 2, 8, 64, 32
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    kb, vb = _bf16(dev, g, nl, b, nk, s, 64), _bf16(dev, g, nl, b, nk, s, 64)
    kp, vp, kps, vps, table = _pool(dev, g, nl, b, nk, page, s // page)
    kpb, vpb, _ = _bf16_pool(dev, g, nl, b, nk, page, s // page, 64)
    pos = torch.full((b,), 40, device=dev, dtype=torch.int32)
    q, fk, fv = _block(dev, g, b, 1, nq, nk)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fv)
    for call in (
            lambda: cattn.verify_attention(q, kc, vc, ks, vs, pos, **kw),
            lambda: cattn.verify_attention(q, kb, vb, None, None, pos, **kw),
            lambda: cpaged.paged_verify_attention(q, kp, vp, table, pos, kps,
                                                  vps, **kw),
            lambda: cpaged.paged_verify_attention(q, kpb, vpb, table, pos,
                                                  None, None, **kw)):
        with pytest.raises(ValueError, match="positions a slot"):
            call()
    lib = build.library()
    stream = build.stream_ptr(dev)
    for t in (1, 2):
        q, fk, fv = _block(dev, g, b, t, nq, nk)
        out = torch.empty_like(q)
        fresh = (fk.data_ptr(), fv.data_ptr(), pos.data_ptr(), out.data_ptr())
        plans = [cattn.verify_plan(b, nk, 64, nq // nk, 2, s, 132,
                                   quant=quant)[:3] for quant in (True, False)]

        def dense(quant):
            return (b, t, nq, nk, s, 64, s, 0, *plans[1 - quant], 0.125,
                    stream)

        def paged(quant):
            return (b, t, nq, nk, nl, 0, page, s // page, 64, 0,
                    *plans[1 - quant], 0.125, stream)
        errs = [
            lib.gabby_verify_attention(q.data_ptr(), kc.data_ptr(),
                                       vc.data_ptr(), ks.data_ptr(),
                                       vs.data_ptr(), *fresh, *dense(True)),
            lib.gabby_verify_attention_bf16(q.data_ptr(), kb.data_ptr(),
                                            vb.data_ptr(), *fresh,
                                            *dense(False)),
            lib.gabby_paged_attention(q.data_ptr(), kp.data_ptr(),
                                      vp.data_ptr(), kps.data_ptr(),
                                      vps.data_ptr(), table.data_ptr(),
                                      *fresh, *paged(True)),
            lib.gabby_paged_attention_bf16(q.data_ptr(), kpb.data_ptr(),
                                           vpb.data_ptr(), table.data_ptr(),
                                           *fresh, *paged(False))]
        torch.cuda.synchronize()
        assert all(e != 0 for e in errs) if t == 1 else errs == [0] * 4, errs


# ---- the verify forms on csrc/decode_attention.cuh -------------------------


@pytest.mark.parametrize("t", [2, 8, 16, 32])
@pytest.mark.parametrize("group", cattn.GROUPS)
@pytest.mark.parametrize("h", cattn.HEAD_DIMS)
def test_verify_forms(dev, h, group, t):
    """The eight verify forms (K9, K13, K11, K18 over int8; K26, K27, K30,
    K31 over bf16) against the plain contract at ragged positions, a repeat
    of each giving the same bits; the paired forms equal the unpaired ones
    (K13 = K9, K27 = K26, K18 = K11, K31 = K30), and the paged ones the
    dense ones (K11 = K9, K30 = K26) on the pool's rows gathered into a
    dense cache as long as the pool's read bound, where both take the same
    plan. Pages of 512 through a shuffled table whose entries past each
    slot's rows point at the scratch page."""
    from gabby_tpu_torch.ops.attention import gather_pages
    g = _gen(dev, 200 + h + 10 * group + t)
    nl, b, nk, s, page = 2, 8, 8, 2048, 512
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    q, fk, fv = _block(dev, g, b, t, nk * group, nk, h)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    for quant in (True, False):
        if quant:
            kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page,
                                          h)
        else:
            kp, vp, table = _bf16_pool(dev, g, nl, b, nk, page, s // page, h)
            ks = vs = None
        table = _unallocate_past(table, pos, page)
        kc, vc, kcs, vcs = [None if x is None else torch.stack(
            [gather_pages(x, table, i) for i in range(nl)])
            for x in (kp, vp, ks, vs)]
        ref = cattn.verify_attention_plain(q, kc, vc, kcs, vcs, pos, **kw)
        form = "" if quant else "_bf16"
        outs = {}
        for paged in (False, True):
            for paired in (False, True):
                name = (("paged_verify_attention" if paged
                         else "verify_attention") + form
                        + ("_paired" if paired else ""))
                kk, vv = (kp, vp) if paged else (kc, vc)
                if paired:
                    kk, vv = pair_heads(kk), pair_heads(vv)
                if paged:
                    def call():
                        return cpaged.paged_verify_attention(
                            q, kk, vv, table, pos, ks, vs, **kw)
                else:
                    def call():
                        return cattn.verify_attention(q, kk, vv, kcs, vcs,
                                                      pos, **kw)
                out = _counted(name, call)
                _close(out, ref, ATTN_TOL)
                assert torch.equal(out, call()), name
                outs[paged, paired] = out
        assert torch.equal(outs[False, True], outs[False, False])
        assert torch.equal(outs[True, True], outs[True, False])
        assert torch.equal(outs[True, False], outs[False, False])


# ---- the s8 forms on csrc/decode_attention.cuh -----------------------------


def _s8_forms_agree(dev, g, h, group, page, b, nk, s, pos):
    """K14, K15, K19 and K20 at the chunk `page` (GABBY_ATTN_CHUNK set by
    the caller) against their plain versions, each repeated for the same
    bits; K15 = K14, K20 = K19, and K19 = K14 on the pool's rows gathered
    into a dense cache as long as the pool's read bound."""
    from gabby_tpu_torch.ops.attention import gather_pages
    nl = 2
    q, fk, fv = _decode_inputs(dev, g, b, nk * group, nk, h)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    kp, vp, ks, vs, table = _pool(dev, g, nl, b, nk, page, s // page, h)
    table = _unallocate_past(table, pos, page)
    kc, vc, kcs, vcs = [torch.stack([gather_pages(x, table, i)
                                     for i in range(nl)])
                        for x in (kp, vp, ks, vs)]
    ref = cattn.decode_attention_s8_plain(q, kc, vc, kcs, vcs, pos, **kw)
    outs = {}
    for form, name, call in (
            ("K14", "decode_attention_s8", lambda kk, vv: (
                cattn.decode_attention_s8(q, kk, vv, kcs, vcs, pos, **kw))),
            ("K19", "paged_decode_attention_s8", lambda kk, vv: (
                cpaged.paged_decode_attention_s8(q, kk, vv, table, pos, ks,
                                                 vs, **kw)))):
        rows = (kc, vc) if form == "K14" else (kp, vp)
        for paired in (False, True):
            kk, vv = ((pair_heads(rows[0]), pair_heads(rows[1])) if paired
                      else rows)
            out = _counted(name + ("_paired" if paired else ""), call, kk,
                           vv)
            _close(out, ref, S8_TOL)
            assert torch.equal(out, call(kk, vv)), (form, paired)
            outs[form, paired] = out
    assert torch.equal(outs["K14", True], outs["K14", False])  # K15 = K14
    assert torch.equal(outs["K19", True], outs["K19", False])  # K20 = K19
    assert torch.equal(outs["K19", False], outs["K14", False])  # K19 = K14


@pytest.mark.parametrize("page", [128, 512])
@pytest.mark.parametrize("h,group", [(64, 4), (128, 3), (128, 8), (64, 1)])
def test_s8_forms_repeat_and_agree(dev, monkeypatch, h, group, page):
    """K14, K15, K19 and K20 against their plain versions at ragged
    positions (head_dim 128 at group 3 among them), a repeat of each giving
    the same bits; the paired forms equal the unpaired ones (K15 = K14,
    K20 = K19), and K19 equals K14 bit for bit on the pool's rows gathered
    into a dense cache as long as the pool's read bound, with the dense
    chunk the page: the same plan, the same tiles, the same chunk
    maxima."""
    monkeypatch.setenv("GABBY_ATTN_CHUNK", str(page))
    g = _gen(dev, 110 + h + group + page)
    pos = torch.tensor(LONG, device=dev, dtype=torch.int32)
    _s8_forms_agree(dev, g, h, group, page, 8, 8, 2048, pos)


@pytest.mark.parametrize("h,group,page,b,s", [
    (128, 8, 32, 1, 8192),    # 8 groups of 32 chunks at 8000 rows
    (64, 1, 32, 8, 4096),     # 4 groups at split 4
    (64, 4, 1024, 64, 8192),  # split 1: 8 tiles a part
])
def test_s8_forms_at_long_read_bounds(dev, monkeypatch, h, group, page, b,
                                      s):
    """The s8 forms at read bounds up to 8192 (the presets' max_seq) and
    64 slots, as the previous test holds them: a slot's chunks read in
    several groups (chunks of 32 rows), and one chunk a group at split 1
    (64 slots, chunks of 1024); positions from 0 to the read bound."""
    monkeypatch.setenv("GABBY_ATTN_CHUNK", str(page))
    g = _gen(dev, 130 + h + group + b)
    pos = [(i * 2741 + 7) % (s + 1) for i in range(b)]
    pos[0] = s - 192
    if b > 1:
        pos[1] = 0
    pos = torch.tensor(pos, device=dev, dtype=torch.int32)
    _s8_forms_agree(dev, g, h, group, page, b, 2 if b == 1 else 8, s, pos)


def test_s8_forms_refuse_what_their_kernel_does_not_take(dev, monkeypatch):
    """A group the kernel is not built for (6), and a chunk whose tiles a
    block cannot park (32768 rows at group 8, head_dim 128), raise
    ValueError before a launch, dense and paged; the C entry refuses a
    plan that is not s8_plan's."""
    from gabby_tpu_torch.ops.cuda import build
    g = _gen(dev, 120)
    b, nk = 2, 2
    kc, vc, ks, vs = _cache(dev, g, 1, b, nk, 64)
    pos = torch.full((b,), 40, device=dev, dtype=torch.int32)
    q, fk, fv = _decode_inputs(dev, g, b, 6 * nk, nk)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fv)
    with pytest.raises(ValueError, match="groups"):
        cattn.decode_attention_s8(q, kc, vc, ks, vs, pos, **kw)
    kp, vp, kps, vps, table = _pool(dev, g, 1, b, nk, 32, 2)
    with pytest.raises(ValueError, match="groups"):
        cpaged.paged_decode_attention_s8(q, kp, vp, table, pos, kps, vps,
                                         **kw)
    monkeypatch.setenv("GABBY_ATTN_CHUNK", "32768")
    kc, vc, ks, vs = _cache(dev, g, 1, 1, nk, 32768, 128)
    q, fk, fv = _decode_inputs(dev, g, 1, 8 * nk, nk, 128)
    pos1 = torch.full((1,), 8000, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        cattn.decode_attention_s8(q, kc, vc, ks, vs, pos1, layer=0,
                                  fresh_k=fk, fresh_v=fv)
    kp, vp, kps, vps, table = _pool(dev, g, 1, 1, nk, 32768, 1, 128)
    with pytest.raises(ValueError, match="shared memory"):
        cpaged.paged_decode_attention_s8(q, kp, vp, table, pos1, kps, vps,
                                         layer=0, fresh_k=fk, fresh_v=fv)
    kp, vp, kps, vps, table = _pool(dev, g, 1, 1, nk, 32, 256, 128)
    # at the C entry: a split that is not 1, 2, 4 or 8, a tile other than
    # 32, and a paged chunk other than the page
    lib = build.library()
    out = torch.empty_like(q)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kps.data_ptr(),
            vps.data_ptr(), table.data_ptr(), fk.data_ptr(), fv.data_ptr(),
            pos1.data_ptr(), out.data_ptr(), 1, 8 * nk, nk, 1, 0, 32, 4, 128,
            128)
    for chunk, plan in ((32, (1, 3, 32)), (32, (1, 2, 16)), (64, (1, 2, 32))):
        err = lib.gabby_attention_s8(*args, chunk, 0, *plan, 0.1,
                                     build.stream_ptr(dev))
        assert err != 0, (chunk, plan)
    torch.cuda.synchronize()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("model", ["1b", "3b"])
def test_prefill_batch_chunk_on_the_card(dev, model, paged):
    """A burst's two chunks (offsets 0 and 64) through
    `generate.prefill_batch_chunk` on the card against the same calls on
    the CPU (plain versions), same int4 weights and inputs: 6 masked lanes
    of 8 over a paired int8 cache with random rows (dense, or pages of 64
    behind a shuffled table), at the heads of Llama-3.2-1B (32 q over 8 kv
    heads of 64) and Llama-3.2-3B (24 over 8 of 128), 2 layers of width 512.
    The logits of each masked lane's last valid row agree within 5e-2 of
    the largest logit, the bound of `chip_smoke.py`'s model phase, with the
    same first greedy token; on both sides the unmasked lanes' rows keep
    their bits; the unembed of the [8, 1, D] last rows reaches K2."""
    from gabby_tpu_torch import config as tcfg
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime import generate
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.runtime.paged import create_paged_cache

    nq, nk, h = {"1b": (32, 8, 64), "3b": LLAMA_HEADS["3b"]}[model]
    cfg = tcfg.tiny(num_heads=nq, num_kv_heads=nk, head_dim=h,
                    hidden_size=512, intermediate_size=1024,
                    vocab_size=4096, max_seq_len=1024)
    cpu = torch.device("cpu")
    params = llama.fuse_projections(quant.quantize_tree(
        llama.init_params(cfg, torch.Generator().manual_seed(0),
                          device=cpu), 4, unembed_bits=4, unembed_group=256))
    b, s, page, t = 8, 1024, 64, 64
    g = torch.Generator().manual_seed(1)
    if paged:
        cache = create_paged_cache(cfg, b, s, 1 + b * s // page,
                                   quantized=True, page_size=page,
                                   paired=True, device=cpu)
        cache.page_table.copy_((torch.randperm(b * s // page, generator=g)
                                + 1).reshape(b, s // page))
    else:
        cache = create_cache(cfg, b, s, quantized=True, paired=True,
                             device=cpu)
    for codes in (cache.k, cache.v):
        codes.copy_(torch.randint(-127, 128, codes.shape, generator=g))
    for scales in (cache.k_scale, cache.v_scale):
        scales.copy_(torch.rand(scales.shape, generator=g) * 0.02 + 0.005)
    tokens = torch.randint(2, cfg.vocab_size, (b, 2 * t), generator=g)
    lengths = torch.tensor([70, 1, 90, 128, 100, 1, 77, 65],
                           dtype=torch.int32)
    mask = lengths > 1
    caches = {"cpu": cache, "card": dataclasses.replace(
        cache, **{f.name: getattr(cache, f.name).to(dev)
                  for f in dataclasses.fields(cache)})}

    def untouched(c):
        """The unmasked lanes' rows: their slots, or their pages."""
        if paged:
            pages = c.page_table[~mask.to(c.k.device)].flatten().long()
            return [x[pages].clone() for x in (c.k, c.v)]
        return [x[:, ~mask.to(x.device)].clone() for x in (c.k, c.v)]

    kept = {key: untouched(c) for key, c in caches.items()}
    logits = {}
    ck.reset_launch_counts()
    for key, device in (("card", dev), ("cpu", cpu)):
        p = params if key == "cpu" else _tree_to(params, dev)
        for off in (0, t):
            logits[key], _ = generate.prefill_batch_chunk(
                p, cfg, tokens[:, off:off + t].to(device),
                lengths.to(device), mask.to(device), caches[key], off)
    assert ck.launch_counts["int4_matmul_grouped"] == 2
    got, want = logits["card"].float().cpu()[mask], logits["cpu"][mask]
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for key, c in caches.items():
        for x, old in zip(untouched(c), kept[key]):
            assert torch.equal(x, old)


@pytest.mark.parametrize("h,nq", [(64, 32), (128, 24), (64, 8)])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_nofresh_decode_attention(dev, quant, h, nq):
    """K34-K41, the no-fresh-row forms (rows j <= positions[b]), against
    their plain versions at position 0, chunk edges and the last row, and
    within a window; one layer's cache alone, the paired cache and the
    paged pool (the same read bound, so the same plan) give the stacked
    unpaired dense form's bits on the same rows, and a repeat its own."""
    from gabby_tpu_torch.ops.attention import gather_pages
    g = _gen(dev, 40 + h + nq)
    nl, b, nk, page, mp = 2, 8, 8, 256, 4
    npages = b * mp + 1

    def rows():
        x = torch.randn((npages, nl, nk, page, h), generator=g, device=dev)
        return quantize_kv(x) if quant else (x.bfloat16(), None)

    (kp, ks), (vp, vs) = rows(), rows()
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    dense = [None if x is None else torch.stack(
        [gather_pages(x, table, i) for i in range(nl)]).contiguous()
        for x in (kp, vp, ks, vs)]
    q = torch.randn((b, 1, nq, h), generator=g, device=dev).bfloat16()
    pos = torch.tensor([0, 1, 31, 32, 33, 500, 1022, 1023], device=dev,
                       dtype=torch.int32)
    form = "_nofresh" + ("" if quant else "_bf16")
    before = dict(ck.launch_counts)
    out = cattn.decode_attention(q, *dense, pos, layer=1)
    _close(out, cattn.decode_attention_plain(q, *dense, pos, layer=1),
           ATTN_TOL)
    assert torch.equal(out, cattn.decode_attention(q, *dense, pos, layer=1))
    one = [None if x is None else x[1] for x in dense]
    assert torch.equal(out, cattn.decode_attention(q, *one, pos))
    paired = [pair_heads(dense[0]), pair_heads(dense[1]), *dense[2:]]
    assert torch.equal(out, cattn.decode_attention(q, *paired, pos, layer=1))
    paged = cpaged.paged_decode_attention(q, kp, vp, table, pos, ks, vs,
                                          layer=1)
    _close(paged, cpaged.paged_decode_attention_plain(
        q, kp, vp, table, pos, ks, vs, layer=1), ATTN_TOL)
    assert torch.equal(paged, out)
    assert torch.equal(paged, cpaged.paged_decode_attention(
        q, pair_heads(kp), pair_heads(vp), table, pos, ks, vs, layer=1))
    wpos = pos.clamp(max=511)
    _close(cattn.decode_attention(q, *dense, wpos, layer=1, window=512),
           cattn.decode_attention_plain(q, *dense, wpos, layer=1), ATTN_TOL)
    torch.cuda.synchronize()
    grew = {k: ck.launch_counts[k] - before[k] for k in before}
    assert grew["decode_attention" + form] == 4
    assert grew["decode_attention" + form + "_paired"] == 1
    assert grew["paged_decode_attention" + form] == 1
    assert grew["paged_decode_attention" + form + "_paired"] == 1
