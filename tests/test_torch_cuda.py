"""The port's CUDA kernels (K1-K8) held against their plain PyTorch versions
on the card, at the serving path's shapes and at the edges (ragged
positions, position 0, M = 1 and 64, M = 65..512 for the prefill matmul,
multi-chunk offsets). Marked `cuda`:
each test skips without a GPU. Run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
lacks.)

Tolerances: both sides see the same bf16 inputs; the kernels accumulate in
f32 in another order and round their output to bf16 (2^-8 relative), and
the plain attention versions round dequantized cache rows to bf16 first.
Outputs are O(1), so 2e-2 absolute + relative covers both. The W4A8
kernel's int32 accumulator is exact and is held to equality."""

import pytest
import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
from gabby_tpu_torch.runtime.kv_cache import quantize_kv

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


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n", [(2048, 3072), (2048, 2048), (8192, 2048),
                                 (2048, 16384)])
def test_int4_stacked(dev, m, k, n):
    g = _gen(dev, 0)
    packed = _packed(dev, g, 3, k // 2, n)
    scale = torch.rand((3, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = ck.launch_counts["int4_matmul_stacked"]
    out = cqm.qmatmul_int4_stacked(x, packed, scale, 2)
    torch.cuda.synchronize()
    assert ck.launch_counts["int4_matmul_stacked"] == before + 1
    ref = cqm.int4_stacked_plain(x, packed, scale, 2)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("m", [1, 8])
def test_int4_grouped_unembed(dev, m):
    g = _gen(dev, 1)
    k, n, group = 2048, 129024, 256
    packed = _packed(dev, g, k // 2, n)
    scale = torch.rand((k // group, n), generator=g, device=dev) * 0.02
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    out = cqm.qmatmul_int4_grouped(x, packed, scale, group)
    ref = cqm.int4_grouped_plain(x, packed, scale, group)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


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


@pytest.mark.parametrize("t,offset", [(16, 0), (64, 100), (512, 512),
                                      (256, 1792)])
def test_prefill_attention(dev, t, offset):
    g = _gen(dev, 3)
    nl, b, nk, nq, s, h, slot = 2, 4, 8, 32, 2048, 64, 3
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q = torch.randn((1, t, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    out = cpfa.prefill_attention(q, kc, vc, ks, vs, slot, offset, layer=1,
                                 fresh_k=fk, fresh_v=fv)
    ref = cpfa.prefill_attention_plain(q, kc, vc, ks, vs, slot, offset,
                                       layer=1, fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


STACKED_SHAPES = [(2048, 3072), (2048, 2048), (8192, 2048), (2048, 16384)]


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n", STACKED_SHAPES)
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


@pytest.mark.parametrize("m", [1, 8, 64])
def test_int8_unembed(dev, m):
    g = _gen(dev, 6)
    k, n = 2048, 128256  # the vocab is not padded: 1002 strips of 128
    codes = _packed(dev, g, k, n)
    scale = torch.rand((n,), generator=g, device=dev) * 0.002
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = ck.launch_counts["int8_matmul"]
    out = cqm.qmatmul_int8(x, codes, scale)
    torch.cuda.synchronize()
    assert ck.launch_counts["int8_matmul"] == before + 1
    ref = cqm.int8_plain(x, codes, scale)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("m", [1, 8, 64, 65, 256, 512])
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


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n", STACKED_SHAPES)
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
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


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
