"""The port's CUDA kernels (K1-K11) held against their plain PyTorch versions
on the card, at the serving path's shapes and at the edges (ragged
positions, position 0, M = 1 and 64, M = 65..512 for the prefill matmul,
multi-chunk offsets, verify blocks of 2..16 rows, page sizes 128..512
through a shuffled table, parked lanes, a window). Marked `cuda`:
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
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
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
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


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
