"""The port's CUDA kernels (K1-K21) held against their plain PyTorch versions
on the card, at the serving path's shapes and at the edges (ragged
positions, position 0, M = 1 and 64, M = 65..512 for the prefill matmul,
multi-chunk offsets, verify blocks of 2..32 rows, page sizes 128..512
through a shuffled table, parked lanes, a window, group sizes 1..8), the
paired kernels also against the unpaired ones on the same rows re-laid, by
equality. Marked `cuda`:
each test skips without a GPU. Run on the card with

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
    # the same body on the unpaired rows: T = 1 of the verify entry point
    same = cattn.verify_attention(q, kc, vc, ks, vs, pos, layer=1,
                                  fresh_k=fk[:, :, None].contiguous(),
                                  fresh_v=fv[:, :, None].contiguous())
    assert torch.equal(out, same)
    k3 = cattn.decode_attention(q, kc, vc, ks, vs, pos, **kw)
    _close(out, k3, ATTN_TOL)
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


@pytest.mark.parametrize("t,offset", [(16, 0), (64, 100), (512, 512),
                                      (256, 1792)])
def test_paired_prefill_attention(dev, t, offset):
    g = _gen(dev, 22)
    nl, b, nk, nq, s, h, slot = 2, 4, 8, 32, 2048, 64, 3
    kc, vc, ks, vs = _cache(dev, g, nl, b, nk, s)
    q = torch.randn((1, t, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
    kp, vp = pair_heads(kc), pair_heads(vc)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
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


@pytest.mark.parametrize("b,sb", [(8, 4), (6, 2), (4, 4), (2, 2)])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_slot_batched_decode_attention(dev, b, sb, group):
    """K16 equals K3 bit for bit: the same per-slot arithmetic, only more
    slots in a block."""
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
