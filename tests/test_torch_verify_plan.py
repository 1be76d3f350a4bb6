"""The launch plan of the verify form of the flash-decode kernel
(csrc/decode_attention.cuh: K9, K13, K26, K27 dense, K11, K18, K30, K31
paged; `attention.verify_plan`) at every preset's head shapes, and a plain
emulation of how the kernel divides the work: plain Python, held here on
the CPU because the kernel runs only on the card
(tests/test_torch_cuda.py).

A plan (split, tile, nt, groups) must give the C entry point what it
takes: a cluster of 1, 2, 4 or 8 blocks, a tile of 32 rows, and nt n8
column tiles a block (1, 2, 4 or 8: a warp each), the T x G columns cut
into `groups` blocks of 8 nt. It splits as far as the cap, a rank's least
rows at the full read bound and VERIFY_BLOCKS_PER_SM blocks a
multiprocessor allow. The shapes alone decide it.

The emulation takes the plan's division as the kernel does: each column
group, each rank its tiles of rows and the last rank the fresh tile
(`verify_rows`), each warp its 8 columns over all of the rank's rows, a
partial (max, sum, output) a (rank, warp), folded in rank order. Every
(cache row, column) pair and every causal (fresh row, column) pair must
be taken exactly once, and the result must be the plain contract's
(`verify_attention_plain`, `paged_verify_attention_plain`)."""

import numpy as np
import pytest
import torch

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

SMS = 132  # H100 SXM
PRESETS = ("llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")
POSITIONS = (2, 5, 8, 16, 32)
LIMITS = (0, 1, 64, 511, 512, 1024, 2048, 8192, 131072)
PAGES = (32, 64, 128, 256, 512)
TOL = dict(rtol=2e-2, atol=2e-2)


def _heads(preset: str):
    cfg = getattr(cfglib, preset)()
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim


def _holds(plan, b, nk, h, g, t, limit, quant):
    """What gabby_verify_attention / gabby_paged_attention take, and the
    plan's rules."""
    split, tile, nt, groups = plan
    assert split in (1, 2, 4, 8)
    assert tile == cattn.VERIFY_TILE == 32
    assert nt in (1, 2, 4, 8) and nt <= cattn.VERIFY_TILES
    cols = t * g
    # the groups hold every column, and none is empty
    assert groups * 8 * nt >= cols > (groups - 1) * 8 * nt
    # one group where the block's tiles hold all the columns
    assert (groups == 1) == (-(-cols // 8) <= cattn.VERIFY_TILES)
    rows = cattn.DECODE_WARPS * cattn.ROWS_PER_WARP  # a rank's least
    blocks = split * nk * groups * b
    per_sm = cattn.verify_blocks_per_sm(h, quant, nt, split)
    assert 1 <= per_sm <= cattn.VERIFY_BLOCKS_PER_SM
    assert split == 1 or split * rows <= limit
    # one wave of blocks
    assert split == 1 or blocks <= per_sm * SMS
    # split as far as the rules allow
    assert (split == cattn.MAX_SPLIT or 2 * split * rows > limit
            or 2 * blocks > cattn.verify_blocks_per_sm(h, quant, nt,
                                                        2 * split) * SMS)
    assert cattn.verify_smem_bytes(h, quant, nt, split) <= cattn.MAX_SMEM


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("t", POSITIONS)
@pytest.mark.parametrize("preset", PRESETS)
def test_verify_plan_at_every_preset(preset, t, quant):
    nq, nk, h = _heads(preset)
    g = nq // nk
    for limit in LIMITS:
        for b in (1, 3, 8):
            plan = cattn.verify_plan(b, nk, h, g, t, limit, SMS, quant=quant)
            _holds(plan, b, nk, h, g, t, limit, quant)
            # the shapes alone: the same call, the same plan
            assert plan == cattn.verify_plan(b, nk, h, g, t, limit, SMS,
                                             quant=quant)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("preset", PRESETS)
def test_verify_plan_at_the_paged_read_bounds(preset, page, quant):
    """Paged, the read bound is page x max_pages; the plan is the dense
    one at that bound (so a paged form gives its dense form's bits) and
    its tile divides the page."""
    nq, nk, h = _heads(preset)
    g = nq // nk
    for t in POSITIONS:
        for max_pages in (1, 4, 33, 256):
            limit = page * max_pages
            plan = cattn.verify_plan(8, nk, h, g, t, limit, SMS, quant=quant,
                                     page=page)
            _holds(plan, 8, nk, h, g, t, limit, quant)
            assert page % plan[1] == 0
            assert plan == cattn.verify_plan(8, nk, h, g, t, limit, SMS,
                                             quant=quant)


def test_verify_plan_at_the_serving_shapes():
    """Speculate 7 (T = 8): every preset's heads hold their columns in one
    block (32 at 1B and 8B, 24 at 3B in four tiles, 64 at 70B in eight),
    so each (slot, kv head)'s rows are read once a call; speculate 15 at
    the 70B heads (128 columns) takes two blocks of 64."""
    # the splits measured fastest on an H100 (PERF.md): 4 at the 1B heads,
    # 2 at the 3B heads, over either cache form
    assert cattn.verify_plan(8, 8, 64, 4, 8, 2048, SMS) == (4, 32, 4, 1)
    assert cattn.verify_plan(8, 8, 64, 4, 8, 2048, SMS,
                             quant=False) == (4, 32, 4, 1)
    assert cattn.verify_plan(8, 8, 128, 3, 8, 2048, SMS)[0] == 2
    assert cattn.verify_plan(8, 8, 128, 3, 8, 2048, SMS,
                             quant=False)[0] == 2
    assert cattn.verify_plan(8, 8, 128, 3, 8, 2048, SMS)[2:] == (4, 1)
    assert cattn.verify_plan(8, 8, 128, 4, 8, 2048, SMS)[2:] == (4, 1)
    assert cattn.verify_plan(8, 8, 128, 8, 8, 2048, SMS)[2:] == (8, 1)
    assert cattn.verify_plan(8, 8, 128, 8, 16, 2048, SMS)[2:] == (8, 2)
    assert cattn.verify_columns(16, 8, 8) == [(0, 64), (64, 128)]
    assert cattn.verify_columns(8, 3, 4) == [(0, 24)]


def test_verify_rows_cut_the_live_rows_in_tiles():
    """A rank's rows are whole tiles from the slot's first row, in order;
    the slot's tiles and the fresh tile are cut as evenly as can be, and
    the last rank alone takes the fresh tile."""
    for n in (0, 1, 31, 32, 33, 1000, 1024, 2047):
        for split in (1, 2, 4, 8):
            runs = cattn.verify_rows(n, split)
            assert runs[0][0] == 0 and runs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            assert all(lo % 32 == 0 or lo == hi == n for lo, hi, _ in runs)
            assert [f for _, _, f in runs] == [False] * (split - 1) + [True]
            units = [-(-(hi - lo) // 32) + f for lo, hi, f in runs]
            assert sum(units) == -(-n // 32) + 1
            assert max(units) - min(units) <= 1


@pytest.mark.parametrize("h,g,t", [(96, 4, 8), (64, 0, 8), (64, 4, 1),
                                   (64, 4, 33)])
def test_verify_plan_refuses_what_the_kernel_does_not_take(h, g, t):
    with pytest.raises(ValueError):
        cattn.verify_plan(8, 8, h, g, t, 2048, SMS)


@pytest.mark.parametrize("h,quant,page", [(64, True, 48), (64, True, 16),
                                          (128, False, 24)])
def test_verify_plan_refuses_a_page_the_tile_does_not_divide(h, quant,
                                                             page):
    with pytest.raises(ValueError, match="tiles"):
        cattn.verify_plan(8, 8, h, 4, 8, page * 4, SMS, quant=quant,
                          page=page)


def _merge(parts):
    """(m, l, acc) partials folded in order, as the kernel folds its warps
    and its ranks: the running max, each partial rescaled to it."""
    m = np.max([p[0] for p in parts], axis=0)
    l = sum(p[1] * np.exp(p[0] - m) for p in parts)
    acc = sum(p[2] * np.exp(p[0] - m)[:, None] for p in parts)
    return m, l, acc


def _emulate(q, kk, vv, pos, fk, fv, limit, plan, sm_scale, cover=None):
    """The verify form's division of the work in numpy (f64): q [B, T, Nq,
    H]; kk, vv [B, Nk, S, H] dequantized; pos [B]; fk, fv [B, Nk, T, H].
    cover: counts [B, Nk, S + T, T x G] of the pairs each part takes (a
    fresh row t' at S + t')."""
    b_, t_, nq, h = q.shape
    nk, s = kk.shape[1], kk.shape[2]
    g_ = nq // nk
    split, tile, nt, groups = plan
    assert tile == cattn.VERIFY_TILE
    cols = cattn.verify_columns(t_, g_, nt)
    assert len(cols) == groups
    out = np.zeros(q.shape)
    for b in range(b_):
        n = max(0, min(int(pos[b]), limit, s))
        for kh in range(nk):
            qc = np.stack([q[b, c // g_, kh * g_ + c % g_]
                           for c in range(t_ * g_)])       # [C, H]
            for c0, c1 in cols:
                for w0 in range(c0, c1, 8):  # a warp's 8 columns
                    w1 = min(w0 + 8, c1)
                    width = w1 - w0
                    ranks = []
                    for lo, hi, fresh in cattn.verify_rows(n, split):
                        # the rank's rows: its cache rows, then (the last
                        # rank) the fresh rows under the causal mask
                        keys, vals = kk[b, kh, lo:hi], vv[b, kh, lo:hi]
                        sc = qc[w0:w1] @ keys.T * sm_scale
                        if fresh:
                            sf = qc[w0:w1] @ fk[b, kh].T * sm_scale
                            seen = (np.arange(t_)[None, :]
                                    <= np.arange(w0, w1)[:, None] // g_)
                            sc = np.concatenate(
                                [sc, np.where(seen, sf, -np.inf)], axis=1)
                            vals = np.concatenate([vals, fv[b, kh]])
                            if cover is not None:
                                cover[b, kh, s:, w0:w1] += seen.T
                        if sc.shape[1] == 0:
                            ranks.append((np.full(width, -1e30),
                                          np.zeros(width),
                                          np.zeros((width, h))))
                            continue
                        m = sc.max(axis=1)
                        p = np.exp(sc - m[:, None])
                        ranks.append((m, p.sum(1), p @ vals))
                        if cover is not None:
                            cover[b, kh, lo:hi, w0:w1] += 1
                    m, l, acc = _merge(ranks)
                    for c in range(w0, w1):
                        out[b, c // g_, kh * g_ + c % g_] = acc[c - w0] / l[
                            c - w0]
    return out


def _inputs(seed, b, t, nq, nk, h, s, quant):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, t, nq, h), generator=gen).bfloat16()
    fk = torch.randn((b, nk, t, h), generator=gen).bfloat16()
    fv = torch.randn((b, nk, t, h), generator=gen).bfloat16()
    kf = torch.randn((1, b, nk, s, h), generator=gen)
    vf = torch.randn((1, b, nk, s, h), generator=gen)
    if quant:
        kc, ks = quantize_kv(kf)
        vc, vs = quantize_kv(vf)
        kk = (kc.float() * ks[..., None]).bfloat16()[0]
        vv = (vc.float() * vs[..., None]).bfloat16()[0]
        return q, fk, fv, (kc, vc, ks, vs), kk, vv
    kb, vb = kf.bfloat16(), vf.bfloat16()
    return q, fk, fv, (kb, vb, None, None), kb[0], vb[0]


def _np(x):
    return x.double().numpy()


# tiny shapes: positions 0 (the fresh block only), 1 (a parked lane), a
# short slot and the whole cache; groups of 1 to 8 and T to one past a
# column tile, so that blocks hold masked columns and several groups
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("h,nq,nk,t,split,nt", [
    (64, 6, 2, 5, 2, 4),    # 15 columns in one group of 32
    (64, 8, 1, 8, 4, 4),    # 64 columns, two groups
    (128, 6, 2, 3, 1, 2),   # 9 columns in a group of 16
    (128, 8, 2, 7, 8, 1),   # 28 columns, four groups of 8
    (64, 8, 1, 9, 2, 8),    # 72 columns, a group of 64 and one of 8
    (64, 2, 2, 2, 2, 1),    # group 1
])
def test_emulated_division_is_the_contract(quant, h, nq, nk, t, split, nt):
    b, s = 4, 96
    q, fk, fv, cache, kk, vv = _inputs(1, b, t, nq, nk, h, s, quant)
    pos = torch.tensor([0, 1, 37, s], dtype=torch.int32)
    tile = cattn.VERIFY_TILE
    g = nq // nk
    groups = len(cattn.verify_columns(t, g, nt))
    cover = np.zeros((b, nk, s + t, t * g), dtype=np.int64)
    got = _emulate(_np(q), _np(kk), _np(vv), pos.numpy(), _np(fk), _np(fv),
                   s, (split, tile, nt, groups), h ** -0.5, cover)
    # every live (cache row, column) pair and causal (fresh row, column)
    # pair exactly once, nothing else
    want = np.zeros_like(cover)
    for bb in range(b):
        want[bb, :, :int(pos[bb])] = 1
        for c in range(t * g):
            want[bb, :, s:s + c // g + 1, c] = 1
    assert np.array_equal(cover, want)
    kc, vc, ks, vs = cache
    ref = cattn.verify_attention_plain(q, kc, vc, ks, vs, pos, layer=0,
                                       fresh_k=fk, fresh_v=fv)
    torch.testing.assert_close(torch.from_numpy(got).float(), ref.float(),
                               **TOL)
    # the paired layout is the same rows re-laid: the same contract
    if nk % 2 == 0:
        refp = cattn.verify_attention_plain(
            q, pair_heads(kc), pair_heads(vc), ks, vs, pos, layer=0,
            fresh_k=fk, fresh_v=fv)
        assert torch.equal(refp, ref)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_emulated_division_through_a_page_table(quant):
    """The paged form: the rows through a shuffled table of 32-row pages,
    the plan at the read bound page x max_pages."""
    b, t, nq, nk, h, page, max_pages = 3, 4, 8, 2, 64, 32, 3
    s = page * max_pages
    q, fk, fv, cache, kk, vv = _inputs(2, b, t, nq, nk, h, s, quant)
    kc, vc, ks, vs = cache
    pos = torch.tensor([0, 45, s], dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    table = torch.randperm(b * max_pages, generator=gen).reshape(
        b, max_pages).to(torch.int32)
    npages = b * max_pages

    def pool(x, fill):
        # [1, B, Nk, S, *] -> [P, 1, Nk, page, *] through the table
        out = torch.full((npages, 1, nk, page, *x.shape[4:]), fill,
                         dtype=x.dtype)
        for bb in range(b):
            for j in range(max_pages):
                out[table[bb, j], 0] = x[0, bb, :, j * page:(j + 1) * page]
        return out

    kp, vp = pool(kc, 0), pool(vc, 0)
    ksp = None if ks is None else pool(ks, 1.0)
    vsp = None if vs is None else pool(vs, 1.0)
    plan = cattn.verify_plan(b, nk, h, nq // nk, t, s, SMS, quant=quant,
                             page=page)
    got = _emulate(_np(q), _np(kk), _np(vv), pos.numpy(), _np(fk), _np(fv),
                   s, plan, h ** -0.5)
    ref = cpaged.paged_verify_attention_plain(q, kp, vp, table, pos, ksp,
                                              vsp, layer=0, fresh_k=fk,
                                              fresh_v=fv)
    torch.testing.assert_close(torch.from_numpy(got).float(), ref.float(),
                               **TOL)
