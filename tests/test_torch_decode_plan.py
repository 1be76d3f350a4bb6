"""The launch plan of the single-position flash-decode kernel
(csrc/decode_attention.cu: K3, K12, K16, K24, K25, K32 dense, K10, K17,
K28, K29 paged; `attention.decode_plan`) at every preset's head shapes and
at the paged read bounds, and the plain mirrors of how the kernel divides
a slot's live rows among its warps (`attention.decode_rows`) and which
page-table entries each warp reads (`attention.decode_pages`): plain
Python, held here on the CPU because the kernel they drive runs only on
the card (tests/test_torch_cuda.py).

A plan (sb, split, tile) must give the C entry point what it takes: one
slot a block (the library's build), a cluster of 1, 2, 4 or 8 blocks and
the tile of its cache form (32 rows; 16 over a bf16 cache at head_dim
128). It splits as far as the cap, ROWS_PER_WARP rows a warp at the full
read bound and BLOCKS_PER_SM blocks a multiprocessor allow, and no
further; a short read bound gives split 1. The rows: ceil(n / tile)
tiles cut into split x 4 parts in order, as even as can be, whole tiles
each. Paged, the read bound is page x max_pages, the tile divides the
page, and a warp reads the table entry of each page its tiles lie in once,
never one at or past the slot's last live page; the paired layouts take
the plans of the unpaired ones, so their bits are the same."""

import pytest
import torch

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
from gabby_tpu_torch.runtime.kv_cache import pair_heads

SMS = 132  # H100 SXM
PRESETS = ("llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")
SLOTS = (1, 2, 3, 4, 6, 8)
LIMITS = (1, 31, 64, 1024, 2048, 8192)


def _heads(preset: str):
    cfg = getattr(cfglib, preset)()
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim


def test_presets_have_the_head_shapes_the_plan_is_held_at():
    assert [_heads(p) for p in PRESETS] == [(32, 8, 64), (24, 8, 128),
                                           (32, 8, 128), (64, 8, 128)]


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("preset", PRESETS)
def test_decode_plan_at_every_preset(preset, limit, quant):
    nq, nk, h = _heads(preset)
    for b in SLOTS:
        sb, split, tile = cattn.decode_plan(b, nk, h, nq // nk, limit, SMS,
                                            quant=quant)
        # what gabby_decode_attention(_bf16) takes
        assert sb == 1 and b % sb == 0
        assert split in (1, 2, 4, 8) and split <= cattn.MAX_SPLIT
        assert tile == (16 if h == 128 and not quant else 32)
        rows = cattn.DECODE_WARPS * cattn.ROWS_PER_WARP  # a rank's least
        blocks = split * nk * (b // sb)
        assert split == 1 or split * rows <= limit
        assert split == 1 or blocks <= cattn.BLOCKS_PER_SM * SMS
        # split no further only where the cap, the rows or the grid stop it
        assert (2 * split > cattn.MAX_SPLIT or 2 * split * rows > limit
                or 2 * blocks > cattn.BLOCKS_PER_SM * SMS)
        if limit <= 64:
            assert split == 1


def test_decode_plan_at_the_serving_shapes():
    """8 slots at the engine's windows, at the 1B and the 3B heads and both
    cache forms: clusters of 4 at 1024 rows (256 blocks), of 8 from 2048
    rows (512), the splits the card measured best (PERF.md §6); the K16 and
    K3 plans are one and the same."""
    for h, g in ((64, 4), (128, 3)):
        for quant in (True, False):
            for limit, split in ((1024, 4), (1025, 4), (2048, 8),
                                 (8192, 8)):
                plan = cattn.decode_plan(8, 8, h, g, limit, SMS, quant=quant)
                assert plan[:2] == (1, split)


@pytest.mark.parametrize("h,g", [(96, 4), (32, 4), (64, 5), (128, 6),
                                 (64, 16), (128, 0)])
def test_decode_plan_refuses_what_the_kernel_does_not_take(h, g):
    with pytest.raises(ValueError):
        cattn.decode_plan(8, 8, h, g, 1024, SMS)


@pytest.mark.parametrize("b,nk,limit,sms", [(0, 8, 1024, SMS),
                                            (8, 0, 1024, SMS),
                                            (8, 8, -1, SMS), (8, 8, 1024, 0)])
def test_decode_plan_refuses_empty_shapes(b, nk, limit, sms):
    with pytest.raises(ValueError):
        cattn.decode_plan(b, nk, 64, 4, limit, sms)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("preset", PRESETS)
def test_decode_rows_tile_the_live_rows(preset, limit, quant):
    """For n in {0, 1, tile - 1, tile, tile + 1, limit} (n <= limit): the
    parts' ranges follow one another from 0 to n without a gap or an
    overlap, start on a tile, and differ by at most one tile in length."""
    nq, nk, h = _heads(preset)
    _, split, tile = cattn.decode_plan(8, nk, h, nq // nk, limit, SMS,
                                       quant=quant)
    for n in sorted({0, 1, tile - 1, tile, tile + 1, limit}):
        if n > limit:
            continue
        rows = cattn.decode_rows(n, split, tile)
        assert len(rows) == split * cattn.DECODE_WARPS
        assert rows[0][0] == 0 and rows[-1][1] == n
        for (lo, hi), (nlo, _) in zip(rows, rows[1:]):
            assert lo <= hi == nlo
        assert all(lo % tile == 0 for lo, _ in rows)
        tiles = [-(-(hi - lo) // tile) for lo, hi in rows]
        assert sum(tiles) == -(-n // tile)
        assert max(tiles) - min(tiles) <= 1


def test_decode_rows_spread_a_short_slot_over_every_rank():
    """A slot whose position is far below the read bound still reaches
    every rank of its cluster: the division follows n, not the limit."""
    _, split, tile = cattn.decode_plan(8, 8, 64, 4, 8192, SMS)
    assert split == 8
    rows = cattn.decode_rows(8 * cattn.DECODE_WARPS * tile, split, tile)
    assert all(hi - lo == tile for lo, hi in rows)
    per_rank = [rows[r * cattn.DECODE_WARPS:(r + 1) * cattn.DECODE_WARPS]
                for r in range(split)]
    assert all(any(hi > lo for lo, hi in part) for part in per_rank)


PAGES = (32, 64, 128, 256, 512)
TABLES = range(1, 17)  # pages a slot's table holds


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("preset", PRESETS)
def test_decode_plan_at_the_paged_read_bounds(preset, page):
    """A pool of tables of 1-16 pages: the read bound page x max_pages
    plans as a dense cache of that many rows does, the tile divides the
    page, and the split stops only where the cap, the rows or the grid
    stop it."""
    nq, nk, h = _heads(preset)
    for quant in (True, False):
        for max_pages in TABLES:
            limit = page * max_pages
            for b in SLOTS:
                plan = cattn.decode_plan(b, nk, h, nq // nk, limit, SMS,
                                         quant=quant, page=page)
                assert plan == cattn.decode_plan(b, nk, h, nq // nk, limit,
                                                 SMS, quant=quant)
                sb, split, tile = plan
                assert sb == 1 and page % tile == 0
                rows = cattn.DECODE_WARPS * cattn.ROWS_PER_WARP
                blocks = split * nk * b
                assert split == 1 or split * rows <= limit
                assert (2 * split > cattn.MAX_SPLIT
                        or 2 * split * rows > limit
                        or 2 * blocks > cattn.BLOCKS_PER_SM * SMS)


@pytest.mark.parametrize("h,quant,page", [(64, True, 16), (64, True, 48),
                                          (64, False, 80), (128, True, 104),
                                          (128, False, 40), (64, True, 0)])
def test_decode_plan_refuses_a_page_the_tile_does_not_divide(h, quant, page):
    with pytest.raises(ValueError, match="page"):
        cattn.decode_plan(8, 8, h, 4, 1024, SMS, quant=quant, page=page)


def test_decode_plan_takes_a_page_of_whole_bf16_tiles_at_h128():
    """Over a bf16 cache at head_dim 128 a tile is 16 rows."""
    assert cattn.decode_plan(8, 8, 128, 4, 1024, SMS, quant=False,
                             page=48)[2] == 16


def _layouts(lead, nk, rows, h, quant):
    """Zero rows [*lead, Nk, rows, H] (a cache [L, B, ...] or a pool
    [P, L, ...]) with their scales, unpaired and paired."""
    shape = (*lead, nk, rows, h)
    kc = torch.zeros(shape, dtype=torch.int8 if quant else torch.bfloat16)
    ks = torch.zeros(shape[:-1]) if quant else None
    return (kc, kc, ks, ks), (pair_heads(kc), pair_heads(kc), ks, ks)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_paired_layouts_take_the_unpaired_plan(preset, quant):
    """The wrappers read a paired cache's or pool's kv-head count as the
    unpaired one's, and `decode_plan` takes no layout, so both layouts get
    one plan (and one order of sums: the same bits on the same rows)."""
    nq, nk, h = _heads(preset)
    b, s, page = 2, 64, 32
    q = torch.zeros((b, 1, nq, h), dtype=torch.bfloat16)
    dense = [cattn._dense_cache("x", q, *cache, 0)
             for cache in _layouts((1, b), nk, s, h, quant)]
    assert [x[0] for x in dense] == [nk, nk]
    assert [x[2] for x in dense] == [0, 1]
    table = torch.zeros((b, 2), dtype=torch.int32)
    pools = [cpaged._check_pool("x", q, pk, pv, table, pks, pvs, 0)
             for pk, pv, pks, pvs in _layouts((2 * b + 1, 1), nk, page, h,
                                              quant)]
    assert [x[0] for x in pools] == [nk, nk]
    assert [x[3] for x in pools] == [0, 1]
    for limit, kw in ((s, {}), (page * 2, dict(page=page))):
        assert len({cattn.decode_plan(b, n, h, nq // nk, limit, SMS,
                                      quant=quant, **kw)
                    for n in (dense[0][0], dense[1][0])}) == 1


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("h", cattn.HEAD_DIMS)
def test_decode_pages_read_each_live_page_once_a_warp(h, quant, page):
    """For tables of 1-16 pages and n live rows from 0 to the read bound:
    each warp reads the entries of the pages its rows lie in, each once and
    in order, and none at or past ceil(n / page); together the warps read
    every live page."""
    for max_pages in TABLES:
        limit = page * max_pages
        _, split, tile = cattn.decode_plan(8, 8, h, 4, limit, SMS,
                                           quant=quant, page=page)
        for n in sorted({0, 1, tile - 1, tile, tile + 1, page - 1, page,
                         page + 1, limit // 2 + 7, limit - 1, limit}):
            if not 0 <= n <= limit:
                continue
            walks = cattn.decode_pages(n, split, tile, page)
            rows = cattn.decode_rows(n, split, tile)
            assert len(walks) == len(rows) == split * cattn.DECODE_WARPS
            live = -(-n // page)
            for reads, (lo, hi) in zip(walks, rows):
                assert reads == sorted(set(reads))  # once each, in order
                assert all(0 <= p < live for p in reads)
                assert reads == ([] if lo == hi else
                                 list(range(lo // page, (hi - 1) // page + 1)))
            assert sorted({p for w in walks for p in w}) == list(range(live))


def test_decode_pages_of_a_warp_within_one_page():
    """At the paged engine's shapes (8 slots of 1024 rows in tables of
    four 512-row pages: a cluster of 8, 32 warps of one 32-row tile) a
    warp's rows lie in one page: one entry a warp."""
    _, split, tile = cattn.decode_plan(8, 8, 64, 4, 2048, SMS, page=512)
    assert (split, tile) == (8, 32)
    walks = cattn.decode_pages(1024, split, tile, 512)
    assert all(len(w) == 1 for w in walks)


@pytest.mark.parametrize("t", [1, 2])
def test_verify_block_takes_two_positions_or_more(t):
    q = torch.zeros((2, t, 8, 64), dtype=torch.bfloat16)
    if t == 1:
        with pytest.raises(ValueError, match="positions a slot"):
            cattn.check_verify_block("verify attention", q)
    else:
        cattn.check_verify_block("verify attention", q)
