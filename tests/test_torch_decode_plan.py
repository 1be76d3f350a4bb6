"""The launch plan of the dense flash-decode kernel (K3, K16, K32;
`attention.decode_plan`) at every preset's head shapes, and the plain
mirror of how the kernel divides a slot's live rows among its warps
(`attention.decode_rows`): plain Python, held here on the CPU because the
kernel they drive runs only on the card (tests/test_torch_cuda.py).

A plan (sb, split, tile) must give the C entry point what it takes: one
slot a block (the library's build), a cluster of 1, 2, 4 or 8 blocks and
the tile of its cache form (32 rows; 16 over a bf16 cache at head_dim
128). It splits as far as the cap, ROWS_PER_WARP rows a warp at the full
read bound and BLOCKS_PER_SM blocks a multiprocessor allow, and no
further; a short read bound gives split 1. The rows: ceil(n / tile)
tiles cut into split x 4 parts in order, as even as can be, whole tiles
each."""

import pytest

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.cuda import attention as cattn

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
