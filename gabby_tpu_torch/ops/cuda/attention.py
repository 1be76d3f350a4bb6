"""Flash-decode and flash-verify attention over the dense KV cache and their
plain PyTorch versions (counterparts of
gabby_tpu/ops/pallas/attention.py:decode_attention and verify_attention in
all their forms).

Over an int8 cache with f32 scales, unpaired [L, B, Nk, S, H]:
  K3   decode, bf16/f32 form (csrc/decode_attention.cu, _decode_call tq = 1);
  K9   verify, T > 1 (csrc/verify_attention.cu, _decode_call tq > 1; the
       kernel of csrc/decode_attention.cuh in its verify form);
  K14  decode, s8 form (csrc/attention_s8.cu, _decode_call use_s8=True;
       the kernel of csrc/decode_attention.cuh in its s8 form);
  K16  decode, bf16/f32 form, the slot-batched launch
       (csrc/decode_attention.cu, _decode_call_multi).
Over the paired int8 cache [L, B, Nk/2, S, 2H] (adjacent kv heads side by
side on the last axis, scales per head; detected by the lane width):
  K12  decode, bf16/f32 form (csrc/decode_attention.cu); K13 verify
       (csrc/verify_attention.cu, _decode_call pair=True);
  K15  decode, s8 form (csrc/attention_s8.cu, pair=True and use_s8=True).
Without fresh rows (the reference's fresh_k=None form, which its public
cache_attention and cache_attention_quantized reach; the cache holds the
current token, rows j <= positions[b] are read):
  K34  decode, int8, unpaired, K35 paired; K36 bf16, unpaired, K37 paired
       (csrc/decode_attention.cu, _decode_call tq = 1 with fresh_k=None).
Over a bf16 cache (no scales: the reference's k_scale=None form):
  K24  decode, unpaired, K25 decode, paired (csrc/decode_attention.cu);
  K26  verify, unpaired, K27 verify, paired (csrc/verify_attention.cu),
       all _decode_call with k_scale=None;
  K32  decode, the slot-batched launch, unpaired
       (csrc/decode_attention.cu, _decode_call_multi with k_scale=None).
Every single-position form (K3, K12, K14, K15, K16, K24, K25, K32,
K34-K37, and the paged K10, K17, K19, K20, K28, K29, K38-K41 of
paged_attention.py) is one kernel (csrc/decode_attention.cuh) whose
launch (slots a block, the cluster that splits a slot's rows, rows a
warp's tile) comes from `decode_plan`, and for the s8 form from
`s8_plan`; it takes group sizes 1, 2, 3, 4 and 8. The verify forms (K9,
K13, K26, K27 here, K11, K18, K30, K31 in paged_attention.py) are the
same kernel with the T x G query columns of a kv head as the products'
N, at `verify_plan`'s launch; they take any group. Every kernel takes
head_dim 64 or 128, reads rows j < min(positions[b], window) of one layer
of the stacked cache (a pointer offset, no copy) and folds the block's
own unquantized k/v in last (the no-fresh-row forms: rows
j < min(positions[b] + 1, window), and nothing after them). A paired
kernel's block owns one kv head and reads its half of each row, so the
paired results equal the unpaired ones on the same rows re-laid. The
cache form is chosen by the scales: given, the cache must be
int8; None, it must be bf16. CPU tensors take the plain versions; CUDA
tensors launch or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabby_tpu_torch.ops import cuda as ck
from gabby_tpu_torch.runtime.kv_cache import dequantize_kv, unpaired

NEG_INF = -1e30
HEAD_DIMS = (64, 128)      # head_dim the kernels are built for
GROUPS = (1, 2, 3, 4, 8)   # group sizes of csrc/decode_attention.cu and s8
DECODE_WARPS = 4           # warps a block of decode_attention.cu: parts a rank
MAX_SPLIT = 8              # the portable cluster size
ROWS_PER_WARP = 64         # rows a warp of decode_attention.cu takes at least
BLOCKS_PER_SM = 4          # blocks of decode_attention.cu a multiprocessor holds
S8_TILE = 32               # rows of a warp's tile in the s8 form
S8_MAX_SPLIT = 4           # the s8 form's largest cluster (see s8_plan)
S8_PARK = 12 * 32          # floats a warp parks for each of its s8 tiles
S8_PARK_TILES = 4          # a part's tiles of an s8 group, chunks allowing
S8_GROUP_CHUNKS = 32       # chunks of a group of the s8 form at most
MAX_SMEM = 232448          # a block's shared memory on the H100, bytes
SM_SMEM = 233472           # a multiprocessor's, 1024 of it kept a block
VERIFY_MAX_T = 32          # positions a verify block at most: one tile
VERIFY_TILE = 32           # cache rows a verify block stages at a time
VERIFY_STAGES = 4          # the verify form's stages in flight
VERIFY_TILES = 8           # n8 column tiles (warps) of a verify block at most
VERIFY_BLOCKS_PER_SM = 4   # verify blocks the plan counts a multiprocessor


def decode_plan(b: int, nk: int, h: int, g: int, limit: int, sms: int, *,
                quant: bool = True,
                page: Optional[int] = None) -> tuple[int, int, int]:
    """The launch of csrc/decode_attention.cu (K3, K12, K16, K24, K25, K32,
    K34-K37 dense; K10, K17, K28, K29 paged, and K38-K41 of
    csrc/paged_attention.cu) for B slots of Nk kv heads of
    head_dim h and group g, read bound `limit` (dense: min(window, S);
    paged: page x max_pages), over an int8 (`quant`) or bf16 cache, on a
    card of `sms` multiprocessors: (sb, split, tile). The grid is (split,
    nk, b // sb), blocks of sb x 128 threads in clusters of `split`. The
    paired layout takes its unpaired plan (nk counts kv heads, not lines),
    and so does a pool whose read bound is a dense cache's: the forms then
    give the same bits on the same rows. `page` (paged): the pool's page,
    which the tile must divide, so that no tile straddles a page.

    sb, slots a block, is 1 (a block is a (slot, kv head, rank); the
    library's kernel is built for one). tile is the rows of a warp's step:
    32, or 16 over a bf16 cache at h = 128, where a step's rows fill a
    lane's registers sooner. split, the blocks a (slot, kv head)'s rows are
    cut over, is the largest of 1, 2, 4, 8 that leaves every warp at least
    ROWS_PER_WARP rows at the full `limit` (a warp's fixed cost, its share
    of the merge, outweighs fewer rows) and the grid within BLOCKS_PER_SM
    blocks a multiprocessor. It depends on the shapes alone, never on the
    positions (the kernel divides a slot's live rows among its warps
    itself), so a launch replays from a CUDA graph."""
    if h not in HEAD_DIMS or g not in GROUPS:
        raise ValueError(f"decode attention takes head_dim in {HEAD_DIMS} "
                         f"and a group in {GROUPS}, got {h}, {g}")
    if b < 1 or nk < 1 or limit < 0 or sms < 1:
        raise ValueError(f"decode_plan: B {b}, Nk {nk}, limit {limit}, "
                         f"{sms} multiprocessors")
    tile = 16 if h == 128 and not quant else 32
    if page is not None and (page < 1 or page % tile):
        raise ValueError(f"paged decode attention reads whole tiles of "
                         f"{tile} rows, which a page of {page} rows does "
                         f"not hold")
    split = 1
    while (2 * split <= MAX_SPLIT
           and DECODE_WARPS * 2 * split * ROWS_PER_WARP <= limit
           and b * nk * 2 * split <= BLOCKS_PER_SM * sms):
        split *= 2
    return 1, split, tile


def verify_plan(b: int, nk: int, h: int, g: int, t: int, limit: int,
                sms: int, *, quant: bool = True,
                page: Optional[int] = None) -> tuple[int, int, int, int]:
    """The launch of the verify form of csrc/decode_attention.cuh (K9, K13,
    K26, K27 dense; K11, K18, K30, K31 paged) for B slots of Nk kv heads
    of head_dim h and group g, t candidate positions, read bound `limit`
    (dense: min(window, S); paged: page x max_pages), over an int8
    (`quant`) or bf16 cache, on a card of `sms` multiprocessors: (split,
    tile, nt, groups). The grid is (split, nk x groups, b), blocks of 32
    nt threads in clusters of `split`.

    A block's columns are the t x g (position, query head) pairs of one kv
    head, column c = t' g + g'; its nt warps take an n8 tile of them each,
    8 nt columns: the fewest tiles that hold all t g columns, as a power
    of two up to VERIFY_TILES; past that the columns are cut into `groups`
    blocks of 8 nt (nt then the power of two that shares them most
    evenly), which re-read the rows through L2. tile is the rows the block
    stages at a time, VERIFY_TILE, for either cache form (a page must hold
    whole tiles). split, the blocks a (slot, kv head)'s rows are cut over,
    is the largest of 1, 2, 4, 8 that leaves every rank at least
    DECODE_WARPS x ROWS_PER_WARP rows at the full `limit` and the grid
    within one wave of blocks at that split (`verify_blocks_per_sm`: rank
    0's inbox grows with the split, and with it a block's shared memory).
    On an H100 that took 4 at the 1B heads and 2 at the 3B heads, each the
    fastest of 1, 2, 4 and 8 there (tools/bench_decode_attention.py
    --splits, PERF.md). The paired layout and a pool whose read bound is a
    dense cache's take the same plan, so those forms give the same bits on
    the same rows. Shapes alone decide it, never the positions, so a launch
    replays from a CUDA graph. `page` (paged): the pool's page, which the
    tile must divide. `quant` does not change it (both cache forms stage
    the same tiles)."""
    if h not in HEAD_DIMS or g < 1 or not 2 <= t <= VERIFY_MAX_T:
        raise ValueError(f"verify attention takes head_dim in {HEAD_DIMS}, "
                         f"a group of at least 1 and 2..{VERIFY_MAX_T} "
                         f"positions, got {h}, {g}, {t}")
    if b < 1 or nk < 1 or limit < 0 or sms < 1:
        raise ValueError(f"verify_plan: B {b}, Nk {nk}, limit {limit}, "
                         f"{sms} multiprocessors")
    tile = VERIFY_TILE
    if page is not None and (page < 1 or page % tile):
        raise ValueError(f"paged verify attention reads whole tiles of "
                         f"{tile} rows, which a page of {page} rows does "
                         f"not hold")
    n8 = -(-t * g // 8)
    groups = -(-n8 // VERIFY_TILES)
    nt = 1
    while nt * groups < n8:
        nt *= 2
    split = 1
    while (2 * split <= MAX_SPLIT
           and DECODE_WARPS * 2 * split * ROWS_PER_WARP <= limit
           and b * nk * groups * 2 * split
           <= verify_blocks_per_sm(h, quant, nt, 2 * split) * sms):
        split *= 2
    return split, tile, nt, groups


def verify_blocks_per_sm(h: int, quant: bool, nt: int, split: int) -> int:
    """The verify blocks a multiprocessor holds at this split, as far as
    shared memory decides (a block also keeps 1024 bytes), at most
    VERIFY_BLOCKS_PER_SM; 0 where a block's does not fit."""
    need = verify_smem_bytes(h, quant, nt, split)
    if need > MAX_SMEM:
        return 0
    return min(VERIFY_BLOCKS_PER_SM, SM_SMEM // (need + 1024))


def verify_smem_bytes(h: int, quant: bool, nt: int, split: int) -> int:
    """The shared memory of a block of the verify form in bytes
    (csrc/decode_attention.cuh verify_smem_bytes): the inbox mbarrier; a
    ring of VERIFY_STAGES tiles (int8 codes of k and v and their scales,
    or bf16 rows padded by 16 bytes); over int8 the tile in bf16 rows; the
    fresh tile's bf16 rows; the inbox of rank 0 (the other ranks'
    partials, nt warps of 8 h + 16 f32 each), where another rank lays out
    its own."""
    row = 2 * h + 16
    stage = (2 * VERIFY_TILE * h + 2 * VERIFY_TILE * 4 if quant
             else 2 * VERIFY_TILE * row)
    return (16 + VERIFY_STAGES * stage
            + (4 if quant else 2) * VERIFY_TILE * row
            + 4 * max(split - 1, 1) * nt * (8 * h + 16))


def verify_rows(n: int, split: int) -> list[tuple[int, int, bool]]:
    """The work each rank of a (slot, kv head) takes in the verify form for
    n live rows (a plain mirror of the kernel): (lo, hi, fresh), its cache
    rows [lo, hi) and whether it takes the fresh tile. The ceil(n /
    VERIFY_TILE) tiles of the slot, then the fresh tile, are cut into
    `split` runs in order, as even as can be, so that the last rank takes
    the fresh tile; every warp of a rank reads all of its rows, for its own
    columns."""
    tiles = -(-n // VERIFY_TILE)
    out = []
    for r in range(split):
        lo = r * (tiles + 1) // split
        hi = (r + 1) * (tiles + 1) // split
        out.append((min(n, lo * VERIFY_TILE), min(n, min(hi, tiles)
                                                   * VERIFY_TILE),
                    hi == tiles + 1))
    return out


def verify_columns(t: int, g: int, nt: int) -> list[tuple[int, int]]:
    """The columns [lo, hi) each column group of the verify form attends
    (a plain mirror of the kernel): groups of 8 nt columns from column 0,
    the last one short."""
    c = t * g
    return [(c0, min(c0 + 8 * nt, c)) for c0 in range(0, c, 8 * nt)]


def chunk_tiles(n: int, tile: int,
                chunk: Optional[int] = None) -> list[tuple[int, int]]:
    """The tiles [lo, hi) csrc/decode_attention.cuh cuts n live rows into,
    in order: tiles of `tile` rows from row 0, the last one short; with a
    quantization chunk (the s8 form), each chunk of `chunk` rows from row
    0 starts a tile, so a chunk's last tile may be short and no tile
    straddles two chunks."""
    if chunk is None:
        return [(r, min(r + tile, n)) for r in range(0, n, tile)]
    return [(r, min(r + tile, c + chunk, n)) for c in range(0, n, chunk)
            for r in range(c, min(c + chunk, n), tile)]


def decode_rows(n: int, split: int, tile: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) each warp of a (slot, kv head) reads in
    csrc/decode_attention.cu for n live rows, part p = rank x DECODE_WARPS
    + warp: the kernel's division of ceil(n / tile) tiles into split x
    DECODE_WARPS parts, as even as can be (a plain mirror of the kernel)."""
    tiles, parts = -(-n // tile), split * DECODE_WARPS
    return [(min(n, p * tiles // parts * tile),
             min(n, (p + 1) * tiles // parts * tile)) for p in range(parts)]


def s8_sizes(split: int, limit: int, chunk: int) -> tuple[int, int, int]:
    """The s8 form's groups (csrc/decode_attention.cuh s8_sizes): (group,
    chunks, park). A slot's live chunks are read `group` at a time, as many
    whole chunks as split x DECODE_WARPS parts of S8_PARK_TILES tiles hold
    (at least 1, at most S8_GROUP_CHUNKS); `chunks` of a group fit the read
    bound `limit`; `park` is the tiles of a part of such a group, which a
    warp parks (S8_PARK_TILES or fewer, unless one chunk holds more)."""
    per, parts = -(-chunk // S8_TILE), split * DECODE_WARPS
    group = max(1, min(S8_GROUP_CHUNKS, S8_PARK_TILES * parts // per))
    nc = -(-limit // chunk) if limit > 0 else 0
    chunks = min(group, nc)
    tiles = len(chunk_tiles(limit, S8_TILE, chunk)) if chunks == nc \
        else chunks * per
    return group, chunks, -(-tiles // parts)


def s8_rows(n: int, split: int, chunk: int,
            limit: int) -> list[list[tuple[int, int]]]:
    """The rows [lo, hi) each warp reads in each group of the s8 form for n
    live rows (a plain mirror of the kernel): a list per group of
    `s8_sizes` chunks, each the group's `chunk_tiles` cut into split x
    DECODE_WARPS parts in order."""
    group = s8_sizes(split, limit, chunk)[0]
    tiles, parts = chunk_tiles(n, S8_TILE, chunk), split * DECODE_WARPS
    nc = -(-n // chunk) if n > 0 else 0
    out = []
    for c0 in range(0, nc, group):
        mine = [tl for tl in tiles if c0 <= tl[0] // chunk < c0 + group]
        end = mine[-1][1]

        def start(i: int) -> int:
            return mine[i][0] if i < len(mine) else end
        out.append([(start(p * len(mine) // parts),
                     start((p + 1) * len(mine) // parts))
                    for p in range(parts)])
    return out


def s8_smem_bytes(h: int, g: int, split: int, limit: int, chunk: int) -> int:
    """The shared memory of a block of the s8 form in bytes, as
    csrc/decode_attention.cuh lays it out: the merge's mbarrier and the
    slot (its warps' partials, the other ranks' and the fresh row's
    scores), then the s8 scratch: two mbarriers; per round the warps', the
    ranks' and the folded maxima of a group's chunks and queries; each
    warp's parked tiles (a score, then p x v_scale, and a v_scale for each
    of 8 elements and 4 rows a lane) and, where the read bound holds more
    than one group, room for its output between groups. It grows with the
    chunk, not the read bound."""
    slot = ((DECODE_WARPS + split - 1) * g * (h + 2) * 4 + g * 4 + 15) & ~15
    _, chunks, park = s8_sizes(split, limit, chunk)
    more = chunks < (-(-limit // chunk) if limit > 0 else 0)
    stash = -(-(h // 16 * 4 * 32) // S8_PARK) if more else 0
    return (16 + slot + 16 + 4 * chunks * g * 2 * (DECODE_WARPS + split + 1)
            + 4 * DECODE_WARPS * (park + stash) * S8_PARK)


def s8_plan(b: int, nk: int, h: int, g: int, limit: int, sms: int,
            chunk: int, *, page: Optional[int] = None
            ) -> tuple[int, int, int]:
    """The launch of the s8 form of csrc/decode_attention.cuh (K14, K15
    dense; K19, K20 paged, where the chunk is the page): `decode_plan`'s
    over an int8 cache with the split at most S8_MAX_SPLIT, so it leaves
    every warp at least ROWS_PER_WARP rows at the full read bound whatever
    the chunk (the ranks trade their chunk maxima, so they may cut one
    chunk's rows), and a paged read bound plans as a dense cache of as many
    rows. Every rank waits for the slowest in each of the form's two
    exchanges, and at split 8 the 8 slots x 8 kv heads' 512 blocks fill the
    H100's register file, so that one call's blocks cannot start under the
    last one's: on an H100 split 4 took 11-18 us a call where 8 took
    16-24 at 1024 live rows of 1025 or 2048, and 14-22 against 14-23 at
    16-2000 rows but for the 1B paged forms (15.9-16.4 against 14.9-15.1;
    tools/bench_decode_attention.py --splits, PERF.md). The block's shared
    memory (`s8_smem_bytes`) does not grow with the read bound, only with a
    chunk of more tiles than the parts park four at a time: the split then
    doubles (up to MAX_SPLIT, more blocks than a wave) while a block takes
    more than half a multiprocessor's. Refused (ValueError): a chunk below
    1, a paged chunk that is not the page, and a chunk whose tiles a block
    cannot park even at MAX_SPLIT (past about 32768 rows). Shapes and the
    chunk alone decide it, never the positions, so a launch replays from a
    CUDA graph."""
    if chunk < 1 or (page is not None and chunk != page):
        raise ValueError(f"s8 decode attention takes a chunk of at least "
                         f"one row (paged: the page), got {chunk}")
    sb, split, tile = decode_plan(b, nk, h, g, limit, sms, quant=True,
                                  page=page)
    split = min(split, S8_MAX_SPLIT)
    share = SM_SMEM // 2 - 1024
    while split < MAX_SPLIT and s8_smem_bytes(h, g, split, limit,
                                              chunk) > share:
        split *= 2
    need = s8_smem_bytes(h, g, split, limit, chunk)
    if need > MAX_SMEM:
        raise ValueError(f"s8 decode attention in chunks of {chunk} rows "
                         f"needs {need} bytes of shared memory a block, "
                         f"more than the {MAX_SMEM} a block has")
    return sb, split, tile


def decode_pages(n: int, split: int, tile: int, page: int) -> list[list[int]]:
    """The page-table entries (logical pages) each warp of a (slot, kv
    head) reads in the paged form of csrc/decode_attention.cu for n live
    rows, in the order it reads them: its tiles' pages, an entry read when
    a tile lies in another page than the tile before it (a plain mirror of
    the kernel's page walk)."""
    tiles, parts = -(-n // tile), split * DECODE_WARPS
    walks = []
    for p in range(parts):
        reads = []
        for t in range(p * tiles // parts, (p + 1) * tiles // parts):
            if not reads or reads[-1] != t * tile // page:
                reads.append(t * tile // page)
        walks.append(reads)
    return walks


def stacked(k_cache, v_cache, k_scale, v_scale, layer: Optional[int]):
    """The cache as the kernels take it: a stack [L, B, ...] and a layer.
    layer=None views one layer's [B, Nk, S, H] (and [B, Nk, S] scales) as a
    one-layer stack, as the reference's decode_attention does (no copy)."""
    if layer is not None:
        return k_cache, v_cache, k_scale, v_scale, layer
    return (k_cache[None], v_cache[None],
            None if k_scale is None else k_scale[None],
            None if v_scale is None else v_scale[None], 0)


def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, positions,
                           *, layer: Optional[int] = None, fresh_k=None,
                           fresh_v=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The reference's contract: the layer's cache (the cache itself when
    layer is None; dequantized when scales are given, un-paired when it is
    paired) in q's dtype, rows j < positions[b] plus the fresh row, or
    without fresh rows rows j <= positions[b], in f32."""
    from gabby_tpu_torch.ops.attention import cache_attention_reference
    k_cache, v_cache, k_scale, v_scale, layer = stacked(
        k_cache, v_cache, k_scale, v_scale, layer)
    if k_scale is None:
        return cache_attention_reference(q, k_cache[layer], v_cache[layer],
                                         positions, scale=scale,
                                         fresh_k=fresh_k, fresh_v=fresh_v)
    h = q.shape[-1]
    kk = dequantize_kv(unpaired(k_cache[layer], h), k_scale[layer], q.dtype)
    vv = dequantize_kv(unpaired(v_cache[layer], h), v_scale[layer], q.dtype)
    return cache_attention_reference(q, kk, vv, positions, scale=scale,
                                     fresh_k=fresh_k, fresh_v=fresh_v)


def s8_attention_core(q, k_codes, v_codes, k_scale, v_scale, positions,
                      fresh_k, fresh_v, sm_scale: float,
                      chunk: int) -> torch.Tensor:
    """The s8 decode contract on one layer's head-major rows: q
    [B, 1, Nq, H]; k/v_codes [B, Nk, S, H] int8; k/v_scale [B, Nk, S] f32;
    fresh_k/v [B, Nk, H]. Per kv head and query row: q quantized to int8 by
    its own absmax, integer scores scaled by qs * (k_scale * sm_scale), an
    online softmax in f32 over chunks of `chunk` rows from row 0 (a chunk is
    entered while its first row is below positions[b]), the value-scaled
    probabilities quantized to int8 by their maximum over the chunk, the
    integer value product scaled back, and the fresh row folded last in
    f32. Integer products are taken in float64, where they are exact."""
    b, _, nq, h = q.shape
    nk, s = k_codes.shape[1], k_codes.shape[2]
    g = nq // nk
    qf = q[:, 0].float().reshape(b, nk, g, h)
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-9) * (1.0 / 127.0)
    q8 = torch.round(qf / qs).double()
    m = torch.full((b, nk, g, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, nk, g, h), dtype=torch.float32, device=q.device)
    top = int(positions.max())
    for lo in range(0, min(s, top), chunk):
        hi = min(lo + chunk, s)
        live = (lo < positions)[:, None, None, None]
        si = torch.einsum("bkgh,bkch->bkgc", q8, k_codes[:, :, lo:hi].double())
        scores = (si.float() * qs) * (k_scale[:, :, None, lo:hi] * sm_scale)
        cols = torch.arange(lo, hi, device=q.device)
        scores = torch.where(cols[None, :] < positions[:, None, None, None],
                             scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        pvf = p * v_scale[:, :, None, lo:hi]
        pscale = torch.clamp(pvf.amax(-1, keepdim=True),
                             min=1e-30) * (1.0 / 127.0)
        p8 = torch.round(pvf / pscale).double()
        ci = torch.einsum("bkgc,bkch->bkgh", p8, v_codes[:, :, lo:hi].double())
        m = torch.where(live, m_new, m)
        l = torch.where(live, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(live, acc * alpha + ci.float() * pscale, acc)
    sf = torch.einsum("bkgh,bkh->bkg", qf, fresh_k.float())[..., None] * sm_scale
    m_new = torch.maximum(m, sf)
    alpha = torch.exp(m - m_new)
    pf = torch.exp(sf - m_new)
    out = ((acc * alpha + pf * fresh_v.float()[:, :, None, :])
           / (l * alpha + pf))
    return out.reshape(b, 1, nq, h).to(q.dtype)


def decode_attention_s8_plain(q, k_cache, v_cache, k_scale, v_scale,
                              positions, *, layer: int, fresh_k, fresh_v,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The s8 form of the decode contract (`s8_attention_core`) on one layer
    of the dense cache, paired or not, with the reference's chunk:
    min(attn_chunk(), S) rows."""
    h = q.shape[-1]
    s = k_cache.shape[3]
    return s8_attention_core(
        q, unpaired(k_cache[layer], h), unpaired(v_cache[layer], h),
        k_scale[layer], v_scale[layer], positions, fresh_k, fresh_v,
        float(scale) if scale is not None else h ** -0.5,
        min(ck.attn_chunk(), s))


def check_cache_form(what: str, k_cache, v_cache, k_scale,
                     v_scale) -> None:
    """The two cache forms a kernel takes: int8 codes with f32 scales, or
    bf16 rows without scales (the reference's k_scale=None form)."""
    if k_scale is None or v_scale is None:
        if (k_scale is not None or v_scale is not None
                or k_cache.dtype != torch.bfloat16
                or v_cache.dtype != torch.bfloat16):
            raise ValueError(f"{what} takes a bf16 cache when it is given "
                             f"no scales, got {k_cache.dtype}")
    elif (k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError(f"{what} takes an int8 cache with f32 scales")


def _dense_cache(what: str, q, k_cache, v_cache, k_scale, v_scale,
                 layer: int):
    """Shape and type checks of one layer of a dense cache (int8 with
    scales, or bf16 with none) against q [B, T, Nq, H]. Returns (Nk, S,
    pair, byte offsets of the layer in the rows and in the scales)."""
    b, _, nq, h = q.shape
    check_cache_form(what, k_cache, v_cache, k_scale, v_scale)
    if k_cache.dim() != 5 or (k_scale is not None and k_scale.dim() != 4):
        raise ValueError(f"{what}: the cache must be stacked "
                         f"[L, B, Nk, S, H], got {tuple(k_cache.shape)}")
    nl, _, heads, s, lanes = k_cache.shape
    pair = int(lanes == 2 * h)
    nk = heads * 2 if pair else heads
    if (h not in HEAD_DIMS or lanes not in (h, 2 * h) or nq % nk
            or k_cache.shape != (nl, b, heads, s, lanes)
            or v_cache.shape != k_cache.shape
            or (k_scale is not None and (k_scale.shape != (nl, b, nk, s)
                                         or v_scale.shape != k_scale.shape))
            or not 0 <= layer < nl):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}, scales "
                         f"{None if k_scale is None else tuple(k_scale.shape)}"
                         f", layer {layer}")
    return (nk, s, pair, layer * b * nk * s * h * k_cache.element_size(),
            layer * b * nk * s * 4)


def scale_planes(k_scale, v_scale) -> tuple:
    """The scale planes a wrapper checks beside the cache: both, or none
    for a bf16 cache."""
    return () if k_scale is None else (k_scale, v_scale)


def check_decode_inputs(what: str, q, fresh_k, fresh_v, positions, tensors,
                        nk: int) -> None:
    """`check_block_inputs` for single-position decode: q [B, 1, Nq, H],
    fresh_k/v [B, Nk, H] (or both None: the no-fresh-row form), and a group
    size the kernels are built for."""
    fresh = fresh_k is not None or fresh_v is not None
    if (q.shape[1] != 1 or q.shape[2] // nk not in GROUPS
            or (fresh and (fresh_k is None or fresh_v is None
                           or fresh_k.dim() != 3 or fresh_v.dim() != 3))):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"fresh "
                         f"{None if fresh_k is None else tuple(fresh_k.shape)}"
                         f", {nk} kv heads (groups {GROUPS})")
    check_block_inputs(what, q, fresh_k[:, :, None] if fresh else None,
                       fresh_v[:, :, None] if fresh else None, positions,
                       tensors, nk)


def _limit(s: int, window: Optional[int]) -> int:
    return s if window is None else min(window, s)


def decode_launch(fn, q, args: tuple, quant: bool, nk: int, limit: int,
                  scale: Optional[float], what: str,
                  page: Optional[int] = None) -> None:
    """One launch of csrc/decode_attention.cu through its entry `fn` at
    `decode_plan`'s launch: `args` are the entry's arguments before the
    plan (pointers, then shapes)."""
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda.quant_matmul import multiprocessors
    _, _, nq, h = q.shape
    plan = decode_plan(q.shape[0], nk, h, nq // nk, limit,
                       multiprocessors(q.device.index), quant=quant,
                       page=page)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(fn(*args, *plan, sm_scale, build.stream_ptr(q.device)), what)


def _dense_decode(what: str, q, k_cache, v_cache, k_scale, v_scale,
                  positions, layer: int, fresh_k, fresh_v,
                  scale: Optional[float], window: Optional[int], *,
                  multi: bool = False):
    """The dense forms' launch (checks, output, one call of the entry for
    the cache form; without fresh rows the no-fresh-row entry). `multi`:
    the slot-batched entry point's conditions, the unpaired cache and a
    slot block that divides B. Returns (out, pair)."""
    b, _, nq, h = q.shape
    nk, s, pair, kv_off, sc_off = _dense_cache(what, q, k_cache, v_cache,
                                               k_scale, v_scale, layer)
    if multi and (pair or pick_slot_block(b) < 2 or fresh_k is None):
        raise ValueError(f"{what} takes the unpaired cache, fresh rows and "
                         f"a slot count that 2 divides, got cache "
                         f"{tuple(k_cache.shape)}")
    quant = k_scale is not None
    check_decode_inputs(what, q, fresh_k, fresh_v, positions,
                        (k_cache, v_cache, *scale_planes(k_scale, v_scale)),
                        nk)
    limit = _limit(s, window)
    if fresh_k is None and limit < 1:
        raise ValueError(f"{what}: without fresh rows a slot reads at least "
                         f"its own row, got a read bound of {limit}")
    from gabby_tpu_torch.ops.cuda import build
    lib = build.library()
    out = torch.empty_like(q)
    rows = (k_cache.data_ptr() + kv_off, v_cache.data_ptr() + kv_off)
    if quant:
        rows += (k_scale.data_ptr() + sc_off, v_scale.data_ptr() + sc_off)
    if fresh_k is None:
        fn = (lib.gabby_decode_attention_nofresh if quant
              else lib.gabby_decode_attention_nofresh_bf16)
    else:
        fn = (lib.gabby_decode_attention if quant
              else lib.gabby_decode_attention_bf16)
        rows += (fresh_k.data_ptr(), fresh_v.data_ptr())
    decode_launch(fn, q, (q.data_ptr(), *rows, positions.data_ptr(),
                          out.data_ptr(), b, nq, nk, s, h, limit, pair),
                  quant, nk, limit, scale, what)
    return out, pair


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor],
                     positions: torch.Tensor, *,
                     layer: Optional[int] = None,
                     fresh_k: Optional[torch.Tensor] = None,
                     fresh_v: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """The bf16/f32 form. q [B, 1, Nq, H] bf16, H 64 or 128, Nq / Nk in
    GROUPS; k/v_cache [L, B, Nk, S, H] int8 (K3) or paired
    [L, B, Nk/2, S, 2H] (K12) with k/v_scale [L, B, Nk, S] f32, or a bf16
    cache of either layout with k/v_scale None (K24, K25); layer=None takes
    one layer's [B, Nk, S, H] (scales [B, Nk, S]) as a one-layer stack;
    positions [B] int32; fresh_k/v [B, Nk, H] bf16: rows j < positions[b]
    plus the fresh row. Without fresh rows (both None: the no-fresh-row
    form, K34 and K35 over int8, K36 and K37 over bf16) the cache holds the
    current token and rows j <= positions[b] are read. Returns
    [B, 1, Nq, H]. `window` (when given) bounds every slot's read, which
    the caller guarantees covers positions[b] (and, without fresh rows,
    positions[b] + 1 rows). One kernel (csrc/decode_attention.cu) for
    every form: on the same rows the paired result equals the unpaired one
    bit for bit."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)
    k_cache, v_cache, k_scale, v_scale, layer = stacked(
        k_cache, v_cache, k_scale, v_scale, layer)
    out, pair = _dense_decode("decode attention", q, k_cache, v_cache,
                              k_scale, v_scale, positions, layer, fresh_k,
                              fresh_v, scale, window)
    ck.launch_counts["decode_attention"
                     + ("" if fresh_k is not None else "_nofresh")
                     + ("" if k_scale is not None else "_bf16")
                     + ("_paired" if pair else "")] += 1
    return out


def pick_slot_block(b: int) -> int:
    """The slot block of the slot-batched decode launch's dispatch, the
    reference's `_pick_slot_block` without its TPU memory budget: the
    largest of 8, 4 and 2 that divides B, else 1 (then the plain launch
    serves). The dispatch takes the slot-batched launch where it is more
    than 1, the reference's condition that a slot block divides B. The
    kernel itself takes `decode_plan`'s slots a block, so K16 and K3 are
    one launch on the same rows."""
    for sb in (8, 4, 2):
        if b % sb == 0:
            return sb
    return 1


def decode_attention_multi(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, positions: torch.Tensor, *,
                           layer: int, fresh_k: torch.Tensor,
                           fresh_v: torch.Tensor,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """`decode_attention` over the unpaired cache where a slot block
    (`pick_slot_block(B)`) divides B: K16 over an int8 cache, K32 over a
    bf16 one (k/v_scale None), both at `decode_plan`'s launch. Same inputs,
    same result; the same bits as K3 (int8) and K24 (bf16)."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)
    out, _ = _dense_decode("slot-batched decode attention", q, k_cache,
                           v_cache, k_scale, v_scale, positions, layer,
                           fresh_k, fresh_v, scale, window, multi=True)
    ck.launch_counts["decode_attention_multi" if k_scale is not None
                     else "decode_attention_multi_bf16"] += 1
    return out


def decode_attention_s8(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, positions: torch.Tensor, *,
                        layer: int, fresh_k: torch.Tensor,
                        fresh_v: torch.Tensor, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """The s8 form (`s8_attention_core`), inputs as `decode_attention`:
    unpaired cache K14, paired cache K15, at `s8_plan`'s launch. The
    quantization chunk is min(attn_chunk(), S) rows. On the same rows
    under the same plan K15 equals K14 bit for bit."""
    if not q.is_cuda:
        return decode_attention_s8_plain(
            q, k_cache, v_cache, k_scale, v_scale, positions, layer=layer,
            fresh_k=fresh_k, fresh_v=fresh_v, scale=scale)
    what = "s8 decode attention"
    b, _, nq, h = q.shape
    if k_scale is None:
        raise ValueError(f"{what} takes an int8 cache with f32 scales")
    nk, s, pair, kv_off, sc_off = _dense_cache(what, q, k_cache, v_cache,
                                               k_scale, v_scale, layer)
    check_decode_inputs(what, q, fresh_k, fresh_v, positions,
                         (k_cache, v_cache, k_scale, v_scale), nk)
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda.quant_matmul import multiprocessors
    limit, chunk = _limit(s, window), min(ck.attn_chunk(), s)
    plan = s8_plan(b, nk, h, nq // nk, limit,
                   multiprocessors(q.device.index), chunk)
    lib = build.library()
    out = torch.empty_like(q)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    build.check(lib.gabby_attention_s8(
        q.data_ptr(), k_cache.data_ptr() + kv_off,
        v_cache.data_ptr() + kv_off, k_scale.data_ptr() + sc_off,
        v_scale.data_ptr() + sc_off, None, fresh_k.data_ptr(),
        fresh_v.data_ptr(), positions.data_ptr(), out.data_ptr(), b, nq, nk,
        1, 0, s, 1, h, limit, chunk, pair, *plan, sm_scale,
        build.stream_ptr(q.device)), what)
    ck.launch_counts["decode_attention_s8_paired" if pair
                     else "decode_attention_s8"] += 1
    return out


def verify_attention_plain(q, k_cache, v_cache, k_scale, v_scale, positions,
                           *, layer: int, fresh_k, fresh_v,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The reference's contract: the layer's cache (dequantized when scales
    are given, un-paired when it is paired) in q's dtype, rows
    j < positions[b] for every query plus the block's own fresh rows
    causally, in f32."""
    from gabby_tpu_torch.ops.attention import verify_attention_reference
    h = q.shape[-1]
    return verify_attention_reference(
        q, unpaired(k_cache[layer], h), unpaired(v_cache[layer], h),
        positions, None if k_scale is None else k_scale[layer],
        None if v_scale is None else v_scale[layer], fresh_k=fresh_k,
        fresh_v=fresh_v, scale=scale)


def check_block_inputs(what: str, q, fresh_k, fresh_v, positions, tensors,
                       nk: int) -> None:
    """Checks shared by the forms of csrc/decode_attention.cuh (decode, T =
    1; verify, T > 1): q [B, T, Nq, H] (H 64 or 128) and
    fresh_k/v [B, Nk, T, H] bf16 (None in the no-fresh-row decode form),
    positions [B] int32, everything contiguous on the GPU and 16-byte
    aligned."""
    b, t, nq, h = q.shape
    fresh = () if fresh_k is None else (fresh_k, fresh_v)
    tensors = (q, *fresh, positions, *tensors)
    if not all(x.is_cuda and x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError(f"{what}: tensors must be contiguous and 16-byte "
                         f"aligned on the GPU")
    if (q.dtype != torch.bfloat16
            or any(x.dtype != torch.bfloat16 for x in fresh)
            or positions.dtype != torch.int32):
        raise ValueError(f"{what} takes bf16 q/fresh and int32 positions")
    if (h not in HEAD_DIMS or nq % nk or not 1 <= t <= 32
            or any(x.shape != (b, nk, t, h) for x in fresh)
            or positions.shape != (b,)):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"fresh {[tuple(x.shape) for x in fresh]}, {nk} kv "
                         f"heads")


def check_verify_block(what: str, q) -> None:
    """The verify form (csrc/decode_attention.cuh) takes 2 <= T <= 32
    positions: a single position is the decode form's."""
    if q.shape[1] < 2:
        raise ValueError(f"{what} takes 2 to 32 positions a slot, got q "
                         f"{tuple(q.shape)}: one position is decode "
                         f"attention's")


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor, *,
                     layer: int, fresh_k: torch.Tensor,
                     fresh_v: torch.Tensor, scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q [B, T, Nq, H] bf16, 2 <= T <= 32 candidate positions per slot, H
    64 or 128; k/v_cache [L, B, Nk, S, H] int8 (K9) or paired
    [L, B, Nk/2, S, 2H] (K13) with k/v_scale [L, B, Nk, S] f32, or a bf16
    cache of either layout with k/v_scale None (K26, K27); positions [B]
    int32 (the read bound; parked lanes are given 1); fresh_k/v
    [B, Nk, T, H] bf16, head-major in both layouts. Returns [B, T, Nq, H].
    `window` (when given) bounds every slot's read, which the caller
    guarantees covers positions[b]. One kernel (csrc/verify_attention.cu,
    the verify form of csrc/decode_attention.cuh) at `verify_plan`'s
    launch: on the same rows the paired result equals the unpaired one bit
    for bit."""
    if not q.is_cuda:
        return verify_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      positions, layer=layer,
                                      fresh_k=fresh_k, fresh_v=fresh_v,
                                      scale=scale)
    what = "verify attention"
    check_verify_block(what, q)
    b, t, nq, h = q.shape
    nk, s, pair, kv_off, sc_off = _dense_cache(what, q, k_cache, v_cache,
                                               k_scale, v_scale, layer)
    if s % VERIFY_TILE:
        raise ValueError(f"{what} stages whole tiles of {VERIFY_TILE} rows: "
                         f"the cache's {s} rows are not a multiple of it")
    check_block_inputs(what, q, fresh_k, fresh_v, positions,
                       (k_cache, v_cache, *scale_planes(k_scale, v_scale)),
                       nk)
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda.quant_matmul import multiprocessors
    lib = build.library()
    out = torch.empty_like(q)
    sm_scale = float(scale) if scale is not None else h ** -0.5
    limit = _limit(s, window)
    split, tile, nt, _ = verify_plan(b, nk, h, nq // nk, t, limit,
                                     multiprocessors(q.device.index),
                                     quant=k_scale is not None)
    rows = (q.data_ptr(), k_cache.data_ptr() + kv_off,
            v_cache.data_ptr() + kv_off)
    rest = (fresh_k.data_ptr(), fresh_v.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, t, nq, nk, s, h, limit, pair, split, tile,
            nt, sm_scale, build.stream_ptr(q.device))
    if k_scale is None:
        build.check(lib.gabby_verify_attention_bf16(*rows, *rest), what)
        ck.launch_counts["verify_attention_bf16_paired" if pair
                         else "verify_attention_bf16"] += 1
        return out
    build.check(lib.gabby_verify_attention(
        *rows, k_scale.data_ptr() + sc_off, v_scale.data_ptr() + sc_off,
        *rest), what)
    ck.launch_counts["verify_attention_paired" if pair
                     else "verify_attention"] += 1
    return out
