"""The s8 form of the single-position flash-decode kernel
(csrc/decode_attention.cuh through csrc/attention_s8.cu: K14, K15 dense,
K19, K20 paged) held on the CPU where its plain parts can be: the
chunk-aligned division of a slot's live rows into tiles, groups of
chunks and parts (`attention.chunk_tiles`, `s8_rows`), the launch plan
(`attention.s8_plan`) at every preset's heads and read bounds and what it
refuses, and a plain mirror of the kernel's arithmetic, written here for
the tests alone: q quantized, every part's scores, the chunk maxima the
ranks trade (the running maximum m_run(c) after each chunk, then the
largest p x v_scale of each chunk), each part's chunks folded in order,
the warps and then the ranks merged in order, the fresh row last. The
kernel itself runs only on the card (tests/test_torch_cuda.py).

Tolerances: the mirror and `s8_attention_core` quantize with the same
operands (q's scale, the scores, m_run, p, the chunk's scale) and take
exact integer products, so what differs is the order of the f32 sums of
l and of the merge, and a bf16 step of the output: 2e-2 relative plus
1e-2 of the plain row's RMS, chip_smoke.py's and tests/test_torch_cuda.py's
S8_TOL. Against the JAX s8 Pallas kernel (interpret mode, called directly
as tests/test_torch_pair_s8.py calls it) 1e-2 absolute and relative, that
file's S8_TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabby_tpu.ops.pallas import attention as pattn
from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.attention import gather_layer
from gabby_tpu_torch.ops.cuda import attention as cattn
from gabby_tpu_torch.runtime.kv_cache import quantize_kv
from test_torch_pair_s8 import _dense_inputs, _j, _jb, _pool_inputs, _t

SMS = 132  # H100 SXM
PRESETS = ("llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")
S8_TOL = dict(rtol=2e-2, atol_rms=1e-2)
JAX_S8_TOL = dict(rtol=1e-2, atol=1e-2)
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    for name in ("GABBY_ATTN_S8", "GABBY_ATTN_MULTI", "GABBY_ATTN_CHUNK"):
        monkeypatch.delenv(name, raising=False)


def _heads(preset: str):
    cfg = getattr(cfglib, preset)()
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim


# ---- the chunk-aligned division -------------------------------------------

LIMITS = (1, 31, 32, 64, 100, 1000, 1024, 1025, 2048)
CHUNKS = (64, 100, 512, 1024, 4096)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("preset", PRESETS)
def test_chunk_tiles_cover_each_chunk_once(preset, limit, chunk):
    """For n in {0, 1, 31, 32, 33, a chunk's edges, limit} (n <= limit):
    the tiles follow one another from row 0 to n, none holds more than 32
    rows or straddles a chunk, each chunk's live rows are tiled exactly
    once from its first row; the s8 form's groups (`s8_rows`) take whole
    chunks in order, at most `s8_sizes`' group of them, and each group's
    parts (split x 4 of them) cut its tiles in order, whole tiles each, at
    most one tile apart and no more than a warp parks."""
    nq, nk, h = _heads(preset)
    _, split, tile = cattn.s8_plan(8, nk, h, nq // nk, limit, SMS,
                                   min(chunk, limit))
    assert tile == cattn.S8_TILE
    c = min(chunk, limit)
    group, _, park = cattn.s8_sizes(split, limit, c)
    for n in sorted({0, 1, 31, 32, 33, c - 1, c, c + 1, limit}):
        if not 0 <= n <= limit:
            continue
        tiles = cattn.chunk_tiles(n, tile, c)
        assert [lo for lo, _ in tiles[1:]] == [hi for _, hi in tiles[:-1]]
        assert (tiles[0][0] if tiles else 0) == 0
        assert (tiles[-1][1] if tiles else 0) == n
        for lo, hi in tiles:
            assert 0 < hi - lo <= tile
            assert lo // c == (hi - 1) // c  # inside one chunk
        for k in range(-(-n // c)):
            mine = [(lo, hi) for lo, hi in tiles if lo // c == k]
            assert mine[0][0] == k * c
            assert mine[-1][1] == min((k + 1) * c, n)
        groups = cattn.s8_rows(n, split, c, limit)
        assert len(groups) == -(-(-(-n // c)) // group)
        end = 0
        for k, rows in enumerate(groups):
            assert len(rows) == split * cattn.DECODE_WARPS
            assert rows[0][0] == end == k * group * c
            end = rows[-1][1]
            starts = {lo for lo, _ in tiles} | {n}
            counts = []
            for (lo, hi), (nlo, _) in zip(rows, rows[1:] + [(end, end)]):
                assert lo <= hi == nlo and lo in starts and hi in starts
                counts.append(sum(1 for a, _ in tiles if lo <= a < hi))
            assert max(counts) - min(counts) <= 1
            assert max(counts) <= park
        assert end == n


def test_decode_rows_without_a_chunk_is_the_bf16_division():
    """The bf16/f32 forms' division is the chunked one with no chunk:
    tiles from row 0, the last short."""
    for n in (0, 1, 31, 33, 1000, 2047):
        for split in (1, 2, 4, 8):
            tiles, parts = -(-n // 32), split * cattn.DECODE_WARPS
            assert cattn.decode_rows(n, split, 32) == [
                (min(n, p * tiles // parts * 32),
                 min(n, (p + 1) * tiles // parts * 32))
                for p in range(parts)]


# ---- the plan --------------------------------------------------------------


@pytest.mark.parametrize("chunk", (64, 100, 512, 1024))
@pytest.mark.parametrize("limit", (1, 64, 1024, 1025, 2048, 8192, 16384,
                                   32768, 131072))
@pytest.mark.parametrize("preset", PRESETS)
def test_s8_plan_at_every_preset(preset, limit, chunk):
    """Dense read bounds up to the presets' max_seq (8192) and past it, at
    1 to 64 slots: the bf16/f32 plan over an int8 cache with the split
    capped at S8_MAX_SPLIT (the chunk does not limit the split), and a
    scratch that fits a block and is the same at every read bound that
    holds more than a group."""
    nq, nk, h = _heads(preset)
    c = min(chunk, limit)
    for b in (1, 4, 8, 32, 64):
        plan = cattn.s8_plan(b, nk, h, nq // nk, limit, SMS, c)
        sb, split, tile = cattn.decode_plan(b, nk, h, nq // nk, limit, SMS,
                                            quant=True)
        assert plan == (sb, min(split, cattn.S8_MAX_SPLIT), tile)
        need = cattn.s8_smem_bytes(h, nq // nk, plan[1], limit, c)
        assert need <= cattn.MAX_SMEM
        group = cattn.s8_sizes(plan[1], limit, c)[0]
        if limit > group * c:
            assert need == cattn.s8_smem_bytes(h, nq // nk, plan[1],
                                               2 * limit, c)


@pytest.mark.parametrize("page", (32, 64, 128, 256, 512))
@pytest.mark.parametrize("preset", PRESETS)
def test_s8_plan_at_the_paged_read_bounds(preset, page):
    """Tables of 1-16 pages, the chunk a page: the plan of a dense cache as
    long as the read bound (so K19 gives K14's bits where the dense chunk
    is the page), within a block's shared memory."""
    nq, nk, h = _heads(preset)
    for max_pages in range(1, 17):
        limit = page * max_pages
        plan = cattn.s8_plan(8, nk, h, nq // nk, limit, SMS, page, page=page)
        assert plan == cattn.s8_plan(8, nk, h, nq // nk, limit, SMS, page)
        assert cattn.s8_smem_bytes(h, nq // nk, plan[1], limit,
                                   page) <= cattn.MAX_SMEM


def test_s8_plan_at_the_serving_shapes():
    """The 1B and 3B heads at the engine's and chip_smoke.py's read
    bounds: clusters of 4 at 1025 rows and at 2048 (the paged pools' 33
    pages of 512 plan for 4 pages a slot), where the bf16/f32 forms take 8;
    below 1024 rows the two agree."""
    for h, g in ((64, 4), (128, 3)):
        assert cattn.s8_plan(8, 8, h, g, 1025, SMS, 1024)[:2] == (1, 4)
        assert cattn.s8_plan(8, 8, h, g, 2048, SMS, 512,
                             page=512)[:2] == (1, 4)
        assert cattn.decode_plan(8, 8, h, g, 2048, SMS)[:2] == (1, 8)
        for limit in (64, 512, 1023):
            assert (cattn.s8_plan(8, 8, h, g, limit, SMS, limit)
                    == cattn.decode_plan(8, 8, h, g, limit, SMS))


def test_s8_plan_raises_the_split_for_long_chunks():
    """A chunk of more tiles than a cluster's parts park four at a time
    raises the split (beyond one wave) until a block takes no more than
    half a multiprocessor's shared memory; chunks of 1024 and below never
    need it, at any slot count."""
    share = {64: cattn.SM_SMEM // 2 - 1024, 128: cattn.SM_SMEM // 2 - 1024}
    for h, g in ((64, 4), (128, 3), (128, 8)):
        for b in (1, 8, 64):
            for chunk in (32, 100, 1024):
                plan = cattn.s8_plan(b, 8, h, g, 8192, SMS, chunk)
                sb, split, tile = cattn.decode_plan(b, 8, h, g, 8192, SMS)
                assert plan[1] == min(split, cattn.S8_MAX_SPLIT)
                assert cattn.s8_smem_bytes(h, g, plan[1], 8192,
                                           chunk) <= share[h]
    assert cattn.s8_plan(64, 8, 64, 4, 32768, SMS, 4096)[1] == 4
    assert cattn.s8_plan(64, 8, 64, 4, 65536, SMS, 16384)[1] == 8
    assert cattn.s8_sizes(8, 65536, 16384)[2] == 16  # tiles a warp parks


@pytest.mark.parametrize("args,kw", [
    ((8, 8, 64, 4, 1024, SMS, 0), {}),                   # no chunk
    ((8, 8, 64, 4, 2048, SMS, 256), dict(page=512)),     # chunk != page
    ((8, 8, 64, 4, 1024, SMS, -64), {}),                 # negative chunk
    ((8, 8, 64, 4, 2048, SMS, 0), dict(page=0)),         # no page
    ((8, 8, 96, 4, 1024, SMS, 1024), {}),                # head_dim
    ((8, 8, 64, 5, 1024, SMS, 1024), {}),                # group
    ((8, 8, 64, 4, 1024, SMS, 1024), dict(page=48)),     # page % 32
    ((64, 8, 128, 8, 65536, SMS, 32768), {}),            # park too big
])
def test_s8_plan_refuses_what_the_kernel_does_not_take(args, kw):
    with pytest.raises(ValueError):
        cattn.s8_plan(*args, **kw)


# ---- a plain mirror of the kernel's arithmetic ----------------------------


def _merge(parts):
    """(m, l, acc) partials folded in order, as the kernel folds a block's
    warps and then rank 0 the ranks: against their common maximum."""
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    ll = sum(l * torch.exp(m - mm) for m, l, _ in parts)
    aa = sum(a * torch.exp(m - mm)[..., None] for m, _, a in parts)
    return mm, ll, aa


def _mirror(q, kc, vc, ks, vs, pos, fk, fv, sm_scale, chunk, split, limit):
    """The s8 kernel's arithmetic on one layer's head-major rows (q
    [B, 1, Nq, H] bf16; k/v codes [B, Nk, S, H] int8; scales [B, Nk, S];
    fresh rows [B, Nk, H]) at a given split, as csrc/decode_attention.cuh
    does it: group by group (`s8_rows`), every rank scores its parts' rows,
    the ranks' chunk maxima fold into m_run(c) (the running maximum after
    chunk c) on every rank, p = exp(s - m_run(c)), the chunks' largest p x
    v_scale into pscale(c), p8 = round(p x v_scale / pscale(c)); each part
    folds its chunks in order, carried from one group to the next (o = o x
    exp(m_run(c - 1) - m_run(c)) + int32(p8 . v) x pscale(c), l over the
    unquantized p), relative to the running maximum of its last chunk;
    then the 4 warps of each rank merge in order, the ranks in order, and
    the fresh row last, in f32."""
    b, _, nq, h = q.shape
    nk = kc.shape[1]
    g = nq // nk
    qf = q[:, 0].float().reshape(b, nk, g, h)
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-9) * (1 / 127)
    q8 = torch.round(qf / qs).double()
    out = torch.empty((b, nk, g, h))
    warps = cattn.DECODE_WARPS
    for i in range(b):
        n = min(int(pos[i]), limit)
        parts = [(torch.full((nk, g), NEG_INF), torch.zeros((nk, g)),
                  torch.zeros((nk, g, h)))] * (split * warps)
        if n > 0:
            s = (torch.einsum("kgh,kjh->kgj", q8[i], kc[i, :, :n].double())
                 .float() * qs[i]) * (ks[i, :, None, :n] * sm_scale)
            nc = -(-n // chunk)
            spans = [(c * chunk, min((c + 1) * chunk, n)) for c in range(nc)]
            m_run = torch.stack([s[..., lo:hi].amax(-1) for lo, hi in spans],
                                -1).cummax(-1).values
            cj = torch.arange(n) // chunk
            p = torch.exp(s - m_run[..., cj])
            pvf = p * vs[i, :, None, :n]
            pscale = torch.clamp(torch.stack(
                [pvf[..., lo:hi].amax(-1) for lo, hi in spans], -1),
                min=1e-30) * (1 / 127)
            p8 = torch.round(pvf / pscale[..., cj]).double()
        for rows in cattn.s8_rows(n, split, chunk, limit):
            for k, (lo, hi) in enumerate(rows):
                m, l, acc = parts[k]
                for c in range(lo // chunk, (hi - 1) // chunk + 1):
                    if hi <= lo:
                        break
                    a, z = max(lo, c * chunk), min(hi, (c + 1) * chunk)
                    ci = torch.einsum("kgj,kjh->kgh", p8[..., a:z],
                                      vc[i, :, a:z].double()).float()
                    lc = p[..., a:z].sum(-1)
                    alpha = torch.exp(m - m_run[..., c])
                    l = l * alpha + lc
                    acc = acc * alpha[..., None] + ci * pscale[..., c, None]
                    m = m_run[..., c]
                parts[k] = (m, l, acc)
        ranks = [_merge(parts[r * warps:(r + 1) * warps])
                 for r in range(split)]
        mm, ll, aa = _merge(ranks)
        sf = torch.einsum("kgh,kh->kg", qf[i], fk[i].float()) * sm_scale
        mf = torch.maximum(mm, sf)
        c0, pf = torch.exp(mm - mf), torch.exp(sf - mf)
        out[i] = ((aa * c0[..., None] + pf[..., None] * fv[i].float()[:, None])
                  / (ll * c0 + pf)[..., None])
    return out.reshape(b, 1, nq, h).to(q.dtype)


def _assert_close_rms(out, ref, tol):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    bad = (out - ref).abs() > tol["atol_rms"] * rms + tol["rtol"] * ref.abs()
    assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} beyond {tol}, "
                           f"worst {(out - ref).abs()[bad].max().item()}")


POSITIONS = [0, 1, 31, 1023, 1024, 1025, 2047, 2000]


def _cache(seed, b=8, nk=2, g=4, s=2048, h=64):
    gen = torch.Generator().manual_seed(seed)
    kc, ks = quantize_kv(torch.randn((b, nk, s, h), generator=gen))
    vc, vs = quantize_kv(torch.randn((b, nk, s, h), generator=gen))
    q = torch.randn((b, 1, nk * g, h), generator=gen).bfloat16()
    fk = torch.randn((b, nk, h), generator=gen).bfloat16()
    fv = torch.randn((b, nk, h), generator=gen).bfloat16()
    return q, kc, vc, ks, vs, fk, fv


@pytest.mark.parametrize("split", (1, 2, 4, 8))
@pytest.mark.parametrize("chunk", (64, 100, 1024))
def test_mirror_matches_the_plain_version_dense(chunk, split):
    """Every split at chunks of 64 (32 a slot), 100 (no multiple of a
    tile) and 1024 (the default), positions on both sides of the tile and
    chunk edges and of the 2048-row read bound."""
    q, kc, vc, ks, vs, fk, fv = _cache(100 + chunk + split)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    sm = 64 ** -0.5
    out = _mirror(q, kc, vc, ks, vs, pos, fk, fv, sm, chunk, split, 2048)
    ref = cattn.s8_attention_core(q, kc, vc, ks, vs, pos, fk, fv, sm, chunk)
    _assert_close_rms(out, ref, S8_TOL)


@pytest.mark.parametrize("split", (1, 2, 4, 8))
@pytest.mark.parametrize("page", (128, 512))
def test_mirror_matches_the_plain_version_paged(page, split):
    """Through a shuffled table of pages, the chunk a page: the mirror on
    the gathered rows (what the kernel reads) against the paged plain
    version."""
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    b, nk, g, h, s = 8, 2, 4, 64, 2048
    gen = torch.Generator().manual_seed(200 + page + split)
    npages = b * s // page + 1
    kp, kps = quantize_kv(torch.randn((npages, 1, nk, page, h),
                                      generator=gen))
    vp, vps = quantize_kv(torch.randn((npages, 1, nk, page, h),
                                      generator=gen))
    table = (torch.randperm(npages - 1, generator=gen) + 1).reshape(
        b, s // page).to(torch.int32)
    q = torch.randn((b, 1, nk * g, h), generator=gen).bfloat16()
    fk = torch.randn((b, nk, h), generator=gen).bfloat16()
    fv = torch.randn((b, nk, h), generator=gen).bfloat16()
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    kk, vv, ks, vs = gather_layer(kp, vp, table, kps, vps, 0, h)
    out = _mirror(q, kk, vv, ks, vs, pos, fk, fv, h ** -0.5, page, split, s)
    ref = cpaged.paged_decode_attention_s8_plain(
        q, kp, vp, table, pos, kps, vps, layer=0, fresh_k=fk, fresh_v=fv)
    _assert_close_rms(out, ref, S8_TOL)


def test_mirror_at_the_3b_heads():
    """Head_dim 128, group 3, at the default chunk and split 4."""
    q, kc, vc, ks, vs, fk, fv = _cache(300, nk=2, g=3, h=128)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    sm = 128 ** -0.5
    out = _mirror(q, kc, vc, ks, vs, pos, fk, fv, sm, 1024, 4, 2048)
    ref = cattn.s8_attention_core(q, kc, vc, ks, vs, pos, fk, fv, sm, 1024)
    _assert_close_rms(out, ref, S8_TOL)


@pytest.mark.parametrize("split", (1, 4))
@pytest.mark.parametrize("chunk", (64, 1024))
def test_mirror_at_a_long_read_bound(chunk, split):
    """An 8192-row read bound (the presets' max_seq), positions up to it:
    many groups of chunks a slot (at chunks of 64), and one chunk a group
    (at chunks of 1024)."""
    q, kc, vc, ks, vs, fk, fv = _cache(400 + chunk + split, b=4, nk=1,
                                       s=8192)
    pos = torch.tensor([8192, 5000, 4097, 1], dtype=torch.int32)
    sm = 64 ** -0.5
    out = _mirror(q, kc, vc, ks, vs, pos, fk, fv, sm, chunk, split, 8192)
    ref = cattn.s8_attention_core(q, kc, vc, ks, vs, pos, fk, fv, sm, chunk)
    _assert_close_rms(out, ref, S8_TOL)


def test_mirror_matches_the_jax_kernel_dense(monkeypatch):
    """Chunks of 64 over a 320-row cache, split 4: the mirror against the
    JAX s8 Pallas kernel (interpret mode)."""
    monkeypatch.setenv("GABBY_ATTN_CHUNK", "64")
    q, fk, fv, kc, vc, ks, vs = _dense_inputs(77, 1, b=4, g=3, s=320)
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    pos = np.asarray([0, 63, 64, 257], np.int32)
    ref = pattn.decode_attention(
        _jb(q), _j(kc), _j(vc), jnp.asarray(pos), _j(ks), _j(vs),
        layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    out = _mirror(_t(q, torch.bfloat16), kc[1], vc[1], ks[1], vs[1],
                  _t(pos), _t(fk, torch.bfloat16), _t(fv, torch.bfloat16),
                  64 ** -0.5, 64, 4, 320)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **JAX_S8_TOL)


def test_mirror_matches_the_jax_kernel_paged():
    """Pages of 16 behind a scattered table (stale entries at the scratch
    page), split 2: the mirror on the gathered rows against the JAX paged
    s8 Pallas kernel (interpret mode)."""
    q, fk, fv, kc, vc, ks, vs, _ = _pool_inputs(78, 1)
    q, fk, fv = (np.concatenate([x, x[::-1]]) for x in (q, fk, fv))
    fk, fv = fk[:, :, 0], fv[:, :, 0]
    table = np.asarray([[3, 0, 0, 0], [5, 1, 0, 0], [2, 8, 0, 0],
                        [6, 9, 4, 7]], np.int32)
    pos = np.asarray([0, 21, 32, 55], np.int32)
    ref = pattn.paged_decode_attention(
        _jb(q), _j(kc), _j(vc), jnp.asarray(table), jnp.asarray(pos), _j(ks),
        _j(vs), layer=jnp.int32(1), fresh_k=_jb(fk), fresh_v=_jb(fv))
    kk, vv, sk, sv = gather_layer(kc, vc, _t(table), ks, vs, 1, 64)
    out = _mirror(_t(q, torch.bfloat16), kk, vv, sk, sv, _t(pos),
                  _t(fk, torch.bfloat16), _t(fv, torch.bfloat16),
                  64 ** -0.5, 16, 2, 64)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **JAX_S8_TOL)
