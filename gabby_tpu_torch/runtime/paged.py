"""Paged KV cache: fixed-size pages + per-slot page tables (counterpart of
gabby_tpu/runtime/paged.py).

The dense cache (kv_cache.py) reserves max_seq rows per slot; paging hands
out `page_size`-row pages on demand from a shared pool, so capacity
follows the TOKENS IN USE, not slots x max_seq: more concurrent slots fit
in the same device memory when sequences are short.

The pool is page-major, [P, L, Nk, page, H] (int8 codes when quantized,
with scale pools [P, L, Nk, page] f32): each (page, layer, kv head) plane
[page, H] is contiguous, the unit the paged attention kernels stream. The
paired layout (`create_paged_cache(paired=True)`) is the dense cache's:
pools [P, L, Nk/2, page, 2H], scale pools still per head. The kernels read
`page_table` [B, max_pages] int32 themselves, so nothing gathers the pool
on the decode path. Chunked prefill (per admission, not
per step) does gather the slot's earlier pages into a dense view and runs
the dense prefill kernel over it; a burst's batched chunk gathers every
slot's (`llama.prefill_hidden`) and writes its masked lanes' pages
(`write_batch_chunk`).

The allocator lives on the host, in the engine. The device only sees the
pools and the table. Like the dense cache, the pools are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gabby_tpu_torch import resolve_device
from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.runtime.kv_cache import kv_shape, lane_indices

PAGE_SIZE = 512  # rows per page (the reference's default)


@dataclasses.dataclass
class PagedKVCache:
    """k, v: [P, L, Nk, page, H] pools; k_scale, v_scale: [P, L, Nk, page]
    f32 when quantized, else None; page_table: [B, max_pages] int32, the
    physical page of each slot's logical page (the engine keeps entries
    past a slot's allocation at 0, the scratch page)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_seq(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def nbytes(self) -> int:
        tensors = [self.k, self.v, self.page_table]
        if self.quantized:
            tensors += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in tensors)


def create_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       num_pages: int, dtype=torch.bfloat16,
                       quantized: bool = False, page_size: int = PAGE_SIZE,
                       paired: bool = False, device=None) -> PagedKVCache:
    """A zeroed pool of `num_pages` pages and a zeroed table on `device`
    (CUDA unless the caller asks for the CPU). paired=True: pools
    [P, L, Nk/2, page, 2H], scale pools still [P, L, Nk, page]."""
    if max_seq % page_size:
        raise ValueError(f"max_seq={max_seq} must be a multiple of "
                         f"page_size={page_size}")
    dev = resolve_device(device)
    heads, lanes = kv_shape(cfg, paired)
    shape = (num_pages, cfg.num_layers, heads, page_size, lanes)
    sshape = (num_pages, cfg.num_layers, cfg.num_kv_heads, page_size)
    table = torch.zeros((batch, max_seq // page_size), dtype=torch.int32,
                        device=dev)
    if quantized:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            page_table=table)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev),
                        k_scale=None, v_scale=None, page_table=table)


def paged_cache_from_numpy(k, v, k_scale, v_scale, page_table,
                           device=None) -> PagedKVCache:
    """Carry a paged cache across from numpy arrays (pools, scale pools or
    None, page table), keeping their types and their layout (paired or
    not)."""
    dev = resolve_device(device)

    def leaf(a):
        return (None if a is None
                else torch.from_numpy(np.array(a)).to(dev))

    return PagedKVCache(k=leaf(k), v=leaf(v), k_scale=leaf(k_scale),
                        v_scale=leaf(v_scale),
                        page_table=leaf(page_table).to(torch.int32))


class PageAllocator:
    """Host-side page bookkeeping: a free list and per-page refcounts.
    Deterministic: free pages are handed out in sorted order."""

    def __init__(self, num_pages: int):
        self.free: list[int] = list(range(num_pages - 1, -1, -1))
        self.refs = [0] * num_pages

    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """n fresh pages (refcount 1 each), or None if the pool is short."""
        if n > len(self.free):
            return None
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def share(self, pages: list[int]) -> list[int]:
        """Bump the refcounts of pages adopted by another slot."""
        for p in pages:
            if self.refs[p] <= 0:
                raise ValueError(f"sharing dead page {p}")
            self.refs[p] += 1
        return list(pages)

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if self.refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self.free.append(p)
        self.free.sort(reverse=True)  # deterministic reuse order


# ---- device ops -----------------------------------------------------------


def gather_slot_rows(cache: PagedKVCache, slot: int, rows: int,
                     layer: Optional[int] = None):
    """Contiguous [L, Nk, rows, H] (+ scales [L, Nk, rows]) view of one
    slot's first `rows` cache rows (a multiple of page_size), or of one
    layer of them ([Nk, rows, H]) when `layer` is given. Used by chunked
    prefill: a per-admission gather, never per step."""
    ps = cache.page_size
    if rows % ps:
        raise ValueError(f"rows={rows} is not a multiple of the page size "
                         f"{ps}")
    n = rows // ps
    phys = cache.page_table[slot, :n].long()

    def take(pool):
        if layer is not None:
            g = pool[phys, layer].movedim(0, 1)  # [Nk, n, page, ...]
            return g.reshape(g.shape[0], n * ps, *g.shape[3:])
        g = pool[phys].movedim(0, 2)  # [L, Nk, n, page, ...]
        return g.reshape(g.shape[0], g.shape[1], n * ps, *g.shape[4:])

    if cache.quantized:
        return (take(cache.k), take(cache.v), take(cache.k_scale),
                take(cache.v_scale))
    return take(cache.k), take(cache.v), None, None


def write_slot_chunk(cache: PagedKVCache, slot: int, offset: int, k_new,
                     v_new, ks_new, vs_new, *, layer: int) -> PagedKVCache:
    """Write one layer's [Nk, T, H] chunk (+ scales [Nk, T]) of one slot
    at row `offset`, in place (offset and T page-aligned): one page-granular
    write per pool through the slot's table row."""
    ps = cache.page_size
    t = k_new.shape[1]
    if offset % ps or t % ps:
        raise ValueError(f"chunk [{offset}, {offset + t}) is not aligned to "
                         f"the page size {ps}")
    n = t // ps
    phys = cache.page_table[slot, offset // ps:offset // ps + n].long()

    def put(pool, new):
        # [Nk, n * page, ...] -> [n, Nk, page, ...]
        pool[phys, layer] = new.reshape(new.shape[0], n, ps,
                                        *new.shape[2:]).movedim(1, 0)

    put(cache.k, k_new.to(cache.k.dtype))
    put(cache.v, v_new.to(cache.v.dtype))
    if cache.quantized:
        put(cache.k_scale, ks_new)
        put(cache.v_scale, vs_new)
    return cache


def write_batch_chunk(cache: PagedKVCache, offset: int, k_new, v_new,
                      ks_new, vs_new, lane_mask: Optional[torch.Tensor], *,
                      layer: int) -> PagedKVCache:
    """Lane-masked batched chunk write (burst admissions): one layer's
    [B, Nk, T, H] chunk rows (+ scales [B, Nk, T]) of every slot at row
    `offset` (offset and T page-aligned), in place, page by page through
    the table. Only the lanes in `lane_mask` (None: all) are written; the
    others' pages, live slots' among them, are not touched. The reference
    routes masked-out lanes to the scratch page instead; the port writes in
    place and skips them."""
    ps = cache.page_size
    t = k_new.shape[2]
    if offset % ps or t % ps:
        raise ValueError(f"chunk [{offset}, {offset + t}) is not aligned to "
                         f"the page size {ps}")
    n = t // ps
    lanes = lane_indices(lane_mask, k_new.shape[0], k_new.device)
    phys = cache.page_table[lanes, offset // ps:offset // ps + n].long()

    def put(pool, new):
        new = new[lanes]  # [b', Nk, n * page, ...] -> [b', n, Nk, page, ...]
        pool[phys, layer] = new.reshape(new.shape[0], new.shape[1], n, ps,
                                        *new.shape[3:]).movedim(2, 1)

    put(cache.k, k_new.to(cache.k.dtype))
    put(cache.v, v_new.to(cache.v.dtype))
    if cache.quantized:
        put(cache.k_scale, ks_new)
        put(cache.v_scale, vs_new)
    return cache


def write_rows(cache: PagedKVCache, positions: torch.Tensor, k_new, v_new,
               ks_new, vs_new, *, layer: int) -> PagedKVCache:
    """Write one layer's rows k/v_new [B, T, Nk, H] (+ scales [B, T, Nk]) at
    cache rows positions [B, T] of each slot, in place, row by row through
    the page table (a block may straddle a page boundary). A row at
    position >= max_seq goes to the scratch page (physical page 0, never
    read), not to the slot's last page."""
    ps = cache.page_size
    b = positions.shape[0]
    pos = positions.long()
    lanes = torch.arange(b, device=pos.device)[:, None]
    logical = torch.clamp(pos // ps, max=cache.page_table.shape[1] - 1)
    phys = torch.where(pos < cache.max_seq,
                       cache.page_table[lanes, logical].long(),
                       torch.zeros_like(pos))
    row = pos % ps
    cache.k[phys, layer, :, row] = k_new.to(cache.k.dtype)
    cache.v[phys, layer, :, row] = v_new.to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[phys, layer, :, row] = ks_new
        cache.v_scale[phys, layer, :, row] = vs_new
    return cache
