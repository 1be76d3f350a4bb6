"""Times the flash-decode kernel (csrc/decode_attention.cuh) on the card in
every form it serves: over an int8 cache K3, the
slot-batched K16 and the paired K12, through the page table K10 and the
paired K17; over a bf16 cache the slot-batched K32, K24 and the paired K25,
through the page table K28 and the paired K29 (csrc/decode_attention.cu);
in the s8 form over an int8 cache K14, the paired K15, through the page
table K19 and the paired K20 (csrc/attention_s8.cu; the dense chunk is
min(attn_chunk(), S), the paged one a page); in the verify form (T = 8
positions a slot, speculate 7) K9, the paired K13, through the page table
K11 and the paired K18 over int8, K26, K27, K30 and K31 over bf16
(csrc/verify_attention.cu, csrc/paged_attention.cu; at the Llama-3.2-3B
heads K13 and K27 alone).

    python -m gabby_tpu_torch.tools.bench_decode_attention [--roots DIR ...]
        [--probe] [--splits] [--long]

At the heads of Llama-3.2-1B (32 q over 8 kv heads of 64 dims, 16 layers)
and Llama-3.2-3B (24 over 8 of 128, 28 layers), 8 slots of a 2048-row
cache, random caches and queries from a seed; the paired forms read the
same rows re-laid, the paged ones the same rows laid into a pool of 33
pages of 512 rows behind a shuffled table (the paged engine's pool), whose
read bound is the table's 2048 rows. One decode step's call set (a launch
a layer) of each form, at equal positions (1024 rows; the dense forms at
window 1025) and at spread ones (16 to 2000 rows, window 2048), eagerly
and replayed from a CUDA graph, beside SDPA on the dequantized rows (eager
and from a graph) and the bound (each live cache byte read once at 3.35
TB/s); with the largest difference from the plain version on two layers,
whether a repeat gives the same bits, and whether each form gives the bits
of its unpaired dense form (K16 and K12 those of K3, K24 those of K32, K25
those of K24, K17 those of K10, K29 those of K28, K15 those of K14, K20
those of K19; the verify forms at equal positions, the dense ones over
the whole cache so that they take the paged forms' plan: K13 and K11
those of K9, K18 those of K11, K27 and K30 those of K26, K31 those of K30;
beside SDPA with the causal fresh block), and a digest of each
single-position form's output bits, which two checkouts give alike where
their kernels give the same bits. `--roots` times the
kernels of each checkout given, in that order, each in a process of its
own, through the same public wrappers (an older commit unpacked with `git
archive` beside this one, so that two versions are compared in one run on
one card: old, new, new, old). `--probe` also builds
csrc/decode_attention.cu alone with DECODE_PROBE = 1 (the copies alone), 2
(no cross-block merge) and 3 (no programmatic dependent launch), and with
DECODE_SLOTS = 2 (two slots a block), and times K3's and K32's call sets
at equal positions through each build beside the whole kernel (each build
twice, in order and in reverse); and csrc/attention_s8.cu alone with
DECODE_PROBE = 4 (no exchange of chunk maxima between the ranks) and 5
(the first exchange alone), timing K14's and K19's call sets the same way;
and csrc/verify_attention.cu alone with VERIFY_PROBE = 1 (the copies
alone), 2 (no fresh block) and 3 (no cross-rank merge), timing K9's and
K26's call sets the same way.
Where the time goes, and what the design's choices are worth. `--long`
also times the s8 forms of each checkout at the Llama-3.2-1B heads over
8192-row caches (the presets' max_seq; the paged pool 16 pages of 512 a
slot), at 1024 and at 8192 live rows a slot, beside SDPA. `--splits` times every
form of this checkout
at every split (1, 2, 4, 8 blocks a cluster), microseconds a call replayed
from a graph, beside the split `decode_plan` (`verify_plan`) picks. The probe builds'
outputs are not the product. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import torch

from gabby_tpu_torch.tools.bench_stacked import _graph_ms, _time

MODELS = {"llama32_1b": (16, 32, 8, 64), "llama32_3b": (28, 24, 8, 128)}
SLOTS, ROWS, CTX, PAGE = 8, 2048, 1024, 512
SPREAD = [2000, 16, 1024, 300, 1700, 64, 1300, 700]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# form: (int8 cache, paired, paged, the form whose bits it must give)
FORMS = {"K3": (True, False, False, None), "K16": (True, False, False, "K3"),
         "K12": (True, True, False, "K3"), "K10": (True, False, True, None),
         "K17": (True, True, True, "K10"), "K32": (False, False, False, None),
         "K24": (False, False, False, "K32"),
         "K25": (False, True, False, "K24"),
         "K28": (False, False, True, None),
         "K29": (False, True, True, "K28"),
         "K14": (True, False, False, None), "K15": (True, True, False, "K14"),
         "K19": (True, False, True, None), "K20": (True, True, True, "K19")}
S8 = ("K14", "K15", "K19", "K20")  # the s8 form (csrc/attention_s8.cu)
# the verify form (csrc/verify_attention.cu, csrc/paged_attention.cu), as
# FORMS; at the Llama-3.2-3B heads only VERIFY_3B
VERIFY_FORMS = {"K9": (True, False, False, None),
                "K13": (True, True, False, "K9"),
                "K11": (True, False, True, "K9"),
                "K18": (True, True, True, "K11"),
                "K26": (False, False, False, None),
                "K27": (False, True, False, "K26"),
                "K30": (False, False, True, "K26"),
                "K31": (False, True, True, "K30")}
VERIFY_3B = ("K13", "K27")
VERIFY_T = 8  # speculate 7: a draft of 7 and the last accepted token


def _inputs(model: str, dev, gen, rows: int = ROWS) -> dict:
    """One model's caches of `rows` rows a slot (int8 with scales, and
    bf16) in the dense, paired and paged layouts, queries and fresh rows,
    and the position sets: at ROWS equal and spread positions, else 1024
    and `rows` live rows a slot, read bound `rows`."""
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv
    nl, nq, nk, h = MODELS[model]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    npages = SLOTS * rows // PAGE + 1
    table = (torch.randperm(npages - 1, generator=gen, device=dev) + 1
             ).reshape(SLOTS, rows // PAGE).to(torch.int32).contiguous()

    def paged(x):
        """[L, B, N, S, *] as a pool [P, L, N, page, *] behind `table`
        (page 0 the unused scratch page)."""
        pool = torch.zeros((npages, nl, x.shape[2], PAGE, *x.shape[4:]),
                           dtype=x.dtype, device=dev)
        split = x.reshape(nl, SLOTS, x.shape[2], rows // PAGE, PAGE,
                          *x.shape[4:])
        pool[table.long()] = split.permute(1, 3, 0, 2, 4,
                                           *range(5, split.dim()))
        return pool

    kc, ks = quantize_kv(rand(nl, SLOTS, nk, rows, h))
    vc, vs = quantize_kv(rand(nl, SLOTS, nk, rows, h))
    kb = rand(nl, SLOTS, nk, rows, h).bfloat16()
    vb = rand(nl, SLOTS, nk, rows, h).bfloat16()
    caches = {}
    for quant, k_, v_, ks_, vs_ in ((True, kc, vc, ks, vs),
                                    (False, kb, vb, None, None)):
        kp, vp = pair_heads(k_), pair_heads(v_)
        pks, pvs = (paged(ks_), paged(vs_)) if quant else (None, None)
        caches[quant] = {
            (False, False): (k_, v_, ks_, vs_),
            (True, False): (kp, vp, ks_, vs_),
            (False, True): (paged(k_), paged(v_), pks, pvs),
            (True, True): (paged(kp), paged(vp), pks, pvs)}
    return dict(
        nl=nl, nq=nq, nk=nk, h=h, caches=caches, table=table,
        q=rand(SLOTS, 1, nq, h).bfloat16(), fk=rand(SLOTS, nk, h).bfloat16(),
        fv=rand(SLOTS, nk, h).bfloat16(),
        rows=rows, pos={
            "equal": (torch.full((SLOTS,), CTX, dtype=torch.int32,
                                 device=dev), CTX + 1),
            "spread": (torch.tensor(SPREAD, dtype=torch.int32, device=dev),
                       rows)} if rows == ROWS else {
            f"{n} of {rows}": (torch.full((SLOTS,), n, dtype=torch.int32,
                                          device=dev), rows)
            for n in (CTX, rows)})


def _bound_ms(x: dict, pos, quant: bool, paged: bool) -> float:
    """Live cache rows (and scales) once, q, out and the fresh rows; paged,
    the table once."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    row = h + 4 if quant else 2 * h
    live = int(pos.sum())
    table = SLOTS * x["rows"] // PAGE * 4 if paged else 0
    return nl * (2 * nk * live * row + 2 * SLOTS * nq * h * 2
                 + 2 * SLOTS * nk * h * 2 + table) / HBM_BYTES_PER_S * 1e3


def _caller(x: dict, form: str, pos, window: int):
    """A call of `form` through the public wrappers on layer i, and its
    plain version."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    quant, pair, paged, _ = FORMS[form]
    k_, v_, ks_, vs_ = x["caches"][quant][(pair, paged)]
    kw = dict(fresh_k=x["fk"], fresh_v=x["fv"])
    if form in S8 and paged:
        def call(i):
            return cpaged.paged_decode_attention_s8(
                x["q"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)

        def plain(i):
            return cpaged.paged_decode_attention_s8_plain(
                x["q"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)
        return call, plain
    if form in S8:
        def call(i):
            return cattn.decode_attention_s8(x["q"], k_, v_, ks_, vs_, pos,
                                             layer=i, window=window, **kw)

        def plain(i):
            return cattn.decode_attention_s8_plain(x["q"], k_, v_, ks_, vs_,
                                                   pos, layer=i, **kw)
        return call, plain
    if paged:
        def call(i):
            return cpaged.paged_decode_attention(
                x["q"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)

        def plain(i):
            return cpaged.paged_decode_attention_plain(
                x["q"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)
        return call, plain
    fn = (cattn.decode_attention_multi if form in ("K16", "K32")
          else cattn.decode_attention)

    def call(i):
        return fn(x["q"], k_, v_, ks_, vs_, pos, layer=i, window=window,
                  **kw)

    def plain(i):
        return cattn.decode_attention_plain(x["q"], k_, v_, ks_, vs_, pos,
                                            layer=i, **kw)
    return call, plain


def _verify_block(x: dict, gen, dev) -> None:
    """The verify block of VERIFY_T positions a slot into x: q [B, T, Nq,
    H], fresh_k/v [B, Nk, T, H]."""
    nq, nk, h = x["nq"], x["nk"], x["h"]
    x["vq"] = torch.randn((SLOTS, VERIFY_T, nq, h), generator=gen,
                          device=dev).bfloat16()
    x["vfk"] = torch.randn((SLOTS, nk, VERIFY_T, h), generator=gen,
                           device=dev).bfloat16()
    x["vfv"] = torch.randn((SLOTS, nk, VERIFY_T, h), generator=gen,
                           device=dev).bfloat16()


def _verify_caller(x: dict, form: str, pos):
    """A call of the verify `form` through the public wrappers on layer i,
    and its plain version; the dense forms read the whole cache (window
    None), so that their plan is the paged forms'."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    quant, pair, paged, _ = VERIFY_FORMS[form]
    k_, v_, ks_, vs_ = x["caches"][quant][(pair, paged)]
    kw = dict(fresh_k=x["vfk"], fresh_v=x["vfv"])
    if paged:
        def call(i):
            return cpaged.paged_verify_attention(
                x["vq"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)

        def plain(i):
            return cpaged.paged_verify_attention_plain(
                x["vq"], k_, v_, x["table"], pos, ks_, vs_, layer=i, **kw)
        return call, plain

    def call(i):
        return cattn.verify_attention(x["vq"], k_, v_, ks_, vs_, pos,
                                      layer=i, **kw)

    def plain(i):
        return cattn.verify_attention_plain(x["vq"], k_, v_, ks_, vs_, pos,
                                            layer=i, **kw)
    return call, plain


def _verify_bound_ms(x: dict, pos, quant: bool, paged: bool) -> float:
    """Live cache rows (and scales) once, q, out and the fresh rows; paged,
    the table once."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    row = h + 4 if quant else 2 * h
    live = int(pos.sum())
    table = SLOTS * x["rows"] // PAGE * 4 if paged else 0
    return nl * (2 * nk * live * row + 2 * SLOTS * VERIFY_T * nq * h * 2
                 + 2 * SLOTS * nk * VERIFY_T * h * 2
                 + table) / HBM_BYTES_PER_S * 1e3


def _time_verify(x: dict, model: str, dev) -> dict:
    """The verify forms at equal positions (1024 live rows a slot), a
    macro-step's call set each, and SDPA on the dequantized rows with the
    fresh block and its causal mask."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    pos, _ = x["pos"]["equal"]
    row, outs = {}, {}
    for form, (quant, _, paged, same) in VERIFY_FORMS.items():
        if model != "llama32_1b" and form not in VERIFY_3B:
            continue
        call, plain = _verify_caller(x, form, pos)
        err = max((call(i).float() - plain(i).float()).abs().max().item()
                  for i in range(2))
        outs[form] = [call(i) for i in range(nl)]
        row[form] = dict(
            max_abs_err=err,
            repeat_equal=all(torch.equal(o, call(i))
                             for i, o in enumerate(outs[form])),
            digest=sum(int(o.view(torch.int16).to(torch.int64).sum())
                       for o in outs[form]),
            graph_ms=_graph_ms(lambda: [call(i) for i in range(nl)]),
            eager_ms=_time(lambda: [call(i) for i in range(nl)], 10),
            bound_ms=_verify_bound_ms(x, pos, quant, paged))
        if same is not None and same in outs:
            row[form][f"equals_{same}"] = all(
                torch.equal(o, s) for o, s in zip(outs[form], outs[same]))
    del outs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    top = int(pos.max())
    past = (torch.arange(top, device=dev)[None, None, :]
            < pos[:, None, None]).expand(SLOTS, VERIFY_T, top)
    causal = (torch.arange(VERIFY_T, device=dev)[None, :]
              <= torch.arange(VERIFY_T, device=dev)[:, None]).expand(
                  SLOTS, VERIFY_T, VERIFY_T)
    mask = torch.cat([past, causal], dim=2)[:, None]
    qt = x["vq"].transpose(1, 2)
    for quant, label in ((True, "int8"), (False, "bf16")):
        k_, v_, ks_, vs_ = x["caches"][quant][(False, False)]
        kd, vd = [], []
        for i in range(nl):
            kk, vv = k_[i, :, :, :top], v_[i, :, :, :top]
            if quant:
                kk = (kk.float() * ks_[i, :, :, :top, None]).bfloat16()
                vv = (vv.float() * vs_[i, :, :, :top, None]).bfloat16()
            kd.append(torch.cat([kk, x["vfk"]], dim=2))
            vd.append(torch.cat([vv, x["vfv"]], dim=2))

        def lib(kd=kd, vd=vd):
            return [sdpa(qt, kd[i], vd[i], attn_mask=mask, enable_gqa=True)
                    for i in range(nl)]

        row[f"library_{label}"] = dict(graph_ms=_graph_ms(lib),
                                       eager_ms=_time(lib, 10))
        del kd, vd
    return row


def _digest(outs) -> str:
    """A hash of a call set's output bits: the inputs come from a seed, so
    two checkouts whose kernels give the same bits print the same one."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time_this_tree(rows: int = ROWS) -> dict:
    """Every form of the gabby_tpu_torch on sys.path, and the library call,
    at every model and position set; at another cache length than ROWS,
    the s8 forms at the Llama-3.2-1B heads alone."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for model in MODELS if rows == ROWS else ["llama32_1b"]:
        x = _inputs(model, dev, gen, rows)
        nl = x["nl"]
        for label, (pos, window) in x["pos"].items():
            row, outs = {}, {}
            for form, (quant, _, paged, same) in FORMS.items():
                if rows != ROWS and form not in S8:
                    continue
                call, plain = _caller(x, form, pos, window)
                err = max((call(i).float() - plain(i).float()).abs().max()
                          .item() for i in range(2))
                outs[form] = [call(i) for i in range(nl)]
                row[form] = dict(
                    max_abs_err=err,
                    repeat_equal=all(torch.equal(o, call(i))
                                     for i, o in enumerate(outs[form])),
                    digest=_digest(outs[form]),
                    graph_ms=_graph_ms(lambda: [call(i) for i in range(nl)]),
                    eager_ms=_time(lambda: [call(i) for i in range(nl)], 10),
                    bound_ms=_bound_ms(x, pos, quant, paged))
                if same is not None:
                    row[form][f"equals_{same}"] = all(
                        torch.equal(o, s)
                        for o, s in zip(outs[form], outs[same]))
            del outs
            # the library call: SDPA on the rows below the longest slot,
            # dequantized, with the fresh row and a mask
            top = int(pos.max())
            mask = torch.cat([torch.arange(top, device=dev)[None, :]
                              < pos[:, None],
                              torch.ones((SLOTS, 1), dtype=torch.bool,
                                         device=dev)], dim=1)[:, None, None]
            qt = x["q"].transpose(1, 2)
            for quant, form in ((True, "int8"), (False, "bf16")):
                k_, v_, ks_, vs_ = x["caches"][quant][(False, False)]
                kd, vd = [], []
                for i in range(nl):
                    kk, vv = k_[i, :, :, :top], v_[i, :, :, :top]
                    if quant:
                        kk = (kk.float() * ks_[i, :, :, :top, None]).bfloat16()
                        vv = (vv.float() * vs_[i, :, :, :top, None]).bfloat16()
                    kd.append(torch.cat([kk, x["fk"][:, :, None]], dim=2))
                    vd.append(torch.cat([vv, x["fv"][:, :, None]], dim=2))

                def lib(kd=kd, vd=vd):
                    return [sdpa(qt, kd[i], vd[i], attn_mask=mask,
                                 enable_gqa=True) for i in range(nl)]

                row[f"library_{form}"] = dict(graph_ms=_graph_ms(lib),
                                              eager_ms=_time(lib, 10))
                del kd, vd
            out[f"{model} {label}"] = row
        if rows == ROWS:
            _verify_block(x, gen, dev)
            out[f"{model} verify T={VERIFY_T} equal"] = _time_verify(
                x, model, dev)
        del x
        torch.cuda.empty_cache()
    return out


ENTRIES = ("gabby_decode_attention", "gabby_decode_attention_bf16",
           "gabby_paged_decode_attention",
           "gabby_paged_decode_attention_bf16", "gabby_attention_s8")
VERIFY_ENTRIES = ("gabby_verify_attention", "gabby_verify_attention_bf16",
                  "gabby_paged_attention", "gabby_paged_attention_bf16")


def _declare(lib, names=ENTRIES):
    """The entries `names` of the kernel in `lib`, typed."""
    from gabby_tpu_torch.ops.cuda import build
    for name in names:
        getattr(lib, name).argtypes = build._SIGNATURES[name]
    return {name: getattr(lib, name) for name in names}


def _s8_chunk(paged: bool) -> int:
    from gabby_tpu_torch.ops import cuda as ck
    return PAGE if paged else min(ck.attn_chunk(), ROWS)


def _launcher(entries: dict, x: dict, form: str, pos, window: int, plan):
    """The call set of one decode step of `form` through its C entry at an
    explicit launch plan (sb, split, tile)."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    quant, pair, paged, _ = FORMS[form]
    k_, v_, ks_, vs_ = x["caches"][quant][(pair, paged)]
    o = torch.empty_like(x["q"])
    fresh = (x["fk"].data_ptr(), x["fv"].data_ptr(), pos.data_ptr(),
             o.data_ptr())
    lay = 0 if paged else k_[0].numel() * k_.element_size()
    slay = 0 if paged or not quant else ks_[0].numel() * 4
    entry = entries["gabby_attention_s8" if form in S8 else
                    "gabby_" + ("paged_" if paged else "")
                    + "decode_attention" + ("" if quant else "_bf16")]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(nl):
            rows = (k_.data_ptr() + i * lay, v_.data_ptr() + i * lay)
            if quant:
                rows += (ks_.data_ptr() + i * slay,
                         vs_.data_ptr() + i * slay)
            if form in S8:
                table = x["table"].data_ptr() if paged else None
                shape = ((nl, i, PAGE, ROWS // PAGE, h, ROWS) if paged
                         else (1, 0, ROWS, 1, h, window))
                args = (*rows, table, *fresh, SLOTS, nq, nk, *shape,
                        _s8_chunk(paged), int(pair))
            elif paged:
                args = (*rows, x["table"].data_ptr(), *fresh, SLOTS, nq, nk,
                        nl, i, PAGE, ROWS // PAGE, h, int(pair))
            else:
                args = (*rows, *fresh, SLOTS, nq, nk, ROWS, h, window,
                        int(pair))
            err = entry(x["q"].data_ptr(), *args, *plan, h ** -0.5, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at plan {plan}")
    return call


def _verify_launcher(entries: dict, x: dict, form: str, pos, plan):
    """A macro-step's call set of the verify `form` through its C entry at
    an explicit launch plan (split, tile, nt)."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    quant, pair, paged, _ = VERIFY_FORMS[form]
    k_, v_, ks_, vs_ = x["caches"][quant][(pair, paged)]
    o = torch.empty_like(x["vq"])
    fresh = (x["vfk"].data_ptr(), x["vfv"].data_ptr(), pos.data_ptr(),
             o.data_ptr())
    lay = 0 if paged else k_[0].numel() * k_.element_size()
    slay = 0 if paged or not quant else ks_[0].numel() * 4
    entry = entries["gabby_" + ("paged_attention" if paged
                                else "verify_attention")
                    + ("" if quant else "_bf16")]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(nl):
            rows = (k_.data_ptr() + i * lay, v_.data_ptr() + i * lay)
            if quant:
                rows += (ks_.data_ptr() + i * slay,
                         vs_.data_ptr() + i * slay)
            if paged:
                args = (*rows, x["table"].data_ptr(), *fresh, SLOTS,
                        VERIFY_T, nq, nk, nl, i, PAGE, ROWS // PAGE, h,
                        int(pair))
            else:
                args = (*rows, *fresh, SLOTS, VERIFY_T, nq, nk, ROWS, h,
                        ROWS, int(pair))
            err = entry(x["vq"].data_ptr(), *args, *plan, h ** -0.5, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at plan {plan}")
    return call


def _verify_plan(x: dict, form: str, sms: int) -> tuple:
    from gabby_tpu_torch.ops.cuda import attention as cattn
    quant, _, paged, _ = VERIFY_FORMS[form]
    return cattn.verify_plan(SLOTS, x["nk"], x["h"], x["nq"] // x["nk"],
                             VERIFY_T, ROWS, sms, quant=quant,
                             page=PAGE if paged else None)[:3]


def _plan(x: dict, form: str, window: int, sms: int) -> tuple:
    from gabby_tpu_torch.ops.cuda import attention as cattn
    quant, _, paged, _ = FORMS[form]
    limit, page = (ROWS, PAGE) if paged else (window, None)
    if form in S8:
        return cattn.s8_plan(SLOTS, x["nk"], x["h"], x["nq"] // x["nk"],
                             limit, sms, _s8_chunk(paged), page=page)
    return cattn.decode_plan(SLOTS, x["nk"], x["h"], x["nq"] // x["nk"],
                             limit, sms, quant=quant, page=page)


# the probe builds: (source, label, flags, the forms timed through it)
PROBES = [
    ("decode_attention.cu", "whole kernel", [], ("K3", "K32")),
    ("decode_attention.cu", "copies alone", ["-DDECODE_PROBE=1"],
     ("K3", "K32")),
    ("decode_attention.cu", "no cross-block merge", ["-DDECODE_PROBE=2"],
     ("K3", "K32")),
    ("decode_attention.cu", "without programmatic dependent launch",
     ["-DDECODE_PROBE=3"], ("K3", "K32")),
    ("decode_attention.cu", "two slots a block", ["-DDECODE_SLOTS=2"],
     ("K3", "K32")),
    ("attention_s8.cu", "s8 whole kernel", [], ("K14", "K19")),
    ("attention_s8.cu", "s8 without the exchanges", ["-DDECODE_PROBE=4"],
     ("K14", "K19")),
    ("attention_s8.cu", "s8 with the first exchange alone",
     ["-DDECODE_PROBE=5"], ("K14", "K19")),
    ("verify_attention.cu", "verify whole kernel", [], ("K9", "K26")),
    ("verify_attention.cu", "verify copies alone", ["-DVERIFY_PROBE=1"],
     ("K9", "K26")),
    ("verify_attention.cu", "verify without the fresh block",
     ["-DVERIFY_PROBE=2"], ("K9", "K26")),
    ("verify_attention.cu", "verify without the cross-rank merge",
     ["-DVERIFY_PROBE=3"], ("K9", "K26")),
]


def _probe() -> dict:
    """K3's and K32's call sets at equal positions through builds of
    csrc/decode_attention.cu alone (the whole kernel, the copies alone, no
    cross-block merge, no programmatic dependent launch, two slots a
    block), K14's and K19's through builds of csrc/attention_s8.cu alone
    (the whole kernel, no exchange of chunk maxima, the first exchange
    alone)."""
    from gabby_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = [os.path.join(tmp, f"probe{i}.so") for i in range(len(PROBES))]
        procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags,
                                   "-shared", "-o", lib,
                                   os.path.join(build.CSRC, src)])
                 for (src, _, flags, _), lib in zip(PROBES, libs)]
        if any(p.wait() for p in procs):
            raise RuntimeError("a probe build failed")
        cdlls = [ctypes.CDLL(lib) for lib in libs]
        entries = [_declare(cdll, VERIFY_ENTRIES[:2]
                            if src == "verify_attention.cu" else [
            name for name in ENTRIES if (name == "gabby_attention_s8")
            == (src == "attention_s8.cu")])
            for (src, _, _, _), cdll in zip(PROBES, cdlls)]
        order = list(range(len(PROBES)))
        for model in MODELS:
            x = _inputs(model, dev, gen)
            _verify_block(x, gen, dev)
            pos, window = x["pos"]["equal"]
            # each build twice, in order and in reverse: a build's place in
            # the sequence moves its time by up to a tenth
            for k in order + order[::-1]:
                _, label, _, forms = PROBES[k]
                for form in forms:
                    if form in VERIFY_FORMS:
                        res.setdefault(f"{model} {form}, {label}",
                                       []).append(_graph_ms(
                                           _verify_launcher(
                                               entries[k], x, form, pos,
                                               _verify_plan(x, form, sms))))
                        continue
                    plan = list(_plan(x, form, window, sms))
                    if label == "two slots a block":
                        plan[0] = 2
                    res.setdefault(f"{model} {form}, {label}", []).append(
                        _graph_ms(_launcher(entries[k], x, form, pos,
                                            window, plan)))
            del x
            torch.cuda.empty_cache()
    return res


def _splits() -> dict:
    """Every form at every split, both models and position sets:
    {case: {"us_a_call": {split: us}, "plan": split}}."""
    from gabby_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    entries = _declare(build.library())
    ventries = _declare(build.library(), VERIFY_ENTRIES)
    res = {}
    for model in MODELS:
        x = _inputs(model, dev, gen)
        for label, (pos, window) in x["pos"].items():
            for form in FORMS:
                if form in ("K16", "K24"):  # K3's and K32's launches
                    continue
                sb, split, tile = _plan(x, form, window, sms)
                res[f"{model} {label} {form}"] = {
                    "us_a_call": {s: _graph_ms(_launcher(
                        entries, x, form, pos, window, (sb, s, tile)))
                        / x["nl"] * 1e3 for s in (1, 2, 4, 8)},
                    "plan": split}
        _verify_block(x, gen, dev)
        pos, _ = x["pos"]["equal"]
        for form in VERIFY_FORMS:
            if model != "llama32_1b" and form not in VERIFY_3B:
                continue
            split, tile, nt = _verify_plan(x, form, sms)
            res[f"{model} verify equal {form}"] = {
                "us_a_call": {s: _graph_ms(_verify_launcher(
                    ventries, x, form, pos, (s, tile, nt)))
                    / x["nl"] * 1e3 for s in (1, 2, 4, 8)},
                "plan": split}
        del x
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gabby_tpu_torch.tools.bench_decode_attention")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose decode kernels to time, in order "
                   "(default: this one)")
    p.add_argument("--probe", action="store_true",
                   help="also time the DECODE_PROBE builds of this checkout")
    p.add_argument("--splits", action="store_true",
                   help="also time every form of this checkout at every "
                   "split")
    p.add_argument("--long", action="store_true",
                   help="also time the s8 forms of each checkout over "
                   "8192-row caches")
    p.add_argument("--single", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one tree at one cache length, in a process of its own
        print(json.dumps(_time_this_tree(args.single)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    runs = []
    for root in args.roots or [here]:
        root = os.path.abspath(root)
        run = {"root": root}
        for rows in [ROWS] + ([8192] if args.long else []):
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--single",
                 str(rows)], env={**os.environ, "PYTHONPATH": root},
                cwd=root, check=True, capture_output=True, text=True)
            run.update(json.loads(done.stdout.strip().splitlines()[-1]))
        runs.append(run)
    result = {"card": card, "runs": runs}
    if args.probe:
        result["probe_graph_ms"] = _probe()
    if args.splits:
        result["splits"] = _splits()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
