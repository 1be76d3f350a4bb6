"""Times the single-position flash-decode kernel (csrc/decode_attention.cu)
on the card in every form it serves: over an int8 cache K3, the
slot-batched K16 and the paired K12, through the page table K10 and the
paired K17; over a bf16 cache the slot-batched K32, K24 and the paired K25,
through the page table K28 and the paired K29.

    python -m gabby_tpu_torch.tools.bench_decode_attention [--roots DIR ...]
        [--probe] [--splits]

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
those of K24, K17 those of K10, K29 those of K28). `--roots` times the
kernels of each checkout given, in that order, each in a process of its
own, through the same public wrappers (an older commit unpacked with `git
archive` beside this one, so that two versions are compared in one run on
one card: old, new, new, old). `--probe` also builds
csrc/decode_attention.cu alone with DECODE_PROBE = 1 (the copies alone), 2
(no cross-block merge) and 3 (no programmatic dependent launch), and with
DECODE_SLOTS = 2 (two slots a block), and times K3's and K32's call sets
at equal positions through each build beside the whole kernel (each build
twice, in order and in reverse): where the time goes, and what two of the
design's choices are worth. `--splits` times every form of this checkout
at every split (1, 2, 4, 8 blocks a cluster), microseconds a call replayed
from a graph, beside the split `decode_plan` picks. The probe builds'
outputs are not the product. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
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
         "K29": (False, True, True, "K28")}


def _inputs(model: str, dev, gen) -> dict:
    """One model's caches (int8 with scales, and bf16) in the dense, paired
    and paged layouts, queries and fresh rows, and both position sets."""
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv
    nl, nq, nk, h = MODELS[model]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    npages = SLOTS * ROWS // PAGE + 1
    table = (torch.randperm(npages - 1, generator=gen, device=dev) + 1
             ).reshape(SLOTS, ROWS // PAGE).to(torch.int32).contiguous()

    def paged(x):
        """[L, B, N, S, *] as a pool [P, L, N, page, *] behind `table`
        (page 0 the unused scratch page)."""
        pool = torch.zeros((npages, nl, x.shape[2], PAGE, *x.shape[4:]),
                           dtype=x.dtype, device=dev)
        split = x.reshape(nl, SLOTS, x.shape[2], ROWS // PAGE, PAGE,
                          *x.shape[4:])
        pool[table.long()] = split.permute(1, 3, 0, 2, 4,
                                           *range(5, split.dim()))
        return pool

    kc, ks = quantize_kv(rand(nl, SLOTS, nk, ROWS, h))
    vc, vs = quantize_kv(rand(nl, SLOTS, nk, ROWS, h))
    kb = rand(nl, SLOTS, nk, ROWS, h).bfloat16()
    vb = rand(nl, SLOTS, nk, ROWS, h).bfloat16()
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
        pos={"equal": (torch.full((SLOTS,), CTX, dtype=torch.int32,
                                  device=dev), CTX + 1),
             "spread": (torch.tensor(SPREAD, dtype=torch.int32, device=dev),
                        ROWS)})


def _bound_ms(x: dict, pos, quant: bool, paged: bool) -> float:
    """Live cache rows (and scales) once, q, out and the fresh rows; paged,
    the table once."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    row = h + 4 if quant else 2 * h
    live = int(pos.sum())
    table = SLOTS * ROWS // PAGE * 4 if paged else 0
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


def _time_this_tree() -> dict:
    """Every form of the gabby_tpu_torch on sys.path, and the library call,
    at every model and position set."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for model in MODELS:
        x = _inputs(model, dev, gen)
        nl = x["nl"]
        for label, (pos, window) in x["pos"].items():
            row, outs = {}, {}
            for form, (quant, _, paged, same) in FORMS.items():
                call, plain = _caller(x, form, pos, window)
                err = max((call(i).float() - plain(i).float()).abs().max()
                          .item() for i in range(2))
                outs[form] = [call(i) for i in range(nl)]
                row[form] = dict(
                    max_abs_err=err,
                    repeat_equal=all(torch.equal(o, call(i))
                                     for i, o in enumerate(outs[form])),
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
        del x
        torch.cuda.empty_cache()
    return out


def _declare(lib):
    """The four entries of csrc/decode_attention.cu in `lib`, typed."""
    from gabby_tpu_torch.ops.cuda import build
    names = ("gabby_decode_attention", "gabby_decode_attention_bf16",
             "gabby_paged_decode_attention",
             "gabby_paged_decode_attention_bf16")
    for name in names:
        getattr(lib, name).argtypes = build._SIGNATURES[name]
    return {name: getattr(lib, name) for name in names}


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
    entry = entries["gabby_" + ("paged_" if paged else "")
                    + "decode_attention" + ("" if quant else "_bf16")]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(nl):
            rows = (k_.data_ptr() + i * lay, v_.data_ptr() + i * lay)
            if quant:
                rows += (ks_.data_ptr() + i * slay,
                         vs_.data_ptr() + i * slay)
            if paged:
                args = (*rows, x["table"].data_ptr(), *fresh, SLOTS, nq, nk,
                        nl, i, PAGE, ROWS // PAGE, h, int(pair))
            else:
                args = (*rows, *fresh, SLOTS, nq, nk, ROWS, h, window,
                        int(pair))
            err = entry(x["q"].data_ptr(), *args, *plan, h ** -0.5, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at plan {plan}")
    return call


def _plan(x: dict, form: str, window: int, sms: int) -> tuple:
    from gabby_tpu_torch.ops.cuda import attention as cattn
    quant, _, paged, _ = FORMS[form]
    return cattn.decode_plan(SLOTS, x["nk"], x["h"], x["nq"] // x["nk"],
                             ROWS if paged else window, sms, quant=quant,
                             page=PAGE if paged else None)


def _probe() -> dict:
    """K3's and K32's call sets at equal positions through builds of
    csrc/decode_attention.cu alone: the whole kernel, the copies alone, no
    cross-block merge, two slots a block."""
    from gabby_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = os.path.join(build.CSRC, "decode_attention.cu")
    builds = {"whole kernel": [], "copies alone": ["-DDECODE_PROBE=1"],
              "no cross-block merge": ["-DDECODE_PROBE=2"],
              "without programmatic dependent launch": ["-DDECODE_PROBE=3"],
              "two slots a block": ["-DDECODE_SLOTS=2"]}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {label: os.path.join(tmp, f"probe{i}.so")
                for i, label in enumerate(builds)}
        procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags,
                                   "-shared", "-o", libs[label], src])
                 for label, flags in builds.items()]
        if any(p.wait() for p in procs):
            raise RuntimeError("a probe build failed")
        entries = {label: _declare(ctypes.CDLL(path))
                   for label, path in libs.items()}
        for model in MODELS:
            x = _inputs(model, dev, gen)
            pos, window = x["pos"]["equal"]
            # each build twice, in order and in reverse: a build's place in
            # the sequence moves its time by up to a tenth
            for label in list(builds) + list(reversed(builds)):
                for form in ("K3", "K32"):
                    plan = list(_plan(x, form, window, sms))
                    if label == "two slots a block":
                        plan[0] = 2
                    res.setdefault(f"{model} {form}, {label}", []).append(
                        _graph_ms(_launcher(entries[label], x, form, pos,
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
    p.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one tree, in a process of its own
        print(json.dumps(_time_this_tree()), flush=True)
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
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--single"],
            env={**os.environ, "PYTHONPATH": root}, cwd=root, check=True,
            capture_output=True, text=True)
        runs.append({"root": root, **json.loads(
            done.stdout.strip().splitlines()[-1])})
    result = {"card": card, "runs": runs}
    if args.probe:
        result["probe_graph_ms"] = _probe()
    if args.splits:
        result["splits"] = _splits()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
