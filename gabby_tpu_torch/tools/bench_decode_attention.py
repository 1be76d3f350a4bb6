"""Times the dense flash-decode kernel (K3 and K16 over an int8 cache, K32
over a bf16 one; csrc/decode_attention.cu) on the card.

    python -m gabby_tpu_torch.tools.bench_decode_attention [--roots DIR ...]
        [--probe] [--splits]

At the heads of Llama-3.2-1B (32 q over 8 kv heads of 64 dims, 16 layers)
and Llama-3.2-3B (24 over 8 of 128, 28 layers), 8 slots of a 2048-row
cache, random caches and queries from a seed: one decode step's call set
(a launch a layer) of K3, K16 and K32, at equal positions (1024 rows,
window 1025) and at spread ones (16 to 2000 rows, window 2048), eagerly
and replayed from a CUDA graph, beside SDPA on the dequantized rows (eager
and from a graph) and the bound (each cache byte read once at 3.35 TB/s);
with the largest difference from the plain version on two layers and
whether a repeat gives the same bits. `--roots` times the kernels of each
checkout given, in that order, each in a process of its own (an older
commit unpacked with `git archive` beside this one, so that two versions
are compared in one run on one card: old, new, new, old). `--probe` also
builds csrc/decode_attention.cu alone with DECODE_PROBE = 1 (the copies
alone), 2 (no cross-block merge) and 3 (no programmatic dependent
launch), and with DECODE_SLOTS = 2 (two slots a block), and times K3's and
K32's call sets at equal positions through each build beside the whole
kernel (each build twice, in order and in reverse): where the time goes,
and what two of the design's choices are worth. `--splits` times
K3 and K32 at every split (1, 2, 4, 8 blocks a cluster), microseconds a
call replayed from a graph, beside the split `decode_plan` picks. The
probe builds' outputs are not the product. Prints one JSON line.
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
SLOTS, ROWS, CTX = 8, 2048, 1024
SPREAD = [2000, 16, 1024, 300, 1700, 64, 1300, 700]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _inputs(model: str, dev, gen) -> dict:
    """One model's caches (int8 with scales, and bf16), queries and fresh
    rows, and both position sets."""
    from gabby_tpu_torch.runtime.kv_cache import quantize_kv
    nl, nq, nk, h = MODELS[model]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    kc, ks = quantize_kv(rand(nl, SLOTS, nk, ROWS, h))
    vc, vs = quantize_kv(rand(nl, SLOTS, nk, ROWS, h))
    return dict(
        nl=nl, nq=nq, nk=nk, h=h, kc=kc, vc=vc, ks=ks, vs=vs,
        kb=rand(nl, SLOTS, nk, ROWS, h).bfloat16(),
        vb=rand(nl, SLOTS, nk, ROWS, h).bfloat16(),
        q=rand(SLOTS, 1, nq, h).bfloat16(), fk=rand(SLOTS, nk, h).bfloat16(),
        fv=rand(SLOTS, nk, h).bfloat16(),
        pos={"equal": (torch.full((SLOTS,), CTX, dtype=torch.int32,
                                  device=dev), CTX + 1),
             "spread": (torch.tensor(SPREAD, dtype=torch.int32, device=dev),
                        ROWS)})


def _bound_ms(x: dict, pos, quant: bool) -> float:
    """Live cache rows (and scales) once, q, out and the fresh rows."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    row = h + 4 if quant else 2 * h
    live = int(pos.sum())
    return nl * (2 * nk * live * row + 2 * SLOTS * nq * h * 2
                 + 2 * SLOTS * nk * h * 2) / HBM_BYTES_PER_S * 1e3


def _time_this_tree() -> dict:
    """K3, K16 and K32 of the gabby_tpu_torch on sys.path, and the library
    call, at every model and position set."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for model in MODELS:
        x = _inputs(model, dev, gen)
        nl = x["nl"]
        kw = dict(fresh_k=x["fk"], fresh_v=x["fv"])
        for label, (pos, window) in x["pos"].items():
            top = int(pos.max())
            mask = torch.cat([torch.arange(top, device=dev)[None, :]
                              < pos[:, None],
                              torch.ones((SLOTS, 1), dtype=torch.bool,
                                         device=dev)], dim=1)[:, None, None]
            row = {}
            forms = {"int8": (x["kc"], x["vc"], x["ks"], x["vs"]),
                     "bf16": (x["kb"], x["vb"], None, None)}
            for form, (k_, v_, ks_, vs_) in forms.items():
                quant = ks_ is not None
                row[f"bound_ms_{form}"] = _bound_ms(x, pos, quant)
                kernels = ({"K3": cattn.decode_attention,
                            "K16": cattn.decode_attention_multi} if quant
                           else {"K32": cattn.decode_attention_multi})
                for name, fn in kernels.items():
                    def call(i, fn=fn, k_=k_, v_=v_, ks_=ks_, vs_=vs_):
                        return fn(x["q"], k_, v_, ks_, vs_, pos, layer=i,
                                  window=window, **kw)

                    err = max((call(i).float() - cattn.decode_attention_plain(
                        x["q"], k_, v_, ks_, vs_, pos, layer=i, **kw)
                        .float()).abs().max().item() for i in range(2))
                    row[name] = dict(
                        max_abs_err=err,
                        repeat_equal=all(torch.equal(call(i), call(i))
                                         for i in range(nl)),
                        graph_ms=_graph_ms(lambda: [call(i)
                                                    for i in range(nl)]),
                        eager_ms=_time(lambda: [call(i) for i in range(nl)],
                                       10))
                if quant:
                    row["K16_equals_K3"] = all(torch.equal(
                        cattn.decode_attention(x["q"], k_, v_, ks_, vs_, pos,
                                               layer=i, window=window, **kw),
                        cattn.decode_attention_multi(
                            x["q"], k_, v_, ks_, vs_, pos, layer=i,
                            window=window, **kw)) for i in range(nl))
                # the library call: SDPA on the rows below the longest slot,
                # dequantized, with the fresh row and a mask
                kd, vd = [], []
                for i in range(nl):
                    kk, vv = k_[i, :, :, :top], v_[i, :, :, :top]
                    if quant:
                        kk = (kk.float() * ks_[i, :, :, :top, None]).bfloat16()
                        vv = (vv.float() * vs_[i, :, :, :top, None]).bfloat16()
                    kd.append(torch.cat([kk, x["fk"][:, :, None]], dim=2))
                    vd.append(torch.cat([vv, x["fv"][:, :, None]], dim=2))
                qt = x["q"].transpose(1, 2)

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


def _launcher(fn, x: dict, quant: bool, pos, window: int, plan):
    """The call set of one decode step through C entry `fn` at an explicit
    launch plan (sb, split, tile)."""
    nl, nq, nk, h = x["nl"], x["nq"], x["nk"], x["h"]
    k_, v_ = (x["kc"], x["vc"]) if quant else (x["kb"], x["vb"])
    o = torch.empty_like(x["q"])
    lay = k_[0].numel() * k_.element_size()
    slay = x["ks"][0].numel() * 4

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(nl):
            scales = ((x["ks"].data_ptr() + i * slay,
                       x["vs"].data_ptr() + i * slay) if quant else ())
            err = fn(x["q"].data_ptr(), k_.data_ptr() + i * lay,
                     v_.data_ptr() + i * lay, *scales, x["fk"].data_ptr(),
                     x["fv"].data_ptr(), pos.data_ptr(), o.data_ptr(), SLOTS,
                     nq, nk, ROWS, h, window, *plan, h ** -0.5, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at plan {plan}")
    return call


def _declare(lib):
    from gabby_tpu_torch.ops.cuda import build
    for name in ("gabby_decode_attention", "gabby_decode_attention_bf16"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
    return lib.gabby_decode_attention, lib.gabby_decode_attention_bf16


def _probe() -> dict:
    """K3's and K32's call sets at equal positions through builds of
    csrc/decode_attention.cu alone: the whole kernel, the copies alone, no
    cross-block merge, two slots a block."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
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
                for name, fn, quant in (("K3", entries[label][0], True),
                                        ("K32", entries[label][1], False)):
                    plan = list(cattn.decode_plan(
                        SLOTS, x["nk"], x["h"], x["nq"] // x["nk"], window,
                        sms, quant=quant))
                    if label == "two slots a block":
                        plan[0] = 2
                    res.setdefault(f"{model} {name}, {label}", []).append(
                        _graph_ms(_launcher(fn, x, quant, pos, window, plan)))
            del x
            torch.cuda.empty_cache()
    return res


def _splits() -> dict:
    """K3 and K32 at every split, both models and position sets:
    {case: {"us_a_call": {split: us}, "plan": split}}."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k3, k32 = _declare(build.library())
    res = {}
    for model in MODELS:
        x = _inputs(model, dev, gen)
        for label, (pos, window) in x["pos"].items():
            for name, fn, quant in (("K3", k3, True), ("K32", k32, False)):
                sb, plan, tile = cattn.decode_plan(
                    SLOTS, x["nk"], x["h"], x["nq"] // x["nk"], window, sms,
                    quant=quant)
                res[f"{model} {label} {name}"] = {
                    "us_a_call": {split: _graph_ms(_launcher(
                        fn, x, quant, pos, window, (sb, split, tile)))
                        / x["nl"] * 1e3 for split in (1, 2, 4, 8)},
                    "plan": plan}
        del x
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gabby_tpu_torch.tools.bench_decode_attention")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose K3, K16 and K32 to time, in order "
                   "(default: this one)")
    p.add_argument("--probe", action="store_true",
                   help="also time the DECODE_PROBE builds of this checkout")
    p.add_argument("--splits", action="store_true",
                   help="also time K3 and K32 of this checkout at every "
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
