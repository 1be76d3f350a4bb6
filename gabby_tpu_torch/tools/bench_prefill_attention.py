"""Times the flash prefill attention over a bf16 cache on the card, K22 and
the paired K23 (csrc/prefill_attention_bf16.cu), against another checkout's
in one run, and checks the int8-cache forms K4 and K21
(csrc/prefill_attention.cu) for equal bits across the checkouts.

    python -m gabby_tpu_torch.tools.bench_prefill_attention [--roots DIR ...]
        [--device cpu]

Three cases, those of `chip_smoke.py`: one prefill chunk's call set (a
launch a layer) at the heads of Llama-3.2-1B (32 q over 8 kv heads of 64
dims, 16 layers) at T = 512 over offset 512; at those of Llama-3.2-3B (24
over 8 of 128, 28 layers) at the same T and offset; and the 1B heads at
T = 64 over 1024 rows (the key range split across blocks). Slot 3 of an
8-slot cache of 2048 rows, random rows, queries and fresh rows from a seed;
the paired forms read the same rows re-laid, the int8 forms the same rows
quantized. For each form: its output bits' digest over every layer; for
K22 and K23 also the largest difference from the plain version on the
first and last layer, ms a call set issued eagerly and replayed from a
CUDA graph, and the host's microseconds to issue one call; beside them SDPA
on the same rows with the causal mask (eager and from a graph). `--roots`
runs the forms of each checkout given, in that order, each in a process of
its own, through the same public wrapper (an older commit unpacked with
`git archive` beside this one: old, new, new, old on one card); the result
says whether K4's and K21's digests agree across the checkouts and whether
each checkout's K23 gives its K22's bits. `--device cpu` runs the same flow
on the plain versions at small shapes (2 layers, 256 rows), for a test.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

# label: (layers, q heads, kv heads, head_dim, T, offset)
CASES = {"1b": (16, 32, 8, 64, 512, 512), "3b": (28, 24, 8, 128, 512, 512),
         "1b_short": (16, 32, 8, 64, 64, 1024)}
CPU_CASES = {"1b": (2, 8, 2, 64, 32, 64), "3b": (2, 6, 2, 128, 32, 64),
             "1b_short": (2, 8, 2, 64, 16, 128)}
SLOTS, ROWS, SLOT = 8, 2048, 3
CPU_SLOTS, CPU_ROWS = 4, 256
FORMS = ("K22", "K23", "K4", "K21")  # bf16, bf16 paired, int8, int8 paired


def _digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time_ms(fn, iters: int, cuda: bool) -> float:
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    from gabby_tpu_torch.tools.bench_stacked import _time
    return _time(fn, iters)


def _host_us(fn, calls: int, cuda: bool) -> float:
    """Microseconds the host takes to issue one call (no waiting)."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _case(dev, nl, nq, nk, h, t, off, slots, rows) -> dict:
    from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    kb, vb = randn(nl, slots, nk, rows, h), randn(nl, slots, nk, rows, h)
    q, fk, fv = randn(1, t, nq, h), randn(nk, t, h), randn(nk, t, h)
    (kc, ks), (vc, vs) = quantize_kv(kb.float()), quantize_kv(vb.float())
    caches = {"K22": (kb, vb, None, None),
              "K23": (pair_heads(kb), pair_heads(vb), None, None),
              "K4": (kc, vc, ks, vs),
              "K21": (pair_heads(kc), pair_heads(vc), ks, vs)}
    kw = dict(fresh_k=fk, fresh_v=fv)
    res = {}
    for name in FORMS:
        k_, v_, ks_, vs_ = caches[name]

        def call(i, k_=k_, v_=v_, ks_=ks_, vs_=vs_):
            return cpfa.prefill_attention(q, k_, v_, ks_, vs_, SLOT, off,
                                          layer=i, **kw)
        outs = [call(i) for i in range(nl)]
        entry = {"digest": _digest(outs)}
        if ks_ is None:
            err, finite = 0.0, True
            for i in (0, nl - 1):
                ref = cpfa.prefill_attention_plain(q, k_, v_, None, None,
                                                   SLOT, off, layer=i, **kw)
                err = max(err, (outs[i].float() - ref.float()).abs().max()
                          .item())
                finite = finite and bool(torch.isfinite(outs[i]).all())
            entry.update(max_abs_err=err, finite=finite,
                         ms=_time_ms(lambda: [call(i) for i in range(nl)],
                                     10 if cuda else 1, cuda),
                         host_us_a_call=_host_us(lambda: call(0),
                                                 200 if cuda else 2, cuda))
            if cuda:
                from gabby_tpu_torch.tools.bench_stacked import _graph_ms
                entry["graph_ms"] = _graph_ms(
                    lambda: [call(i) for i in range(nl)])
        res[name] = entry
        del outs
    res["K23_equals_K22"] = res["K23"]["digest"] == res["K22"]["digest"]
    res["K21_equals_K4"] = res["K21"]["digest"] == res["K4"]["digest"]
    # SDPA on the same bf16 rows, the causal fresh block appended
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = torch.cat([torch.ones((t, off), dtype=torch.bool, device=dev),
                      torch.ones((t, t), dtype=torch.bool,
                                 device=dev).tril()], dim=1)
    kd = [torch.cat([kb[i, SLOT, :, :off], fk], dim=1)[None]
          for i in range(nl)]
    vd = [torch.cat([vb[i, SLOT, :, :off], fv], dim=1)[None]
          for i in range(nl)]
    qt = q.transpose(1, 2)

    def library():
        return [sdpa(qt, kd[i], vd[i], attn_mask=mask, enable_gqa=True)
                for i in range(nl)]
    res["sdpa_ms"] = _time_ms(library, 10 if cuda else 1, cuda)
    if cuda:
        from gabby_tpu_torch.tools.bench_stacked import _graph_ms
        res["sdpa_graph_ms"] = _graph_ms(library)
    keys = t * off + t * (t + 1) // 2
    res["bound_ms"] = nl * 4 * nq * h * keys / 989e12 * 1e3  # operations
    return res


def _time_this_tree(device: str) -> dict:
    """Every case through the gabby_tpu_torch on sys.path."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cases = CASES if cuda else CPU_CASES
    slots, rows = (SLOTS, ROWS) if cuda else (CPU_SLOTS, CPU_ROWS)
    out = {}
    for label, (nl, nq, nk, h, t, off) in cases.items():
        out[label] = _case(dev, nl, nq, nk, h, t, off, slots, rows)
        if cuda:
            torch.cuda.empty_cache()
    return out


def _agree(runs: list, form: str) -> bool:
    """Whether every checkout gave the same bits for `form` in every case."""
    return all(len({r["cases"][c][form]["digest"] for r in runs}) == 1
               for c in runs[0]["cases"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gabby_tpu_torch.tools.bench_prefill_attention")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose prefill kernels to time, in order "
                   "(default: this one)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain versions at small shapes")
    p.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_prefill_attention: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one checkout, in a process of its own
        print(json.dumps(_time_this_tree(args.device)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    runs = []
    for root in args.roots or [here]:
        root = os.path.abspath(root)
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--single",
             "--device", args.device],
            env={**os.environ, "PYTHONPATH": root}, cwd=root, check=True,
            capture_output=True, text=True)
        runs.append({"root": root, "cases": json.loads(
            done.stdout.strip().splitlines()[-1])})
    print(json.dumps({
        "card": card, "runs": runs,
        "K4_same_bits_across_roots": _agree(runs, "K4"),
        "K21_same_bits_across_roots": _agree(runs, "K21"),
        "K23_equals_K22": [all(c["K23_equals_K22"]
                               for c in r["cases"].values()) for r in runs],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
