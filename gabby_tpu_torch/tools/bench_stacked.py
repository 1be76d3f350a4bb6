"""Times the stacked matmuls on the card: the int4 one (K1,
`qmatmul_int4_stacked`), its raw-byte-dot form (K33,
`qmatmul_int4_stacked_rawdot`), the W4A8 one (K8,
`qmatmul_int4_w4a8_stacked`) and the int8-weight one (K5,
`qmatmul_int8_stacked`).

    python -m gabby_tpu_torch.tools.bench_stacked [--roots DIR ...] [--probe]
        [--splits] [--kernels NAME ...]

At the four projections (wqkv, wo, w_gup, w_down) of Llama-3.2-1B (16
layers) and Llama-3.2-3B (28 layers), random codes and scales from a seed,
at M = 8 (a decode step) and M = 64 (a verify macro-step): one decode
step's call set (4 projections x every layer; K5 on int8 stacks [L, K, N],
the others on packed int4 ones [L, K/2, N]) eagerly and replayed from a
CUDA graph, each projection's layers replayed alone, beside `torch.matmul`
on the dequantized bf16 weight (`library`, `library_int8`), with the
largest difference from the plain version, whether the output equals the
plain version's bits, whether a repeat gives the same bits, a digest of
the outputs of the first calls (the inputs come from one seed, so equal
digests of two trees mean equal bits), and the host's
microseconds a call (the wrapper's time to return, 500 calls without
waiting for the card). `--roots` times the
kernels of each checkout given, in that order, each in a process of its
own (an older commit unpacked with `git archive` beside this one, so that
two versions are compared in one run on one card: old, new, new, old).
`--probe` also builds each stacked form's source (K1
csrc/quant_matmul_stacked.cu, K5 quant_matmul_int8_stacked.cu, K8
quant_matmul_w4a8.cu) alone with K1_PROBE = 0..4 (the whole kernel; the
copies alone; no unpack; no cross-block reduction; the whole kernel
launched without programmatic dependent launch), K8 also with 5 (no row
maxima and no exchange of them) and 6 (no quantization of the landed x
tiles), and times each form's 1B call set through each build at M = 8 and
64: where the kernel's time goes. `--splits` times K1 at each projection of both models, M = 8
and 64, at every split of K its kernel takes (1, 2, 4, 8 blocks dividing
the stages), microseconds a call replayed from a graph, beside the split
`stacked_plan` picks. The probe builds' outputs are not the product. A
projection replayed alone reads 32-96 MB at the 1B shapes, so part of it
may come from the 50 MB L2; the call set (486 MB) cannot. Prints one JSON
line.
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
import time

import torch

MODELS = ("llama32_1b", "llama32_3b")
# the wrappers timed, and the bits of the codes their stacks hold
KERNELS = {"qmatmul_int4_stacked": 4, "qmatmul_int4_stacked_rawdot": 4,
           "qmatmul_int4_w4a8_stacked": 4, "qmatmul_int8_stacked": 8}
# --probe: each form's source, C entry and K1_PROBE builds
PROBES = {"qmatmul_int4_stacked": ("quant_matmul_stacked.cu",
                                   "gabby_int4_matmul", range(5)),
          "qmatmul_int8_stacked": ("quant_matmul_int8_stacked.cu",
                                   "gabby_int8_matmul_stacked", range(5)),
          "qmatmul_int4_w4a8_stacked": ("quant_matmul_w4a8.cu",
                                        "gabby_w4a8_matmul", range(7))}
PROBE_WHAT = ("whole kernel", "copies alone", "products without the unpack",
              "no cross-block reduction",
              "without programmatic dependent launch", "no row maxima",
              "no quantization of the x tiles")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _time(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time(graph.replay, iters)


def _host_us(fn, calls: int = 500) -> float:
    """Microseconds the host takes to issue one call of fn (no waiting)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _projections(cfg):
    d = cfg.hidden_size
    return [(d, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, d),
            (d, 2 * cfg.intermediate_size), (cfg.intermediate_size, d)]


def _stacks(model: str, dev, gen, bits: int = 4):
    """(layers, [(k, n, codes, scale [L, n])]) of a model: codes packed
    int4 [L, k/2, n] (bits 4) or int8 [L, k, n] (bits 8)."""
    from gabby_tpu_torch import config as cfglib
    cfg = getattr(cfglib, model)()
    mats = []
    for k, n in _projections(cfg):
        rows = k // 2 if bits == 4 else k
        packed = torch.randint(-128, 128, (cfg.num_layers, rows, n),
                               generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
        scale = torch.rand((cfg.num_layers, n), generator=gen,
                           device=dev) * (0.02 if bits == 4 else 0.002)
        mats.append((k, n, packed, scale))
    return cfg.num_layers, mats


def _bound_ms(nl: int, mats, m: int) -> float:
    """Bytes of a call set (codes, scales, x, output) at 3.35 TB/s."""
    return sum(nl * (p[0].numel() + n * 4 + m * k * 2 + m * n * 2)
               for k, n, p, _ in mats) / HBM_BYTES_PER_S * 1e3


def _time_this_tree(kernels) -> dict:
    """The `kernels` of the gabby_tpu_torch on sys.path, and the library
    call, at every model and M."""
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    from gabby_tpu_torch.ops.quant import unpack_int4
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for model in MODELS:
        stacks = {}
        for bits in sorted({KERNELS[k] for k in kernels}):
            nl, mats = _stacks(model, dev, gen, bits)
            dense = [(torch.stack([unpack_int4(p[i]) for i in range(nl)])
                      if bits == 4 else p).bfloat16()
                     * s[:, None, :].bfloat16() for _, _, p, s in mats]
            stacks[bits] = (mats, dense)
        for m in (8, 64):
            row = {}
            for bits, (mats, dense) in stacks.items():
                suffix = "" if bits == 4 else "_int8"
                xs = [torch.randn((m, k), generator=gen,
                                  device=dev).bfloat16()
                      for k, _, _, _ in mats]
                row["bound_ms" + suffix] = _bound_ms(nl, mats, m)
                row["library" + suffix] = _library(nl, mats, dense, xs)
                calls = [(x, p, s, layer) for layer in range(nl)
                         for x, (_, _, p, s) in zip(xs, mats)]
                for name in kernels:
                    if KERNELS[name] == bits:
                        row[name] = _time_kernel(cqm, name, nl, mats, xs,
                                                 calls)
            out[f"{model} M={m}"] = row
        del stacks
        torch.cuda.empty_cache()
    return out


def _library(nl, mats, dense, xs) -> dict:
    """torch.matmul on the dequantized bf16 weights: the call set and each
    projection's layers, from a graph."""
    lib = [(x, w[layer]) for layer in range(nl) for x, w in zip(xs, dense)]
    return dict(
        graph_ms=_graph_ms(lambda: [torch.matmul(*c) for c in lib]),
        eager_ms=_time(lambda: [torch.matmul(*c) for c in lib], 10),
        by_projection_graph_ms={
            f"{k}x{n}": _graph_ms(
                lambda: [torch.matmul(x, w[layer]) for layer in range(nl)])
            for x, w, (k, n, _, _) in zip(xs, dense, mats)})


def _time_kernel(cqm, name, nl, mats, xs, calls) -> dict:
    fn = getattr(cqm, name)
    plain = getattr(cqm, name.replace("qmatmul_", "") + "_plain")
    outs = [(fn(*c), plain(*c)) for c in calls[:4]]
    digest = hashlib.sha256()
    for o, _ in outs:
        digest.update(o.view(torch.int16).cpu().numpy().tobytes())
    return dict(
        max_abs_err=max((o.float() - r.float()).abs().max().item()
                        for o, r in outs),
        plain_equal=all(torch.equal(o, r) for o, r in outs),
        digest=digest.hexdigest()[:16],
        repeat_equal=all(torch.equal(fn(*c), fn(*c)) for c in calls[:4]),
        graph_ms=_graph_ms(lambda: [fn(*c) for c in calls]),
        eager_ms=_time(lambda: [fn(*c) for c in calls], 10),
        host_us=_host_us(lambda: fn(*calls[0])),
        by_projection_graph_ms={
            f"{k}x{n}": _graph_ms(
                lambda: [fn(x, p, s, layer) for layer in range(nl)])
            for x, (k, n, p, s) in zip(xs, mats)})


def _probe(kernels) -> dict:
    """Each form's 1B call set at M = 8 and 64 through builds of its source
    alone with K1_PROBE = 0.. (PROBES), each timed twice, in order and in
    reverse."""
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    todo = [(name, p) for name in kernels if name in PROBES
            for p in PROBES[name][2]]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {job: os.path.join(tmp, f"{job[0]}_{job[1]}.so")
                for job in todo}
        procs = [subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DK1_PROBE={p}", "-shared",
             "-o", libs[(name, p)],
             os.path.join(build.CSRC, PROBES[name][0])])
            for name, p in todo]
        if any(p.wait() for p in procs):
            raise RuntimeError("a probe build failed")
        calls = {}
        for name in dict.fromkeys(name for name, _ in todo):
            bits = KERNELS[name]
            per = 2 if bits == 4 else 1
            nl, mats = _stacks(MODELS[0], dev, gen, bits)
            for m in (8, 64):
                args = []
                for k, n, p, s in mats:
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).bfloat16()
                    o = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                    bt, split = cqm.stacked_plan(m, k // per, n, sms)
                    # the map from the library: the probe builds hold the
                    # entry point alone
                    wmap = cqm._stack_map(p)
                    args.append((x, wmap, s, o, k, n, bt, split))
                calls[name, m] = (nl, args, mats)
        for order in (todo, todo[::-1]):
            for name, p in order:
                lib = ctypes.CDLL(libs[name, p])
                entry = PROBES[name][1]
                fn = getattr(lib, entry)
                fn.argtypes = build._SIGNATURES[entry]
                for m in (8, 64):
                    nl, args, _ = calls[name, m]

                    def call():
                        stream = torch.cuda.current_stream().cuda_stream
                        for layer in range(nl):
                            for x, wmap, s, o, k, n, bt, split in args:
                                head = [x.data_ptr(), ctypes.addressof(wmap),
                                        s[layer].data_ptr(), o.data_ptr()]
                                if entry == "gabby_w4a8_matmul":
                                    head.append(None)
                                err = fn(*head, m, k, n, layer, bt, split,
                                         stream)
                                if err:
                                    raise RuntimeError(
                                        f"probe {name} {p}: CUDA error {err}")

                    res.setdefault(f"{name}: {PROBE_WHAT[p]}, M={m}",
                                   []).append(_graph_ms(call))
    return res


def _splits() -> dict:
    """K1 at every split its kernel takes, each projection of MODELS, M = 8
    and 64: {case: {"us_a_call": {split: us}, "plan": split}}."""
    from gabby_tpu_torch.ops.cuda import build
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.library()
    res = {}
    for model in MODELS:
        nl, mats = _stacks(model, dev, gen)
        for m in (8, 64):
            for k, n, p, s in mats:
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
                o = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                wmap = cqm._stack_map(p)
                bt, plan = cqm.stacked_plan(m, k // 2, n, sms)
                times = {}
                for split in (1, 2, 4, 8):
                    if (k // 128) % split:
                        continue

                    def call():
                        stream = torch.cuda.current_stream().cuda_stream
                        for layer in range(nl):
                            build.check(lib.gabby_int4_matmul(
                                x.data_ptr(), ctypes.addressof(wmap),
                                s[layer].data_ptr(), o.data_ptr(), m, k, n,
                                layer, bt, split, stream), "split sweep")

                    times[split] = _graph_ms(call) / nl * 1e3
                res[f"{model} M={m} {k}x{n}"] = {"us_a_call": times,
                                                 "plan": plan}
        del mats
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.bench_stacked")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose stacked kernels to time, in order "
                   "(default: this one)")
    p.add_argument("--kernels", nargs="*", default=list(KERNELS),
                   choices=list(KERNELS), help="the wrappers to time "
                   "(default: all)")
    p.add_argument("--probe", action="store_true",
                   help="also time the K1_PROBE builds of this checkout")
    p.add_argument("--splits", action="store_true",
                   help="also time K1 of this checkout at every split of K")
    p.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stacked: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one tree, in a process of its own
        print(json.dumps(_time_this_tree(args.kernels)), flush=True)
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
            [sys.executable, os.path.abspath(__file__), "--single",
             "--kernels", *args.kernels],
            env={**os.environ, "PYTHONPATH": root}, cwd=root, check=True,
            capture_output=True, text=True)
        runs.append({"root": root, **json.loads(
            done.stdout.strip().splitlines()[-1])})
    result = {"card": card, "runs": runs}
    if args.probe:
        result["probe_graph_ms"] = _probe(args.kernels)
    if args.splits:
        result["splits"] = _splits()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
