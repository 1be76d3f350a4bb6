"""Times the unembeds on the card: the int4 one (K2,
`qmatmul_int4_grouped`) and the int8 one (K6, `qmatmul_int8`).

    python -m gabby_tpu_torch.tools.bench_unembed [--roots DIR ...] [--probe]

At the unembeds of Llama-3.2-1B and 3B (hidden 2048 and 3072; K2 -> the
vocabulary padded to 129024, group 256; K6 -> the vocabulary as a loaded
checkpoint has it, 128256) and M = 8 and 64: each call replayed from a
CUDA graph, beside `torch.matmul` on the dequantized table, with the
largest difference from the plain version and a digest of the output (the
same inputs in every tree, so equal digests are equal bits). `--roots`
times the kernels of each checkout given, in that order, each in a process
of its own (an older commit unpacked with `git archive` beside this one,
so that two versions are compared in one run on one card: old, new, new,
old). `--probe` also builds csrc/quant_matmul_unembed.cu and
csrc/quant_matmul_int8_unembed.cu twice more each with parts of their
consumers removed (UNEMBED_PROBE=1: every stage released unread, the
copies alone; UNEMBED_PROBE=2: the products without the unpack) and times
those builds at the 1B shape at M = 8 and 64: where each kernel's time
goes. Their outputs are not the product. Prints one JSON line.
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

SHAPES = [(2048, 129024), (3072, 129024)]  # hidden -> padded vocabulary
INT8_SHAPES = [(2048, 128256), (3072, 128256)]  # hidden -> vocabulary
GROUP = 256


def _graph_ms(fn, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(k: int, n: int, gen, dev):
    packed = torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    scale = torch.rand((k // GROUP, n), generator=gen, device=dev) * 0.02
    return packed, scale


def _int8_inputs(k: int, n: int, gen, dev):
    codes = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.002
    return codes, scale


def _digest(t: torch.Tensor) -> int:
    """A sum of the output's bits: equal inputs, equal bits, equal sums."""
    return int(t.view(torch.int16).to(torch.int64).sum().item())


def _time_this_tree() -> dict:
    """K2 and K6 of the gabby_tpu_torch on sys.path, at every shape and M."""
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    from gabby_tpu_torch.ops.quant import unpack_int4
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for k, n in SHAPES:
        packed, scale = _inputs(k, n, gen, dev)
        table = (unpack_int4(packed).float()
                 * torch.repeat_interleave(scale, GROUP, dim=0)).bfloat16()
        for m in (8, 64):
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            got = cqm.qmatmul_int4_grouped(x, packed, scale, GROUP)
            ref = cqm.int4_grouped_plain(x, packed, scale, GROUP)
            out[f"K2 {k}x{n} M={m}"] = dict(
                max_abs_err=(got.float() - ref.float()).abs().max().item(),
                digest=_digest(got),
                graph_ms=_graph_ms(lambda: cqm.qmatmul_int4_grouped(
                    x, packed, scale, GROUP)),
                library_graph_ms=_graph_ms(lambda: torch.matmul(x, table)))
        del packed, scale, table
    for k, n in INT8_SHAPES:
        codes, scale = _int8_inputs(k, n, gen, dev)
        table = codes.bfloat16() * scale.bfloat16()
        for m in (8, 64):
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            got = cqm.qmatmul_int8(x, codes, scale)
            ref = cqm.int8_plain(x, codes, scale)
            out[f"K6 {k}x{n} M={m}"] = dict(
                max_abs_err=(got.float() - ref.float()).abs().max().item(),
                digest=_digest(got),
                graph_ms=_graph_ms(lambda: cqm.qmatmul_int8(x, codes,
                                                            scale)),
                library_graph_ms=_graph_ms(lambda: torch.matmul(x, table)))
        del codes, scale, table
    return out


def _probe_lib(tmp: str, src: str, probe: int, entry: str):
    from gabby_tpu_torch.ops.cuda import build
    lib_path = os.path.join(tmp, f"{entry}_probe{probe}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                    f"-DUNEMBED_PROBE={probe}", "-shared", "-o", lib_path,
                    os.path.join(build.CSRC, src)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes = build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def _probe() -> dict:
    """The 1B unembeds at M = 8 and 64 through builds with UNEMBED_PROBE =
    0, 1, 2: K2 (csrc/quant_matmul_unembed.cu) and K6
    (csrc/quant_matmul_int8_unembed.cu)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    k, n = SHAPES[0]
    packed, scale = _inputs(k, n, gen, dev)
    k8, n8 = INT8_SHAPES[0]
    codes, scale8 = _int8_inputs(k8, n8, gen, dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for probe, what in ((0, "whole kernel"), (1, "copies alone"),
                            (2, "products without the unpack")):
            k2 = _probe_lib(tmp, "quant_matmul_unembed.cu", probe,
                            "gabby_int4_unembed")
            k6 = _probe_lib(tmp, "quant_matmul_int8_unembed.cu", probe,
                            "gabby_int8_unembed")
            for m in (8, 64):
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
                out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                out8 = torch.empty((m, n8), dtype=torch.bfloat16, device=dev)

                def call2():
                    err = k2(x.data_ptr(), packed.data_ptr(),
                             scale.data_ptr(), out.data_ptr(), m, k, n, GROUP,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"K2 probe {probe}: error {err}")

                def call6():
                    err = k6(x.data_ptr(), codes.data_ptr(),
                             scale8.data_ptr(), out8.data_ptr(), m, k8, n8,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"K6 probe {probe}: error {err}")

                res[f"K2 M={m} {what}"] = _graph_ms(call2)
                res[f"K6 M={m} {what}"] = _graph_ms(call6)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.bench_unembed")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose K2 and K6 to time, in order "
                   "(default: this one)")
    p.add_argument("--probe", action="store_true",
                   help="also time the UNEMBED_PROBE builds of this checkout")
    p.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_unembed: no CUDA device", file=sys.stderr)
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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
