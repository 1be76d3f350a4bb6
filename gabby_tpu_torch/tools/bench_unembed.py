"""Times the int4 unembed (K2, `qmatmul_int4_grouped`) on the card.

    python -m gabby_tpu_torch.tools.bench_unembed [--roots DIR ...] [--probe]

At the unembeds of Llama-3.2-1B and 3B (hidden 2048 and 3072 -> the
vocabulary padded to 129024, group 256) and M = 8 and 64: each call
replayed from a CUDA graph, beside `torch.matmul` on the dequantized table,
with the largest difference from the plain version. `--roots` times the K2
of each checkout given, in that order, each in a process of its own (an
older commit unpacked with `git archive` beside this one, so that two
versions are compared in one run on one card: old, new, new, old).
`--probe` also builds csrc/quant_matmul_unembed.cu twice more with parts
of its consumers removed (K2_PROBE=1: every stage released unread, the
copies alone; K2_PROBE=2: the products without the unpack) and times those
builds at the 1B shape at M = 8: where the kernel's time goes. Their
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

SHAPES = [(2048, 129024), (3072, 129024)]  # hidden -> padded vocabulary
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


def _time_this_tree() -> dict:
    """K2 of the gabby_tpu_torch on sys.path, at every shape and M."""
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
            out[f"{k}x{n} M={m}"] = dict(
                max_abs_err=(got.float() - ref.float()).abs().max().item(),
                graph_ms=_graph_ms(lambda: cqm.qmatmul_int4_grouped(
                    x, packed, scale, GROUP)),
                library_graph_ms=_graph_ms(lambda: torch.matmul(x, table)))
        del packed, scale, table
    return out


def _probe() -> dict:
    """The 1B unembed at M = 8 through builds with K2_PROBE = 0, 1, 2."""
    from gabby_tpu_torch.ops.cuda import build
    src = os.path.join(build.CSRC, "quant_matmul_unembed.cu")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    k, n = SHAPES[0]
    packed, scale = _inputs(k, n, gen, dev)
    x = torch.randn((8, k), generator=gen, device=dev).bfloat16()
    out = torch.empty((8, n), dtype=torch.bfloat16, device=dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for probe, what in ((0, "whole kernel"), (1, "copies alone"),
                            (2, "products without the unpack")):
            lib_path = os.path.join(tmp, f"probe{probe}.so")
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                            f"-DK2_PROBE={probe}", "-shared", "-o",
                            lib_path, src], check=True, capture_output=True)
            fn = ctypes.CDLL(lib_path).gabby_int4_unembed
            fn.argtypes = build._SIGNATURES["gabby_int4_unembed"]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), 8, k, n, GROUP,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe {probe}: CUDA error {err}")

            res[what] = _graph_ms(call)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.bench_unembed")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose K2 to time, in order (default: "
                   "this one)")
    p.add_argument("--probe", action="store_true",
                   help="also time the K2_PROBE builds of this checkout")
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
