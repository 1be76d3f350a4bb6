"""Profile decode_loop calls under torch.profiler and aggregate the time by
op: the port's counterpart of tools/profile_decode.py.

    python -m gabby_tpu_torch.tools.profile_decode [--config int4_1b]
        [--batch 8] [--context 1024] [--max-seq 2048] [--steps 64]
        [--no-fuse] [--top 28] [--device cuda]

Builds the model as the reference's tool does (random weights from seed 0;
int4 weights come with the group-256 int4 unembed; fused projections
unless --no-fuse; the paired int8 cache where the kv-head count is even
and GABBY_ATTN_PAIR is not 0), warms up one `decode_loop` call of --steps
steps at the reference's attention window, then traces 3 calls under
`torch.profiler` (each ended by `torch.cuda.synchronize`) and prints the
device's total over the 3 calls beside their wall time, so that the
device's idle share reads off, and the wall of one call outside the trace
(the profiler's own host cost is in the traced wall), then the top ops as
`us/step  xcount name`. On the card the device's time is its kernel, copy and fill events
in the Chrome trace; on the CPU (--device cpu), where there is no device,
the ops' self CPU time. A tool, not a benchmark: it names no cell.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

# the reference's configurations (bench.py CONFIGS), by preset name
CONFIGS = {
    "int8_1b": dict(preset="llama32_1b", bits=8, kv_quant=False),
    "int8kv_1b": dict(preset="llama32_1b", bits=8, kv_quant=True),
    "bf16_1b": dict(preset="llama32_1b", bits=None, kv_quant=False),
    "int4_1b": dict(preset="llama32_1b", bits=4, kv_quant=True),
    "int4_3b": dict(preset="llama32_3b", bits=4, kv_quant=True),
    "int4_8b": dict(preset="llama3_8b", bits=4, kv_quant=True),
    "tiny": dict(preset="tiny", bits=None, kv_quant=False),
    # a CPU-runnable smoke of the full int4 path (paired cache, grouped
    # unembed, int8 kv), for testing the tool, not a record
    "tiny_int4": dict(preset="tiny", bits=4, kv_quant=True),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALLS = 3


def window_for(context: int, steps: int, max_seq: int) -> int:
    """The reference's attention window: the smallest power of two from
    1024 that covers the context and the burst, at most max_seq."""
    window = 1024
    while window < context + steps + 2:
        window *= 2
    return min(window, max_seq)


def device_rows(trace: dict) -> dict:
    """Name -> [us, count] of the device's events in a Chrome trace."""
    agg: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            row = agg.setdefault(e["name"], [0.0, 0])
            row[0] += float(e.get("dur", 0))
            row[1] += 1
    return agg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.profile_decode")
    p.add_argument("--config", default="int4_1b", choices=sorted(CONFIGS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--context", type=int, default=1024)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--top", type=int, default=28)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for a smoke run)")
    args = p.parse_args(argv)

    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch import resolve_device
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime import generate
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    spec = CONFIGS[args.config]
    cfg = getattr(cfglib, spec["preset"])(max_seq_len=args.max_seq)
    params = llama.init_params(cfg, dtype=torch.bfloat16, device=dev)
    if spec["bits"]:
        # the reference's serving layout: int4 weights with the int4
        # group-256 unembed
        params = quant.quantize_tree(
            params, spec["bits"],
            unembed_bits=4 if spec["bits"] == 4 else None,
            unembed_group=256)
    if not args.no_fuse:
        params = llama.fuse_projections(params)
    b = args.batch
    paired = (os.environ.get("GABBY_ATTN_PAIR", "1") != "0"
              and cfg.num_kv_heads % 2 == 0)
    cache = create_cache(cfg, b, args.max_seq, dtype=torch.bfloat16,
                         quantized=spec["kv_quant"], paired=paired,
                         device=dev)
    tokens = torch.full((b,), 17, dtype=torch.int32, device=dev)
    positions = torch.full((b,), args.context, dtype=torch.int32,
                           device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    sstate = generate.SamplingState.greedy(b, dev)
    window = window_for(args.context, args.steps, args.max_seq)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def run():
        out = generate.decode_loop(params, cfg, tokens, positions, active,
                                   cache, sstate, args.steps, window=window)
        sync()
        return out

    with torch.inference_mode():
        run()  # warm: the kernels' build and first launches
        t0 = time.perf_counter()
        run()  # one call outside the trace: the host's cost without it
        plain_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                run()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_step = CALLS * args.steps
    if cuda:
        with tempfile.TemporaryDirectory(prefix="gabby-prof-") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                agg = device_rows(json.load(f))
        if not agg:
            print("profile_decode: the trace holds no device event: the "
                  "card was not traced", file=sys.stderr)
            return 1
        where = f"device {torch.cuda.get_device_name(dev)}"
    else:
        agg = {e.key: [float(e.self_cpu_time_total), e.count]
               for e in prof.key_averages() if e.self_cpu_time_total > 0}
        where = "cpu (self time of the ops: there is no device)"
    total_ms = sum(us for us, _ in agg.values()) / 1e3
    print(f"{where}: total {total_ms:.3f} ms over {CALLS} calls x "
          f"{args.steps} steps, wall {wall_ms:.3f} ms "
          f"({args.config}, batch {b}, context {args.context}, window "
          f"{window}); one call untraced {plain_ms:.3f} ms", flush=True)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (us, count) in rows:
        print(f"{us / per_step:9.1f} us/step  x{count:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
