"""Times the engine end to end on the card in the `int4_3b` configuration
of chip_smoke.py: Llama-3.2-3B at full width and depth, int4 weights
(unembed int4 in groups of 256) from seed 0, the paired int8 cache with
s8 decode attention, 8 slots of 2048 rows; three concurrent requests of
43, 173 and 623 prompt tokens, 32 new tokens each, after a warm-up
request.

    python -m gabby_tpu_torch.tools.bench_engine [--roots DIR ...]
        [--repeats N]

Each run is a process of its own through the public engine of the
checkout it times (`--roots`, default this one; an older commit unpacked
with `git archive` beside this one), so that two versions are compared on
one card in one call: the roots in order, then in reverse, `--repeats`
times in all. A run reports its wall seconds from the first submit to the
last token, output tok/s, decode steps and ms a decode step. Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

PROMPTS = [43, 173, 623]
NEW_TOKENS = 32


def _run_once() -> dict:
    """One timed run of the gabby_tpu_torch on sys.path."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    dev = torch.device("cuda")
    cfg = cfglib.llama32_3b(max_seq_len=2048)
    params = llama.fuse_projections(quant.quantize_tree(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev), 4, unembed_bits=4,
        unembed_group=256))
    ck.set_attn_s8(True)
    tok = Tokenizer.byte_fallback(cfg.vocab_size)
    eng = Engine(cfg, params, tok, EngineConfig(
        batch_slots=8, max_seq=2048, kv_quantized=True, pair_kv_heads=True),
        device=dev)
    try:
        warm = eng.submit([{"role": "user", "content": "warm up"}],
                          max_tokens=4)
        while warm.out.get()[1] is None:
            pass
        ck.reset_launch_counts()
        stats0 = eng.stats_snapshot()
        span = min(cfg.vocab_size, tok.vocab_size) - 16
        t0 = time.perf_counter()
        reqs = [eng.submit_ids([(i * 7919 + j * 104729) % span + 1
                                for j in range(n)], max_tokens=NEW_TOKENS)
                for i, n in enumerate(PROMPTS)]
        for req in reqs:
            while req.out.get(timeout=600)[1] is None:
                pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = eng.stats_snapshot()
        counts = dict(ck.launch_counts)
    finally:
        eng.shutdown()
        ck.set_attn_s8(None)
    out = sum(r.completion_tokens for r in reqs)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    return {"wall_s": wall, "output_tok_per_s": out / wall,
            "decode_steps": steps, "ms_a_decode_step": 1e3 * wall / steps,
            "s8_launches": counts.get("decode_attention_s8_paired", 0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.bench_engine")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose engine to time (default: this one)")
    p.add_argument("--repeats", type=int, default=1,
                   help="passes over the roots, every other one reversed")
    p.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_engine: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one run, in a process of its own
        print(json.dumps(_run_once()), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in args.roots or [here]]
    runs = []
    for rep in range(args.repeats):
        for root in roots if rep % 2 == 0 else roots[::-1]:
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--single"],
                env={**os.environ, "PYTHONPATH": root}, cwd=root, check=True,
                capture_output=True, text=True)
            runs.append({"root": root, **json.loads(
                done.stdout.strip().splitlines()[-1])})
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
