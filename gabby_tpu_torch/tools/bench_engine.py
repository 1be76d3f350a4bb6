"""Times the engine end to end on the card in three cells of chip_smoke.py,
each with int4 weights (unembed int4 in groups of 256) from seed 0, the
paired int8 cache with s8 decode attention, 8 slots of 2048 rows, 32 new
tokens a request, after a warm-up request:

* `int4_3b`: Llama-3.2-3B at full width and depth; three concurrent
  requests of 43, 173 and 623 prompt tokens.
* `1b_dense`: Llama-3.2-1B at full width and depth, the server's default
  configuration; the ten concurrent chat requests of chip_smoke.py's
  engine runs (contents of 5 to 900 characters).
* `1b_paged`: the same over 33 pages of 512 rows.

    python -m gabby_tpu_torch.tools.bench_engine [--roots DIR ...]
        [--cells CELL ...] [--repeats N]

Each run is a process of its own through the public engine of the
checkout it times (`--roots`, default this one; an older commit unpacked
with `git archive` beside this one), so that two versions are compared on
one card in one call: for each cell, the roots in order, then in reverse,
`--repeats` times in all. A run reports its wall seconds from the first
submit to the last token, output tok/s, the median time to first token
of its requests (the engine's stamp, at admission), decode steps, ms a
decode step and burst admissions (None where the engine has no such
count). Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

NEW_TOKENS = 32
# chat contents of chip_smoke.py's engine runs, in characters
CONTENT_SIZES = [20, 40, 150, 200, 400, 450, 502, 600, 900, 5]
CELLS = {
    "int4_3b": dict(model="llama32_3b", prompt_lens=[43, 173, 623]),
    "1b_dense": dict(model="llama32_1b", chat=CONTENT_SIZES),
    "1b_paged": dict(model="llama32_1b", chat=CONTENT_SIZES,
                     engine=dict(paged_pages=33, page_size=512)),
}


def _run_once(cell: str) -> dict:
    """One timed run of `cell` through the gabby_tpu_torch on sys.path."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    spec = CELLS[cell]
    dev = torch.device("cuda")
    cfg = getattr(cfglib, spec["model"])(max_seq_len=2048)
    params = llama.fuse_projections(quant.quantize_tree(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev), 4, unembed_bits=4,
        unembed_group=256))
    ck.set_attn_s8(True)
    tok = Tokenizer.byte_fallback(cfg.vocab_size)
    eng = Engine(cfg, params, tok, EngineConfig(
        batch_slots=8, max_seq=2048, kv_quantized=True, pair_kv_heads=True,
        **spec.get("engine", {})), device=dev)
    try:
        warm = eng.submit([{"role": "user", "content": "warm up"}],
                          max_tokens=4)
        while warm.out.get()[1] is None:
            pass
        ck.reset_launch_counts()
        stats0 = eng.stats_snapshot()
        span = min(cfg.vocab_size, tok.vocab_size) - 16
        t0 = time.perf_counter()
        if "chat" in spec:
            reqs = [eng.submit(
                [{"role": "user",
                  "content": "".join(chr(97 + (i * 7 + j) % 26)
                                     for j in range(n))}],
                max_tokens=NEW_TOKENS) for i, n in enumerate(spec["chat"])]
        else:
            reqs = [eng.submit_ids([(i * 7919 + j * 104729) % span + 1
                                    for j in range(n)],
                                   max_tokens=NEW_TOKENS)
                    for i, n in enumerate(spec["prompt_lens"])]
        for req in reqs:
            while True:
                _, fin = req.out.get(timeout=600)
                if fin is not None:
                    break
            if fin not in ("length", "stop"):
                raise RuntimeError(f"{cell}: a request finished {fin}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = eng.stats_snapshot()
        counts = dict(ck.launch_counts)
    finally:
        eng.shutdown()
        ck.set_attn_s8(None)
    out = sum(r.completion_tokens for r in reqs)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    bursts = (stats["burst_admissions"] - stats0["burst_admissions"]
              if "burst_admissions" in stats else None)
    return {"cell": cell, "requests": len(reqs),
            "prompt_tokens": [len(r.prompt_ids) for r in reqs],
            "wall_s": wall, "output_tok_per_s": out / wall,
            "ttft_p50_ms": 1e3 * statistics.median(
                r.first_token_ts - r.submit_ts for r in reqs),
            "decode_steps": steps, "ms_a_decode_step": 1e3 * wall / steps,
            "burst_admissions": bursts,
            "s8_launches": (counts.get("decode_attention_s8_paired", 0)
                            + counts.get("paged_decode_attention_s8_paired",
                                         0))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.bench_engine")
    p.add_argument("--roots", nargs="*", default=[],
                   help="checkouts whose engine to time (default: this one)")
    p.add_argument("--cells", nargs="*", default=list(CELLS),
                   choices=list(CELLS), help="cells to time (default: all)")
    p.add_argument("--repeats", type=int, default=1,
                   help="passes over the roots, every other one reversed")
    p.add_argument("--single", choices=list(CELLS), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_engine: no CUDA device", file=sys.stderr)
        return 2
    if args.single:  # one run, in a process of its own
        print(json.dumps(_run_once(args.single)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in args.roots or [here]]
    runs = []
    for cell in args.cells:
        for rep in range(args.repeats):
            for root in roots if rep % 2 == 0 else roots[::-1]:
                done = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--single",
                     cell], env={**os.environ, "PYTHONPATH": root}, cwd=root,
                    capture_output=True, text=True)
                if done.returncode:
                    sys.stderr.write(done.stderr[-4000:])
                    raise RuntimeError(f"{cell} under {root}: exit "
                                       f"{done.returncode}")
                runs.append({"root": root, **json.loads(
                    done.stdout.strip().splitlines()[-1])})
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
