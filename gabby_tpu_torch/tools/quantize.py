"""Offline quantization: HF checkpoint -> pre-quantized gabby checkpoint
(counterpart of gabby_tpu/tools/quantize.py; the directories it writes
load in either package).

Quantize once, serve many times: serving cold-start skips the per-layer
quantization pass and streams int codes straight to the device. The output
directory is self-contained (tokenizer/config copied) and loads via the
same `--model-dir` flag:

  python -m gabby_tpu_torch.tools.quantize --model-dir ~/hf/Llama-3.2-1B \
      --out ~/gabby/llama1b-int4 --bits 4
  python -m gabby_tpu_torch.server --model-dir ~/gabby/llama1b-int4 --kv-quant
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.tools.quantize")
    p.add_argument("--model-dir", required=True, help="source HF checkpoint")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--bits", type=int, default=8, choices=[4, 8])
    p.add_argument("--device", default="cuda",
                   help="torch device to quantize on (cuda, or cpu)")
    args = p.parse_args(argv)

    from gabby_tpu_torch import loader

    cfg, params, _ = loader.load_model_dir(
        args.model_dir, dtype=torch.bfloat16, quant_bits=args.bits,
        device=args.device)
    loader.save_quantized(args.out, cfg, params, args.bits,
                          src_dir=args.model_dir)
    print(f"wrote {args.out} (bits={args.bits})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
