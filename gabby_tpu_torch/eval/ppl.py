"""Perplexity evaluation — the quantization quality gate (counterpart of
gabby_tpu/eval/ppl.py).

The protocol is the standard sliding-window one: the corpus is tokenized to
one stream, split into fixed windows of `seq_len`, and ppl = exp(mean NLL
over all predicted positions) — window position 0 is never scored (no
context).

Data: the harness takes a LOCAL text file (e.g. WikiText-2's
`wiki.test.raw`) or a raw token array; tests drive it with a synthetic
corpus, which measures the same quantization DELTAS the gates care about
(a gate is relative to the same data under bf16, not an absolute number).

Usage:
  python -m gabby_tpu_torch.eval.ppl --model-dir ~/m/llama-3.2-1b \
      --text wiki.test.raw --quant 8
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.models import llama


@torch.no_grad()
def _window_nll(params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: [B, T] -> (sum NLL over positions 1..T-1, count)."""
    logits = llama.forward(params, cfg, tokens)  # [B, T, V] f32
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.sum(), nll.numel()


def ppl_from_tokens(params, cfg: ModelConfig, token_stream: np.ndarray, *,
                    seq_len: int = 512, batch: int = 4,
                    max_windows: Optional[int] = None) -> float:
    """Perplexity of a flat token stream under the model, on the device
    the params lie on."""
    n = (len(token_stream) // seq_len) * seq_len
    windows = np.asarray(token_stream[:n], np.int64).reshape(-1, seq_len)
    if max_windows:
        windows = windows[:max_windows]
    device = params["embed"].device
    total, count = 0.0, 0
    for i in range(0, len(windows), batch):
        chunk = torch.from_numpy(windows[i:i + batch]).to(device)
        s, c = _window_nll(params, cfg, chunk)
        total += float(s)
        count += int(c)
    return float(np.exp(total / max(count, 1)))


def evaluate_ppl(params, cfg: ModelConfig, text: str, tokenizer, *,
                 seq_len: int = 512, batch: int = 4,
                 max_windows: Optional[int] = None) -> float:
    ids = tokenizer.encode(text, allow_special=False)
    return ppl_from_tokens(params, cfg, np.asarray(ids, np.int64),
                           seq_len=seq_len, batch=batch,
                           max_windows=max_windows)


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json as jsonlib

    p = argparse.ArgumentParser(prog="gabby_tpu_torch.eval.ppl")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--text", required=True,
                   help="local corpus file (e.g. WikiText-2 wiki.test.raw)")
    p.add_argument("--quant", type=int, default=0, choices=[0, 4, 8])
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-windows", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    args = p.parse_args(argv)

    from gabby_tpu_torch.loader import load_model_dir
    bits = args.quant if args.quant in (4, 8) else None
    cfg, params, tokenizer = load_model_dir(
        args.model_dir, dtype=torch.bfloat16, quant_bits=bits,
        device=args.device)
    with open(args.text, encoding="utf-8") as f:
        text = f.read()
    ppl = evaluate_ppl(params, cfg, text, tokenizer,
                       seq_len=args.seq_len, batch=args.batch,
                       max_windows=args.max_windows or None)
    print(jsonlib.dumps({"ppl": round(ppl, 4), "quant": args.quant or "bf16",
                         "seq_len": args.seq_len}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
