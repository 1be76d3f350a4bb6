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


@torch.no_grad()
def decode_nll(params, cfg: ModelConfig, token_stream: np.ndarray, *,
               prefill: int = 16, steps: int = 48, max_seq: int = 128,
               paired: bool = False) -> float:
    """Mean teacher-forced NLL of tokens prefill .. prefill + steps - 1
    through the serving path: one `prefill_slot` chunk of `prefill` tokens,
    then `decode_step` token by token, over an int8 cache of one slot
    (paired or not). This is what the decode-attention form moves
    (`ops.cuda.attn_s8`), so the s8 gate compares two calls of it; the
    cache-free `ppl_from_tokens` never reaches decode attention."""
    from gabby_tpu_torch.runtime.generate import token_logprob
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    device = params["embed"].device
    toks = torch.from_numpy(np.asarray(
        token_stream[:prefill + steps], np.int64)).to(device)
    cache = create_cache(cfg, 1, max_seq, quantized=True, paired=paired,
                         device=device)
    cur, cache = llama.prefill_slot(params, cfg, toks[:prefill], prefill, 0,
                                    0, cache)
    nll = 0.0
    for i in range(prefill, prefill + steps):
        nll -= float(token_logprob(cur, toks[i]))
        logits, cache = llama.decode_step(
            params, cfg, toks[i:i + 1].to(torch.int32),
            torch.tensor([i], dtype=torch.int32, device=device), cache)
        cur = logits[0]
    return nll / steps


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
