"""The published block, float32: RMSNorm, rotate-half RoPE, grouped-query
causal attention, SwiGLU, no biases, no qk-norm, an untied or tied int4
unembed (the HF Llama and Mistral forward with `rope_scaling` null and no
sliding window). Runs layer by layer over every sequence at once, the
matrix products in blocks of rows, so that 7B-class weights fit beside the
activations; each layer's weights are dequantized in float32 when it is
reached and dropped after it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import quant

ROWS = 8192       # rows of one block of a matrix product
Q_ROWS = 512      # query rows of one block of attention


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[i:i + ROWS] @ w for i in range(0, x.shape[0], ROWS)])


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1."""
    t = x.shape[0]
    freqs = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(emb) + rot * torch.sin(emb)


def _attention(q, k, v, group: int) -> torch.Tensor:
    """Causal attention of one sequence: q [T, H, hd], k, v [T, Hk, hd]."""
    t, heads, hd = q.shape
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, T, hd]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) * hd ** -0.5
    out = torch.empty_like(qh)
    for s in range(0, t, Q_ROWS):
        e = min(t, s + Q_ROWS)
        scores = qh[:, s:e] @ k[:, :e].transpose(1, 2)  # [H, rows, e]
        mask = (torch.arange(s, e, device=q.device)[:, None]
                >= torch.arange(e, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, s:e] = torch.softmax(scores, dim=-1) @ v[:, :e]
    return out.transpose(0, 1).reshape(t, heads * hd)


def inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return torch.from_numpy((1.0 / theta ** exps).astype(np.float32)).to(device)


def logits(shape, weights: dict, seqs: list[list[int]],
           starts: list[int]) -> list[torch.Tensor]:
    """For each token sequence, the float32 logits [len - start, vocab] at
    positions start-1 .. len-2 (what predicts tokens start .. len-1).
    `shape`: hidden_size, intermediate_size, num_layers, num_heads,
    num_kv_heads, head_dim, rms_norm_eps, rope_theta, vocab_size,
    tie_word_embeddings."""
    dev = weights["embed"].device
    lens = [len(s) for s in seqs]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    with torch.no_grad(), exact_f32():
        ids = torch.tensor([i for s in seqs for i in s], device=dev)
        x = weights["embed"][ids].float()
        freq = inv_freq(shape.head_dim, shape.rope_theta, dev)
        nh, nk, hd = shape.num_heads, shape.num_kv_heads, shape.head_dim
        b = weights["blocks"]
        for layer in range(shape.num_layers):
            wq, wk, wv = (quant.int4_channel(b[n][layer])
                          for n in ("wq", "wk", "wv"))
            h = _rms(x, b["attn_norm"][layer], shape.rms_norm_eps)
            q, k, v = _mm(h, wq), _mm(h, wk), _mm(h, wv)
            del wq, wk, wv, h
            attn = torch.empty_like(q)
            for i in range(len(seqs)):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                qi = _rope(q[lo:hi].reshape(-1, nh, hd), freq)
                ki = _rope(k[lo:hi].reshape(-1, nk, hd), freq)
                vi = v[lo:hi].reshape(-1, nk, hd)
                attn[lo:hi] = _attention(qi, ki, vi, nh // nk)
            del q, k, v
            x = x + _mm(attn, quant.int4_channel(b["wo"][layer]))
            del attn
            h = _rms(x, b["mlp_norm"][layer], shape.rms_norm_eps)
            wg = quant.int4_channel(b["w_gate"][layer])
            wu = quant.int4_channel(b["w_up"][layer])
            wd = quant.int4_channel(b["w_down"][layer])
            for s in range(0, x.shape[0], ROWS):
                hs = h[s:s + ROWS]
                x[s:s + ROWS] += (F.silu(hs @ wg) * (hs @ wu)) @ wd
            del wg, wu, wd, h
        table = (weights["embed"].T if shape.tie_word_embeddings
                 else weights["lm_head"])
        w_lm = quant.int4_grouped(table, 256)
        out = []
        for i, st in enumerate(starts):
            lo = int(bounds[i])
            rows = x[lo + st - 1: lo + lens[i] - 1]
            out.append(_rms(rows, weights["final_norm"], shape.rms_norm_eps)
                       @ w_lm)
        return out
