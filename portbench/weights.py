"""Seeded bf16 weights in the port's tree layout, made on the device.

Both sides get these same tensors: the program quantizes and fuses them in
its set-up, the reference works its int4 codes out again from them. One
`torch.Generator` on the device draws every leaf in a fixed order, each in
one call and in the type it is served in, so the same seed gives the same
bits on every run.
"""

from __future__ import annotations

import torch


def make(cfg, seed: int, device) -> dict:
    """{"embed", "blocks": {...}, "final_norm", "lm_head"}: matrices
    [in, out] (stacked [L, in, out]) drawn N(0, 1 / fan_in) in bf16, norms
    ones; `lm_head` None for tied embeddings."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, f, v, nl = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_layers)
    q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def w(*shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                        device=device)
        return x.mul_(fan_in ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    return {
        "embed": w(v, d, fan_in=d),
        "blocks": {
            "attn_norm": ones(nl, d),
            "mlp_norm": ones(nl, d),
            "wq": w(nl, d, q_dim, fan_in=d),
            "wk": w(nl, d, kv_dim, fan_in=d),
            "wv": w(nl, d, kv_dim, fan_in=d),
            "wo": w(nl, q_dim, d, fan_in=q_dim),
            "w_gate": w(nl, d, f, fan_in=d),
            "w_up": w(nl, d, f, fan_in=d),
            "w_down": w(nl, f, d, fan_in=f),
        },
        "final_norm": ones(d),
        "lm_head": None if cfg.tie_word_embeddings else w(d, v, fan_in=d),
    }
