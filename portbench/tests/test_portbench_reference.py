"""The plain reference against the port on the tiny preset's shapes: its
frozen int4 arithmetic gives the port's dequantized weights exactly, and
its float32 forward is near the port's full forward from the same seeded
bf16 weights."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import weights
from portbench.reference import model as ref
from portbench.reference import quant as rq

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops import quant


def _shape(cfg, tied):
    return types.SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=tied)


@pytest.mark.parametrize("tied", [False, True])
def test_frozen_int4_equals_the_ports(tied):
    cfg = cfglib.tiny(tie_word_embeddings=tied)
    w = weights.make(_shape(cfg, tied), 77, "cpu")
    q = quant.quantize_tree(w, 4, unembed_bits=4, unembed_group=256)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for layer in range(cfg.num_layers):
            port = quant.dequantize(
                quant.QTensor(q["blocks"][name].q[layer],
                              q["blocks"][name].scale[layer], 4),
                torch.float32)
            assert torch.equal(rq.int4_channel(w["blocks"][name][layer]),
                               port), (name, layer)
    table = w["embed"].T if tied else w["lm_head"]
    port = quant.dequantize(q["lm_head"], torch.float32)[:, :cfg.vocab_size]
    assert torch.equal(rq.int4_grouped(table, 256), port)


@pytest.mark.parametrize("tied", [False, True])
def test_reference_forward_near_the_ports(tied):
    cfg = cfglib.tiny(tie_word_embeddings=tied)
    shape = _shape(cfg, tied)
    w = weights.make(shape, 5, "cpu")
    params = llama.fuse_projections(
        quant.quantize_tree(w, 4, unembed_bits=4, unembed_group=256))
    gen = torch.Generator().manual_seed(3)
    seqs = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in (9, 40)]
    got = ref.logits(shape, w, seqs, [1, 1])
    for s, lg in zip(seqs, got):
        port = llama.forward(params, cfg, torch.tensor([s]))[0, :-1]
        assert lg.shape == port.shape
        # the port keeps its activations in bf16 (2^-8 relative a value)
        err = (lg - port).abs().max().item()
        assert err < 0.03 * lg.abs().max().item(), err
        # where the argmax differs, it is a near tie of the reference's
        pick = lg.gather(1, port.argmax(-1, keepdim=True))[:, 0]
        gap = (lg.max(-1).values - pick).max().item()
        assert gap < 0.03 * lg.abs().max().item(), gap
