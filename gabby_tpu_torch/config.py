"""Model configuration for the Llama-3 family.

A copy of gabby_tpu/config.py for the PyTorch port (which imports nothing
of the JAX package): a typed, hashable ModelConfig built from a parsed
HuggingFace `config.json`, and the presets. `fused_tp` is the shard-block
layout of fused projections (llama.fuse_projections) for tensor-parallel
serving (gabby_tpu_torch/parallel/).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 wavelength-dependent rope scaling ("rope_type": "llama3")."""

    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = RopeScaling()
    max_seq_len: int = 8192  # serving-time cap, not the HF 128k training cap
    tie_word_embeddings: bool = True
    # Special token ids (Llama-3 tokenizer). Overridden by generation_config.json.
    bos_token_id: int = 128000
    eos_token_ids: tuple[int, ...] = (128001, 128008, 128009)
    # Shard-block layout of fused projection weights: the `tp` the tree
    # was fused with (llama.fuse_projections). 1 = plain concatenation;
    # set through dataclasses.replace when fusing for tp ranks.
    fused_tp: int = 1

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def from_hf_dict(d: dict[str, Any], **overrides: Any) -> "ModelConfig":
        """Build from a parsed HuggingFace config.json (llama architecture)."""
        rs = d.get("rope_scaling")
        scaling = None
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            scaling = RopeScaling(
                factor=float(rs["factor"]),
                low_freq_factor=float(rs["low_freq_factor"]),
                high_freq_factor=float(rs["high_freq_factor"]),
                original_max_position_embeddings=int(
                    rs["original_max_position_embeddings"]
                ),
            )
        num_heads = int(d["num_attention_heads"])
        head_dim = int(d.get("head_dim") or d["hidden_size"] // num_heads)
        eos = d.get("eos_token_id", 128009)
        eos = tuple(eos) if isinstance(eos, (list, tuple)) else (int(eos),)
        kw: dict[str, Any] = dict(
            vocab_size=int(d["vocab_size"]),
            hidden_size=int(d["hidden_size"]),
            intermediate_size=int(d["intermediate_size"]),
            num_layers=int(d["num_hidden_layers"]),
            num_heads=num_heads,
            num_kv_heads=int(d.get("num_key_value_heads", num_heads)),
            head_dim=head_dim,
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-5)),
            rope_theta=float(d.get("rope_theta", 500000.0)),
            rope_scaling=scaling,
            tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
            bos_token_id=int(d.get("bos_token_id", 128000)),
            eos_token_ids=eos,
        )
        kw.update(overrides)
        return ModelConfig(**kw)

    @staticmethod
    def from_json_file(path: str, **overrides: Any) -> "ModelConfig":
        with open(path) as f:
            return ModelConfig.from_hf_dict(json.load(f), **overrides)


# ---- Presets (shapes from the published HF configs of each model) ----


def llama32_1b(**kw: Any) -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0, tie_word_embeddings=True, **kw)


def llama32_3b(**kw: Any) -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, tie_word_embeddings=True, **kw)


def llama3_8b(**kw: Any) -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rope_scaling=None, tie_word_embeddings=False, **kw)


def llama3_70b(**kw: Any) -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rope_scaling=None, tie_word_embeddings=False, **kw)


def tiny(**kw: Any) -> ModelConfig:
    """A toy config for tests: runs in milliseconds on CPU."""
    base = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, rope_scaling=None, max_seq_len=128,
        tie_word_embeddings=False, bos_token_id=0, eos_token_ids=(1,),
    )
    base.update(kw)
    return ModelConfig(**base)

