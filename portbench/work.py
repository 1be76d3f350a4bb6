"""The work a served step needs, in operations and bytes, from the model's
shapes and the counted steps, chunks and live rows; and the H100's peaks.

Each input byte counts read once and each output byte written once,
whatever a kernel reads again, and only the work these inputs need: the
live lanes of a decode step, the valid tokens of a padded chunk, the live
cache rows of each slot. So a roofline share reads the same work whatever
implementation a later change puts under the span.

Serving recipe counted: int4 projections (half a byte a weight plus one
f32 scale an output channel), the int4 unembed with one f32 scale per 256
inputs of a vocab column, bf16 activations in and out (f32 logits), an
int8 cache of one f32 scale per (row, kv head) for each of k and v.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, int8 tensor cores,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass
class Work:
    flops: float = 0.0      # counted at the bf16 peak
    int8_ops: float = 0.0   # counted at the int8 peak
    bytes: float = 0.0

    def __iadd__(self, o: "Work") -> "Work":
        self.flops += o.flops
        self.int8_ops += o.int8_ops
        self.bytes += o.bytes
        return self

    def least_s(self) -> float:
        """The least time the chip could take: its slower bound."""
        return max(self.bytes / PEAK_BYTES,
                   self.flops / PEAK_BF16_FLOPS + self.int8_ops / PEAK_INT8_OPS)

    def ops(self) -> float:
        return self.flops + self.int8_ops


def projections(shape) -> list[tuple[int, int]]:
    """(K, N) of one layer's products, as served (q|k|v and gate|up fused:
    the same weights and work as apart)."""
    d, f = shape.hidden_size, shape.intermediate_size
    q = shape.num_heads * shape.head_dim
    kv = shape.num_kv_heads * shape.head_dim
    return [(d, q + 2 * kv), (q, d), (d, 2 * f), (f, d)]


def _int4_bytes(k: int, n: int, group: int = 0) -> float:
    return k * n / 2 + (k // group if group else 1) * n * 4


def matmuls(shape, rows: int, unembed_rows: int) -> Work:
    """Every layer's products over `rows` token rows, then the unembed over
    `unembed_rows`: weights once, activations in and out once."""
    w = Work()
    for k, n in projections(shape):
        w.bytes += shape.num_layers * (_int4_bytes(k, n)
                                       + rows * (k + n) * 2)
        w.flops += shape.num_layers * 2.0 * rows * k * n
    if unembed_rows:
        d, v = shape.hidden_size, shape.vocab_size
        w.bytes += _int4_bytes(d, v, 256) + unembed_rows * (d * 2 + v * 4)
        w.flops += 2.0 * unembed_rows * d * v
    return w


def row_bytes(shape) -> int:
    """One cache row of one layer: int8 k and v codes plus their scales."""
    return shape.num_kv_heads * (2 * shape.head_dim + 2 * 4)


def decode_attention(shape, rows: list[int]) -> Work:
    """One decode step's attention in every layer: each live slot reads its
    `rows` cache rows before the fresh one (int8, with scales), takes its
    fresh k and v (bf16) and its q, writes its output; scores and values
    are 4 x head_dim operations a (query head, row), on the int8 path."""
    nh, hd = shape.num_heads, shape.head_dim
    per_slot_io = (2 * nh * hd + 2 * shape.num_kv_heads * hd) * 2
    w = Work()
    for r in rows:
        w.bytes += shape.num_layers * (r * row_bytes(shape) + per_slot_io)
        w.int8_ops += shape.num_layers * 4.0 * nh * hd * (r + 1)
    return w


def prefill_attention(shape, tokens: int, offset: int) -> Work:
    """One chunk of `tokens` valid tokens at `offset` in every layer: the
    slot's earlier rows read once (int8, with scales), the chunk's q, k, v
    in and its output out (bf16); causal pairs x 4 x head_dim operations a
    query head."""
    nh, nk, hd = shape.num_heads, shape.num_kv_heads, shape.head_dim
    pairs = tokens * offset + tokens * (tokens + 1) / 2
    w = Work()
    w.bytes = shape.num_layers * (offset * row_bytes(shape)
                                  + tokens * (2 * nh * hd + 2 * nk * hd) * 2)
    w.flops = shape.num_layers * 4.0 * nh * hd * pairs
    return w
