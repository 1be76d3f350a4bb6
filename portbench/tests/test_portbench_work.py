"""The roofline's operations and bytes against hand sums."""

from __future__ import annotations

import types

import pytest

from portbench import work

SHAPE = types.SimpleNamespace(
    hidden_size=256, intermediate_size=512, num_layers=3, num_heads=8,
    num_kv_heads=2, head_dim=32, vocab_size=1024)


def test_decode_matmuls_hand_sum():
    m = 5
    # per layer (K, N): qkv (256, 256 + 128), wo (256, 256), gate|up
    # (256, 1024), down (512, 256)
    mats = [(256, 384), (256, 256), (256, 1024), (512, 256)]
    wbytes = sum(k * n / 2 + n * 4 for k, n in mats)
    act = sum(m * (k + n) * 2 for k, n in mats)
    flops = sum(2 * m * k * n for k, n in mats)
    un_bytes = 256 * 1024 / 2 + (256 // 256) * 1024 * 4 + m * (256 * 2 +
                                                              1024 * 4)
    w = work.matmuls(SHAPE, m, m)
    assert w.bytes == pytest.approx(3 * (wbytes + act) + un_bytes)
    assert w.flops == pytest.approx(3 * flops + 2 * m * 256 * 1024)
    assert w.int8_ops == 0


def test_decode_attention_hand_sum():
    rows = [10, 100]
    per_row = 2 * (2 * 32 + 2 * 4)  # k and v codes + scales, 2 kv heads
    io = (2 * 8 * 32 + 2 * 2 * 32) * 2  # q, out, fresh k, v in bf16
    w = work.decode_attention(SHAPE, rows)
    assert w.bytes == pytest.approx(3 * sum(r * per_row + io for r in rows))
    assert w.int8_ops == pytest.approx(3 * sum(4 * 8 * 32 * (r + 1)
                                               for r in rows))


def test_prefill_attention_hand_sum():
    t, off = 7, 20
    pairs = sum(off + i + 1 for i in range(t))
    w = work.prefill_attention(SHAPE, t, off)
    assert w.flops == pytest.approx(3 * 4 * 8 * 32 * pairs)
    assert w.bytes == pytest.approx(
        3 * (off * 2 * (2 * 32 + 8) + t * (2 * 8 * 32 + 2 * 2 * 32) * 2))


def test_least_time_takes_the_slower_bound():
    w = work.Work(flops=989e12, bytes=3.35e12 / 2)
    assert w.least_s() == pytest.approx(1.0)
    w = work.Work(int8_ops=1979e12 / 4, bytes=3.35e12)
    assert w.least_s() == pytest.approx(1.0)
