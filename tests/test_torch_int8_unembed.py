"""The launch of the int8 unembed (K6, `quant_matmul.int8_unembed_launch`)
at every preset's unembed: plain Python, held here on the CPU because the
kernel it drives runs only on the card (tests/test_torch_cuda.py).

K6 is the int8 form of K2's persistent kernel (csrc/quant_matmul_unembed.cuh):
a stage is 64 int8 rows x 128 channels, so K must be a multiple of 64; TMA
copies the [K, N] plane with a row stride of N bytes, which must be a
multiple of 16; the token tile is 8 (M <= 8) or 64, so M is 1..64. The
persistent grid is the 128-channel strips (the last one may pass N) or two
blocks a multiprocessor at the n8 tile, one at the n64 tile, whichever is
fewer. Every other shape is refused with ValueError: there is no fallback."""

import pytest
import torch

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm

SMS = 132  # H100 SXM
PRESETS = ("llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")


@pytest.mark.parametrize("m", [1, 8, 9, 13, 64])
@pytest.mark.parametrize("preset", PRESETS)
def test_int8_unembed_launch_at_every_preset(preset, m):
    cfg = getattr(cfglib, preset)()
    k, n = cfg.hidden_size, cfg.vocab_size
    bt, blocks = cqm.int8_unembed_launch(m, k, n, SMS)
    assert bt == (8 if m <= 8 else 64) and m <= bt
    strips = -(-n // 128)
    assert blocks == min(strips, SMS * (2 if bt == 8 else 1))
    # every strip has a block: blocks b, b + blocks, ... cover 0..strips-1
    assert sorted(s for b in range(blocks)
                  for s in range(b, strips, blocks)) == list(range(strips))


@pytest.mark.parametrize("k", [64, 2048, 3072, 4096, 8192])
@pytest.mark.parametrize("n", [16, 32016, 128256, 129024])
def test_int8_unembed_launch_takes_its_shapes(k, n):
    bt, blocks = cqm.int8_unembed_launch(8, k, n, SMS)
    assert (bt, blocks) == (8, min(-(-n // 128), 2 * SMS))


@pytest.mark.parametrize("m,k,n,what", [
    (8, 96, 128256, "multiple of 64"),    # K not a multiple of a stage
    (8, 2080, 128256, "multiple of 64"),
    (8, 0, 128256, "multiple of 64"),
    (8, 2048, 128250, "multiple of 16"),  # N not a multiple of 16
    (8, 2048, 120, "multiple of 16"),
    (8, 2048, 0, "multiple of 16"),
    (0, 2048, 128256, "rows"),            # M outside 1..64
    (65, 2048, 128256, "rows"),
])
def test_int8_unembed_launch_refuses_what_its_kernel_does_not_take(m, k, n,
                                                                   what):
    with pytest.raises(ValueError, match=what):
        cqm.int8_unembed_launch(m, k, n, SMS)


def test_int8_unembed_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version at any shape, the
    ones the card refuses too."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 96), generator=g).bfloat16()
    codes = torch.randint(-128, 128, (96, 40), generator=g,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.rand((40,), generator=g) * 0.01
    out = cqm.qmatmul_int8(x, codes, scale)
    ref = (x.float() @ codes.float() * scale).bfloat16()
    assert torch.equal(out, ref)
