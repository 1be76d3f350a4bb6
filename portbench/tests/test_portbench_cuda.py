"""On the card: the check's control comes out not correct in every cell,
at the cell's own sizes and load, on three seeds, while the program as
served comes out correct on the same seeds, over a 30 s window (with the
pre-roll, long enough that finished requests fill the sample); and the
port's own recipe for a tied int4 unembed reaches K2. Run on the chip:

    python -m pytest -q portbench/tests/test_portbench_cuda.py
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness, spec

pytestmark = pytest.mark.cuda

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    bench = spec.benchmark()
    for seed in SEEDS:
        res, nums, _ = harness.run(bench, cell, seed, 30.0, False, card,
                                   time.monotonic(), control=True)
        assert not res["correct"], (seed, nums)
        res, nums, _ = harness.run(bench, cell, seed, 30.0, False, card,
                                   time.monotonic())
        assert res["correct"], (seed, nums)


def test_tied_int4_unembed_reaches_k2(card):
    """quantize_tree's tied branch, at a vocab that needs no padding (as
    SmolLM2-1.7B's 49152 = 24 x 2048), gives the product that the loader's
    contiguous copy of the table gives. It fails while that branch hands
    K2 the transposed view's non-contiguous codes; once it passes, the
    harness's own copy of the table for tied models (harness._served_params)
    can go."""
    from gabby_tpu_torch.ops import quant

    g = torch.Generator(device=card).manual_seed(5)
    embed = torch.randn(4096, 512, generator=g, device=card,
                        dtype=torch.bfloat16)
    x = torch.randn(8, 512, generator=g, device=card, dtype=torch.bfloat16)
    tied = quant.quantize_tree({"embed": embed, "lm_head": None}, 4,
                               unembed_bits=4, unembed_group=256)
    loader = quant.quantize_unembed_table(embed.T.contiguous(), bits=4,
                                          group=256)
    assert torch.equal(quant.qlinear(x, tied["lm_head"]),
                       quant.qlinear(x, loader))
