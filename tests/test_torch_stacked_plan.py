"""The launch plan of the stacked matmuls (K1/K33, K8 and K5,
`quant_matmul.stacked_plan` through `stacked_launch`) at every preset's
four projections: plain Python, held here on the CPU because the kernel it
drives runs only on the card (tests/test_torch_cuda.py). K1, K33 and K8
take a packed plane of K/2 rows, K5 an int8 plane of K rows: K5 has twice
the stages of 64 rows at the same K.

A plan (bt, split) must give the kernel what it takes: a token tile of 8
(M <= 8) or 64 holding all M rows, and a cluster of 1, 2, 4 or 8 blocks
that divides the strip's stages of 64 packed rows, so that each block gets
at least one stage. It fills one wave of blocks (two a multiprocessor at
bt = 8, one at bt = 64) and no more, and splits as far as that wave, the
divisibility and the cap (8 at bt = 8, 4 at bt = 64) allow, so that it
covers the card's 132 SMs wherever they let it."""

import pytest

from gabby_tpu_torch import config as cfglib
from gabby_tpu_torch.ops.cuda import quant_matmul as cqm

SMS = 132  # H100 SXM
PRESETS = ("llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")
PROJECTIONS = ("wqkv", "wo", "w_gup", "w_down")


def _shape(preset: str, proj: str):
    cfg = getattr(cfglib, preset)()
    d = cfg.hidden_size
    return {"wqkv": (d, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, d),
            "w_gup": (d, 2 * cfg.intermediate_size),
            "w_down": (cfg.intermediate_size, d)}[proj]


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("preset", PRESETS)
def test_stacked_plan_at_every_preset(preset, proj, m):
    k, n = _shape(preset, proj)
    kp, stages, strips = k // 2, k // 128, n // 128
    bt, split = cqm.stacked_plan(m, kp, n, SMS)
    assert bt == (8 if m <= 8 else 64) and m <= bt
    cap = cqm.split_cap(bt)
    assert split in (1, 2, 4, 8) and split <= cap <= cqm.MAX_SPLIT
    assert stages % split == 0 and stages // split >= 1
    slots = SMS * (2 if bt == 8 else 1)
    grid = strips * split
    assert grid <= max(slots, strips)  # one wave, unless the strips exceed
    # split no further only where the cap, the stages or the wave stop it
    assert (2 * split > cap or stages % (2 * split)
            or strips * 2 * split > slots)
    if bt == 8 and strips < SMS and split < cap and stages % (2 * split) == 0:
        assert grid >= SMS  # the grid covers the SMs wherever it can


def test_stacked_plan_at_the_1b_shapes():
    """The splits the card measured best (PERF.md §6): [8, 8, 2, 8] at
    M = 8 and [4, 4, 1, 4] at M = 64 for wqkv, wo, w_gup, w_down."""
    for m, want in ((8, [8, 8, 2, 8]), (64, [4, 4, 1, 4])):
        got = [cqm.stacked_plan(m, k // 2, n, SMS)[1]
               for k, n in (_shape("llama32_1b", p) for p in PROJECTIONS)]
        assert got == want


@pytest.mark.parametrize("m,kp,n", [(0, 1024, 2048), (65, 1024, 2048),
                                    (8, 1000, 2048), (8, 1024, 2000),
                                    (8, 0, 2048), (8, 1024, 0)])
def test_stacked_plan_refuses_what_the_kernel_does_not_take(m, kp, n):
    with pytest.raises(ValueError):
        cqm.stacked_plan(m, kp, n, SMS)


# the stacked kernels by counter, and the weight rows a K row
STACKED = {"int4_matmul_w4a8_stacked": 2, "int8_matmul_stacked": 1}


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(STACKED))
def test_int8_forms_plan_at_every_preset(name, preset, proj, m):
    """K8's plan is K1's (the same packed plane); K5's counts K / 64
    stages. Either fills the kernel's rules at every preset."""
    k, n = _shape(preset, proj)
    stages, strips = k // (64 * STACKED[name]), n // 128
    bt, split = cqm.stacked_launch(name, m, k, n, SMS)
    assert (bt, split) == cqm.stacked_plan(m, k // STACKED[name], n, SMS)
    assert bt == (8 if m <= 8 else 64) and m <= bt
    cap = cqm.split_cap(bt)
    assert split in (1, 2, 4, 8) and split <= cap
    assert stages % split == 0 and stages // split >= 1
    slots = SMS * (2 if bt == 8 else 1)
    assert strips * split <= max(slots, strips)
    assert (2 * split > cap or stages % (2 * split)
            or strips * 2 * split > slots)


@pytest.mark.parametrize("name,m,k,n", [
    ("int8_matmul_stacked", 8, 2016, 2048),   # K not a multiple of 64
    ("int8_matmul_stacked", 8, 2048, 2000),   # N not a multiple of 128
    ("int8_matmul_stacked", 0, 2048, 2048),
    ("int8_matmul_stacked", 65, 2048, 2048),
    ("int4_matmul_w4a8_stacked", 8, 2112, 2048),  # K not a multiple of 128
    ("int4_matmul_w4a8_stacked", 8, 2047, 2048),
    ("int4_matmul_w4a8_stacked", 8, 2048, 2112),
    ("int4_matmul_w4a8_stacked", 0, 2048, 2048),
    ("int4_matmul_w4a8_stacked", 65, 2048, 2048)])
def test_int8_forms_refuse_what_their_kernel_does_not_take(name, m, k, n):
    with pytest.raises(ValueError):
        cqm.stacked_launch(name, m, k, n, SMS)


def test_int8_form_takes_a_k_that_int4_refuses():
    """K = 2112 is 33 stages of 64 int8 rows, but 16.5 of 64 packed rows."""
    assert cqm.stacked_launch("int8_matmul_stacked", 8, 2112, 2048, SMS)
    with pytest.raises(ValueError):
        cqm.stacked_launch("int4_matmul_stacked", 8, 2112, 2048, SMS)
