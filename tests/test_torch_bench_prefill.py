"""The A/B timer of the prefill attention kernels
(gabby_tpu_torch/tools/bench_prefill_attention.py) on the CPU: with
`--device cpu` it runs its whole flow on the plain versions at small
shapes, each checkout given to `--roots` in a process of its own. Two
copies of this checkout must give the same digests, the paired forms the
unpaired forms' bits (the plain versions un-pair, then run the same
arithmetic), and the plain version against itself no difference."""

import json
import os

from gabby_tpu_torch.tools import bench_prefill_attention as bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prefill_attention_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--roots", ROOT, ROOT]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "cpu"
    assert out["K4_same_bits_across_roots"] is True
    assert out["K21_same_bits_across_roots"] is True
    assert out["K23_equals_K22"] == [True, True]
    assert len(out["runs"]) == 2
    for run in out["runs"]:
        assert set(run["cases"]) == set(bench.CPU_CASES)
        for case in run["cases"].values():
            for form in ("K22", "K23"):
                assert case[form]["max_abs_err"] == 0.0
                assert case[form]["finite"] is True
                assert case[form]["ms"] > 0
                assert case[form]["host_us_a_call"] > 0
            assert case["K21_equals_K4"] is True
            assert case["bound_ms"] > 0 and case["sdpa_ms"] > 0
