"""The harness end to end on the CPU at the tiny size: files found by
name alone, the check failing on a broken timed path, the import check,
and the command's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, imports, spec
from portbench.tests.conftest import TINY, TRAFFIC, make_root

from gabby_tpu_torch.models import llama
from gabby_tpu_torch.runtime import generate

CPU = torch.device("cpu")
SECONDS = 1.5


def _run(root, cell, seed=11, traced=False, **kw):
    return harness.run(spec.benchmark(root), cell, seed, SECONDS, traced,
                       CPU, time.monotonic(), root=root, **kw)


def test_new_config_traffic_and_metric_from_files_alone(tmp_path):
    root = make_root(str(tmp_path / "root"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny_mha.json"), "w") as f:
        json.dump(dict(TINY, num_key_value_heads=4), f)
    with open(os.path.join(pb, "traffic", "short.json"), "w") as f:
        json.dump(dict(TRAFFIC["batch"], clients=3,
                       output={"median": 14, "sigma": 0.3, "min": 10,
                               "max": 20}), f)
    with open(os.path.join(pb, "metrics", "probe.requests.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records))\n")
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "tiny_mha", "source": "test",
                             "file": "portbench/configs/tiny_mha.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_mha.short",
                               "config": "tiny_mha", "traffic": "short",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        m["workloads"].append("tiny_mha.short")
    bench["per_layer"].append({
        "name": "probe.requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "output_tok_s", "workloads": ["tiny_mha.short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res, nums, _ = _run(root, "tiny_mha.short", traced=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["probe.requests"]["value"] > 3
    res, _, _ = _run(root, "tiny_mha.short")
    assert {"setup_s", "output_tok_s"} <= set(res["metrics"])
    assert res["latency"]["tpot_n"] > 0
    assert list(res)[-1] == "check"


def test_sound_run_is_correct(tiny_root):
    res, nums, _ = _run(tiny_root, "tiny.chat")
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 10
    assert nums["tokens"] >= 100 and nums["requests"] >= 8
    assert res["device"]["platform"] == "cpu"


def test_token_altered_where_produced_fails(tiny_root, monkeypatch):
    loop = generate.decode_loop
    vocab = TINY["vocab_size"]

    def altered(*a, **k):
        out = list(loop(*a, **k))
        out[0] = (out[0] + 1) % vocab   # the tokens served
        out[3] = (out[3] + 1) % vocab   # and fed to the next step
        return tuple(out)
    monkeypatch.setattr(generate, "decode_loop", altered)
    res, nums, _ = _run(tiny_root, "tiny.batch")
    assert not res["correct"]
    assert nums["max_gap"] > TINY["check"]["max_gap"]


def test_step_leaving_the_cache_unchanged_fails(tiny_root, monkeypatch):
    step = llama.decode_step

    def frozen(params, cfg, tokens, positions, cache, **k):
        saved = [t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                     cache.v_scale)]
        logits, cache = step(params, cfg, tokens, positions, cache, **k)
        for t, s in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                        saved):
            t.copy_(s)
        return logits, cache
    monkeypatch.setattr(llama, "decode_step", frozen)
    res, nums, _ = _run(tiny_root, "tiny.batch")
    assert not res["correct"], nums


def test_import_check_compares_whole_top_level_names():
    assert imports.forbidden(["gabby_tpu_torch", "gabby_tpu_torch.ops",
                              "jaxtyping", "flaxen.x", "numpy"]) == []
    assert imports.forbidden(["jax.numpy", "gabby_tpu.ops.quant",
                              "jaxlib", "flax"]) == ["flax", "gabby_tpu",
                                                      "jax", "jaxlib"]


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys, time, torch\n"
            "from portbench import harness, imports, spec\n"
            f"root = {tiny_root!r}\n"
            "harness.run(spec.benchmark(root), 'tiny.chat', 3, 1.0, True,"
            " torch.device('cpu'), time.monotonic(), root=root)\n"
            "print(imports.forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mistral7b.chat", "--seed", "4294967301", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_command_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mistral7b.chat", "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
