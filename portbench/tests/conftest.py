"""Fixtures of the benchmark's CPU tests: a throwaway root holding a
BENCHMARK.json of tiny cells, their configuration and traffic files and
the benchmark's metric readers, which the harness finds by name."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench import spec

TINY = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "rope_scaling": None, "tie_word_embeddings": False,
    "bos_token_id": 0, "eos_token_id": 1, "reduced": [],
    "assumed": {"max_seq": 256},
    # sound tiny runs read about 0.05 and 0.15 (CPU, bf16 activations)
    "check": {"max_gap": 0.3, "max_lp_err": 0.5},
}
TRAFFIC = {
    "chat": {"loop": "open", "rate_rps": 20, "slots": 4,
             "prompt": {"median": 40, "sigma": 0.8, "min": 4, "max": 150},
             "output": {"median": 12, "sigma": 0.5, "min": 4, "max": 40},
             "preroll_s": 0.5, "trace_slice_s": 0.4},
    "batch": {"loop": "closed", "clients": 4, "slots": 4, "block": 8,
              "prompt": {"median": 60, "sigma": 0.5, "min": 8, "max": 150},
              "output": {"median": 20, "sigma": 0.5, "min": 8, "max": 40},
              "preroll_s": 0.5, "trace_slice_s": 0.4},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_root(path: str, tiny=TINY, traffic=TRAFFIC) -> str:
    """A root with tiny cells `tiny.<traffic>` over every metric of the
    repository's BENCHMARK.json whose readers need no device."""
    bench = spec.benchmark()
    os.makedirs(os.path.join(path, "portbench", "configs"))
    os.makedirs(os.path.join(path, "portbench", "traffic"))
    shutil.copytree(os.path.join(spec.ROOT, "portbench", "metrics"),
                    os.path.join(path, "portbench", "metrics"))
    with open(os.path.join(path, "portbench", "configs", "tiny.json"),
              "w") as f:
        json.dump(tiny, f)
    for name, t in traffic.items():
        with open(os.path.join(path, "portbench", "traffic",
                               name + ".json"), "w") as f:
            json.dump(t, f)
    cells = [f"tiny.{n}" for n in traffic]
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": c, "config": "tiny",
                           "traffic": c.split(".")[1], "chips": 1,
                           "why": "test"} for c in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = cells
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture()
def tiny_root(tmp_path):
    return make_root(str(tmp_path / "root"))


@pytest.fixture()
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
