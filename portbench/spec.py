"""BENCHMARK.json and the files it names, found by name under a root.

A cell (`workloads` entry) names its configuration, whose `file` holds
the sizes as run, and its traffic mix, `portbench/traffic/<traffic>.json`.
Each metric, end to end or per layer, is read by its own
`portbench/metrics/<name>.py`, whose `read(run)` returns a number or None
(nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import os
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json "
                     f"(cells: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(os.path.join(root, entry["file"]))


def traffic(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "portbench", "traffic", name + ".json"))


def metrics(bench: dict, cell_name: str, per_layer: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones, or with
    a trace the per-layer ones. A metric with `workloads` is reported in
    those cells; an end-to-end one without, in every cell; a per-layer one
    without, in every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not per_layer:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(name: str, root: str = ROOT) -> types.ModuleType:
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def shape(cfg: dict) -> types.SimpleNamespace:
    """The sizes the benchmark's own code reads (weights, work, reference),
    from a configuration file's published keys."""
    heads = cfg["num_attention_heads"]
    return types.SimpleNamespace(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=heads,
        num_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        tie_word_embeddings=cfg["tie_word_embeddings"],
        bos=cfg["bos_token_id"],
        eos=(cfg["eos_token_id"] if isinstance(cfg["eos_token_id"], list)
             else [cfg["eos_token_id"]]))
