"""The port stands alone: every gabby_tpu_torch module and chip_smoke.py
import with JAX, ml_dtypes and safetensors made unimportable (the card's
machine has none of them: the loader reads bf16 as 16-bit words), and none
of them loads a gabby_tpu module. Entry points with no device refuse to run
when CUDA is absent."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "ml_dtypes", "safetensors"):
    sys.modules[blocked] = None    # any `import <blocked>` now raises
sys.path.insert(0, sys.argv[1])
import gabby_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    gabby_tpu_torch.__path__, "gabby_tpu_torch.")]
for name in ("loader", "tools.quantize", "eval.ppl", "runtime.paged",
             "ops.cuda.paged_attention", "ops.cuda.attention",
             "ops.cuda.prefill_attention", "runtime.kv_cache"):
    assert "gabby_tpu_torch." + name in names, name
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "gabby_tpu" or m.startswith("gabby_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_gabby_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE, REPO], check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert int(out.stdout.strip()) >= 27  # chip_smoke + the package modules


_ROUNDTRIP = r"""
import sys
for blocked in ("jax", "ml_dtypes", "safetensors"):
    sys.modules[blocked] = None
sys.path.insert(0, sys.argv[1])
import torch
from gabby_tpu_torch import loader
path = sys.argv[2]
t = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).bfloat16(),
     "q": torch.arange(-6, 6, dtype=torch.int8).reshape(4, 3)}
loader.write_safetensors(path, t)
back = loader.read_safetensors(path)
assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t["w"])
assert torch.equal(back["q"], t["q"])
print("ok")
"""


def test_loader_reads_and_writes_bf16_without_ml_dtypes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _ROUNDTRIP, REPO,
         str(tmp_path / "x.safetensors")], check=True, capture_output=True,
        text=True, timeout=120, cwd=REPO)
    assert out.stdout.strip() == "ok"


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    """Every Python source of the port and chip_smoke.py, read as text: no
    import of jax or of gabby_tpu, at module level or inside a function
    (the probe above only runs module-level imports)."""
    import ast
    import glob
    files = [os.path.join(REPO, "chip_smoke.py")] + glob.glob(
        os.path.join(REPO, "gabby_tpu_torch", "**", "*.py"), recursive=True)
    assert len(files) >= 27
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "gabby_tpu"), (path, mod)


def test_entry_points_default_to_the_card():
    """Every entry point that takes a device resolves None to CUDA
    (`resolve_device`), the ones this slice touched included."""
    import inspect

    from gabby_tpu_torch import resolve_device
    from gabby_tpu_torch.runtime import kv_cache, paged
    for fn in (kv_cache.create_cache, kv_cache.cache_from_numpy,
               paged.create_paged_cache, paged.paged_cache_from_numpy):
        assert inspect.signature(fn).parameters["device"].default is None
        assert "resolve_device(device)" in inspect.getsource(fn)
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.runtime.engine import Engine
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.tokenizer import Tokenizer

    cfg = cfglib.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, {}, Tokenizer.byte_fallback(cfg.vocab_size))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_cache(cfg, 1, 16, quantized=True, paired=True)
    from gabby_tpu_torch.runtime.paged import create_paged_cache
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_paged_cache(cfg, 1, 32, 3, page_size=16, paired=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg)
    from gabby_tpu_torch import loader
    from gabby_tpu_torch.tools import quantize
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loader.load_model_dir("/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quantize.main(["--model-dir", "/nonexistent", "--out", "/nonexistent"])
