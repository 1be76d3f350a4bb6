"""Builds gabby_tpu_torch/csrc/*.cu into one shared library and loads it.

Route: nvcc by hand into a library with a plain C interface, bound with
ctypes (no PyTorch headers, so each source compiles in seconds). Every
source compiles in its own nvcc process, all started together, then one
link. The library lands in <repo>/build/gabby_tpu_torch/libgabby_kernels.so
beside a stamp holding the hash of the sources and flags it was built
from, so a changed source rebuilds. Nothing builds at
import: the first CUDA tensor that reaches a wrapper calls `library()`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gabby_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compiles (if the hash changed) and returns the library's path.
    verbose=True adds `-Xptxas -v` and prints each compile's output
    (registers, shared memory and spills per kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, "libgabby_kernels.so")
    stamp = lib + ".hash"
    digest = source_hash()
    if not verbose and os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read() == digest:
                return lib
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            if verbose or p.returncode:
                print(f"[nvcc {os.path.basename(src)}]\n"
                      f"{out.decode(errors='replace')}", flush=True)
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        tmp_lib = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
                        *[obj for _, obj, _ in procs]],
                       check=True, capture_output=True)
        os.replace(tmp_lib, lib)  # atomic: a concurrent build never sees half
    with open(stamp, "w") as f:
        f.write(digest)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: pointers and the stream as void*, ints as int; each
# returns the cudaError_t of its launch (0 = success)
_SIGNATURES = {
    # K1: x, the stack's tensor map (host bytes), scale (layer offset),
    # out; M, K, N, layer, bt, split (stacked_plan); stream
    "gabby_int4_matmul": [_P] * 4 + [_I] * 6 + [_P],
    # K33, the raw-byte-dot form, and K5 (the map of an int8 stack): the
    # same arguments
    "gabby_int4_matmul_rawdot": [_P] * 4 + [_I] * 6 + [_P],
    "gabby_int8_matmul_stacked": [_P] * 4 + [_I] * 6 + [_P],
    # K8: x, the map, scale, out, the int32 accumulator or NULL; M, K, N,
    # layer, bt, split; stream
    "gabby_w4a8_matmul": [_P] * 5 + [_I] * 6 + [_P],
    # stack of byte planes; L, K (2 x the rows), N; the 128-byte map
    "gabby_int4_stacked_map": [_P] + [_I] * 3 + [_P],
    # K2: x, packed, scale, out; M, K, N, group; stream
    "gabby_int4_unembed": [_P] * 4 + [_I] * 4 + [_P],
    # K6: x, codes, scale, out; M, K, N; stream
    "gabby_int8_unembed": [_P] * 4 + [_I] * 3 + [_P],
    # x, packed (layer offset), scale (layer offset), out, part (the split
    # K's workspace or NULL); M, K, N, k_split; stream
    "gabby_int4_matmul_prefill": [_P] * 5 + [_I] * 4 + [_P],
    # M, K, N -> k_split
    "gabby_int4_matmul_prefill_splits": [_I] * 3,
    # K3, K12, K16: q, k, v, k_scale, v_scale (layer offset), fresh_k,
    # fresh_v, positions, out; B, Nq, Nk, S, H, limit, pair, sb, split,
    # tile (decode_plan); sm_scale; stream
    "gabby_decode_attention": [_P] * 9 + [_I] * 10 + [_F, _P],
    # K24, K25, K32: the same without the scales
    "gabby_decode_attention_bf16": [_P] * 7 + [_I] * 10 + [_F, _P],
    # K34, K35: the no-fresh-row form of K3 and K12, their arguments
    # without fresh_k and fresh_v; K36, K37: the same over a bf16 cache
    "gabby_decode_attention_nofresh": [_P] * 7 + [_I] * 10 + [_F, _P],
    "gabby_decode_attention_nofresh_bf16": [_P] * 5 + [_I] * 10 + [_F, _P],
    # K10, K17: q, k, v, k_scale, v_scale (whole pools), page table,
    # fresh_k, fresh_v, positions, out; B, Nq, Nk, L, layer, page,
    # max_pages, H, pair, sb, split, tile (decode_plan); sm_scale; stream
    "gabby_paged_decode_attention": [_P] * 10 + [_I] * 12 + [_F, _P],
    # K28, K29: the same without the scales
    "gabby_paged_decode_attention_bf16": [_P] * 8 + [_I] * 12 + [_F, _P],
    # K38, K39: the no-fresh-row form of K10 and K17, their arguments
    # without fresh_k and fresh_v; K40, K41: the same over bf16 pools
    "gabby_paged_decode_attention_nofresh": [_P] * 8 + [_I] * 12 + [_F, _P],
    "gabby_paged_decode_attention_nofresh_bf16": [_P] * 6 + [_I] * 12
    + [_F, _P],
    # q, k, v, k_scale, v_scale (layer + slot offset), fresh_k, fresh_v,
    # out, part (the split's workspace or NULL); T, Nq, Nk, S, H, offset,
    # pair, n_split; sm_scale; stream
    "gabby_prefill_attention": [_P] * 9 + [_I] * 8 + [_F, _P],
    # T, Nq, Nk, offset -> n_split
    "gabby_prefill_attention_splits": [_I] * 4,
    # K9, K13: q, k, v, k_scale, v_scale (layer offset), fresh_k, fresh_v,
    # positions, out; B, T, Nq, Nk, S, H, limit, pair, split, tile, nt
    # (verify_plan); sm_scale; stream
    "gabby_verify_attention": [_P] * 9 + [_I] * 11 + [_F, _P],
    # K11, K18: q, k, v, k_scale, v_scale (whole pools), page table,
    # fresh_k, fresh_v, positions, out; B, T, Nq, Nk, L, layer, page,
    # max_pages, H, pair, split, tile, nt (verify_plan); sm_scale; stream
    "gabby_paged_attention": [_P] * 10 + [_I] * 13 + [_F, _P],
    # K14, K15, K19, K20: q, k, v, k_scale, v_scale (dense: layer offset;
    # paged: whole pools), page table or NULL, fresh_k, fresh_v, positions,
    # out; B, Nq, Nk, layers, layer, rows, max_pages, H, limit, chunk, pair,
    # sb, split, tile (s8_plan); sm_scale; stream
    "gabby_attention_s8": [_P] * 10 + [_I] * 14 + [_F, _P],
    # the bf16-cache forms: the int8 forms' arguments without the scales
    # (K22, K23: prefill_attention_bf16.cu, whose splits follow its own
    # blocks)
    "gabby_prefill_attention_bf16": [_P] * 7 + [_I] * 8 + [_F, _P],
    "gabby_prefill_attention_bf16_splits": [_I] * 4,
    "gabby_verify_attention_bf16": [_P] * 7 + [_I] * 11 + [_F, _P],
    "gabby_paged_attention_bf16": [_P] * 8 + [_I] * 13 + [_F, _P],
    # K42, the decode layer's attention prologue: qkv, positions, inv_freq,
    # q, fresh_k, fresh_v (written), k, v, k_scale, v_scale (layer offset);
    # B, Nq, Nk, S, H, pair; stream
    "gabby_decode_prologue": [_P] * 10 + [_I] * 6 + [_P],
}


def _declare(lib: ctypes.CDLL) -> None:
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gabby_error_string.argtypes = [ctypes.c_int]
    lib.gabby_error_string.restype = ctypes.c_char_p


def check(err: int, what: str) -> None:
    """Raises if a launch returned a CUDA error."""
    if err != 0:
        msg = library().gabby_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
