"""ctypes bridge to the native serving front-end (cpp/ -> libgabby_bridge.so).

A copy of gabby_tpu/bridge.py for the PyTorch port (the port imports
nothing of the JAX package); the C++ front-end is shared unchanged.

The C++ half owns everything the reference implements natively (HTTP/1.1,
routing, thread pool, OpenAI protocol, SSE framing — SURVEY.md §2a); this
module plugs the PyTorch engine into its Generator seam via cpp/src/bridge/
c_api.h. Worker threads in C++ call `generate` concurrently; the engine's
continuous batching makes those calls overlap on device.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
import threading
from typing import Callable, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's own build of cpp/, apart from the JAX server's cpp/build: it
# links libstdc++ statically (see build_native)
_BUILD_DIR = os.path.join("build", "gabby_tpu_torch", "cpp")

_EMIT_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_size_t)
_GENERATE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_void_p, _EMIT_FN)
# NB: buf must be c_void_p, NOT c_char_p — ctypes converts c_char_p args to
# immutable bytes, dropping the pointer we need to write through.
_STATS_FN = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_size_t)


class _ServerConfig(ctypes.Structure):
    _fields_ = [
        ("port", ctypes.c_int),
        ("read_timeout_millis", ctypes.c_int),
        ("write_timeout_millis", ctypes.c_int),
        ("workers", ctypes.c_int),
        ("max_queue", ctypes.c_int),
        ("log_level", ctypes.c_int),
    ]


def build_native(repo_root: str = _REPO_ROOT) -> str:
    """Builds cpp/ with cmake if the bridge library is missing; returns the
    library path.

    libstdc++ and libgcc are linked statically, their symbols hidden. With
    the shared libstdc++ of GCC 13, the first number the front-end's logger
    formatted after torch had loaded segfaulted in std::ostream (seen on an
    H100 host, Ubuntu 24.04); the static build serves there. Processes
    that build at once take turns (a file lock), so none loads a library
    another is still linking."""
    build_dir = os.path.join(repo_root, _BUILD_DIR)
    lib = os.path.join(build_dir, "libgabby_bridge.so")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib
        subprocess.run(
            ["cmake", "-S", os.path.join(repo_root, "cpp"), "-B", build_dir,
             "-DCMAKE_BUILD_TYPE=Release",
             "-DCMAKE_SHARED_LINKER_FLAGS=-static-libstdc++ -static-libgcc "
             "-Wl,--exclude-libs,ALL"],
            check=True, capture_output=True)
        subprocess.run(["cmake", "--build", build_dir, "-j", "4",
                        "--target", "gabby_bridge"],
                       check=True, capture_output=True)
    return lib


def load_library(path: Optional[str] = None) -> ctypes.CDLL:
    lib = ctypes.CDLL(path or build_native())
    lib.gabby_server_create.restype = ctypes.c_void_p
    lib.gabby_server_create.argtypes = [ctypes.POINTER(_ServerConfig),
                                        _GENERATE_FN, ctypes.c_void_p,
                                        ctypes.c_char_p]
    lib.gabby_server_start.restype = ctypes.c_int
    lib.gabby_server_start.argtypes = [ctypes.c_void_p]
    lib.gabby_server_port.restype = ctypes.c_int
    lib.gabby_server_port.argtypes = [ctypes.c_void_p]
    lib.gabby_server_stop.argtypes = [ctypes.c_void_p]
    lib.gabby_server_wait.argtypes = [ctypes.c_void_p]
    lib.gabby_server_destroy.argtypes = [ctypes.c_void_p]
    lib.gabby_last_error.restype = ctypes.c_char_p
    lib.gabby_server_set_stats.argtypes = [ctypes.c_void_p, _STATS_FN,
                                           ctypes.c_void_p]
    lib.gabby_server_set_ready.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


class NativeServer:
    """Runs the C++ HTTP front-end with a Python request handler.

    handler(request: dict, emit: Callable[[dict], bool]) -> None
      request: {"messages": [...], "temperature": ..., "stream": bool, ...}
      emit({"delta": str}) streams a chunk; the final call must include
      {"done": True, "finish_reason": str, "prompt_tokens": n,
       "completion_tokens": n}. emit returns False if the client aborted.
    """

    def __init__(self, handler: Callable, *, port: int = 8080,
                 workers: int = 4, model_id: str = "gabby-tpu",
                 read_timeout_millis: int = 60000,
                 write_timeout_millis: int = 600000,
                 max_queue: int = 0, log_level: int = 3,
                 lib_path: Optional[str] = None,
                 stats_fn: Optional[Callable[[], dict]] = None):
        self._lib = load_library(lib_path)
        self._handler = handler
        self._stopped = threading.Event()

        # the trampoline must outlive the server: keep refs on self
        def _generate(user_data, req_buf, req_len, emit_ctx, emit):
            del user_data
            try:
                request = json.loads(
                    ctypes.string_at(req_buf, req_len).decode("utf-8"))
            except Exception:
                return 1

            def emit_py(chunk: dict) -> bool:
                payload = json.dumps(chunk, ensure_ascii=False).encode("utf-8")
                return emit(emit_ctx, payload, len(payload)) == 0

            try:
                self._handler(request, emit_py)
                return 0
            except Exception as e:  # surface a clean 500 with the message
                try:
                    emit_py({"error": f"{type(e).__name__}: {e}",
                             "done": True})
                except Exception:
                    pass
                return 2

        self._generate_cb = _GENERATE_FN(_generate)
        cfg = _ServerConfig(port=port, read_timeout_millis=read_timeout_millis,
                            write_timeout_millis=write_timeout_millis,
                            workers=workers, max_queue=max_queue,
                            log_level=log_level)
        self._server = self._lib.gabby_server_create(
            ctypes.byref(cfg), self._generate_cb, None,
            model_id.encode("utf-8"))
        if not self._server:
            raise RuntimeError("gabby_server_create: " +
                               self._lib.gabby_last_error().decode())

        if stats_fn is not None:
            def _stats(user_data, buf, cap):
                del user_data
                try:
                    payload = json.dumps(stats_fn()).encode("utf-8")
                except Exception:
                    return 0
                n = min(len(payload), cap)
                ctypes.memmove(buf, payload, n)
                return n

            self._stats_cb = _STATS_FN(_stats)
            self._lib.gabby_server_set_stats(self._server, self._stats_cb,
                                             None)

    def start(self) -> int:
        """Starts listening; returns the bound port."""
        port = self._lib.gabby_server_start(self._server)
        if port < 0:
            raise RuntimeError("gabby_server_start: " +
                               self._lib.gabby_last_error().decode())
        return port

    def set_ready(self, ready: bool) -> None:
        """Flips /readyz between 503 (warming) and 200. The server starts
        ready; call set_ready(False) before start() when an engine warm-up
        runs after the socket opens."""
        self._lib.gabby_server_set_ready(self._server, 1 if ready else 0)

    @property
    def port(self) -> int:
        return self._lib.gabby_server_port(self._server)

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self._lib.gabby_server_stop(self._server)

    def wait(self) -> None:
        self._lib.gabby_server_wait(self._server)

    def close(self) -> None:
        self.stop()
        self.wait()
        if self._server:
            self._lib.gabby_server_destroy(self._server)
            self._server = None
