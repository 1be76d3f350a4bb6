"""On-demand torch.profiler captures of a serving process: the port's
counterpart of the reference server's `--profiler-port`
(`jax.profiler.start_server(port)`, gabby_tpu/server.py).

`ProfilerServer(port)` binds its port when it is made (a port that is
taken raises OSError, which the server turns into an exit with a message)
and answers, on a daemon thread, from the standard library's HTTP server:

    GET /capture?duration_ms=N    (default 1000, at most 60000)

with the gzipped Chrome trace (JSON) of that window: the engine thread's
`aten::` ops and, when the engine runs on the card, the card's kernels,
under the port's own spans (runtime/tracing.py): the engine's
`gabby.engine.iteration` holding `.compose`, `.admit`, `.decode`, `.fetch`
and `.emit`, the model step's `gabby.model.prefill`, `.decode_step` and
`.sample`, and the ops' `gabby.matmul` and `gabby.attn`. The seconds of
each engine phase are counted whether or not a capture runs, and reach
`/statusz` and `/metricsz` through `Engine.stats`.
A copy is written under a `tempfile.mkdtemp(prefix="gabby-prof-")`
directory, whose path goes to the log. On the card a trace that holds no
CUDA kernel event is an error answer (500, with the reason): the card was
not traced, and a CPU-only trace is not passed off as whole.

Where the profiler runs: torch.profiler's CPU side records the thread that
opens it (a profile opened on one thread records none of another thread's
ops), so the HTTP thread does not open it. It posts the request to the
engine's `Capturer`; the engine thread takes it up at its next plan
boundary (`Capturer.tick`, once an iteration of `Engine._loop`, also when
idle: an idle engine wakes every 0.05 s), starts
`torch.profiler.profile`, stops it at the first boundary after the
duration has passed and hands the stopped profile back. Exporting it,
which takes longer than a step, happens on the HTTP thread. One capture at
a time: another request meanwhile is answered 409.

Under tensor or data parallelism every rank serves its own port, the
flag's port plus its process id (the ranks share a host), and each
follower captures its own replay loop; the reference starts one server a
host process.
"""

from __future__ import annotations

import gzip
import http.server
import json
import os
import sys
import tempfile
import threading
import time
import urllib.parse
from typing import Optional

import torch

DEFAULT_MS = 1000
MAX_MS = 60000


class CaptureError(Exception):
    """A capture that did not give a trace: `status` is the HTTP answer."""

    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


class _Request:
    def __init__(self, duration_s: float):
        self.duration_s = duration_s
        self.done = threading.Event()
        self.profile = None
        self.error: Optional[str] = None
        # the engine thread's own cost: ms to start and to stop the profiler
        self.start_ms = self.stop_ms = 0.0


class Capturer:
    """The engine thread's side of a capture. `capture` (any thread) posts
    a request and waits for the stopped profile; `tick` (the engine thread,
    at each plan boundary) starts and stops the profiler; `close` (the
    engine thread, as it ends) stops a running one and fails what is
    pending."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._lock = threading.Lock()
        self._pending: Optional[_Request] = None
        self._active: Optional[tuple] = None  # (request, profile, deadline)
        self._closed = False

    def activities(self) -> list:
        """The host's ops, and the card's kernels when the engine is on it."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def capture(self, duration_s: float, timeout: float) -> _Request:
        """The finished request: its stopped `profile` and what starting
        and stopping it cost the engine thread."""
        req = _Request(duration_s)
        with self._lock:
            if self._closed:
                raise CaptureError(503, "the engine has stopped")
            self._pending = req
        if not req.done.wait(timeout):
            raise CaptureError(504, f"the engine thread did not finish the "
                                    f"capture within {timeout:.0f} s")
        if req.error is not None:
            raise CaptureError(500, req.error)
        return req

    def tick(self) -> None:
        now = time.monotonic()
        if self._active is not None and now >= self._active[2]:
            req, prof, _ = self._active
            self._active = None
            try:
                prof.stop()
                req.stop_ms = (time.monotonic() - now) * 1e3
                req.profile = prof
            except Exception as e:  # noqa: BLE001 — answered, not raised
                req.error = f"torch.profiler failed to stop: {e}"
            req.done.set()
        if self._active is not None or self._pending is None:
            return
        with self._lock:
            req, self._pending = self._pending, None
        t0 = time.monotonic()
        try:
            prof = torch.profiler.profile(activities=self.activities())
            prof.start()
        except Exception as e:  # noqa: BLE001 — answered, not raised
            req.error = f"torch.profiler failed to start: {e}"
            req.done.set()
            return
        now = time.monotonic()
        req.start_ms = (now - t0) * 1e3
        self._active = (req, prof, now + req.duration_s)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, None
        if self._active is not None:
            req, prof, _ = self._active
            self._active = None
            try:
                prof.stop()
            except Exception:  # noqa: BLE001 — the engine is ending anyway
                pass
            req.error = "the engine stopped during the capture"
            req.done.set()
        if pending is not None:
            pending.error = "the engine has stopped"
            pending.done.set()


def kernel_events(trace: dict) -> int:
    """The CUDA kernel events of a Chrome trace from torch.profiler."""
    return sum(1 for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel")


class ProfilerServer:
    """The capture endpoint on `port` (all interfaces, as the reference's
    profiler server). `attach(engine)` gives it the engine to capture;
    before that a capture is answered 503."""

    def __init__(self, port: int):
        self.trace_dir = tempfile.mkdtemp(prefix="gabby-prof-")
        self._capturer: Optional[Capturer] = None
        self._one = threading.Lock()
        self._count = 0
        owner = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — the standard library's name
                status, body, headers = owner._answer(self.path)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                del fmt, args  # the capture's own line goes to the log

        self._http = http.server.ThreadingHTTPServer(("", port), Handler)
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="gabby-profiler").start()
        print(f"[profiler] captures on port {self.port} "
              f"(GET /capture?duration_ms=N), traces in {self.trace_dir}",
              file=sys.stderr, flush=True)

    def attach(self, engine) -> None:
        """Captures the engine's thread from now on. The profiler's first
        start in a process pays a one-time set-up of seconds, later starts
        about a millisecond: an empty profile on this thread pays it now,
        so that the engine thread's first capture does not stall serving
        for it."""
        capturer = Capturer(engine.device.type == "cuda")
        t0 = time.monotonic()
        warm = torch.profiler.profile(activities=capturer.activities())
        warm.start()
        warm.stop()
        print(f"[profiler] set up in {(time.monotonic() - t0) * 1e3:.0f} ms",
              file=sys.stderr, flush=True)
        self._capturer = capturer
        engine.capturer = capturer

    def close(self) -> None:
        self._http.shutdown()
        self._http.server_close()

    def _answer(self, path: str) -> tuple[int, bytes, dict]:
        url = urllib.parse.urlparse(path)
        if url.path != "/capture":
            return _text(404, "GET /capture?duration_ms=N")
        try:
            ms = int(urllib.parse.parse_qs(url.query).get(
                "duration_ms", [DEFAULT_MS])[0])
        except ValueError:
            return _text(400, "duration_ms must be an integer")
        if ms < 1:
            return _text(400, "duration_ms must be at least 1")
        ms = min(ms, MAX_MS)
        if self._capturer is None:
            return _text(503, "the engine is not serving yet")
        if not self._one.acquire(blocking=False):
            return _text(409, "a capture is already running")
        try:
            return self._capture(ms)
        except CaptureError as e:
            return _text(e.status, str(e))
        finally:
            self._one.release()

    def _capture(self, ms: int) -> tuple[int, bytes, dict]:
        req = self._capturer.capture(ms / 1e3, timeout=ms / 1e3 + 120)
        self._count += 1
        path = os.path.join(self.trace_dir, f"capture-{self._count}.json")
        t0 = time.perf_counter()
        req.profile.export_chrome_trace(path)
        with open(path, "rb") as f:
            raw = f.read()
        os.remove(path)
        export_ms = (time.perf_counter() - t0) * 1e3
        trace = json.loads(raw)
        kernels = kernel_events(trace)
        events = len(trace.get("traceEvents", []))
        print(f"[profiler] capture {self._count}: {ms} ms, {events} events, "
              f"{kernels} kernel events; the engine thread took "
              f"{req.start_ms:.0f} ms to start the profiler and "
              f"{req.stop_ms:.0f} ms to stop it, the export {export_ms:.0f} "
              f"ms", file=sys.stderr, flush=True)
        if self._capturer.cuda and kernels == 0:
            return _text(500, "the trace holds no CUDA kernel event: the "
                              "card was not traced")
        body = gzip.compress(raw)
        path += ".gz"
        with open(path, "wb") as f:
            f.write(body)
        print(f"[profiler] capture {self._count} written to {path}",
              file=sys.stderr, flush=True)
        return 200, body, {"Content-Type": "application/gzip",
                           "X-Trace-Path": path,
                           "X-Start-Ms": f"{req.start_ms:.1f}",
                           "X-Stop-Ms": f"{req.stop_ms:.1f}",
                           "X-Export-Ms": f"{export_ms:.1f}"}


def _text(status: int, msg: str) -> tuple[int, bytes, dict]:
    return status, (msg + "\n").encode(), {"Content-Type": "text/plain"}
