"""`--profiler-port` and the decode profile of the port on the CPU with the
tiny model: a server with the flag answers a capture while a request
streams, with a gzipped Chrome trace that holds the engine thread's
`aten::` ops (torch.profiler's CPU side records the thread that opens it,
so the engine thread opens it: runtime/profiler.py), and the stream equals
the same request's without a capture; a second server on the same port
exits with a message, as `jax.profiler.start_server` raises there; the
capture endpoint's answers to bad requests; and
`python -m gabby_tpu_torch.tools.profile_decode` prints its total and its
rows. The card's side (the step's CUDA kernels in the trace) is held by
chip_smoke.py's profiler phase."""

import gzip
import http.client
import json
import socket
import subprocess
import sys
import threading

import pytest

from gabby_tpu_torch.runtime import profiler as tprof
from test_torch_server import REPO, _serving

CHAT = {"model": "tiny", "max_tokens": 40, "stream": True,
        "messages": [{"role": "system", "content": "s"},
                     {"role": "user", "content": "tell me a long story"}]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body, dict(resp.getheaders())


def _stream(port) -> str:
    """The streamed completion's text (the deltas of its SSE chunks)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(CHAT),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    assert resp.status == 200, body
    text = []
    for line in body.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            for choice in json.loads(line[6:]).get("choices", []):
                text.append(choice.get("delta", {}).get("content") or "")
    return "".join(text)


def test_capture_while_a_request_streams():
    pport = _free_port()
    with _serving(["--preset", "tiny", "--random-weights",
                   "--profiler-port", str(pport)]) as port:
        plain = _stream(port)
        got = {}

        def capture():
            got["answer"] = _get(pport, "/capture?duration_ms=1500")

        th = threading.Thread(target=capture)
        th.start()
        # the engine opens the window at its next plan boundary (an idle
        # engine wakes every 0.05 s); the request streams inside it
        threading.Event().wait(0.3)
        traced = _stream(port)
        th.join(150)
        status, body, headers = got["answer"]
        assert status == 200, body
        assert headers["Content-Type"] == "application/gzip"
        trace = json.loads(gzip.decompress(body))
        ops = [e for e in trace["traceEvents"]
               if str(e.get("name", "")).startswith("aten::")]
        assert ops, "no aten:: op in the trace"
        # every op recorded is the engine thread's: the HTTP threads open
        # no profiler
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        assert tprof.kernel_events(trace) == 0  # the CPU: no device
        assert len({e["tid"] for e in ops}) == 1, names
        # the saved copy is the answer
        with open(headers["X-Trace-Path"], "rb") as f:
            assert f.read() == body
        assert traced == plain and plain


def test_capture_answers_bad_requests():
    pport = _free_port()
    server = tprof.ProfilerServer(pport)
    try:
        assert _get(pport, "/capture?duration_ms=x")[0] == 400
        assert _get(pport, "/capture?duration_ms=0")[0] == 400
        assert _get(pport, "/nothing")[0] == 404
        # no engine attached yet
        assert _get(pport, "/capture?duration_ms=10")[0] == 503
    finally:
        server.close()


def test_a_taken_profiler_port_exits_at_start_up():
    """A second server on the same port exits with a message before it
    builds anything."""
    from gabby_tpu_torch import server
    pport = _free_port()
    first = tprof.ProfilerServer(pport)
    try:
        with pytest.raises(SystemExit, match=f"--profiler-port: cannot "
                           f"serve captures on port {pport}"):
            server.main(["--device", "cpu", "--preset", "tiny",
                         "--random-weights", "--profiler-port", str(pport)])
    finally:
        first.close()


def test_profile_decode_prints_its_total_and_rows():
    run = subprocess.run(
        [sys.executable, "-m", "gabby_tpu_torch.tools.profile_decode",
         "--config", "tiny_int4", "--device", "cpu", "--steps", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    head = [ln for ln in lines if " total " in ln]
    assert len(head) == 1 and "over 3 calls x 4 steps, wall" in head[0]
    rows = [ln for ln in lines if "us/step" in ln]
    assert rows and all(" x" in ln for ln in rows)
    assert any("aten::" in ln for ln in rows)
