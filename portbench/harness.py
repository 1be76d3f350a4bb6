"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up (`setup_s`, from the start of the process to the window): the
seeded bf16 weights on the device, the port's serving recipe over them
(`quant.quantize_tree(..., 4, unembed_bits=4, unembed_group=256)` then
`llama.fuse_projections`), the engine as the server builds it for
`--quant 4 --kv-quant` (the paired int8 cache, s8 decode attention, 8
steps a burst), one short request, then the pre-roll: the cell's own
traffic for `preroll_s`, not counted. The window follows at once and
lasts `seconds`; nothing compiles in it (the kernels are built, and every
shape the traffic uses was served in the pre-roll). The run does not
drain: at the window's end the records are read, the peak memory taken,
the engine stopped and its state freed; then the plain reference judges a
sample of the finished requests.

The client is one thread: it submits each request when it is due (open
loop) or when its client's last one ended (closed loop), and every 10 ms
reads the tokens each running request has received (`Request.token_ids`,
which the engine appends before it streams; the random-weight tokenizer
turns most ids into no text, so the out-queue itself carries few deltas)
and its finish from the out-queue. Every half second of the window it
counts the cache rows the streaming requests hold (prompt and tokens
received), the pool's fill beside the peak memory.

With a trace, spans (spans.py) wrap the port's layers, the engine counters
are read over the first half of the window, and then, once a request
waits for its first token, the engine thread profiles `trace_slice_s`
seconds (runtime.profiler.Capturer) whose Chrome trace trace.py reduces.
"""

from __future__ import annotations

import gc
import json
import os
import queue
import tempfile
import threading
import time
import types
from typing import Optional

import numpy as np
import torch

from portbench import check, endtoend, spec, trace, traffic, weights, work
from portbench.spans import Spans

POLL_S = 0.01
STEPS_PER_CALL = 8  # the server's default burst, busy or not


def _engine(cfgd: dict, traffic_d: dict, params, seed: int, device):
    from gabby_tpu_torch.config import ModelConfig
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    max_seq = cfgd["assumed"]["max_seq"]
    mcfg = ModelConfig.from_hf_dict(cfgd, max_seq_len=max_seq)
    econf = EngineConfig(
        batch_slots=traffic_d["slots"], max_seq=max_seq, seed=seed,
        steps_per_call=STEPS_PER_CALL, steps_per_call_busy=STEPS_PER_CALL,
        kv_quantized=True, cache_dtype="bfloat16",
        pair_kv_heads=mcfg.num_kv_heads % 2 == 0)
    return Engine(mcfg, params, Tokenizer.byte_fallback(mcfg.vocab_size),
                  econf, device=device, stop_ids=set(mcfg.eos_token_ids))


def _served_params(shape, seed: int, device):
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant

    w = weights.make(shape, seed, device)
    if shape.tie_word_embeddings:
        # the loader's recipe for a tied checkpoint: the unembed is its
        # own copy of the embedding, [D, V] and contiguous. quantize_tree's
        # tied branch quantizes the transposed view instead, whose codes
        # come out non-contiguous unless the vocab needs padding, and K2
        # refuses them (PERF.md, Open questions)
        w["lm_head"] = w["embed"].T.contiguous()
    q = quant.quantize_tree(w, 4, unembed_bits=4, unembed_group=256)
    del w
    return llama.fuse_projections(q)


class Client:
    """Submits the traffic and records what each request received."""

    def __init__(self, engine, shape, seed: int):
        self.engine, self.shape = engine, shape
        self.rng = np.random.default_rng([int(seed), 4])
        self.records: list[endtoend.Record] = []
        self.open: list[endtoend.Record] = []

    def submit(self, planned, due: float) -> endtoend.Record:
        ids = traffic.token_ids(self.rng, planned.prompt_len,
                                self.shape.vocab_size, self.shape.bos,
                                self.shape.eos)
        rec = endtoend.Record(planned.prompt_len, planned.max_tokens, due)
        rec.request = self.engine.submit_ids(
            ids, max_tokens=planned.max_tokens, temperature=0.0)
        self.records.append(rec)
        self.open.append(rec)
        return rec

    def poll(self, now: float) -> list[endtoend.Record]:
        """Reads every running request; returns those that ended."""
        ended = []
        for rec in self.open:
            n = len(rec.request.token_ids)
            if n > len(rec.times):
                rec.times.extend([now] * (n - len(rec.times)))
            while True:
                try:
                    _, fin = rec.request.out.get_nowait()
                except queue.Empty:
                    break
                if fin is not None:
                    rec.finish = fin
                    ended.append(rec)
                    break
        if ended:
            self.open = [r for r in self.open if r.finish is None]
        return ended


def _wait(req, timeout: float = 600.0) -> str:
    deadline = time.monotonic() + timeout
    while True:
        _, fin = req.out.get(timeout=max(0.0, deadline - time.monotonic()))
        if fin is not None:
            return fin


class _Capture:
    """A profile of `slice_s` seconds taken by the engine thread."""

    def __init__(self, engine, slice_s: float):
        from gabby_tpu_torch.runtime.profiler import Capturer

        self.capturer = Capturer(engine.device.type == "cuda")
        # the profiler's first start in a process costs seconds: pay it
        # here, in set-up, not on the engine thread in the window
        warm = torch.profiler.profile(activities=self.capturer.activities())
        warm.start()
        warm.stop()
        engine.capturer = self.capturer
        self.slice_s = slice_s
        self.profile = None
        self.error = None
        self.thread = None

    def start(self) -> None:
        def take():
            try:
                self.profile = self.capturer.capture(
                    self.slice_s, timeout=self.slice_s + 120).profile
            except Exception as e:  # noqa: BLE001 — reported by the run
                self.error = str(e)
        self.thread = threading.Thread(target=take, name="pb-capture")
        self.thread.start()

    def summary(self) -> trace.Summary:
        self.thread.join(timeout=self.slice_s + 180)
        if self.profile is None:
            raise RuntimeError(f"the traced slice gave no profile: "
                               f"{self.error}")
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            self.profile.export_chrome_trace(path)
            with open(path) as f:
                return trace.summarize(json.load(f))
        finally:
            os.remove(path)


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        traced: bool, device, t_start: float, root: str = spec.ROOT,
        control: bool = False,
        traffic_d: Optional[dict] = None) -> tuple[dict, dict, list]:
    """(the result line's object, the numbers compared, the backlog).
    `control` runs the program with its fp8 activation path on (the
    check's control); `traffic_d` replaces the cell's traffic file (the
    knee sweep). The backlog is [(seconds into the window, requests sent
    and not yet given a first token)] every half second."""
    from gabby_tpu_torch.ops import quant

    cell = spec.cell(bench, cell_name)
    cfgd = spec.config(bench, cell["config"], root)
    traffic_d = traffic_d or spec.traffic(cell["traffic"], root)
    shape = spec.shape(cfgd)
    max_seq = cfgd["assumed"]["max_seq"]
    cuda = device.type == "cuda"
    fp8_was = quant.act_fp8_enabled()
    quant.set_act_fp8(control or fp8_was)
    spans = Spans(shape) if traced else None
    engine = None
    marks = [("start", time.monotonic())]
    try:
        params = _served_params(shape, seed, device)
        if cuda:
            torch.cuda.synchronize(device)
        marks.append(("weights_and_quantize", time.monotonic()))
        engine = _engine(cfgd, traffic_d, params, seed, device)
        del params
        marks.append(("engine", time.monotonic()))
        warm = engine.submit_ids(
            traffic.token_ids(np.random.default_rng([int(seed), 5]), 16,
                              shape.vocab_size, shape.bos, shape.eos),
            max_tokens=4, temperature=0.0, internal=True)
        fin = _wait(warm)
        if fin not in ("stop", "length"):
            raise RuntimeError(f"the warm-up request ended {fin!r}")
        marks.append(("first_request", time.monotonic()))
        capture = None
        if traced:
            spans.install()
            capture = _Capture(engine, traffic_d["trace_slice_s"])
        client = Client(engine, shape, seed)
        t_pre = time.monotonic()
        marks.append(("profiler_and_spans", t_pre))
        t0 = t_pre + traffic_d["preroll_s"]
        t1 = t0 + seconds
        t_cap = t0 + seconds / 2 if traced else t1
        if traffic_d["loop"] == "open":
            pre, win = traffic.open_loop(traffic_d, seconds, seed, max_seq)
            due = [(t_pre + p.at, p) for p in pre + win]
            feed = None
        else:
            due = []
            feed = traffic.closed_loop(traffic_d, seed, max_seq)
            for _ in range(traffic_d["clients"]):
                client.submit(next(feed), t_pre)
        nxt = 0
        steps0 = steps1 = None  # engine counters at c0 and at c1
        backlog, t_log = [], t_pre
        live = []  # cache rows of the streaming requests, every 0.5 s
        now = time.monotonic()
        while now < t1:
            while nxt < len(due) and due[nxt][0] <= now:
                client.submit(due[nxt][1], due[nxt][0])
                nxt += 1
            for _ in client.poll(now):
                if feed is not None:
                    client.submit(next(feed), now)
            if steps0 is None and now >= t0:
                steps0, c0 = engine.stats["decode_steps"], now
            # the traced slice opens while a request waits for its first
            # token, so that it holds prefill chunks beside decode steps
            if steps1 is None and now >= t_cap and (
                    not traced or any(not r.times for r in client.open)
                    or now >= t1 - traffic_d["trace_slice_s"] - 10):
                steps1, c1 = engine.stats["decode_steps"], now
                if capture is not None:
                    capture.start()
            if now >= t_log:
                backlog.append((now - t0, sum(not r.times
                                              for r in client.open)))
                if now >= t0:
                    live.append(sum(r.prompt_len + len(r.times)
                                    for r in client.open if r.times))
                t_log += 0.5
            time.sleep(POLL_S)
            now = time.monotonic()
        client.poll(now)
        if steps1 is None:
            steps1, c1 = engine.stats["decode_steps"], now
        peak = (torch.cuda.max_memory_allocated(device) if cuda
                else 0)
        summary = capture.summary() if capture is not None else None
        engine.shutdown()
        client.engine = None
        for rec in list(client.open):
            try:
                while True:
                    _, fin = rec.request.out.get(timeout=5)
                    if fin is not None:
                        rec.finish = fin
                        break
            except queue.Empty:
                pass
    finally:
        if spans is not None:
            spans.uninstall()
        quant.set_act_fp8(fp8_was)
        if engine is not None:
            engine.shutdown()
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    recs = client.records
    view = types.SimpleNamespace(
        records=recs, t0=t0, t1=t1, setup_s=t0 - t_start,
        count_s=c1 - c0, decode_steps=steps1 - steps0,
        count_tokens=sum(len(r.in_window(c0, c1)) for r in recs),
        live_rows=live, trace=summary,
        book=spans.book if spans else None, shape=shape,
        cell=cell, config=cfgd, traffic=traffic_d)
    metrics = {}
    for m in spec.metrics(bench, cell_name, traced):
        value = spec.reader(m["name"], root).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(1 for r in recs if t0 <= r.due < t1)
    failed = sum(1 for r in recs
                 if r.finish not in (None, "stop", "length", "abort"))

    w = weights.make(shape, seed, device)
    picked = check.sample(recs, seed)
    nums = check.numbers(shape, w, picked) if picked else {}
    del w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ok, shown = check.verdict(nums, cfgd["check"])
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    # latencies beside the metrics, unbounded: on this host-bound engine a
    # window holds too few requests for a steady tail (PERF.md §2)
    ttfts = endtoend.ttfts_ms(recs, t0, t1)
    tpots = endtoend.tpots_ms(recs, t0, t1)
    result["latency"] = {
        "ttft_p50_ms": endtoend.percentile(ttfts, 50), "ttft_n": len(ttfts),
        "tpot_p50_ms": endtoend.percentile(tpots, 50), "tpot_n": len(tpots),
        "finished": sum(r.finish in ("stop", "length") for r in recs)}
    # the pool's fill beside the peak: the mean live rows' bytes and the
    # whole pool's (slots x max_seq rows)
    layer_rows = work.row_bytes(shape) * shape.num_layers
    result["cache"] = {
        "live_bytes": (float(np.mean(live)) * layer_rows if live else 0.0),
        "pool_bytes": traffic_d["slots"] * max_seq * layer_rows}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["check"] = shown
    # set-up by part: seconds from the process start to the harness, then
    # each step to the pre-roll, which ends at the window
    nums["setup_parts"] = {"process_to_harness": marks[0][1] - t_start}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        nums["setup_parts"][name] = b - a
    nums["setup_parts"]["preroll"] = t0 - t_pre
    return result, nums, backlog
