"""Spans that the benchmark opens around the port's layers, in traced runs.

`Spans(shape).install()` wraps, by the names the port looks them up under, the
model step's entries (`generate.decode_loop`, `generate.prefill_slot`,
`generate.prefill_batch_chunk`, which the engine calls) and the products
and attention entries that `models/llama.py` calls (`linear`,
`cache_attention*`, `slot_prefill_attention`, `causal_attention`) in
`torch.profiler.record_function` spans named `pb.<phase>` and `pb.<op>`.
While the profiler records (the engine thread opens it at a plan
boundary, so a model call is wholly in or wholly out), each step call also
books the work it needs (`work.py`) under its phase: "decode" or
"prefill". `uninstall()` puts the port's functions back.
"""

from __future__ import annotations

import collections
import functools
import inspect

import torch

from portbench import work

class Book:
    """The work booked while the profiler recorded, by (phase, op), and
    the prompt tokens the prefill calls took."""

    def __init__(self):
        self.work = collections.defaultdict(work.Work)
        self.prompt_tokens = 0


def _recording() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _span(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


class Spans:
    def __init__(self, shape):
        self.shape = shape
        self.book = Book()
        self._saved = []

    def _patch(self, module, name, new):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def install(self) -> None:
        from gabby_tpu_torch.models import llama
        from gabby_tpu_torch.runtime import generate

        shape, book = self.shape, self.book

        def step(name, phase, booker):
            fn = getattr(generate, name)
            sig = inspect.signature(fn)

            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                if _recording():
                    booker(sig.bind(*args, **kwargs).arguments)
                with torch.profiler.record_function(f"pb.{phase}"):
                    return fn(*args, **kwargs)
            self._patch(generate, name, wrapped)

        def decode(a):
            pos = a["positions"].tolist()
            live = [p for p, on in zip(pos, a["active"].tolist()) if on]
            for s in range(a["num_steps"]):
                book.work["decode", "matmul"] += work.matmuls(
                    shape, len(live), len(live))
                book.work["decode", "attn"] += work.decode_attention(
                    shape, [p + s for p in live])

        def prefill_one(tokens: int, offset: int):
            book.work["prefill", "attn"] += work.prefill_attention(
                shape, tokens, offset)
            book.prompt_tokens += tokens

        def prefill_slot(a):
            prefill_one(a["length"], a["offset"])
            book.work["prefill", "matmul"] += work.matmuls(
                shape, a["length"], 1)

        def prefill_batch(a):
            off, bucket = a["offset"], a["tokens"].shape[1]
            lanes = [min(bucket, n - off) for n, on in zip(
                a["lengths"].tolist(), a["lane_mask"].tolist()) if on]
            lanes = [n for n in lanes if n > 0]
            for n in lanes:
                prefill_one(n, off)
            book.work["prefill", "matmul"] += work.matmuls(
                shape, sum(lanes), len(lanes))

        step("decode_loop", "decode", decode)
        step("prefill_slot", "prefill", prefill_slot)
        step("prefill_batch_chunk", "prefill", prefill_batch)
        self._patch(llama, "linear", _span("pb.matmul", llama.linear))
        for name in ("cache_attention", "cache_attention_quantized",
                     "slot_prefill_attention", "causal_attention"):
            self._patch(llama, name, _span("pb.attn", getattr(llama, name)))

    def uninstall(self) -> None:
        while self._saved:
            module, name, fn = self._saved.pop()
            setattr(module, name, fn)
