"""What the per-layer metric readers share: roofline shares, the idle
share and the model's share of the peak, from a traced run's booked work
(spans.Book) and its trace summary (trace.Summary). Each returns None
where the slice holds nothing to read."""

from __future__ import annotations

from portbench import work


def roofline_pct(run, phase: str, op: str):
    """The least time the booked work needs over the device time of the
    kernels launched under its spans, in %."""
    if run.trace is None or run.book is None:
        return None
    w = run.book.work.get((phase, op))
    dev_s = run.trace.device_s.get((phase, op), 0.0)
    if w is None or not w.ops() or dev_s <= 0:
        return None
    return 100.0 * w.least_s() / dev_s


def idle_pct(run):
    """The share of the traced slice with no kernel, copy or fill
    running, in %."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(run):
    """The model's operations in the slice (every booked product and
    attention, decode and prefill) over the slice's seconds at the bf16
    peak, in %."""
    if run.trace is None or run.book is None or run.trace.window_s <= 0:
        return None
    ops = sum(w.ops() for w in run.book.work.values())
    if not ops:
        return None
    return 100.0 * ops / (run.trace.window_s * work.PEAK_BF16_FLOPS)


def prefill_ms_per_ktok(run):
    """Device ms under the prefill spans per 1000 prompt tokens they took."""
    if run.trace is None or run.book is None or not run.book.prompt_tokens:
        return None
    dev_s = run.trace.device_s.get(("prefill", "all"), 0.0)
    if dev_s <= 0:
        return None
    return dev_s * 1e3 / (run.book.prompt_tokens / 1e3)
