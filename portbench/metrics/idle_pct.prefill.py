"""idle_pct.prefill (device): the share of the traced slice with no kernel, copy or fill running (union of intervals), in %."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
