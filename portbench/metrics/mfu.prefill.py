"""mfu.prefill (device): the model operations of the traced slice over its seconds at 989 TFLOP/s, in %."""

from portbench import readers


def read(run):
    return readers.mfu_pct(run)
