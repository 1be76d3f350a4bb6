"""decode_attn_roofline: the least time of the decode attn work booked in the traced slice over the device time of the kernels under its spans, in %."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, "decode", "attn")
