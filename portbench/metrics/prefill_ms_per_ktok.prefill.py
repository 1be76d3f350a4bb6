"""prefill_ms_per_ktok.prefill (model step): device ms under the prefill spans per 1000 prompt tokens, in the traced slice."""

from portbench import readers


def read(run):
    return readers.prefill_ms_per_ktok(run)
