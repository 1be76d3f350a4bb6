"""admit_ms_per_ktok (model step): the engine's admit phase in host ms over the counted half-window's iterations per 1000 prompt tokens they prefilled (the program's iteration log), beside the device's prefill_ms_per_ktok.prefill."""

from portbench import engine_log


def read(run):
    return engine_log.admit_ms_per_ktok(run)
