"""admit_wait_ms.serve (engine): the median ms from submission to admission (Request.admit_ts - submit_ts) of the requests admitted in the counted half-window."""

from portbench import engine_log


def read(run):
    return engine_log.admit_wait_ms(run)
