"""fetch_ms_per_step (engine): the engine's fetch phase (the burst's host copy and the wait for it) in ms over the counted half-window's iterations, per decode step they ran (the program's iteration log)."""

from portbench import engine_log


def read(run):
    return engine_log.ms_per_step(run, ("fetch",))
