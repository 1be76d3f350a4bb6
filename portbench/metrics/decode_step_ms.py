"""decode_step_ms (engine): ms of the counted part of the window per decode step the engine counted (stats decode_steps)."""


def read(run):
    if not run.decode_steps:
        return None
    return run.count_s * 1e3 / run.decode_steps
