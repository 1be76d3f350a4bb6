"""tokens_per_step (engine): output tokens received per decode step, over the counted part of the window: the batch's occupancy."""


def read(run):
    if not run.decode_steps:
        return None
    return run.count_tokens / run.decode_steps
