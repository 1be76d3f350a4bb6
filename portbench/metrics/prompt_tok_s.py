"""prompt_tok_s: prompt tokens of the requests whose first token came in the window, per second of it."""

from portbench import endtoend


def read(run):
    return endtoend.prompt_tok_s(run.records, run.t0, run.t1)
