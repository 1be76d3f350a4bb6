"""output_tok_s: output tokens received in the window per second of it."""

from portbench import endtoend


def read(run):
    return endtoend.output_tok_s(run.records, run.t0, run.t1)
