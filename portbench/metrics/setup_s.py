"""setup_s: seconds from the start of the process to the window (weights made and quantized, the engine built, one request, the pre-roll)."""


def read(run):
    return run.setup_s
