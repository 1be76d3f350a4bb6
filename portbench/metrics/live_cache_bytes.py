"""live_cache_bytes (engine): the int8 cache bytes that the streaming requests hold (prompt and tokens received a request, every layer), averaged over the window's half-second samples. Requests still mid-prefill are not counted."""

from portbench import work


def read(run):
    if not run.live_rows:
        return None
    rows = sum(run.live_rows) / len(run.live_rows)
    return rows * work.row_bytes(run.shape) * run.shape.num_layers
