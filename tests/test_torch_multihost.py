"""Multi-process serving of the port (counterpart of tests/test_multihost.py,
at dp = 1): HostSync's plan broadcast, its timeout and the poisoning after
it; the liveness counters' `dead_peers` once a follower is killed; two
ranks serving through the engine, the leader's plans replayed by the
follower, with identical token streams on both (seeded and unseeded
sampling, penalties, logit_bias, top_logprobs and speculation riding the
plan); a follower's death failing the leader's requests within the sync
timeout; and `python -m gabby_tpu_torch.server --tp 2` serving a chat
completion on the CPU. Every process group meets through a FileStore in
tmp_path (no ports to race for under xdist), and every spawn has its own
timeout that kills its ranks."""

import http.client
import json
import multiprocessing
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import quant as tquant
from gabby_tpu_torch.parallel import (bind_group, init_distributed,
                                      shard_params)
from gabby_tpu_torch.parallel.mesh import _rank_entry, spawn_ranks
from gabby_tpu_torch.parallel.multihost import HostSync, HostSyncTimeout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(num_heads=8, num_kv_heads=4, head_dim=8, hidden_size=32,
            intermediate_size=64, vocab_size=256)
STOP = 1  # an arbitrary stop id for the random model
DONE = "gabby/test/done"
WARM = "gabby/test/warm"


def _join(rank, nprocs, store_path, timeout=30.0):
    import torch.distributed as dist
    return init_distributed(None, nprocs, rank,
                            store=dist.FileStore(store_path, nprocs),
                            device="cpu", timeout=timeout)


def _leader_of_two(fn, args: tuple, timeout: float):
    """fn(rank, 2, *args) in two spawned processes, rank 1 of which is
    meant to die: rank 0's result; every process is killed at the end."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, 2, args, results))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        rank, ok, value = results.get(timeout=timeout)
    except queue.Empty:
        pytest.fail(f"no result within {timeout:.0f}s")
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    assert rank == 0 and ok, value
    assert procs[1].exitcode != 0, "rank 1 was meant to die"
    return value


# ---- HostSync ---------------------------------------------------------------


def _sync_rank(rank, nprocs, store_path):
    group = _join(rank, nprocs, store_path)
    sync = HostSync(group, timeout=3.0)
    sync.HB_INTERVAL = 0.2
    got = sync.broadcast({"plan": [1, 2, 3], "steps": 8} if rank == 0
                         else {"ignored": rank})
    sync.barrier()
    if rank == 1:
        # sit out the leader's next broadcast, then die by a signal
        group.store.wait([DONE])
        os.kill(os.getpid(), signal.SIGKILL)
    out = {"got": got, "alive": sync.dead_peers(stall=2.0)}
    t0 = time.monotonic()
    try:
        sync.broadcast({"x": 1}, timeout=1.0)
    except HostSyncTimeout:
        out["timeout_s"] = time.monotonic() - t0
    try:
        sync.broadcast({"x": 2})
    except HostSyncTimeout as e:
        out["poisoned"] = str(e)
    group.store.set(DONE, "1")
    t0 = time.monotonic()
    while time.monotonic() - t0 < 20:
        dead = sync.dead_peers(stall=2.0)
        if dead:
            out["dead"], out["dead_s"] = dead, time.monotonic() - t0
            break
        time.sleep(0.2)
    return out


def test_hostsync_broadcast_timeout_poison_and_dead_peers(tmp_path):
    out = _leader_of_two(_sync_rank, (str(tmp_path / "store"),),
                         timeout=60)
    assert out["got"] == {"plan": [1, 2, 3], "steps": 8}
    assert out["alive"] == []
    assert 1.0 <= out["timeout_s"] < 3.0
    assert "previous broadcast timed out" in out["poisoned"]
    assert out["dead"] == [1] and out["dead_s"] < 10


def test_hostsync_single_process_is_a_passthrough():
    from gabby_tpu_torch.parallel import local_group
    sync = HostSync(local_group("cpu"))
    assert sync.broadcast({"a": 1}) == {"a": 1}
    assert sync.is_leader and sync.dead_peers() == []
    sync.barrier()


# ---- the engine over two ranks ---------------------------------------------


def _engine(rank, nprocs, group, sync, **econfig):
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer
    cfg = tcfg.tiny(max_seq_len=128, **DIMS)
    full = tquant.quantize_tree(tllama.init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu"), 8)
    params = bind_group(tllama.fuse_projections(
        shard_params(full, rank, nprocs)), group)
    conf = dict(batch_slots=2, max_seq=128, steps_per_call=4,
                steps_per_call_busy=2, default_max_tokens=5,
                cache_dtype="float32", kv_quantized=True)
    conf.update(econfig)
    return Engine(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size),
                  EngineConfig(**conf), device="cpu", stop_ids={STOP},
                  sync=sync)


# the per-request sampling surface rides the plan (Engine._req_meta): every
# field below must give the same streams on both ranks
PROMPTS = [
    (list(range(2, 12)), {}),                       # short, greedy
    ([7] * 70, {}),                                 # multi-chunk
    (list(range(30, 45)), {}),                      # admitted mid-decode
    (list(range(50, 60)), dict(temperature=1.0, top_k=8, seed=123)),
    (list(range(60, 72)), dict(temperature=0.9, presence_penalty=1.0,
                               frequency_penalty=0.5, logit_bias={3: 30.0},
                               top_logprobs=2)),
    (list(range(80, 90)), dict(temperature=1.2, top_p=0.9)),  # unseeded
]
CONFIGS = {"dense, speculate 3": dict(speculate_tokens=3),
           "paged": dict(paged_pages=1 + 2 * 8, page_size=16)}


def _serving_rank(rank, nprocs, store_path):
    from gabby_tpu_torch.runtime.engine import Engine
    group = _join(rank, nprocs, store_path)
    sync = HostSync(group, timeout=30.0)
    records = {label: [] for label in CONFIGS}
    real_finish = Engine._finish

    def finish(self, slot_ix, reason):
        s = self._slots[slot_ix]
        if s is not None and s.request.token_ids:
            self.records.append((tuple(s.request.prompt_ids),
                                 tuple(s.request.token_ids),
                                 tuple(s.request.token_logprobs)))
        real_finish(self, slot_ix, reason)

    Engine._finish = finish
    fins = {}
    for label, extra in CONFIGS.items():
        eng = _engine(rank, nprocs, group, sync, **extra)
        eng.records = records[label]
        if sync.is_leader:
            reqs = [eng.submit_ids(ids, max_tokens=5, **kw)
                    for ids, kw in PROMPTS]
            fins[label] = []
            for req in reqs:
                while True:
                    _, fin = req.out.get(timeout=120)
                    if fin is not None:
                        fins[label].append(fin)
                        break
            eng.shutdown()  # broadcasts the plan that releases the follower
        else:
            eng._thread.join(timeout=120)
            assert not eng._thread.is_alive()
    group.close()
    return {label: sorted(r) for label, r in records.items()}, fins


def test_two_rank_engine_serving_gives_identical_records(tmp_path):
    (lead, fins), (follow, _) = spawn_ranks(
        _serving_rank, 2, (str(tmp_path / "store"),), timeout=150)
    for label in CONFIGS:
        assert all(f in ("stop", "length") for f in fins[label]), fins
        assert lead[label] == follow[label], label
        assert len(lead[label]) == len(PROMPTS), lead[label]
        for _, emitted, lps in lead[label]:
            assert 1 <= len(emitted) <= 5 and len(lps) == len(emitted)


def _death_rank(rank, nprocs, store_path):
    group = _join(rank, nprocs, store_path, timeout=20.0)
    sync = HostSync(group, timeout=4.0)
    # a long request, so that it is still decoding when the follower dies
    eng = _engine(rank, nprocs, group, sync, max_seq=1024)
    if rank == 1:
        # die abruptly once the leader has served a request warm
        group.store.wait([WARM])
        time.sleep(0.5)  # inside the leader's next request
        os.kill(os.getpid(), signal.SIGKILL)
    warm = eng.submit_ids(list(range(2, 30)), max_tokens=8)
    while warm.out.get(timeout=60)[1] is None:
        pass
    group.store.set(WARM, "1")
    t0 = time.monotonic()
    req = eng.submit_ids(list(range(2, 30)), max_tokens=900)
    fin = None
    while fin is None:
        _, fin = req.out.get(timeout=60)
    return fin, time.monotonic() - t0


def test_follower_death_fails_the_leaders_requests(tmp_path):
    """A follower killed mid-serving: the leader's in-flight request ends in
    an error (the collective it was in breaks, or the broadcast times out,
    or the watchdog sees the stalled counter) within the sync timeout and
    the watchdog's two polls, not a hang."""
    fin, secs = _leader_of_two(_death_rank, (str(tmp_path / "store"),),
                               timeout=90)
    assert fin.startswith("error"), fin
    assert secs < 4.0 + 2 * 1.0 + 5.0, secs


# ---- the server's own entry point ------------------------------------------


def test_server_tp2_serves_a_chat_completion():
    """`python -m gabby_tpu_torch.server --device cpu --tp 2`: the leader
    starts its follower, serves one chat completion, and on SIGTERM the
    shutdown plan releases the follower; both exit 0."""
    try:
        from gabby_tpu_torch.bridge import build_native
        build_native()
    except Exception as e:  # no toolchain in this environment
        pytest.skip(f"native front-end unavailable: {e}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gabby_tpu_torch.server", "--device", "cpu",
         "--tp", "2", "--preset", "tiny", "--random-weights", "--port", "0",
         "--slots", "2", "--max-seq", "128", "--kv-quant", "--quant", "4",
         "--log-level", "0", "--workers", "2", "--sync-timeout", "30"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    seen = []
    try:
        port = None
        deadline = time.monotonic() + 90
        while port is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            seen.append(line)
            if line.startswith("listening on port"):
                port = int(line.split()[-1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(
            {"model": "tiny", "max_tokens": 5, "messages": [
                {"role": "user", "content": "hello"}]}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
        assert resp.status == 200, body
        assert body["usage"]["completion_tokens"] == 5
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    while not lines.empty():
        seen.append(lines.get())
    text = "".join(seen)
    assert "follower 1/2 serving leader plans" in text, text
    assert "data plane gloo" in text and "warm-up skipped" in text, text
