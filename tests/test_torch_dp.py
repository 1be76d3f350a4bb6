"""Data-parallel serving of the port (`--dp`, the data axis of parallel/):
the counterpart of tests/test_multihost.py's dp = 2 case and of the
reference server's --dp checks.

Two gloo ranks (dp = 2, tp = 1, each a process of its own joined through a
FileStore in tmp_path, one spawn with its own timeout) serve eight
requests on four slots, two a replica, dense and on the paged pool: greedy
ones (one of them past a 64-token chunk, one cut by a stop string, one
with penalties and logit_bias, one with top_logprobs), a seeded sampled
one and two unseeded sampled ones. Every request is queued before the
leader's first plan (the engine's ingress is held until then), so the
admissions do not depend on thread timing. Both ranks' records must be
identical, and every stream must equal the port's single-process engine's
(dp = 1) token for token, logprobs within 1e-5 and top rows equal: the
unseeded draw is made over the whole slot batch on every replica
(sampling.uniforms), so a lane draws the same at dp = 1 and 2. The greedy
streams must also equal gabby_tpu's engine on a dp = 2 mesh of the
conftest's virtual CPU devices, token for token up to a near-tie (a
position where the two sides' best logprobs lie within NEAR_TIE, the int8
rows' difference), with the logprobs before it within NEAR_TIE (the
seeded stream is a counter hash in the port, and the unseeded one not
threefry).

Then the designed divergences and refusals: a prefix donor is taken only
from the destination's own replica; pair_kv_heads and a slot count dp
does not divide are refused; the server takes --dp, --sp-ring and
--sp-prefill-tokens, refuses --slots that --dp does not divide and a grid
larger than the visible cards with the reference's messages, and serves a
chat completion through `python -m gabby_tpu_torch.server --device cpu
--dp 2 --sp-ring`."""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch import server as tserver
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.parallel import collectives, init_distributed
from gabby_tpu_torch.parallel.mesh import spawn_ranks
from gabby_tpu_torch.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEQ = 128
STOP = 1
# request index -> (prompt ids, submit arguments); the stop string of
# request 2 is cut from its dp = 1 text (`stop` fixture)
REQUESTS = [
    (list(range(2, 12)), {}),
    ([7] * 70, {}),
    (list(range(30, 45)), {}),
    (list(range(14, 26)), dict(presence_penalty=1.0, frequency_penalty=0.5,
                               logit_bias={3: 5.0})),
    (list(range(90, 99)), dict(top_logprobs=3)),
    (list(range(50, 60)), dict(temperature=1.0, top_k=8, seed=123)),
    (list(range(80, 90)), dict(temperature=1.2, top_p=0.9)),
    (list(range(100, 140)), dict(temperature=1.0)),
]
GREEDY = [0, 1, 2, 3, 4]
# the port's int8-cache logprobs sit within about 1e-2 of gabby_tpu's (an
# int8 code that rounds one step apart; tests/test_torch_tp.py's bound),
# so a greedy token whose best two candidates lie closer may flip
NEAR_TIE = 1e-2
CONFIGS = {"dense": {}, "paged": dict(paged_pages=1 + 4 * 8, page_size=16)}
BASE = dict(batch_slots=4, max_seq=MAX_SEQ, steps_per_call=4,
            steps_per_call_busy=2, default_max_tokens=6,
            cache_dtype="float32", kv_quantized=True,
            # no age guard: it reads the wall clock
            spf_age_limit=1e9)


def _port_params(tree):
    return tllama.fuse_projections(tllama.params_from_numpy(tree,
                                                            device="cpu"))


def _serve(make, leader: bool, stop: str):
    """Build an engine (make()) with its ingress held, queue every request
    on the leader, release it, drain: the leader's per-request (tokens,
    finish, logprobs, top rows); followers replay until the shutdown
    plan. Returns (outputs or None, the records of every finished slot:
    prompt, tokens, logprobs)."""
    from gabby_tpu_torch.runtime.engine import Engine

    gate = threading.Event()
    real_drain, real_finish = Engine._drain_ingress, Engine._finish
    records = []

    def drain(self):
        gate.wait()
        real_drain(self)

    def finish(self, slot_ix, reason):
        s = self._slots[slot_ix]
        if s is not None:
            records.append((tuple(s.request.prompt_ids),
                            tuple(s.request.token_ids),
                            tuple(s.request.token_logprobs)))
        real_finish(self, slot_ix, reason)

    Engine._drain_ingress, Engine._finish = drain, finish
    try:
        eng = make()
        out = None
        if leader:
            reqs = [eng.submit_ids(ids, max_tokens=6,
                                   **(dict(kw, stop=[stop]) if i == 2
                                      else kw))
                    for i, (ids, kw) in enumerate(REQUESTS)]
            gate.set()
            out = []
            for r in reqs:
                while True:
                    _, fin = r.out.get(timeout=120)
                    if fin is not None:
                        break
                out.append((list(r.token_ids), fin, list(r.token_logprobs),
                            [list(map(tuple, row)) for row in r.token_top]))
            eng.shutdown()
        else:
            gate.set()
            eng._thread.join(timeout=120)
            assert not eng._thread.is_alive()
    finally:
        Engine._drain_ingress, Engine._finish = real_drain, real_finish
    return out, sorted(records)


def _engine(tree, sync=None, **kw):
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    cfg = tcfg.tiny(max_seq_len=MAX_SEQ)
    return Engine(cfg, _port_params(tree),
                  Tokenizer.byte_fallback(cfg.vocab_size),
                  EngineConfig(**{**BASE, **kw}), device="cpu",
                  stop_ids={STOP}, sync=sync)


def _dp_rank(rank: int, nprocs: int, store_path: str, tree_path: str,
             stop: str) -> dict:
    import pickle

    import torch.distributed as dist
    from gabby_tpu_torch.parallel.multihost import HostSync

    group = init_distributed(None, nprocs, rank, dp=nprocs, device="cpu",
                             store=dist.FileStore(store_path, nprocs),
                             timeout=60)
    sync = HostSync(group, timeout=60)
    with open(tree_path, "rb") as f:
        tree = pickle.load(f)
    out = {}
    try:
        for label, extra in CONFIGS.items():
            collectives.reset_counts()
            outs, records = _serve(lambda: _engine(tree, sync, **extra),
                                   sync.is_leader, stop)
            out[label] = dict(outs=outs, records=records,
                              counts=dict(collectives.counts))
    finally:
        group.close()
    return out


def _jax_model():
    import jax
    import jax.numpy as jnp
    from gabby_tpu import config as jcfg
    from gabby_tpu.models import llama as jllama
    from gabby_tpu.ops import quant as jquant

    from test_torch_model import to_numpy_tree

    jc = jcfg.tiny(max_seq_len=MAX_SEQ)
    params = jquant.quantize_tree(jllama.init_params(
        jc, jax.random.PRNGKey(0), dtype=jnp.float32), 8)
    return jc, params, to_numpy_tree(params)


@pytest.fixture(scope="module")
def model():
    return _jax_model()


@pytest.fixture(scope="module")
def stop(model):
    """A stop string inside request 2's greedy dp = 1 text."""
    *_, tree = model
    eng = _engine(tree)
    try:
        req = eng.submit_ids(REQUESTS[2][0], max_tokens=6)
        while req.out.get(timeout=60)[1] is None:
            pass
        text = eng.tokenizer.decode(req.token_ids)
    finally:
        eng.shutdown()
    assert len(text) >= 4
    return text[2:4]


@pytest.fixture(scope="module")
def runs(model, stop, tmp_path_factory):
    """dp = 2 (both ranks) and dp = 1 (this process), each configuration."""
    import pickle

    *_, tree = model
    d = tmp_path_factory.mktemp("dp")
    with open(d / "tree.pkl", "wb") as f:
        pickle.dump(tree, f)
    ranks = spawn_ranks(_dp_rank, 2, (str(d / "store"), str(d / "tree.pkl"),
                                      stop), timeout=180)
    one = {label: _serve(lambda: _engine(tree, **extra), True, stop)
           for label, extra in CONFIGS.items()}
    return ranks, one


@pytest.mark.parametrize("label", list(CONFIGS))
def test_dp2_ranks_hold_identical_records(runs, label):
    ranks, _ = runs
    lead, follow = (r[label] for r in ranks)
    assert lead["records"] == follow["records"]
    assert len(lead["records"]) == len(REQUESTS)
    # one gathered view a decode burst, on both ranks alike
    assert lead["counts"]["gather_slots"] == \
        follow["counts"]["gather_slots"] > 0
    # request 4's first top rows crossed from its slot's replica
    assert lead["counts"]["from_replica"] >= 1


@pytest.mark.parametrize("label", list(CONFIGS))
def test_dp2_streams_equal_dp1(runs, label):
    """Greedy, seeded and unseeded streams, finishes, logprobs and top
    rows: dp = 2 as at dp = 1."""
    ranks, one = runs
    got, want = ranks[0][label]["outs"], one[label][0]
    assert [g[1] for g in got] == [w[1] for w in want]
    assert want[2][1] == "stop" and len(want[2][0]) < 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], (i, g[0], w[0])
        np.testing.assert_allclose(g[2], w[2], rtol=1e-5, atol=1e-5)
        assert [[t for t, _ in row] for row in g[3]] == \
            [[t for t, _ in row] for row in w[3]]
        for grow, wrow in zip(g[3], w[3]):
            np.testing.assert_allclose([x for _, x in grow],
                                       [x for _, x in wrow], atol=1e-5)
    assert len(got[4][3]) == len(got[4][0]) > 0  # top rows, first included
    # the sampled lanes did sample (not the greedy token every step)
    assert got[6][0] != got[7][0]


@pytest.mark.parametrize("label", list(CONFIGS))
def test_dp2_greedy_streams_equal_the_reference_on_a_dp2_mesh(model, runs,
                                                              stop, label):
    import jax
    from gabby_tpu.parallel import (cache_shardings, make_mesh,
                                    paged_cache_shardings, shard_params)
    from gabby_tpu.runtime.engine import Engine as JEngine
    from gabby_tpu.runtime.engine import EngineConfig as JEngineConfig
    from gabby_tpu.tokenizer import Tokenizer as JTokenizer

    jc, params, _ = model
    ranks, _ = runs
    mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    shardings = (paged_cache_shardings if label == "paged"
                 else cache_shardings)(mesh, True)
    gate = threading.Event()
    real = JEngine._drain_ingress

    def drain(self):
        gate.wait()
        real(self)

    JEngine._drain_ingress = drain
    try:
        eng = JEngine(jc, shard_params(params, mesh),
                      JTokenizer.byte_fallback(jc.vocab_size),
                      JEngineConfig(**BASE, **CONFIGS[label]),
                      cache_shardings=shardings, stop_ids={STOP})
        try:
            reqs = [eng.submit_ids(REQUESTS[i][0], max_tokens=6,
                                   **(dict(REQUESTS[i][1], stop=[stop])
                                      if i == 2 else REQUESTS[i][1]))
                    for i in GREEDY]
            gate.set()
            for r in reqs:
                while r.out.get(timeout=300)[1] is None:
                    pass
            want = [(list(r.token_ids), list(r.token_logprobs))
                    for r in reqs]
        finally:
            eng.shutdown()
    finally:
        JEngine._drain_ingress = real
    for i, (tokens, lps) in zip(GREEDY, want):
        got, _, got_lps, _ = ranks[0][label]["outs"][i]
        n = next((j for j, (a, b) in enumerate(zip(got, tokens)) if a != b),
                 None)
        if n is None:
            assert got == tokens, i
            continue
        # a near-tie: both tokens are their side's best, and the sides'
        # logprobs differ by what the int8 rows do (NEAR_TIE)
        assert abs(got_lps[n] - lps[n]) <= NEAR_TIE, (i, n, got, tokens)
        np.testing.assert_allclose(got_lps[:n], lps[:n], atol=NEAR_TIE)


# ---- designed divergences and refusals, in this process --------------------


class _Grid:
    """A stand-in HostSync of a dp = 2 grid's rank 0 that never leaves
    this process: the plan broadcast hands the plan back."""

    def __init__(self):
        self.group = types.SimpleNamespace(dp_size=2, dp_rank=0, size=1,
                                           rank=0)
        self.num_processes, self.process_index = 2, 0
        self.is_leader, self.timeout, self.store = True, None, None

    def broadcast(self, payload=None, timeout=None):
        return payload


def test_a_prefix_donor_stays_on_its_replica(model):
    """Replica 0 holds slots 0 and 1, replica 1 slots 2 and 3: a resident
    prompt in slot 2 donates to slot 3 and not to slot 0 (its rows are on
    the other replica's device), where dp = 1 takes it for any slot."""
    *_, tree = model
    prompt = list(range(2, 2 + 96))
    want = (2, 80)
    eng = _engine(tree, _Grid())
    one = _engine(tree)
    for e in (eng, one):
        e.shutdown()
        e._slot_prompts[2] = list(prompt)
    assert eng._find_donor(prompt[:80] + [5], 3) == want
    assert eng._find_donor(prompt[:80] + [5], 0) == (-1, 0)
    assert eng._find_donor(prompt[:80] + [5]) == want
    assert one._find_donor(prompt[:80] + [5], 0) == want
    assert eng._cache.k.shape[1] == 2 and eng._lo == 0
    assert eng._sstate.draw_total == 4


def test_grid_refusals(model):
    *_, tree = model
    with pytest.raises(ValueError, match="pair_kv_heads"):
        _engine(tree, _Grid(), pair_kv_heads=True)
    with pytest.raises(ValueError, match="divisible by dp=2"):
        _engine(tree, _Grid(), batch_slots=3)


def test_server_takes_the_data_axis_flags():
    args = tserver.build_parser().parse_args(
        ["--dp", "2", "--sp-ring", "--sp-prefill-tokens", "512"])
    assert (args.dp, args.sp_ring, args.sp_prefill_tokens) == (2, True, 512)
    assert not hasattr(tserver, "_NOT_PORTED")  # nothing is refused
    defaults = tserver.build_parser().parse_args([])
    assert (defaults.dp, defaults.sp_ring,
            defaults.sp_prefill_tokens) == (1, False, 1024)
    assert tserver.build_parser().parse_args(
        ["--dp", "2", "--profiler-port", "9000"]).profiler_port == 9000


def test_server_refuses_slots_dp_does_not_divide():
    with pytest.raises(SystemExit, match=r"--slots 3 must be divisible by "
                       r"--dp 2 \(slots shard over the data axis\)"):
        tserver.main(["--dp", "2", "--slots", "3", "--device", "cpu"])


def test_server_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"--dp 2 --tp 1 needs 2 visible "
                       r"cards; 1 visible \(dp\*tp = 2\*1 != 1 devices\)"):
        tserver.main(["--dp", "2"])
    with pytest.raises(SystemExit, match="must divide the global device "
                       "count 3"):
        tserver.main(["--dp", "2", "--coordinator", "127.0.0.1:1",
                      "--num-processes", "3", "--process-id", "0"])


def test_server_dp2_serves_a_chat_completion():
    """`python -m gabby_tpu_torch.server --device cpu --dp 2 --sp-ring
    --sp-prefill-tokens 16`: the leader starts its follower (replica 1),
    serves a chat completion whose 64-token admission chunk takes the
    ring, and on SIGTERM both exit 0."""
    try:
        from gabby_tpu_torch.bridge import build_native
        build_native()
    except Exception as e:  # no toolchain in this environment
        pytest.skip(f"native front-end unavailable: {e}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gabby_tpu_torch.server", "--device", "cpu",
         "--dp", "2", "--sp-ring", "--sp-prefill-tokens", "16", "--preset",
         "tiny", "--random-weights", "--port", "0", "--slots", "2",
         "--max-seq", "128", "--kv-quant", "--quant", "8", "--log-level",
         "0", "--workers", "2", "--sync-timeout", "30"],
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
        assert body["usage"]["prompt_tokens"] > 16
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
    assert "dp 1/2, tp rank 0/1 on cpu" in text, text
