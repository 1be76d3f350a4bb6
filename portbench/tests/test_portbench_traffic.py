"""The generator fixes the multiset of lengths; the seed only orders the
requests, draws the arrivals and the token ids."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from portbench import spec, traffic

SEEDS = [1, 2 ** 31 + 5, 987654321987]


@pytest.mark.parametrize("name", ["chat", "batch", "prefill"])
def test_length_multiset_fixed_across_seeds(name):
    t = spec.traffic(name)
    if t["loop"] == "open":
        sets = []
        for seed in SEEDS:
            pre, win = traffic.open_loop(t, 30, seed, 4096)
            assert len(win) % t["block"] == 0
            assert abs(len(win) - t["rate_rps"] * 30) <= t["block"] / 2
            assert all(t["preroll_s"] <= p.at < t["preroll_s"] + 30
                       for p in win)
            assert [p.at for p in win] == sorted(p.at for p in win)
            assert all(0 <= p.at < t["preroll_s"] for p in pre)
            sets.append((sorted((p.prompt_len, p.max_tokens) for p in pre),
                         sorted((p.prompt_len, p.max_tokens) for p in win)))
        orders = [[(p.prompt_len, p.max_tokens) for p in
                   traffic.open_loop(t, 30, s, 4096)[1]] for s in SEEDS]
        assert orders[0] != orders[1]
    else:
        block = t["block"]
        sets = []
        for seed in SEEDS:
            reqs = list(itertools.islice(
                traffic.closed_loop(t, seed, 4096), 3 * block))
            sets.append([sorted((p.prompt_len, p.max_tokens)
                                for p in reqs[i:i + block])
                         for i in range(0, 3 * block, block)])
            assert sets[-1][0] == sets[-1][1] == sets[-1][2]
    assert all(s == sets[0] for s in sets)


def test_fixed_order_is_the_same_for_every_seed():
    t = dict(spec.traffic("batch"), order="fixed")
    seqs = [[(p.prompt_len, p.max_tokens) for p in itertools.islice(
        traffic.closed_loop(t, s, 4096), 3 * t["block"])] for s in SEEDS]
    assert seqs[0] == seqs[1] == seqs[2]
    t["order"] = "seed"
    seqs = [[(p.prompt_len, p.max_tokens) for p in itertools.islice(
        traffic.closed_loop(t, s, 4096), 3 * t["block"])] for s in SEEDS]
    assert seqs[0] != seqs[1]


@pytest.mark.parametrize("name", ["chat", "batch", "prefill"])
def test_lengths_within_clips_and_cache(name):
    t = spec.traffic(name)
    pairs = traffic.length_set(t, 200, 4096)
    for p, o in pairs:
        assert t["prompt"]["min"] <= p <= t["prompt"]["max"]
        assert 1 <= o <= t["output"]["max"]
        assert p + o < 4096
    med = sorted(p for p, _ in pairs)[100]
    assert abs(med - t["prompt"]["median"]) <= 0.05 * t["prompt"]["median"]


def test_token_ids_skip_specials():
    ids = traffic.token_ids(np.random.default_rng(0), 5000, 300, 1, [2])
    assert ids[0] == 1 and len(ids) == 5000
    assert min(ids[1:]) >= 3 and max(ids) < 300
