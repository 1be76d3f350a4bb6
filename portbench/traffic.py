"""The one traffic generator: a traffic file of parameters -> requests.

A traffic file (`traffic/<name>.json`) holds:
  loop        "open" (Poisson arrivals at `rate_rps`) or "closed"
              (`clients` callers, each sending its next request when its
              last one ends)
  slots       the engine's batch slots
  prompt, output   {"median", "sigma", "min", "max"}: log-normal lengths
  preroll_s   seconds of the same traffic served before the window
  trace_slice_s    seconds profiled in the middle of a traced window
  block       requests per block: each block is a whole set of quantiles
  order       "seed" (the default: each block in an order of the seed's)
              or "fixed" (a closed loop's blocks in the same order for
              every seed)

The cell fixes the multiset of lengths: a set of n requests takes the
quantiles (i + 1/2) / n of both distributions, paired by a permutation
that does not depend on the seed; an open loop's gaps between arrivals
are likewise the quantiles of the exponential distribution. The seed only
orders the requests (unless the order is fixed) and the gaps, and draws
the token ids. An open loop's
pre-roll and window are each a whole number of blocks (about rate x
seconds requests); a closed loop takes its requests from consecutive
blocks. Each block is a whole set in an order of the seed's, so every
stretch of a run offers the same mix.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

PAIRING_SEED = 20240417  # fixed: the pairing of prompt and output quantiles


@dataclasses.dataclass
class Planned:
    prompt_len: int
    max_tokens: int
    at: float = 0.0  # seconds from the start of the pre-roll (open loop)


def quantile_lengths(dist: dict, n: int) -> list[int]:
    """n lengths at the quantiles (i + 1/2) / n of a log-normal, rounded
    and clipped to [min, max]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(dist["max"], max(dist["min"], round(x)))))
    return out


def length_set(traffic: dict, n: int, max_seq: int) -> list[tuple[int, int]]:
    """The fixed multiset of (prompt, output) lengths of n requests: every
    request fits the cache (prompt + output < max_seq)."""
    prompts = quantile_lengths(traffic["prompt"], n)
    outputs = quantile_lengths(traffic["output"], n)
    perm = np.random.default_rng(PAIRING_SEED).permutation(n)
    pairs = []
    for p, j in zip(prompts, perm):
        p = min(p, max_seq - 2)
        pairs.append((p, max(1, min(outputs[j], max_seq - 1 - p))))
    return pairs


def gaps(rate: float, n: int) -> list[float]:
    """n gaps between arrivals at the quantiles (i + 1/2) / n of the
    exponential distribution of mean 1 / rate: a Poisson process's gaps
    as a fixed multiset."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def open_loop(traffic: dict, seconds: float, seed: int,
              max_seq: int) -> tuple[list[Planned], list[Planned]]:
    """(pre-roll requests, window requests) with their arrival times. Each
    part, [0, pre-roll) and [pre-roll, pre-roll + seconds), takes about
    rate x span requests, a whole number of blocks; each block is a whole
    set of lengths and of gaps in an order of the seed's, its gaps scaled
    so the part spans its seconds. So the seed moves when requests come
    and not how much is offered, in any stretch of the run."""
    rng = np.random.default_rng([int(seed), 1])
    rate, pre = traffic["rate_rps"], traffic["preroll_s"]
    block = traffic.get("block", 8)
    pairs = length_set(traffic, block, max_seq)
    base = np.array(gaps(rate, block))
    parts = []
    for start, span in ((0.0, pre), (pre, seconds)):
        blocks = max(1, round(rate * span / block))
        order = np.concatenate([rng.permutation(block)
                                for _ in range(blocks)])
        g = np.concatenate([base[rng.permutation(block)]
                            for _ in range(blocks)])
        g *= span / g.sum()
        times = start + np.cumsum(g) - g[0] * rng.uniform()
        parts.append([Planned(pairs[o][0], pairs[o][1], float(t))
                      for o, t in zip(order, times)])
    return parts[0], parts[1]


def closed_loop(traffic: dict, seed: int, max_seq: int):
    """An endless iterator of requests for the closed loop's clients. With
    `"order": "fixed"` every seed sends the same sequence: a window that
    sees a few dozen of a long-output loop's requests holds the lengths
    that the order puts in flight, so a seed's order would change the work
    measured."""
    if traffic.get("order", "seed") == "fixed":
        rng = np.random.default_rng(PAIRING_SEED + 1)
    else:
        rng = np.random.default_rng([int(seed), 2])
    block = traffic.get("block", 64)
    pairs = length_set(traffic, block, max_seq)
    while True:
        for o in rng.permutation(block):
            yield Planned(pairs[o][0], pairs[o][1])


def token_ids(rng: np.random.Generator, n: int, vocab: int, bos: int,
              eos: list[int]) -> list[int]:
    """bos, then n - 1 ids drawn uniformly from the vocabulary above bos
    and eos (the special ids sit at its bottom)."""
    lo = max(bos, *eos) + 1
    return [bos] + rng.integers(lo, vocab, size=max(0, n - 1)).tolist()
