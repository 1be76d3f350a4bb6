"""Whether the served tokens are right: the plain reference over a sample
of the finished requests, drawn from the seed with the longest among them.

For every served token of the sample (the first, from a prefill chunk or
a burst's batched chunk, and every one after it, from decode steps through
the int8 cache) the reference's float32 logits at the position that
predicts it give two numbers:
  max_gap     the widest gap by which the served token's logit lies below
              the reference's best (greedy serving: 0 where they agree)
  max_lp_err  the widest distance between the log-probability the engine
              reported for the token (`Request.token_logprobs`) and the
              reference's
  rms_lp_err  the root mean square of that distance over every served
              token of the sample: steadier from seed to seed than a
              widest gap, which swings by its nature
The configuration file's `check` gives the numbers held to a limit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref

TARGET_SERVED = 512   # served tokens a sample reaches at least ...
MIN_REQUESTS = 8      # ... over at least this many requests ...
TOKEN_BUDGET = 50000  # ... unless prompt + served tokens would pass this


def sample(records, seed: int) -> list:
    """Finished requests: the one with the most served tokens, then others
    in an order of the seed's, until the sample is large enough."""
    done = [r for r in records
            if r.finish in ("stop", "length") and r.request.token_ids]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i].request.token_ids),
                                 done[i].prompt_len))
    order = [longest] + [int(i) for i in np.random.default_rng(
        [int(seed), 3]).permutation(len(done)) if i != longest]
    out, served, total = [], 0, 0
    for i in order:
        req = done[i].request
        n = len(req.prompt_ids) + len(req.token_ids)
        if out and total + n > TOKEN_BUDGET:
            break
        out.append(done[i])
        served += len(req.token_ids)
        total += n
        if served >= TARGET_SERVED and len(out) >= MIN_REQUESTS:
            break
    return out


def numbers(shape, weights: dict, picked: list) -> dict:
    """max_gap and max_lp_err over the sample's served tokens, and the
    counts they were taken over."""
    seqs, starts, served, lps = [], [], [], []
    for r in picked:
        req = r.request
        toks = list(req.token_ids)
        seqs.append(list(req.prompt_ids) + toks)
        starts.append(len(req.prompt_ids))
        served.append(toks)
        lps.append(list(req.token_logprobs))
    logits = ref.logits(shape, weights, seqs, starts)
    gap = lp_err = sq = 0.0
    for lg, toks, lp in zip(logits, served, lps):
        t = torch.tensor(toks, device=lg.device)
        at = lg.gather(1, t[:, None])[:, 0]
        gap = max(gap, float((lg.max(dim=1).values - at).max()))
        ref_lp = at - torch.logsumexp(lg, dim=1)
        prog = torch.tensor(lp, device=lg.device, dtype=torch.float32)
        lp_err = max(lp_err, float((prog - ref_lp).abs().max()))
        sq += float(((prog - ref_lp) ** 2).sum())
    n = sum(map(len, served))
    return {"max_gap": gap, "max_lp_err": lp_err,
            "rms_lp_err": (sq / n) ** 0.5, "requests": len(picked),
            "tokens": n}


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": nums.get(k), "limit": v} for k, v in limits.items()}
    ok = all(s["value"] is not None and s["value"] <= s["limit"]
             for s in shown.values())
    return ok, shown
