"""Generation loops (counterpart of gabby_tpu/runtime/generate.py).

`decode_loop` runs a burst of decode steps with every piece of slot state
— tokens, positions, active lanes, sampling parameters — on the device:
the sampled token feeds the next step there and EOS is detected there, so
the host pays ONE fetch per burst (`pack_host_view`), not one per token.
Dead lanes (finished or empty slots) keep shapes static and read one cache
row. `spec_decode_loop` is the speculative form: each macro-step drafts
from the slot's own token history and verifies the drafts in one forward.
The cache (dense or paged) is updated in place by the model steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops import sampling
from gabby_tpu_torch.runtime.kv_cache import KVCache


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling parameters (tensors on the device) and the
    engine's random stream."""

    temperature: torch.Tensor  # [B] f32; 0 = greedy
    top_k: torch.Tensor        # [B] int32; 0 = disabled
    top_p: torch.Tensor        # [B] f32; 1.0 = disabled
    generator: torch.Generator

    @staticmethod
    def greedy(batch: int, device, seed: int = 0) -> "SamplingState":
        return SamplingState(
            temperature=torch.zeros(batch, dtype=torch.float32,
                                    device=device),
            top_k=torch.zeros(batch, dtype=torch.int32, device=device),
            top_p=torch.ones(batch, dtype=torch.float32, device=device),
            generator=torch.Generator(device=device).manual_seed(seed))


def decode_loop(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, active: torch.Tensor,
                cache: KVCache, sstate: SamplingState, num_steps: int,
                eos_ids: Optional[torch.Tensor] = None,
                window: Optional[int] = None):
    """Run `num_steps` decode iterations on the device.

    tokens [B] int32 current token per slot; positions [B] int32 its cache
    index; active [B] bool; eos_ids [E] int32 stop set. window: bound on
    every active slot's live context for the whole burst.

    Returns (out_tokens [K, B], out_active [K, B] — which tokens a live
    slot emitted — and the final tokens, positions, active). The cache is
    updated in place."""
    max_seq = cache.max_seq
    one = torch.ones_like(positions)
    out_tokens, out_active = [], []
    for _ in range(num_steps):
        read_pos = torch.where(active, positions, one)
        logits, cache = llama.decode_step(params, cfg, tokens, positions,
                                          cache, window=window,
                                          attn_positions=read_pos)
        nxt = sampling.sample(logits, sstate.generator,
                              temperature=sstate.temperature,
                              top_k=sstate.top_k, top_p=sstate.top_p)
        nxt = torch.where(active, nxt, tokens)
        out_tokens.append(nxt)
        out_active.append(active)
        positions = torch.where(active, positions + 1, positions)
        if eos_ids is not None:
            active = active & ~torch.isin(nxt, eos_ids)
        # hard stop at cache capacity (the slot's next write would overflow)
        active = active & (positions < max_seq)
        tokens = nxt
    return (torch.stack(out_tokens), torch.stack(out_active), tokens,
            positions, active)


def spec_decode_loop(params, cfg: ModelConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, active: torch.Tensor, cache,
                     sstate: SamplingState, history: torch.Tensor,
                     num_steps: int, draft_len: int, eos_ids: torch.Tensor,
                     window: Optional[int] = None):
    """Speculative decode: `num_steps` MACRO-steps, each verifying up to
    `draft_len` n-gram drafts in one forward (llama.verify_step), so one
    weight stream can yield several tokens.

    Drafting is prompt-lookup (no draft model): find the most recent
    occurrence of the slot's current bigram in its own token `history`
    [B, S] and propose the tokens that followed it. Greedy slots only:
    acceptance compares drafts against the exact argmax, so in exact
    arithmetic the emitted stream equals plain decode's. Sampled
    (temperature > 0) lanes draft nothing and behave like decode_loop.

    Returns (out_tokens [K, B, draft_len + 1], out_counts [K, B] — tokens
    emitted per slot per macro-step, 0 for inactive lanes — and the final
    tokens, positions, active). The cache and `history` are updated in
    place."""
    max_seq = cache.max_seq
    d = draft_len
    t_blk = d + 1
    b, s_hist = history.shape
    dev = tokens.device
    j = torch.arange(s_hist - 1, device=dev)
    tpos = torch.arange(t_blk, device=dev)[None, :]
    darange = torch.arange(d, device=dev)[None, :]
    greedy = sstate.temperature <= 0.0
    one = torch.ones_like(positions)
    out_em, out_n = [], []
    for _ in range(num_steps):
        pos = positions.long()
        # ---- draft: most recent bigram match in the slot's own history
        prev = torch.gather(history, 1,
                            torch.clamp(pos - 1, min=0)[:, None])[:, 0]
        matches = ((history[:, :-1] == prev[:, None])
                   & (history[:, 1:] == tokens[:, None])
                   & (j[None, :] + 1 < pos[:, None])
                   & (pos[:, None] > 0))
        jstar = torch.argmax(torch.where(matches, j[None, :], -1), dim=1)
        found = matches.any(dim=1)
        # near the window end a slot stops DRAFTING (the extra block rows
        # would cross max_seq) but still emits single tokens to the same
        # cache-capacity bound as decode_loop
        cap_ok = pos + t_blk <= max_seq
        # draft tokens = history[jstar + 2 ..], only as far as KNOWN history
        navail = torch.clamp(pos - (jstar + 1), 0, d)
        count = torch.where(found & active & cap_ok & greedy, navail,
                            torch.zeros_like(navail))
        didx = torch.clamp(jstar[:, None] + 2 + darange, 0, s_hist - 1)
        draft = torch.gather(history, 1, didx)  # [B, d]

        # ---- verify all candidates in one forward
        tokens_bt = torch.cat([tokens[:, None], draft], dim=1)
        read_pos = torch.where(active, positions, one)
        logits_bt, cache = llama.verify_step(params, cfg, tokens_bt,
                                             positions, cache, window=window,
                                             attn_positions=read_pos)
        pred = torch.argmax(logits_bt, dim=-1).to(torch.int32)  # [B, T]
        # sampled lanes: token 0 via the full sampler (their count is 0)
        em0 = sampling.sample(logits_bt[:, 0], sstate.generator,
                              temperature=sstate.temperature,
                              top_k=sstate.top_k, top_p=sstate.top_p)
        em = torch.cat([em0[:, None].to(torch.int32), pred[:, 1:]], dim=1)

        # accepted drafts: the longest prefix where each draft equals the
        # argmax the verify computed for the PRECEDING position
        okd = (draft == pred[:, :-1]) & (darange < count[:, None])
        acc = torch.cumprod(okd.long(), dim=1).sum(dim=1)
        n_emit = torch.where(active, acc + 1, torch.zeros_like(acc))
        # clamp to capacity FIRST (decode_loop's bound), so an EOS beyond
        # the clamp does not read as "stop"; then cut at the first EOS
        n_emit = torch.minimum(n_emit, torch.clamp(max_seq - pos, min=0))
        is_eos = torch.isin(em, eos_ids)
        eos_pos = torch.where(is_eos, tpos, t_blk).min(dim=1).values
        hit_eos = eos_pos < n_emit
        n_emit = torch.minimum(n_emit, eos_pos + 1)

        last_ix = torch.clamp(n_emit - 1, min=0)
        new_tok = torch.where(n_emit > 0,
                              torch.gather(em, 1, last_ix[:, None])[:, 0],
                              tokens)
        new_pos = pos + n_emit
        # append the emitted tokens to history (rows past the new position
        # are untrusted and excluded by the search's position bound)
        upd_idx = torch.clamp(pos[:, None] + 1 + tpos, 0, s_hist - 1)
        keep = tpos < n_emit[:, None]
        history.scatter_(1, upd_idx,
                         torch.where(keep, em,
                                     torch.gather(history, 1, upd_idx)))
        out_em.append(em)
        out_n.append(n_emit)
        active = active & ~hit_eos & (new_pos < max_seq)
        tokens = new_tok
        positions = new_pos.to(positions.dtype)
    return (torch.stack(out_em), torch.stack(out_n), tokens, positions,
            active)


def write_history(history: torch.Tensor, row: int, ids: torch.Tensor,
                  length: int) -> None:
    """Admission time: place a slot's prompt ids (padded to the history's
    width) at history[row], in place; entries past `length` are zeroed so
    stale tokens cannot fake n-gram matches."""
    history[row] = ids.to(history.dtype)
    history[row, length:] = 0


def pack_spec_host_view(out_tokens: torch.Tensor, out_counts: torch.Tensor,
                        active: torch.Tensor,
                        pre_tokens: torch.Tensor) -> torch.Tensor:
    """Packs a speculative burst's host feedback — candidate tokens
    [K, B, T], tokens emitted per slot per macro-step [K, B], final slot
    liveness [B], and the pre-burst tokens [B] — into one int32 vector,
    fetched with one transfer."""
    return torch.cat([out_tokens.reshape(-1).to(torch.int32),
                      out_counts.reshape(-1).to(torch.int32),
                      active.to(torch.int32), pre_tokens.to(torch.int32)])


def token_logprob(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """log P(ids) under softmax(logits). logits [..., V] f32, ids [...]."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, ids[..., None].long())[..., 0]
    return chosen - lse


def pack_host_view(out_tokens: torch.Tensor, out_active: torch.Tensor,
                   active: torch.Tensor,
                   pre_tokens: torch.Tensor) -> torch.Tensor:
    """Packs a burst's host feedback — emitted tokens [K, B], their
    emitted-by mask [K, B], final slot liveness [B], and the pre-burst
    tokens [B] (the first tokens of fresh admissions, sampled on the
    device) — into one int32 vector, fetched with one transfer."""
    return torch.cat([out_tokens.reshape(-1).to(torch.int32),
                      out_active.reshape(-1).to(torch.int32),
                      active.to(torch.int32), pre_tokens.to(torch.int32)])


def prefill_slot(params, cfg: ModelConfig, tokens: torch.Tensor, length: int,
                 slot: int, offset: int, cache):
    """Single-slot chunked prefill: a [T]-bucket chunk into cache row `slot`
    at `offset`. Returns (last-valid logits [V], cache)."""
    return llama.prefill_slot(params, cfg, tokens, length, slot, offset,
                              cache)


def admit_slot(logits: torch.Tensor, slot: int, prompt_len: int,
               temperature: float, top_k: int, top_p: float,
               tokens: torch.Tensor, positions: torch.Tensor,
               active: torch.Tensor, sstate: SamplingState,
               history: Optional[torch.Tensor] = None) -> None:
    """Finalizes an admission ON THE DEVICE: samples the first token from
    the prefill logits with the request's parameters and writes the slot's
    state in place (the token reaches the host in the next packed fetch).
    With `history` (the n-gram speculation corpus, whose prompt part
    `write_history` placed) the first token is recorded at
    history[slot, prompt_len]."""
    dev = logits.device
    first = sampling.sample(
        logits[None, :], sstate.generator,
        temperature=torch.full((1,), temperature, dtype=torch.float32,
                               device=dev),
        top_k=torch.full((1,), top_k, dtype=torch.int32, device=dev),
        top_p=torch.full((1,), top_p, dtype=torch.float32, device=dev))
    tokens[slot] = first[0]
    positions[slot] = prompt_len
    active[slot] = True
    sstate.temperature[slot] = temperature
    sstate.top_k[slot] = top_k
    sstate.top_p[slot] = top_p
    if history is not None:
        history[slot, min(prompt_len, history.shape[1] - 1)] = first[0]


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                  offset: int):
    """Prefill of one [B, T] chunk at `offset` for every slot; returns the
    LAST position's logits [B, V] only (the unembed runs on the [B, 1, D]
    slice, the decode-sized form) and the cache."""
    h, cache = llama.prefill_hidden(params, cfg, tokens, cache,
                                    offset=offset)
    return llama._unembed(params, cfg, h[:, -1:])[:, 0], cache


def prefill_batch_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                        lengths: torch.Tensor, lane_mask: torch.Tensor,
                        cache, offset: int):
    """Burst admission: prefill a [B, T] chunk for the lanes in `lane_mask`
    at once (the weights stream once for the group; the other lanes' cache
    rows, possibly live, stay as they were) and return the logits [B, V] at
    each row's LAST VALID position, lengths [B] being the prompts' lengths
    (a row whose prompt ended in an earlier chunk gets garbage: a burst
    groups prompts of one chunk schedule)."""
    h, cache = llama.prefill_hidden(params, cfg, tokens, cache,
                                    offset=offset, lane_mask=lane_mask)
    b, t = tokens.shape
    ix = torch.clamp(lengths.long() - 1 - offset, 0, t - 1)
    h_last = h[torch.arange(b, device=h.device), ix]  # [B, D]
    return llama._unembed(params, cfg, h_last[:, None])[:, 0], cache


def admit_slots(logits: torch.Tensor, lengths: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor, lane_mask: torch.Tensor,
                tokens: torch.Tensor, positions: torch.Tensor,
                active: torch.Tensor, sstate: SamplingState,
                history: torch.Tensor) -> None:
    """Batched admit_slot for the lanes in `lane_mask` (burst admission):
    samples each row's first token with its own parameters and writes the
    slot state in place, the first token also at history[b, lengths[b]].
    Unmasked lanes keep their state."""
    nxt = sampling.sample(logits, sstate.generator, temperature=temperature,
                          top_k=top_k, top_p=top_p)
    lane = lane_mask
    tokens.copy_(torch.where(lane, nxt, tokens))
    positions.copy_(torch.where(lane, lengths.to(positions.dtype), positions))
    active |= lane
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    col = torch.clamp(lengths.long(), max=history.shape[1] - 1)
    history[rows, col] = torch.where(lane, nxt, history[rows, col])
    sstate.temperature.copy_(torch.where(lane, temperature,
                                         sstate.temperature))
    sstate.top_k.copy_(torch.where(lane, top_k, sstate.top_k))
    sstate.top_p.copy_(torch.where(lane, top_p, sstate.top_p))


def copy_slot_prefix(cache: KVCache, src: int, dst: int) -> KVCache:
    """Prefix reuse on the dense cache: copy slot `src`'s WHOLE cache row
    onto slot `dst`, in place. Only the common-prefix rows matter; the rest
    is overwritten by the admission's suffix prefill or by decode before
    anything reads it."""
    for arr in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if arr is not None:
            arr[:, dst] = arr[:, src]
    return cache
