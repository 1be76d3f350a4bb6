"""Generation loops (counterpart of gabby_tpu/runtime/generate.py).

`decode_loop` runs a burst of decode steps with every piece of slot state
— tokens, positions, active lanes, sampling parameters — on the device:
the sampled token feeds the next step there and EOS is detected there, so
the host pays ONE fetch per burst (`pack_host_view`), not one per token.
Dead lanes (finished or empty slots) keep shapes static and read one cache
row. `spec_decode_loop` is the speculative form: each macro-step drafts
from the slot's own token history and verifies the drafts in one forward.
The cache (dense or paged) is updated in place by the model steps.

Every emitted token carries its log-probability under the full softmax
(`token_logprob`), and with `n_top > 0` the exact top-n alternatives
(`top_candidates`, OpenAI `top_logprobs`). OpenAI penalties and
logit_bias (`PenaltyState`) adjust the distribution that sampling and the
reported logprobs both see; the state is updated in place.

While torch.profiler records, each prefill entry is a `gabby.model.prefill`
span, each step's forward a `gabby.model.decode_step` and its sampling a
`gabby.model.sample` (runtime/tracing.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.models import llama
from gabby_tpu_torch.ops import sampling
from gabby_tpu_torch.runtime import tracing
from gabby_tpu_torch.runtime.kv_cache import KVCache


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling parameters (tensors on the device) and the
    engine's random stream."""

    temperature: torch.Tensor  # [B] f32; 0 = greedy
    top_k: torch.Tensor        # [B] int32; 0 = disabled
    top_p: torch.Tensor        # [B] f32; 1.0 = disabled
    generator: torch.Generator
    # OpenAI `seed`: -1 = the engine's stream; >= 0 = the lane draws from
    # its own (seed, position) stream (sampling.lane_gumbel)
    seed: torch.Tensor         # [B] int32
    # these B lanes are lanes [draw_offset, draw_offset + B) of a slot
    # batch of draw_total (None: B) that every replica draws uniforms for
    draw_offset: int = 0
    draw_total: Optional[int] = None

    @staticmethod
    def greedy(batch: int, device, seed: int = 0, draw_offset: int = 0,
               draw_total: Optional[int] = None) -> "SamplingState":
        return SamplingState(
            temperature=torch.zeros(batch, dtype=torch.float32,
                                    device=device),
            top_k=torch.zeros(batch, dtype=torch.int32, device=device),
            top_p=torch.ones(batch, dtype=torch.float32, device=device),
            generator=torch.Generator(device=device).manual_seed(seed),
            seed=torch.full((batch,), -1, dtype=torch.int32, device=device),
            draw_offset=draw_offset, draw_total=draw_total)

    def draws(self) -> dict:
        """sampling.sample's draw arguments for these lanes."""
        return dict(draw_offset=self.draw_offset, draw_total=self.draw_total)


@dataclasses.dataclass
class PenaltyState:
    """OpenAI sampling-penalty state, per slot, on the device. The engine
    creates it when a request with penalties or logit_bias is admitted and
    drops it (None: no penalty work at all) when the last one finishes.
    Updated in place."""

    counts: torch.Tensor     # [B, V] int32: tokens SAMPLED so far (OpenAI)
    presence: torch.Tensor   # [B] f32: subtracted once per seen token
    frequency: torch.Tensor  # [B] f32: subtracted per occurrence
    bias: torch.Tensor       # [B, V] f32: logit_bias rows (zeros = off)
    # HF/vLLM-style repetition_penalty: tokens seen in the PROMPT or
    # sampled so far get logit/rep when positive, logit*rep when negative;
    # 1.0 = off. prompt_mask is the prompt half of "seen"
    rep: torch.Tensor          # [B] f32
    prompt_mask: torch.Tensor  # [B, V] bool

    @staticmethod
    def zeros(batch: int, vocab: int, device) -> "PenaltyState":
        return PenaltyState(
            counts=torch.zeros((batch, vocab), dtype=torch.int32,
                               device=device),
            presence=torch.zeros(batch, dtype=torch.float32, device=device),
            frequency=torch.zeros(batch, dtype=torch.float32, device=device),
            bias=torch.zeros((batch, vocab), dtype=torch.float32,
                             device=device),
            rep=torch.ones(batch, dtype=torch.float32, device=device),
            prompt_mask=torch.zeros((batch, vocab), dtype=torch.bool,
                                    device=device))


def penalize_row(logits: torch.Tensor, counts_row: torch.Tensor,
                 presence, frequency, bias_row: torch.Tensor, rep,
                 prompt_row: torch.Tensor) -> torch.Tensor:
    """The penalty adjustment of logits [..., V] by rows that broadcast
    against them: repetition_penalty FIRST (HF semantics, on the raw
    logits), then + bias - presence * [count > 0] - frequency * count.
    On a single [V] row it is the admission-time first token's, sampled
    from the prefill logits before the slot's rows are in the batch."""
    seen = prompt_row | (counts_row > 0)
    rep_adj = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, rep_adj, logits)
    return (logits + bias_row
            - torch.where(counts_row > 0, presence,
                          torch.zeros_like(logits))
            - counts_row.to(torch.float32) * frequency)


def apply_penalties(logits: torch.Tensor,
                    pstate: Optional[PenaltyState]) -> torch.Tensor:
    """logits [B, V] adjusted by each slot's penalty rows; the identity
    when pstate is None."""
    if pstate is None:
        return logits
    return penalize_row(logits, pstate.counts, pstate.presence[:, None],
                        pstate.frequency[:, None], pstate.bias,
                        pstate.rep[:, None], pstate.prompt_mask)


def count_token(pstate: Optional[PenaltyState], nxt: torch.Tensor,
                active: torch.Tensor) -> Optional[PenaltyState]:
    """Count the just-emitted token of every ACTIVE lane, in place (a
    no-op when penalties are off)."""
    if pstate is None:
        return None
    rows = torch.arange(nxt.shape[0], device=nxt.device)
    pstate.counts[rows, nxt.long()] += active.to(torch.int32)
    return pstate


def set_penalty_slot(pstate: PenaltyState, slot: int,
                     counts_row: torch.Tensor, presence: float,
                     frequency: float, bias_row: torch.Tensor, rep: float,
                     prompt_row: torch.Tensor) -> PenaltyState:
    """Write one slot's penalty rows at admission, in place (counts_row
    starts at zero: OpenAI counts only tokens SAMPLED so far; prompt_row
    is the prompt-presence mask repetition_penalty needs)."""
    pstate.counts[slot] = counts_row
    pstate.presence[slot] = presence
    pstate.frequency[slot] = frequency
    pstate.bias[slot] = bias_row
    pstate.rep[slot] = rep
    pstate.prompt_mask[slot] = prompt_row
    return pstate


def count_slot_token(pstate: PenaltyState, slot: int,
                     token: torch.Tensor) -> PenaltyState:
    """Count one slot's just-sampled token (the admission-time first
    token, which the decode loop's counting never sees), in place."""
    pstate.counts[slot, token.long()] += 1
    return pstate


def top_candidates(logits: torch.Tensor, n_top: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """EXACT top-n_top (logprob, id) pairs of each distribution (OpenAI
    `top_logprobs`). logits [..., V] -> ([..., n_top] f32 logprobs,
    [..., n_top] int32 ids); zero-width at n_top == 0."""
    if n_top == 0:
        shp = logits.shape[:-1] + (0,)
        return (torch.zeros(shp, dtype=torch.float32, device=logits.device),
                torch.zeros(shp, dtype=torch.int32, device=logits.device))
    tl, ti = torch.topk(logits, n_top, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    return tl - lse[..., None], ti.to(torch.int32)


def decode_loop(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, active: torch.Tensor,
                cache: KVCache, sstate: SamplingState, num_steps: int,
                eos_ids: Optional[torch.Tensor] = None,
                window: Optional[int] = None, n_top: int = 0,
                pstate: Optional[PenaltyState] = None):
    """Run `num_steps` decode iterations on the device.

    tokens [B] int32 current token per slot; positions [B] int32 its cache
    index; active [B] bool; eos_ids [E] int32 stop set. window: bound on
    every active slot's live context for the whole burst. pstate: the
    penalty rows (apply_penalties before sampling, so that sampling and
    the reported logprobs see one distribution; each emitted token is
    counted in place).

    Returns (out_tokens [K, B], out_active [K, B] — which tokens a live
    slot emitted — out_logprobs [K, B] f32, the final tokens, positions,
    active, and the top rows out_top_lp [K, B, n_top] f32 and out_top_ids
    [K, B, n_top] int32, zero-width at n_top == 0). The cache is updated
    in place."""
    max_seq = cache.max_seq
    one = torch.ones_like(positions)
    out_tokens, out_active, out_lp, out_top_lp, out_top_ids = \
        [], [], [], [], []
    for _ in range(num_steps):
        read_pos = torch.where(active, positions, one)
        with tracing.span("model.decode_step"):
            logits, cache = llama.decode_step(params, cfg, tokens, positions,
                                              cache, window=window,
                                              attn_positions=read_pos)
        with tracing.span("model.sample"):
            logits = apply_penalties(logits, pstate)
            nxt = sampling.sample(logits, sstate.generator,
                                  temperature=sstate.temperature,
                                  top_k=sstate.top_k, top_p=sstate.top_p,
                                  lane_seeds=sstate.seed,
                                  lane_positions=positions, **sstate.draws())
            out_lp.append(token_logprob(logits, nxt))
            top_lp, top_ids = top_candidates(logits, n_top)
            out_top_lp.append(top_lp)
            out_top_ids.append(top_ids)
            count_token(pstate, nxt, active)
        nxt = torch.where(active, nxt, tokens)
        out_tokens.append(nxt)
        out_active.append(active)
        positions = torch.where(active, positions + 1, positions)
        if eos_ids is not None:
            active = active & ~torch.isin(nxt, eos_ids)
        # hard stop at cache capacity (the slot's next write would overflow)
        active = active & (positions < max_seq)
        tokens = nxt
    return (torch.stack(out_tokens), torch.stack(out_active),
            torch.stack(out_lp), tokens, positions, active,
            torch.stack(out_top_lp), torch.stack(out_top_ids))


def spec_decode_loop(params, cfg: ModelConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, active: torch.Tensor, cache,
                     sstate: SamplingState, history: torch.Tensor,
                     num_steps: int, draft_len: int, eos_ids: torch.Tensor,
                     window: Optional[int] = None, n_top: int = 0):
    """Speculative decode: `num_steps` MACRO-steps, each verifying up to
    `draft_len` n-gram drafts in one forward (llama.verify_step), so one
    weight stream can yield several tokens.

    Drafting is prompt-lookup (no draft model): find the most recent
    occurrence of the slot's current bigram in its own token `history`
    [B, S] and propose the tokens that followed it. Greedy slots only:
    acceptance compares drafts against the exact argmax, so in exact
    arithmetic the emitted stream equals plain decode's. Sampled
    (temperature > 0) lanes draft nothing and behave like decode_loop,
    seeded lanes folding `positions` for token 0.

    Returns (out_tokens [K, B, draft_len + 1], out_counts [K, B] — tokens
    emitted per slot per macro-step, 0 for inactive lanes — out_logprobs
    [K, B, T] f32 of every candidate, the final tokens, positions, active,
    and the top rows out_top_lp [K, B, T, n_top] f32 and out_top_ids [K,
    B, T, n_top] int32). The cache and `history` are updated in place."""
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
    out_em, out_n, out_lp, out_top_lp, out_top_ids = [], [], [], [], []
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
        with tracing.span("model.decode_step"):
            logits_bt, cache = llama.verify_step(
                params, cfg, tokens_bt, positions, cache, window=window,
                attn_positions=read_pos)
        with tracing.span("model.sample"):
            pred = torch.argmax(logits_bt, dim=-1).to(torch.int32)  # [B, T]
            # sampled lanes: token 0 via the full sampler (their count is 0)
            em0 = sampling.sample(logits_bt[:, 0], sstate.generator,
                                  temperature=sstate.temperature,
                                  top_k=sstate.top_k, top_p=sstate.top_p,
                                  lane_seeds=sstate.seed,
                                  lane_positions=positions, **sstate.draws())
            em = torch.cat([em0[:, None].to(torch.int32), pred[:, 1:]], dim=1)
            out_lp.append(token_logprob(logits_bt, em))  # [B, T]
            top_lp, top_ids = top_candidates(logits_bt, n_top)  # [B, T, n]
            out_top_lp.append(top_lp)
            out_top_ids.append(top_ids)

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
    return (torch.stack(out_em), torch.stack(out_n), torch.stack(out_lp),
            tokens, positions, active, torch.stack(out_top_lp),
            torch.stack(out_top_ids))


def write_history(history: torch.Tensor, row: int, ids: torch.Tensor,
                  length: int) -> None:
    """Admission time: place a slot's prompt ids (padded to the history's
    width) at history[row], in place; entries past `length` are zeroed so
    stale tokens cannot fake n-gram matches."""
    history[row] = ids.to(history.dtype)
    history[row, length:] = 0


def _bits(x: torch.Tensor) -> torch.Tensor:
    """f32 values as their int32 bit patterns (flattened)."""
    return x.to(torch.float32).reshape(-1).contiguous().view(torch.int32)


def pack_spec_host_view(out_tokens: torch.Tensor, out_counts: torch.Tensor,
                        active: torch.Tensor, pre_tokens: torch.Tensor,
                        out_logprobs: torch.Tensor,
                        first_logprobs: torch.Tensor, top_lp: torch.Tensor,
                        top_ids: torch.Tensor) -> torch.Tensor:
    """Packs a speculative burst's host feedback — candidate tokens
    [K, B, T], tokens emitted per slot per macro-step [K, B], final slot
    liveness [B], the pre-burst tokens [B], then the candidates' f32
    logprobs [K, B, T], the first tokens' [B] and the top rows [K, B, T,
    n] (f32 logprobs bitcast to int32, then ids) — into one int32 vector,
    fetched with one transfer."""
    return torch.cat([out_tokens.reshape(-1).to(torch.int32),
                      out_counts.reshape(-1).to(torch.int32),
                      active.to(torch.int32), pre_tokens.to(torch.int32),
                      _bits(out_logprobs), _bits(first_logprobs),
                      _bits(top_lp), top_ids.reshape(-1).to(torch.int32)])


def token_logprob(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """log P(ids) under softmax(logits). logits [..., V] f32, ids [...]."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, ids[..., None].long())[..., 0]
    return chosen - lse


def pack_host_view(out_tokens: torch.Tensor, out_active: torch.Tensor,
                   active: torch.Tensor, pre_tokens: torch.Tensor,
                   out_logprobs: torch.Tensor, first_logprobs: torch.Tensor,
                   top_lp: torch.Tensor,
                   top_ids: torch.Tensor) -> torch.Tensor:
    """Packs a burst's host feedback — emitted tokens [K, B], their
    emitted-by mask [K, B], final slot liveness [B], the pre-burst tokens
    [B] (the first tokens of fresh admissions, sampled on the device),
    then the f32 logprobs [K, B] and the first tokens' [B], bitcast to
    int32, and the top rows [K, B, n] (logprobs bitcast, then ids;
    zero-width unless a request asked for `top_logprobs`) — into one
    int32 vector, fetched with one transfer."""
    return torch.cat([out_tokens.reshape(-1).to(torch.int32),
                      out_active.reshape(-1).to(torch.int32),
                      active.to(torch.int32), pre_tokens.to(torch.int32),
                      _bits(out_logprobs), _bits(first_logprobs),
                      _bits(top_lp), top_ids.reshape(-1).to(torch.int32)])


def view_segments(steps: int, n_top: int) -> list[tuple[int, int]]:
    """pack_host_view's sections as (leading, trailing) sizes around the
    slot axis: each section is [leading, B, trailing]."""
    return [(steps, 1), (steps, 1), (1, 1), (1, 1), (steps, 1), (1, 1),
            (steps, n_top), (steps, n_top)]


def spec_view_segments(steps: int, t_blk: int,
                       n_top: int) -> list[tuple[int, int]]:
    """pack_spec_host_view's sections, as view_segments gives them."""
    return [(steps, t_blk), (steps, 1), (1, 1), (1, 1), (steps, t_blk),
            (1, 1), (steps, t_blk * n_top), (steps, t_blk * n_top)]


def merge_host_views(parts: torch.Tensor, segments, batch: int
                     ) -> torch.Tensor:
    """Replica views [dp, n] of `batch` slots each (replica d holding
    slots [d * batch, (d + 1) * batch)) -> the one packed view [dp * n] of
    all dp * batch slots that a single replica would have packed."""
    dp = parts.shape[0]
    out, off = [], 0
    for lead, trail in segments:
        n = lead * batch * trail
        block = parts[:, off:off + n].reshape(dp, lead, batch, trail)
        out.append(block.permute(1, 0, 2, 3).reshape(-1))
        off += n
    return torch.cat(out)


def prefill_slot(params, cfg: ModelConfig, tokens: torch.Tensor, length: int,
                 slot: int, offset: int, cache):
    """Single-slot chunked prefill: a [T]-bucket chunk into cache row `slot`
    at `offset`. Returns (last-valid logits [V], cache)."""
    with tracing.span("model.prefill"):
        return llama.prefill_slot(params, cfg, tokens, length, slot, offset,
                                  cache)


def admit_slot(logits: torch.Tensor, slot: int, prompt_len: int,
               temperature: float, top_k: int, top_p: float,
               tokens: torch.Tensor, positions: torch.Tensor,
               active: torch.Tensor, sstate: SamplingState,
               history: Optional[torch.Tensor] = None,
               first_lp: Optional[torch.Tensor] = None,
               seed: int = -1) -> None:
    """Finalizes an admission ON THE DEVICE: samples the first token from
    the prefill logits with the request's parameters and writes the slot's
    state in place (the token reaches the host in the next packed fetch).
    With `history` (the n-gram speculation corpus, whose prompt part
    `write_history` placed) the first token is recorded at
    history[slot, prompt_len]; with `first_lp` [B] f32 its logprob at
    first_lp[slot]. A seeded lane (seed >= 0) folds prompt_len - 1, the
    position convention decode keeps (it folds `positions` for the token
    landing at positions + 1)."""
    dev = logits.device
    first = sampling.sample(
        logits[None, :], sstate.generator,
        temperature=torch.full((1,), temperature, dtype=torch.float32,
                               device=dev),
        top_k=torch.full((1,), top_k, dtype=torch.int32, device=dev),
        top_p=torch.full((1,), top_p, dtype=torch.float32, device=dev),
        lane_seeds=torch.full((1,), seed, dtype=torch.int64, device=dev),
        lane_positions=torch.full((1,), prompt_len - 1, dtype=torch.int64,
                                  device=dev))
    tokens[slot] = first[0]
    positions[slot] = prompt_len
    active[slot] = True
    sstate.temperature[slot] = temperature
    sstate.top_k[slot] = top_k
    sstate.top_p[slot] = top_p
    sstate.seed[slot] = seed
    if first_lp is not None:
        first_lp[slot] = token_logprob(logits, first[0])
    if history is not None:
        history[slot, min(prompt_len, history.shape[1] - 1)] = first[0]


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                  offset: int):
    """Prefill of one [B, T] chunk at `offset` for every slot; returns the
    LAST position's logits [B, V] only (the unembed runs on the [B, 1, D]
    slice, the decode-sized form) and the cache."""
    with tracing.span("model.prefill"):
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
    with tracing.span("model.prefill"):
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
                history: torch.Tensor,
                first_lp: Optional[torch.Tensor] = None,
                seeds: Optional[torch.Tensor] = None) -> None:
    """Batched admit_slot for the lanes in `lane_mask` (burst admission):
    samples each row's first token with its own parameters (and seeds [B],
    -1 = the engine's stream; a seeded row folds lengths - 1) and writes
    the slot state in place, the first token also at history[b,
    lengths[b]] and its logprob at first_lp[b]. Unmasked lanes keep their
    state."""
    if seeds is None:
        seeds = torch.full_like(sstate.seed, -1)
    nxt = sampling.sample(logits, sstate.generator, temperature=temperature,
                          top_k=top_k, top_p=top_p, lane_seeds=seeds,
                          lane_positions=lengths.long() - 1,
                          **sstate.draws())
    lane = lane_mask
    if first_lp is not None:
        first_lp.copy_(torch.where(lane, token_logprob(logits, nxt),
                                   first_lp))
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
    sstate.seed.copy_(torch.where(lane, seeds.to(sstate.seed.dtype),
                                  sstate.seed))


def copy_slot_prefix(cache: KVCache, src: int, dst: int) -> KVCache:
    """Prefix reuse on the dense cache: copy slot `src`'s WHOLE cache row
    onto slot `dst`, in place. Only the common-prefix rows matter; the rest
    is overwritten by the admission's suffix prefill or by decode before
    anything reads it."""
    for arr in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if arr is not None:
            arr[:, dst] = arr[:, src]
    return cache
