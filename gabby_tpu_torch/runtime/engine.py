"""Continuous-batching inference engine (counterpart of
gabby_tpu/runtime/engine.py).

* One engine thread owns the device loop; HTTP worker threads submit
  requests into a queue and block on per-request output queues.
* The decode batch is a fixed [B] of slots; request churn flips `active`
  lanes and rewrites slot rows.
* New requests are admitted by per-slot chunked prefill
  (generate.prefill_slot) over the bucket ladder PREFILL_BUCKETS, one
  chunk per loop iteration, so a long prompt never stalls live streams for
  more than a chunk. Waiting requests are admitted shortest prompt first,
  with an age guard against starvation.
* Burst admission: when two or more slots are free and two or more
  waiting requests share a chunk schedule of at most two chunks, they are
  prefilled together, one lane-masked batched call per chunk
  (generate.prefill_batch_chunk), so the weights stream once a chunk for
  the group; the other slots, live ones among them, are untouched.
* Prefix reuse: a finished request's prompt stays resident in its slot. An
  admission whose prompt shares at least 64 tokens (on the bucket grid)
  with a resident prompt starts past them: the dense cache copies the
  donor's rows (generate.copy_slot_prefix), the paged cache adopts its
  whole pages by reference (PageAllocator.share), and only the suffix is
  prefilled.
* Decode runs bursts of `steps_per_call` steps (`steps_per_call_busy`
  while an admission is in flight) in generate.decode_loop; tokens stream
  back between bursts through one host fetch each.
* `speculate_tokens > 0` runs the bursts in generate.spec_decode_loop
  instead: n-gram drafts from each slot's own history, verified in one
  forward per macro-step. The engine measures what a macro-step yields
  and costs, switches speculation off when it does not pay, and re-probes
  later.
* `paged_pages > 0` swaps the dense cache for a shared pool of pages
  (runtime/paged.py): the host-side allocator backs each slot's rows on
  demand, before every prefill chunk and every burst. A finished
  request's pages stay resident as a prefix donor until the slot is
  reused or the pool needs them.
* Request features: OpenAI penalties and logit_bias (a lazily created
  generate.PenaltyState; penalized requests admit singly and decode on
  the plain loop), logprobs and top_logprobs of every emitted token, the
  first included, and the per-request seed (sampling.lane_gumbel).
* `prefill_int8_shadow` prefills through the exact int8 shadow of an int4
  tree (quant.promote_int4_to_int8); decode and verify keep the packed
  int4 stream.
* `pipeline_fetch` dispatches decode burst N+1 before burst N's packed
  host view is read: the view goes to pinned host memory by an
  asynchronous copy on the one stream, guarded by an event, and the host
  bookkeeping lags one burst (slot epochs drop the overshoot tokens).
* Every iteration is a plan: `_compose_plan` decides (cancellations,
  deadlines, a burst or a single admission with its donor, the burst's
  decode steps) and `_execute_plan` runs it. Tensor-parallel serving
  (params carrying a TPGroup, see parallel/) runs one engine a rank: rank
  0 composes and broadcasts each plan through `sync` (a
  parallel.multihost.HostSync) and every rank executes it, so all device
  calls and host decisions stay in lockstep. Decisions read from a clock
  ride the plan or are taken out: speculation keeps its configured
  break-even, pipelined fetches are off, warm-up is refused. A watchdog
  fails every request when a peer's liveness counter stalls.
* Data parallelism (a `sync` whose group has dp_size > 1, see
  parallel/mesh.py): replica d owns slots [d B/dp, (d + 1) B/dp), the
  reference's P("data") on the slot axis. Every rank keeps the host state
  of all B slots (the plan replays identically) and device state (cache,
  slot rows, sampling and penalty rows, history) for its own slots only.
  An admission runs on the replica that owns its slot: the other replicas
  skip its device calls but draw its uniforms (sampling.uniforms), and
  its first token reaches them through the gathered host view. Each
  decode burst runs on a replica's own lanes; its packed view is gathered
  over the dp group before it is read (`_host_view`), so every rank
  unpacks the same bytes. A burst admission masks out the lanes another
  replica owns; a prefix donor is taken only from the destination's own
  replica. With a dense cache, an admission chunk of at least
  `sp_prefill_tokens` whose bucket dp divides runs on every replica as
  sequence-parallel prefill (parallel/sp.py): the chunk's tokens shard
  over the replicas and the owner writes the rows.
* Every iteration that runs a plan logs one record (runtime/tracing.py):
  the seconds of its phases (compose, admit, decode, fetch, emit), its
  decode steps and the prompt tokens it prefilled; `stats` keeps their
  running sums and `Request.admit_ts` stamps when a request left the
  backlog. While torch.profiler records, each phase is a `gabby.engine.*`
  span.
"""

from __future__ import annotations

import codecs
import collections
import dataclasses
import queue
import statistics
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from gabby_tpu_torch import resolve_device
from gabby_tpu_torch.config import ModelConfig
from gabby_tpu_torch.ops import sampling
from gabby_tpu_torch.parallel import collectives, sp
from gabby_tpu_torch.parallel.sharding import local_config, slot_block
from gabby_tpu_torch.runtime import generate, tracing
from gabby_tpu_torch.runtime.kv_cache import create_cache
from gabby_tpu_torch.runtime.paged import PageAllocator, create_paged_cache
from gabby_tpu_torch.tokenizer import ChatFormat, Tokenizer

# chunk-length ladder for slot prefill: smallest bucket >= remaining,
# repeating the largest for long prompts (the reference's ladder)
PREFILL_BUCKETS = (16, 64, 256, 512)


class RequestError(ValueError):
    """Client-caused request rejection; maps to HTTP 400 at the API layer."""

    status = 400


class PoolExhausted(RuntimeError):
    """The paged pool cannot back an admission's next chunk."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine knobs that this port serves, with the
    reference's defaults."""

    batch_slots: int = 8
    max_seq: int = 2048
    seed: int = 0
    # decode steps fused per burst when nothing is being admitted, and
    # while an admission is in flight (shorter bursts keep TTFT low)
    steps_per_call: int = 32
    steps_per_call_busy: int = 8
    default_max_tokens: int = 512
    default_temperature: float = 0.0   # greedy
    default_top_k: int = 0
    default_top_p: float = 1.0
    kv_quantized: bool = False
    cache_dtype: str = "bfloat16"
    # Paged KV cache (runtime/paged.py): > 0 switches the cache to a shared
    # pool of this many pages of page_size rows (one of them the scratch
    # page). Capacity then follows the tokens in use instead of
    # slots x max_seq. 0 = dense per-slot cache.
    paged_pages: int = 0
    page_size: int = 512
    # Paired kv-head cache layout (kv_cache.create_cache(paired=True) /
    # paged.create_paged_cache(paired=True)): adjacent kv heads side by
    # side in one cache row, dense and paged caches; needs an even kv-head
    # count. It changes where rows are stored, not what is computed; the
    # server turns it on whenever the head count allows.
    pair_kv_heads: bool = False
    # Speculative decoding (generate.spec_decode_loop): > 0 verifies up to
    # this many n-gram prompt-lookup drafts per forward for GREEDY slots.
    # Switches itself off when the measured acceptance does not pay for
    # the wider verify pass. 0 = off.
    speculate_tokens: int = 0
    # tokens per verify macro-step below which speculation loses: the
    # prior until the engine has measured its own ratio
    spec_breakeven: float = 1.2
    # measure the break-even instead of trusting the prior: the engine
    # times its plain and verify bursts and uses median(verify s/step) /
    # median(plain s/step) once both windows hold 8 samples; the derived
    # value surfaces as stats["spec_breakeven_derived"]
    spec_auto_breakeven: bool = True
    # when > 0, a disabled engine re-probes speculation after this many
    # plain decode steps (workloads shift); 0 = off for the engine's life
    spec_reprobe_steps: int = 8192
    # waiting requests are admitted shortest prompt first; the oldest
    # waiter goes first once it has waited spf_age_limit seconds
    spf_age_limit: float = 5.0
    # Prefill through an EXACT int8 shadow of int4 weights
    # (quant.promote_int4_to_int8): the same codes and scales, so no
    # numerics change. Short chunks (M <= 64) then take the stacked int8
    # kernel (K5) and longer ones one int8-codes product, instead of the
    # int4 unpack-then-matmul (or K7). Costs 2x the int4 bytes of the
    # stacks; decode keeps the packed int4 stream. No-op without int4.
    prefill_int8_shadow: bool = False
    # Dispatch-ahead fetches: decode burst N+1 is enqueued before burst
    # N's packed host view is read, so the transfer rides under N+1's
    # device work. The view is copied into pinned host memory right after
    # N is enqueued (an event marks the copy's end); device state stays
    # exact, while host bookkeeping (max_tokens, stop strings, slot frees)
    # lags one burst: overshoot tokens are dropped at emission (slot
    # epochs guard re-admitted slots), and the attention window and the
    # page horizon add the pending burst's steps. Off under speculation
    # (verify timings and acceptance need synchronous fetches).
    pipeline_fetch: bool = False
    # Sequence-parallel prefill for long admissions under dp > 1
    # (parallel/sp.py): an admission chunk whose bucket is at least
    # sp_prefill_tokens and divisible by dp shards its token axis over the
    # data-parallel replicas (the chunk's K/V all-gathered for attention,
    # or rotated around the ring with sp_prefill_ring). Dense cache only
    # (paged admissions keep the per-slot path); decided from the bucket
    # and the config, so every rank takes the same path. 0 disables. At
    # the default no bucket of the ladder (at most 512) reaches it.
    sp_prefill_tokens: int = 1024
    sp_prefill_ring: bool = False


@dataclasses.dataclass
class Request:
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    top_k: int
    top_p: float
    stop: list[str] = dataclasses.field(default_factory=list)
    # the engine pushes (delta_text, finish_reason|None); the last item has
    # finish_reason set. On shutdown it pushes (None, "abort").
    out: "queue.Queue[tuple[Optional[str], Optional[str]]]" = \
        dataclasses.field(default_factory=queue.Queue)
    completion_tokens: int = 0
    submit_ts: float = dataclasses.field(default_factory=time.monotonic)
    first_token_ts: Optional[float] = None
    # when the leader took it off the backlog for an admission (monotonic)
    admit_ts: Optional[float] = None
    cancelled: bool = False  # set by Engine.cancel
    # every generated token id, appended before each out-queue push
    token_ids: list[int] = dataclasses.field(default_factory=list)
    # each generated token's log-probability under the full (penalized)
    # softmax, parallel to token_ids and appended before the same push
    token_logprobs: list[float] = dataclasses.field(default_factory=list)
    # higher priority admits first; deadline_s is a budget from submission
    priority: int = 0
    deadline_s: Optional[float] = None
    # OpenAI penalties: presence/frequency in [-2, 2] (0 = off) and
    # logit_bias {token id: bias in [-100, 100]}, applied to every sampled
    # distribution, the first token's included; logprobs report the
    # ADJUSTED distribution. repetition_penalty (HF/vLLM extension): tokens
    # seen in the prompt or sampled so far get logit/rep when positive,
    # logit*rep when negative; 1.0 = off
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: Optional[dict[int, float]] = None
    repetition_penalty: float = 1.0
    # OpenAI `seed`, normalized to [0, 2^31) at submit; None = the
    # engine's stream. A seeded request reproduces its sampled output
    # whatever shares the batch
    seed: Optional[int] = None
    internal: bool = False  # warm-up traffic: kept out of the stats
    # OpenAI `top_logprobs`: 0 = off; 1-20 = per generated token, the top-k
    # alternatives of its distribution as (id, logprob) pairs (parallel to
    # token_ids, appended after token_logprobs)
    top_logprobs: int = 0
    token_top: list[list[tuple[int, float]]] = dataclasses.field(
        default_factory=list)

    @property
    def penalized(self) -> bool:
        return bool(self.presence_penalty or self.frequency_penalty
                    or self.logit_bias or self.repetition_penalty != 1.0)


@dataclasses.dataclass
class _Slot:
    request: Request
    prompt_len: int = 0
    first_pending: bool = True  # first token sampled on the device
    # incremental detokenization: a UTF-8 decoder holds incomplete
    # multi-byte tails; text_held is the stop-string holdback window
    dec: object = dataclasses.field(
        default_factory=lambda: codecs.getincrementaldecoder("utf-8")(
            errors="replace"))
    text_held: str = ""
    drop_tail: bool = False
    # the first token's top-candidate (logprobs, ids) rows on the device,
    # taken at admission when the request asked for top_logprobs
    first_top: Optional[tuple] = None


@dataclasses.dataclass
class _Admission:
    """A request mid-prefill: its chunks interleave with decode bursts."""

    slot_ix: int
    req: Request
    ids: np.ndarray
    offset: int = 0
    last_logits: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _BurstRecord:
    """One dispatched decode burst's packed host view and what unpacking
    and emitting it needs. Under pipeline_fetch `packed` is a pinned host
    tensor filled by an asynchronous copy that `ready` marks the end of,
    read one iteration later. `epochs` snapshots each slot's generation at
    dispatch: emissions into a slot freed (and perhaps re-admitted) since
    are dropped, the overshoot tokens a synchronous fetch would never
    have emitted. `first_slots`: the slots whose first token the view
    carries (first_pending at dispatch); a slot admitted later keeps
    first_pending until the record that carries it."""

    packed: torch.Tensor
    steps: int
    n_top: int
    epochs: tuple
    first_slots: tuple
    ready: Optional[object] = None  # torch.cuda.Event on the card


def _n_top_bucket(n: int) -> int:
    """The call-wide top_logprobs width: 0, or 5, 10 or 20."""
    if not n:
        return 0
    return 5 if n <= 5 else (10 if n <= 10 else 20)


class Engine:
    """Continuous-batching engine over a fixed slot batch, on `device`
    (CUDA unless the caller passes device="cpu").

    sync: a parallel.multihost.HostSync for multi-process serving. With
    more than one process, rank 0 (the leader) serves submissions and
    broadcasts every iteration's plan; the others (followers) replay it
    and are released by the leader's shutdown plan. A rank-local params
    tree (one carrying a TPGroup) needs one, and so does data parallelism:
    the sync's group says the rank's replica (dp_rank of dp_size)."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 econfig: EngineConfig = EngineConfig(), *,
                 device=None, stop_ids: Optional[set[int]] = None,
                 sync=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        # every prefill entry takes _prefill_params; decode and verify
        # take params
        self._prefill_params = params
        if econfig.prefill_int8_shadow:
            from gabby_tpu_torch.ops.quant import promote_int4_to_int8
            self._prefill_params = promote_int4_to_int8(params)
        self.tokenizer = tokenizer
        self.chat = ChatFormat(tokenizer)
        self.ec = econfig
        if econfig.max_seq % PREFILL_BUCKETS[0]:
            raise ValueError(
                f"max_seq={econfig.max_seq} must be a multiple of "
                f"{PREFILL_BUCKETS[0]} (the prefill bucket grid)")
        if not 0 <= econfig.speculate_tokens <= 15:
            # the verify block is draft + 1 rows: at most 16
            raise ValueError("speculate_tokens must be in [0, 15]")
        b = econfig.batch_slots
        dev = self.device
        self._sync = sync
        self._multi = sync is not None and sync.num_processes > 1
        group = params.get("tp")
        tp = 1 if group is None else group.size
        grid = None if sync is None else sync.group
        self._grid = grid if grid is not None and grid.dp_size > 1 else None
        dp = 1 if self._grid is None else grid.dp_size
        if econfig.pair_kv_heads and (tp > 1 or dp > 1):
            raise ValueError("pair_kv_heads is single-device only for now "
                             "(unvalidated under cache shardings)")
        if tp > 1 and not self._multi:
            raise ValueError("a tensor-parallel engine needs sync: its "
                             "ranks must replay one plan")
        # this replica's slots [lo, lo + bl): the device state's rows
        self._lo, hi = slot_block(b, dp, 0 if dp == 1 else grid.dp_rank)
        self._dp, self._bl = dp, hi - self._lo
        bl = self._bl
        # the cache holds this rank's kv heads
        cache_cfg = local_config(cfg, tp)
        self._paged = econfig.paged_pages > 0
        if econfig.pair_kv_heads and cfg.num_kv_heads % 2:
            raise ValueError("pair_kv_heads needs an even kv-head count")
        if self._paged:
            ps = econfig.page_size
            if econfig.max_seq % ps:
                raise ValueError(f"max_seq must be a multiple of "
                                 f"page_size={ps} in paged mode")
            if dev.type == "cuda" and ps % 32:
                raise ValueError(f"page_size={ps}: the paged attention "
                                 f"kernels take pages of a multiple of 32 "
                                 f"rows")
            # the whole pool on every replica (the page axis is unsharded,
            # the allocator host-global); a replica's page table holds its
            # own slots' rows, and only its slots' pages hold its writes
            self._cache = create_paged_cache(
                cache_cfg, bl, econfig.max_seq, econfig.paged_pages,
                dtype=getattr(torch, econfig.cache_dtype),
                quantized=econfig.kv_quantized, page_size=ps,
                paired=econfig.pair_kv_heads, device=dev)
            self._alloc = PageAllocator(econfig.paged_pages)
            # physical page 0 is the permanent SCRATCH page: table entries
            # past a slot's allocation point at it, so parked-position
            # writes and dead-entry reads never touch a live page
            if self._alloc.alloc(1) != [0]:
                raise ValueError("paged_pages must be at least 1")
            self._slot_pages: list[list[int]] = [[] for _ in range(b)]
            self._pt_host = np.zeros((b, econfig.max_seq // ps), np.int32)
            # paged chunk writes are page-granular: buckets sit on the
            # page grid
            self._buckets = tuple(sorted({ps, max(ps, 512)}))
        else:
            self._cache = create_cache(
                cache_cfg, bl, econfig.max_seq,
                dtype=getattr(torch, econfig.cache_dtype),
                quantized=econfig.kv_quantized,
                paired=econfig.pair_kv_heads, device=dev)
            self._buckets = PREFILL_BUCKETS
        self._sp = dp > 1 and not self._paged and econfig.sp_prefill_tokens > 0
        stop = stop_ids if stop_ids is not None else self.chat.stop_ids()
        self._stop_set = {int(s) for s in stop}
        self._eos_ids = torch.tensor(sorted(self._stop_set),
                                     dtype=torch.int32, device=dev)
        # device slot state. Free slots' write positions are PARKED at
        # max_seq - 1: decode writes every lane's row with no active
        # gating, and row max_seq - 1 is never read before a live slot
        # overwrites it
        self._park = econfig.max_seq - 1
        self._tokens = torch.zeros(bl, dtype=torch.int32, device=dev)
        self._positions = torch.full((bl,), self._park, dtype=torch.int32,
                                     device=dev)
        self._active = torch.zeros(bl, dtype=torch.bool, device=dev)
        # every replica draws the whole batch's uniforms (sampling.sample)
        self._sstate = generate.SamplingState.greedy(
            bl, dev, econfig.seed, draw_offset=self._lo, draw_total=b)
        # the first tokens' logprobs, written at admission on the device
        self._first_lp = torch.zeros(bl, dtype=torch.float32, device=dev)
        # penalty rows, created when a penalized request is admitted and
        # dropped when the last one leaves (_pen_slots: their slots)
        self._pstate: Optional[generate.PenaltyState] = None
        self._pen_slots: set[int] = set()
        # per-slot token history: the n-gram speculation corpus (the prompt
        # placed at admission, generated tokens appended on the device)
        self._history = torch.zeros((bl, econfig.max_seq), dtype=torch.int32,
                                    device=dev)
        self._spec_enabled = econfig.speculate_tokens > 0
        # the acceptance probe's window start (spec_macro_steps,
        # spec_tokens) and, while disabled, the decode_steps count at the
        # disable (the re-probe timer)
        self._spec_probe_base = (0, 0)
        self._spec_off_since: Optional[int] = None
        # measured wall seconds per step of plain and verify bursts, for
        # the auto break-even: rolling, so the ratio stays current
        self._plain_step_s: "collections.deque[float]" = \
            collections.deque(maxlen=32)
        self._spec_step_s: "collections.deque[float]" = \
            collections.deque(maxlen=32)
        self._plain_probe_ctr = 0
        # dispatch-ahead fetches (EngineConfig.pipeline_fetch): at most one
        # burst record outstanding; a slot's epoch moves at every finish
        # and admission, so a record dispatched before cannot emit into it
        self._pipeline = (econfig.pipeline_fetch
                          and econfig.speculate_tokens == 0
                          and not self._multi)
        self._pending_burst: Optional[_BurstRecord] = None
        self._slot_epoch = [0] * b
        # the leader's requests between composing a plan and executing it
        self._pending_admit: Optional[Request] = None
        self._burst_reqs: Optional[list[Request]] = None

        self._slots: list[Optional[_Slot]] = [None] * b
        # slots mid-prefill (a single admission's, or a burst's while it
        # runs): free in `_slots`, yet their pages are live
        self._filling: set[int] = set()
        # prefix registry: the prompt whose KV rows are resident in each
        # slot (kept after the request finishes; cleared when a new
        # admission starts overwriting the slot)
        self._slot_prompts: list[Optional[list[int]]] = [None] * b
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._backlog: list[Request] = []
        self._wake = threading.Event()
        self._shutdown = False
        self._failed = False
        self._fail_msg: Optional[str] = None
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "completion_tokens": 0,
                      "prompt_tokens": 0, "decode_steps": 0,
                      "burst_admissions": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0,
                      "spec_macro_steps": 0, "spec_tokens": 0,
                      # gauge: is speculation on now (1/0), and how often
                      # the acceptance probe switched it off
                      "spec_on": int(self._spec_enabled),
                      "spec_disables": 0,
                      # iterations that ran a plan (warm-up included) and
                      # the seconds of each of their phases
                      "iterations": 0}
        self.stats.update((p + "_s", 0.0) for p in tracing.PHASES)
        self._clock = tracing.Clock()
        self._ttfts: list[float] = []
        self._spans: "collections.deque[dict]" = collections.deque(maxlen=32)
        # the profiler's engine-thread side (runtime/profiler.py), set by
        # the server's --profiler-port: ticked at every plan boundary
        self.capturer = None
        self._thread = threading.Thread(target=self._loop_guarded,
                                        daemon=True, name="gabby-engine")
        self._thread.start()
        if (self._multi and sync.timeout is not None
                and sync.store is not None):
            threading.Thread(target=self._watchdog, daemon=True,
                             name="gabby-watchdog").start()

    # ---- public API ----

    def submit(self, messages: list[dict[str, str]], **kw) -> Request:
        """Queue a chat request (Llama-3 chat template applied)."""
        return self.submit_ids(self.chat.prompt_ids(messages), **kw)

    def submit_raw(self, prompt: str, **kw) -> Request:
        """Queue a raw completion request: BOS + the encoded prompt."""
        ids = [self.tokenizer.token_id("<|begin_of_text|>")]
        ids += self.tokenizer.encode(prompt)
        return self.submit_ids(ids, **kw)

    def submit_ids(self, prompt_ids: list[int], *,
                   max_tokens: Optional[int] = None,
                   temperature: Optional[float] = None,
                   top_k: Optional[int] = None,
                   top_p: Optional[float] = None,
                   stop: Optional[list[str]] = None,
                   top_logprobs: int = 0,
                   priority: int = 0,
                   deadline_s: Optional[float] = None,
                   presence_penalty: float = 0.0,
                   frequency_penalty: float = 0.0,
                   logit_bias: Optional[dict] = None,
                   repetition_penalty: float = 1.0,
                   seed: Optional[int] = None,
                   internal: bool = False) -> Request:
        ec = self.ec
        if not 0 <= (top_logprobs or 0) <= 20:
            raise RequestError("top_logprobs must be in [0, 20]")
        if not 0.0 < (repetition_penalty or 1.0) <= 10.0:
            raise RequestError("repetition_penalty must be in (0, 10]")
        if not -8 <= int(priority or 0) <= 8:
            raise RequestError("priority must be in [-8, 8]")
        if deadline_s is not None and not deadline_s > 0:
            raise RequestError("deadline_ms must be > 0")
        for name, v in (("presence_penalty", presence_penalty),
                        ("frequency_penalty", frequency_penalty)):
            if not -2.0 <= (v or 0.0) <= 2.0:
                raise RequestError(f"{name} must be in [-2, 2]")
        if seed is not None:
            try:
                seed = int(seed) & 0x7FFFFFFF
            except (TypeError, ValueError):
                raise RequestError("seed must be an integer")
        bias: Optional[dict[int, float]] = None
        if logit_bias:
            try:
                bias = {int(k): float(v) for k, v in logit_bias.items()}
            except (TypeError, ValueError):
                raise RequestError("logit_bias keys must be token ids")
            if len(bias) > 300:  # OpenAI's documented cap
                raise RequestError("logit_bias supports at most 300 entries")
            for k, v in bias.items():
                if not 0 <= k < self.cfg.vocab_size:
                    raise RequestError(f"logit_bias token id {k} out of "
                                       f"vocab range")
                if not -100.0 <= v <= 100.0:
                    raise RequestError("logit_bias values must be in "
                                       "[-100, 100]")
        limit = ec.max_seq - 1
        if len(prompt_ids) > limit:
            raise RequestError(
                f"prompt is {len(prompt_ids)} tokens but this server's "
                f"context window is {ec.max_seq} (max prompt {limit})")
        if not prompt_ids:
            raise RequestError("prompt is empty")
        if top_k is not None and top_k > sampling.MAX_CANDIDATES:
            raise RequestError(
                f"top_k={top_k} exceeds the supported maximum of "
                f"{sampling.MAX_CANDIDATES}")
        req = Request(
            prompt_ids=list(prompt_ids),
            max_tokens=max_tokens if max_tokens and max_tokens > 0
            else ec.default_max_tokens,
            temperature=temperature if temperature is not None
            and temperature >= 0 else ec.default_temperature,
            top_k=top_k if top_k is not None and top_k >= 0
            else ec.default_top_k,
            top_p=top_p if top_p is not None and 0 < top_p <= 1
            else ec.default_top_p,
            stop=[s for s in (stop or []) if s][:8],
            top_logprobs=int(top_logprobs or 0),
            priority=int(priority or 0), deadline_s=deadline_s,
            presence_penalty=float(presence_penalty or 0.0),
            frequency_penalty=float(frequency_penalty or 0.0),
            logit_bias=bias,
            repetition_penalty=float(repetition_penalty or 1.0),
            seed=seed, internal=internal)
        # a stopped engine must not accept work nobody will drain; the
        # check and the enqueue share the lock with shutdown's flag flip
        with self._lock:
            if self._failed or self._shutdown:
                req.out.put((None, self._fail_msg or "abort"))
                return req
            self._queue.put(req)
        self._wake.set()
        return req

    def generate_sync(self, messages: list[dict[str, str]],
                      on_delta: Optional[Callable[[str], None]] = None,
                      **kw) -> tuple[str, str, int, int]:
        """Blocking helper: (text, finish_reason, prompt_tokens,
        completion_tokens); calls on_delta per streamed chunk."""
        req = self.submit(messages, **kw)
        parts: list[str] = []
        while True:
            delta, fin = req.out.get()
            if delta:
                parts.append(delta)
                if on_delta:
                    on_delta(delta)
            if fin is not None:
                return ("".join(parts), fin, len(req.prompt_ids),
                        req.completion_tokens)

    def warmup(self, concurrency: Optional[int] = None) -> float:
        """Dress-rehearse serving before real traffic: one solo request,
        then a concurrent wave at 2x the slot count whose prompt lengths
        cover the bucket ladder and one multi-chunk prompt, on distinct
        token streams (burst admissions, multi-chunk prefill, the busy and
        drained burst lengths), and one repeat of the solo prompt (the
        prefix-donor lookup). Rehearsal requests are internal (kept out of
        the stats). Raises if any rehearsal request fails. The
        speculation state is restored afterwards: synthetic prompts would
        otherwise feed the acceptance probe and could switch speculation
        off for real traffic. Single-process only: followers never run it,
        so a leader-side reset would desynchronize the ranks. Returns
        seconds elapsed."""
        if self._multi:
            raise RuntimeError(
                "Engine.warmup is single-process only (a leader-side stats "
                "reset would desynchronize the counters every rank's "
                "speculation decisions derive from)")
        t0 = time.monotonic()
        ec = self.ec
        spec_was = self._spec_enabled
        gen = max(4, min(max(ec.steps_per_call, ec.steps_per_call_busy) + 2,
                         ec.max_seq // 4))
        limit = max(1, ec.max_seq - 1 - gen)
        lens = sorted({min(b, limit) for b in self._buckets})
        if self._buckets[-1] + self._buckets[0] <= limit:
            lens.append(self._buckets[-1] + self._buckets[0])
        vocab = max(2, self.cfg.vocab_size - 2)
        errs: list[str] = []

        def run(i: int, n: int) -> None:
            # distinct streams, so that the wave cannot ride a donor (i = 0
            # repeated is the one that may)
            ids = [(i * 7919 + j * 104729) % vocab + 1 for j in range(n)]
            req = self.submit_ids(ids, max_tokens=gen, internal=True)
            while True:
                _, fin = req.out.get()
                if fin is not None:
                    if fin not in ("stop", "length"):
                        errs.append(fin)
                    return

        run(0, lens[0])
        n = concurrency if concurrency else 2 * ec.batch_slots
        threads = [threading.Thread(
            target=run, args=(0, lens[0]) if i == 1 else
            (i, lens[i % len(lens)])) for i in range(1, n + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise RuntimeError(f"warmup rehearsal failed ({len(errs)} "
                               f"request(s); first: {errs[0]})")
        # the rehearsal's token streams are no evidence about real traffic,
        # and its first bursts' wall times no evidence about steady state
        self._spec_enabled = spec_was
        if spec_was:
            self._spec_off_since = None
        with self._lock:
            self.stats["spec_on"] = int(spec_was)
        self._plain_step_s.clear()
        self._spec_step_s.clear()
        return time.monotonic() - t0

    def cancel(self, req: Request) -> None:
        """Abort a request: its slot, queue entry or admission is released
        at the next loop iteration with a final ("cancelled") item."""
        req.cancelled = True
        self._wake.set()

    def stats_snapshot(self) -> dict:
        """Serving metrics (TTFT is submit -> first token)."""
        with self._lock:
            s = dict(self.stats)
            ttfts = list(self._ttfts)
            s["recent"] = list(self._spans)
        if ttfts:
            s["p50_ttft_ms"] = round(float(np.median(ttfts)) * 1e3, 2)
        s["active_slots"] = sum(1 for x in self._slots if x is not None)
        s["queued"] = self._queue.qsize() + len(self._backlog)
        return s

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # ---- scheduling ----

    def _next_bucket(self, remaining: int, offset: int) -> int:
        """Smallest bucket >= remaining that fits before max_seq, else the
        largest that fits (the prompt continues in later chunks). Paged
        mode uses a page-aligned ladder."""
        room = self.ec.max_seq - offset
        for bkt in self._buckets:
            if remaining <= bkt <= room:
                return bkt
        return max(b for b in self._buckets if b <= room)

    def _attn_window(self, steps: int) -> Optional[int]:
        """Bound on every live slot's furthest read in a burst of `steps`
        steps: the smallest power of two from 1024 up that covers it,
        capped at max_seq. Under speculation each macro-step may advance a
        slot by the whole verify block. None for the paged cache, whose
        kernels are bounded by the page table."""
        if self._paged:
            return None
        live = [s.prompt_len + len(s.request.token_ids)
                for s in self._slots if s is not None]
        if not live:
            return None
        span = (self.ec.speculate_tokens + 1) if self._spec_enabled else 1
        need = max(live) + self._lag() + steps * span + 2
        w = 1024
        while w < need:
            w *= 2
        return min(w, self.ec.max_seq)

    def _lag(self) -> int:
        """Steps the host's token counts lag the device by: the pending
        record's (pipeline_fetch), else 0."""
        return self._pending_burst.steps if self._pending_burst else 0

    # ---- paged-pool bookkeeping (self._paged only) ----

    def _push_page_table(self) -> None:
        self._cache.page_table.copy_(torch.from_numpy(
            self._pt_host[self._lo:self._lo + self._bl]))

    def _release_slot_pages(self, slot_ix: int) -> None:
        """Drop the slot's page references (pages it shares survive through
        the other holders' refcounts) and its prefix-registry entry; its
        table row points at the scratch page again."""
        self._slot_prompts[slot_ix] = None
        self._release_tail_pages(slot_ix, 0)

    def _release_tail_pages(self, slot_ix: int, keep: int) -> None:
        """Drop the slot's pages from logical page `keep` on; its table
        entries from there point at the scratch page."""
        tail = self._slot_pages[slot_ix][keep:]
        if tail:
            self._alloc.release(tail)
            del self._slot_pages[slot_ix][keep:]
            self._pt_host[slot_ix, keep:] = 0
            self._push_page_table()

    def _evict_idle_pages(self, keep: int = -1) -> None:
        """Pool pressure relief: free the resident (prefix-donor) pages of
        FREE slots. Live slots and slots mid-prefill are never touched."""
        for i, s in enumerate(self._slots):
            if (s is None and i != keep and i not in self._filling
                    and self._slot_pages[i]):
                self._release_slot_pages(i)

    def _ensure_pages(self, slot_ix: int, upto_row: int) -> bool:
        """Back rows [0, upto_row) of the slot with physical pages."""
        ps = self.ec.page_size
        need = (min(upto_row, self.ec.max_seq) + ps - 1) // ps
        cur = len(self._slot_pages[slot_ix])
        if need <= cur:
            return True
        got = self._alloc.alloc(need - cur)
        if got is None:
            self._evict_idle_pages(keep=slot_ix)
            got = self._alloc.alloc(need - cur)
            if got is None:
                return False
        self._slot_pages[slot_ix].extend(got)
        self._pt_host[slot_ix, cur:need] = got
        self._push_page_table()
        return True

    def _find_donor(self, ids: list[int],
                    slot: Optional[int] = None) -> tuple[int, int]:
        """Longest common prefix of `ids` with a resident slot prompt:
        (donor slot, common length), the length rounded down to the bucket
        grid (the suffix prefill starts on it) and capped to leave at least
        one token to prefill and one bucket of cache room. (-1, 0) below 64
        tokens, where a copy is not worth a call. Under dp > 1, with the
        destination `slot` given, only residents of its replica count:
        another replica's rows or pages are not on this one's device."""
        grid = self._buckets[0]
        n = len(ids)
        best, best_common = -1, 0
        for slot_ix, resident in enumerate(self._slot_prompts):
            if resident is None or (slot is not None
                                    and not self._same_replica(slot, slot_ix)):
                continue
            limit = min(len(resident), n - 1, self.ec.max_seq - grid)
            common = 0
            while common < limit and resident[common] == ids[common]:
                common += 1
            common = (common // grid) * grid
            if common > best_common:
                best, best_common = slot_ix, common
        if best_common < 64:
            return -1, 0
        return best, best_common

    def _same_replica(self, a: int, b: int) -> bool:
        return a // self._bl == b // self._bl

    def _local(self, slot_ix: int) -> Optional[int]:
        """The slot's row in this replica's device state, or None when
        another replica owns it."""
        j = slot_ix - self._lo
        return j if 0 <= j < self._bl else None

    def _burn_draw(self, n: int) -> None:
        """The uniforms a sampling call of n lanes draws, drawn and dropped
        by a replica that skips the call (its slot lives elsewhere)."""
        sampling.uniforms(self._sstate.generator, n, self.device)

    def _check_ids(self, ids) -> None:
        """Under dp > 1 only the owner's device sees a prompt: a token id
        the embedding would refuse is refused on every rank alike."""
        if self._dp > 1 and len(ids) and not (
                0 <= min(ids) and max(ids) < self.cfg.vocab_size):
            raise IndexError(f"prompt token id out of the vocab "
                             f"[0, {self.cfg.vocab_size})")

    def _share_top(self, slot_ix: int, top, k: int):
        """A first token's top rows (logprobs [k] f32, ids [k] int32), from
        the replica that owns the slot to every replica (the leader's
        request may live on another replica than its slot)."""
        if self._dp == 1:
            return top
        packed = (None if top is None else
                  torch.cat([top[0].float().view(torch.int32),
                             top[1].to(torch.int32)]))
        packed = collectives.from_replica(
            packed, slot_ix // self._bl, self._grid, shape=(2 * k,),
            dtype=torch.int32, device=self.device)
        return packed[:k].view(torch.float32), packed[k:]

    def _host_view(self, packed: torch.Tensor, segments) -> torch.Tensor:
        """The burst's packed view on the host, over all B slots: under
        dp > 1 every replica's view, gathered over the dp group (one
        collective a burst) and merged slot-major (the reference's
        `_fetch_replicate`), so every rank reads the same bytes."""
        if self._dp == 1:
            return packed.cpu()
        parts = collectives.gather_slots(packed, self._grid).cpu()
        return generate.merge_host_views(parts, segments, self._bl)

    def _chunk_schedule(self, n: int) -> tuple:
        """The (offset, bucket) chunks a prompt of n tokens prefills through."""
        out, offset = [], 0
        while offset < n:
            bucket = self._next_bucket(n - offset, offset)
            out.append((offset, bucket))
            offset += min(bucket, n - offset)
        return tuple(out)

    @staticmethod
    def _req_meta(req: Request) -> dict:
        """The request fields a follower needs to mirror every host-side
        decision (sampling, penalties, max_tokens, stop matching, top
        rows)."""
        return dict(max_tokens=req.max_tokens, temperature=req.temperature,
                    top_k=req.top_k, top_p=req.top_p, stop=list(req.stop),
                    top_logprobs=req.top_logprobs,
                    presence_penalty=req.presence_penalty,
                    frequency_penalty=req.frequency_penalty,
                    logit_bias=(dict(req.logit_bias)
                                if req.logit_bias else None),
                    repetition_penalty=req.repetition_penalty,
                    seed=req.seed)

    @staticmethod
    def _stub_request(ids, meta: dict) -> Request:
        """A follower's shadow of the leader's Request: the same control
        fields; nobody reads its out queue."""
        return Request(prompt_ids=list(ids), **meta)

    @staticmethod
    def _slack(req: Request) -> float:
        if req.deadline_s is None:
            return float("inf")
        return req.submit_ts + req.deadline_s - time.monotonic()

    def _drain_ingress(self) -> None:
        """Move arrivals into the backlog, dropping entries cancelled or
        past their deadline before admission."""
        while True:
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        kept = []
        for r in self._backlog:
            if r.cancelled:
                r.out.put((None, "cancelled"))
            elif self._slack(r) <= 0:
                r.out.put((None, "error: deadline exceeded while queued"))
            else:
                kept.append(r)
        self._backlog = kept

    def _pop_next_admission(self) -> Optional[Request]:
        """The oldest waiter once it has aged past spf_age_limit; else the
        top priority stratum, earliest deadline first when one is at risk,
        else shortest prompt first."""
        self._drain_ingress()
        if not self._backlog:
            return None
        oldest = min(range(len(self._backlog)),
                     key=lambda i: self._backlog[i].submit_ts)
        if (time.monotonic() - self._backlog[oldest].submit_ts
                > self.ec.spf_age_limit):
            return self._backlog.pop(oldest)
        top = max(r.priority for r in self._backlog)
        stratum = [i for i, r in enumerate(self._backlog)
                   if r.priority == top]
        urgent = [i for i in stratum
                  if self._slack(self._backlog[i]) < self.ec.spf_age_limit]
        if urgent:
            ix = min(urgent, key=lambda i: self._slack(self._backlog[i]))
        else:
            ix = min(stratum,
                     key=lambda i: (len(self._backlog[i].prompt_ids), i))
        return self._backlog.pop(ix)

    def _select_burst(self, freed=()) -> Optional[tuple]:
        """With at least 2 free slots and at least 2 waiting requests of the
        top priority stratum, group those that share the chunk schedule of
        the shortest waiting prompt (at most two chunks) into one burst: (the
        schedule, the slots, the requests), taken off the backlog. Requests
        with a strong resident-prefix match are left to the single path
        (a row copy and a short suffix prefill), and so are penalized ones
        (their admission writes penalty rows). On the paged cache a burst
        starts only if the pool backs every lane's pages with 2 to spare.
        `freed`: live slots this iteration's plan finishes first."""
        free = [i for i, s in enumerate(self._slots)
                if s is None or i in freed]
        if len(free) < 2:
            return None
        self._drain_ingress()
        if len(self._backlog) < 2:
            return None
        top = max(r.priority for r in self._backlog)
        pool = [r for r in self._backlog if r.priority == top]
        if len(pool) < 2:
            return None
        anchor = min(pool, key=lambda r: len(r.prompt_ids))
        sched = self._chunk_schedule(len(anchor.prompt_ids))
        if self._paged:
            # count PAGES, not chunks: a chunk spans bucket / page_size
            rows = sched[-1][0] + sched[-1][1]
            need = (min(len(free), len(pool))
                    * -(-rows // self.ec.page_size))
            if self._alloc.available() < need + 2:
                return None
        group = []
        for r in pool:
            if len(group) >= len(free):
                break
            _, common = self._find_donor(r.prompt_ids)
            if common * 2 >= len(r.prompt_ids) or r.penalized:
                continue
            if (len(sched) <= 2
                    and self._chunk_schedule(len(r.prompt_ids)) == sched):
                group.append(r)
        if len(group) < 2:
            return None
        for r in group:
            self._backlog.remove(r)
        return sched, free[:len(group)], group

    # ---- admission ----

    def _start_admission(self, slot_ix: int, req: Request, donor: int,
                         common: int) -> _Admission:
        """A single admission into free slot `slot_ix`. With a resident
        donor prefix (the plan's `donor` and `common`, from `_find_donor`
        when the plan was composed; donor -1: none) it starts past it:
        the dense cache copies the donor's rows
        (none to copy when the donor is the slot itself); the paged cache
        adopts the donor's whole prefix pages by reference, or, when the
        donor is the slot itself, drops the pages past the prefix, which
        another slot may share, so that the suffix lands in fresh pages."""
        adm = _Admission(slot_ix=slot_ix, req=req,
                         ids=np.asarray(req.prompt_ids, np.int64))
        self._slot_prompts[slot_ix] = None  # about to be overwritten
        if self._paged:
            if donor == slot_ix:
                self._release_tail_pages(slot_ix,
                                         common // self.ec.page_size)
            else:
                self._release_slot_pages(slot_ix)
                if donor >= 0:
                    shared = self._alloc.share(
                        self._slot_pages[donor][:common // self.ec.page_size])
                    self._slot_pages[slot_ix] = shared
                    self._pt_host[slot_ix, :len(shared)] = shared
                    self._push_page_table()
        elif (donor >= 0 and donor != slot_ix
              and self._local(slot_ix) is not None):
            # the donor's prefix rows are frozen: decode writes land at
            # positions >= its prompt length (the plan's donor lives on
            # the slot's replica: _find_donor)
            generate.copy_slot_prefix(self._cache, self._local(donor),
                                      self._local(slot_ix))
        if donor >= 0:
            adm.offset = common
            if not req.internal:
                with self._lock:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_tokens_reused"] += common
        return adm

    def _execute_burst(self, sched: tuple, slots: list[int],
                       group: list[Request]) -> None:
        """One lane-masked `prefill_batch_chunk` per chunk of the shared
        schedule, then each lane's history and one `admit_slots`. A request
        the model or the pool cannot take fails the group's requests, and
        the engine serves on. Under dp > 1 each replica prefills its own
        lanes of the group (none: no call), the others masked out."""
        b, bl, dev = len(self._slots), self._bl, self.device
        lengths = np.ones((bl,), np.int32)
        mask = np.zeros((bl,), bool)
        mine = [(self._local(slot_ix), r) for slot_ix, r in zip(slots, group)
                if self._local(slot_ix) is not None]
        for j, r in mine:
            lengths[j] = len(r.prompt_ids)
            mask[j] = True
        for slot_ix in slots:
            self._slot_prompts[slot_ix] = None  # being overwritten
            if self._paged:
                self._release_slot_pages(slot_ix)
        lengths_d = torch.from_numpy(lengths).to(dev)
        lane_mask = torch.from_numpy(mask).to(dev)
        self._filling = set(slots)
        try:
            for r in group:
                self._check_ids(r.prompt_ids)
            for offset, bucket in sched:
                for slot_ix in slots:
                    if self._paged and not self._ensure_pages(
                            slot_ix, offset + bucket):
                        raise PoolExhausted("kv page pool exhausted")
                if not mine:
                    continue
                chunk = np.zeros((bl, bucket), np.int64)
                for j, r in mine:
                    take = min(bucket, len(r.prompt_ids) - offset)
                    chunk[j, :take] = r.prompt_ids[offset:offset + take]
                logits, self._cache = generate.prefill_batch_chunk(
                    self._prefill_params, self.cfg,
                    torch.from_numpy(chunk).to(dev),
                    lengths_d, lane_mask, self._cache, offset)
        except (ValueError, IndexError, KeyError, PoolExhausted) as e:
            for slot_ix, r in zip(slots, group):
                r.out.put((None, f"error: {e}"))
                if self._paged:
                    self._release_slot_pages(slot_ix)
            return
        finally:
            self._filling = set()
        self._clock.prompt_tokens += sum(len(r.prompt_ids) for r in group)
        ec = self.ec
        temp = np.full((bl,), ec.default_temperature, np.float32)
        topk = np.full((bl,), ec.default_top_k, np.int32)
        topp = np.full((bl,), ec.default_top_p, np.float32)
        seeds = np.full((bl,), -1, np.int32)
        for j, r in mine:
            temp[j], topk[j], topp[j] = r.temperature, r.top_k, r.top_p
            seeds[j] = -1 if r.seed is None else r.seed
        for slot_ix, r in zip(slots, group):
            self._write_prompt_history(slot_ix, r.prompt_ids)
        if mine:
            generate.admit_slots(
                logits, lengths_d, torch.from_numpy(temp).to(dev),
                torch.from_numpy(topk).to(dev), torch.from_numpy(topp).to(dev),
                lane_mask, self._tokens, self._positions, self._active,
                self._sstate, self._history, first_lp=self._first_lp,
                seeds=torch.from_numpy(seeds).to(dev))
        else:
            self._burn_draw(b)
        now = time.monotonic()
        for slot_ix, r in zip(slots, group):
            self._slot_prompts[slot_ix] = list(r.prompt_ids)
            slot = _Slot(request=r, prompt_len=len(r.prompt_ids))
            if r.top_logprobs:
                j = self._local(slot_ix)
                slot.first_top = self._share_top(
                    slot_ix, None if j is None else generate.top_candidates(
                        logits[j], r.top_logprobs), r.top_logprobs)
            self._slots[slot_ix] = slot
            # a new occupant: a pending record's view predates it
            self._slot_epoch[slot_ix] += 1
            self._count_admitted(r, now)
        with self._lock:
            self.stats["burst_admissions"] += sum(not r.internal
                                                  for r in group)

    def _write_prompt_history(self, slot_ix: int, ids) -> None:
        """The whole prompt into the slot's history row (the n-gram drafts
        read it), before the slot is activated; by its replica."""
        j = self._local(slot_ix)
        if j is None:
            return
        padded = np.zeros((self.ec.max_seq,), np.int32)
        padded[:len(ids)] = ids
        generate.write_history(self._history, j,
                               torch.from_numpy(padded).to(self.device),
                               len(ids))

    def _count_admitted(self, req: Request, now: float) -> None:
        """Stamp the request's first token and count it in the stats."""
        with self._lock:
            req.first_token_ts = now
            if not req.internal:
                self.stats["requests"] += 1
                self.stats["prompt_tokens"] += len(req.prompt_ids)
                self._ttfts.append(now - req.submit_ts)
                if len(self._ttfts) > 1024:
                    del self._ttfts[:512]

    def _prefill_one_chunk(self, adm: _Admission) -> bool:
        """Advance an admission by ONE chunk; True when fully prefilled."""
        remaining = len(adm.ids) - adm.offset
        bucket = self._next_bucket(remaining, adm.offset)
        take = min(bucket, remaining)
        if self._paged and not self._ensure_pages(adm.slot_ix,
                                                  adm.offset + bucket):
            raise PoolExhausted("kv page pool exhausted")
        chunk = np.zeros((bucket,), np.int64)
        chunk[:take] = adm.ids[adm.offset:adm.offset + take]
        self._check_ids(chunk[:take])
        tokens = torch.from_numpy(chunk).to(self.device)
        j = self._local(adm.slot_ix)
        if (self._sp and bucket >= self.ec.sp_prefill_tokens
                and bucket % self._dp == 0):
            # a long chunk: every replica takes a block of its tokens; the
            # logits come back on every rank, the rows in the owner's cache
            adm.last_logits, self._cache = sp.sp_prefill_slot(
                self._prefill_params, self.cfg, tokens, take, adm.slot_ix,
                adm.offset, self._cache, group=self._grid,
                ring=self.ec.sp_prefill_ring)
        elif j is not None:
            adm.last_logits, self._cache = generate.prefill_slot(
                self._prefill_params, self.cfg, tokens, take, j, adm.offset,
                self._cache)
        adm.offset += take
        self._clock.prompt_tokens += take
        return adm.offset >= len(adm.ids)

    def _drop_admission(self, adm: _Admission, msg: str) -> None:
        """End an admission that will not become a live slot: its request
        hears `msg`, and the pages its chunks took go back to the pool."""
        adm.req.out.put((None, msg))
        if self._paged:
            self._release_slot_pages(adm.slot_ix)

    def _setup_penalties(self, slot_ix: int, req: Request,
                         ids) -> Optional[tuple]:
        """Write a penalized request's rows into the (lazily created)
        PenaltyState and return its [V] admission rows (counts, bias,
        prompt mask) on the device, or None for a request without
        penalties. Freed slots' rows are cleared in _finish, so clean slots
        need no clearing here."""
        if not req.penalized:
            return None
        v, dev = self.cfg.vocab_size, self.device
        if self._pstate is None:
            # on every replica: the decode loops must match
            self._pstate = generate.PenaltyState.zeros(self._bl, v, dev)
        self._pen_slots.add(slot_ix)
        j = self._local(slot_ix)
        if j is None:
            return None
        # counts start at ZERO: OpenAI's formula counts the tokens SAMPLED
        # so far, never the prompt's; the prompt-presence mask feeds only
        # repetition_penalty
        counts_row = torch.zeros(v, dtype=torch.int32, device=dev)
        bias_row = np.zeros((v,), np.float32)
        for k, bias in (req.logit_bias or {}).items():
            bias_row[k] = bias
        prompt_row = np.zeros((v,), bool)
        prompt_row[np.asarray(ids, np.int64)] = True
        bias_row = torch.from_numpy(bias_row).to(dev)
        prompt_row = torch.from_numpy(prompt_row).to(dev)
        generate.set_penalty_slot(
            self._pstate, j, counts_row, req.presence_penalty,
            req.frequency_penalty, bias_row, req.repetition_penalty,
            prompt_row)
        return counts_row, bias_row, prompt_row

    def _finish_admission(self, adm: _Admission) -> None:
        """Activate the prefilled slot; its first token is sampled on the
        device (from the penalty-adjusted row for a penalized request, and
        counted) and reaches the host with the next burst's fetch. The
        slot's cache now holds the whole prompt: it registers as a prefix
        donor. Under dp > 1 the slot's replica does the device work; the
        others draw its uniforms."""
        req, n, slot_ix = adm.req, len(adm.ids), adm.slot_ix
        j = self._local(slot_ix)
        self._write_prompt_history(slot_ix, adm.ids)
        pen_rows = self._setup_penalties(slot_ix, req, adm.ids)
        top = None
        if j is None:
            self._burn_draw(1)
        else:
            if pen_rows is not None:
                counts_row, bias_row, prompt_row = pen_rows
                adm.last_logits = generate.penalize_row(
                    adm.last_logits, counts_row, req.presence_penalty,
                    req.frequency_penalty, bias_row, req.repetition_penalty,
                    prompt_row)
            generate.admit_slot(adm.last_logits, j, n, req.temperature,
                                req.top_k, req.top_p, self._tokens,
                                self._positions, self._active, self._sstate,
                                history=self._history,
                                first_lp=self._first_lp,
                                seed=-1 if req.seed is None else req.seed)
            if pen_rows is not None:
                # the first token is an emitted token: count it
                generate.count_slot_token(self._pstate, j, self._tokens[j])
            if req.top_logprobs:
                top = generate.top_candidates(adm.last_logits,
                                              req.top_logprobs)
        slot = _Slot(request=req, prompt_len=n)
        if req.top_logprobs:
            slot.first_top = self._share_top(slot_ix, top, req.top_logprobs)
        self._slots[slot_ix] = slot
        self._slot_epoch[slot_ix] += 1  # as in _execute_burst
        self._slot_prompts[slot_ix] = list(req.prompt_ids)
        self._count_admitted(req, time.monotonic())

    # ---- emission ----

    def _emit_token(self, slot_ix: int, token_id: int,
                    logprob: float = 0.0, top=None) -> None:
        """Append a token (its logprob, and with top_logprobs its top rows
        `top` = (ids, logprobs) of the call-wide bucket, cut to the
        request's own k) to the slot's request and stream its text delta.
        Only the new token's bytes are decoded (an incremental UTF-8
        decoder holds split multi-byte sequences); the last
        max(len(stop)) - 1 characters are held back so a stop string is
        never emitted."""
        slot = self._slots[slot_ix]
        if slot is None:
            return
        req = slot.request
        if token_id in self._stop_set:
            self._finish(slot_ix, "stop")
            return
        req.token_ids.append(token_id)
        req.token_logprobs.append(logprob)
        if req.top_logprobs:
            k = req.top_logprobs
            req.token_top.append(
                [] if top is None else
                [(int(i), float(x)) for i, x in zip(top[0][:k], top[1][:k])])
        req.completion_tokens = len(req.token_ids)
        raw = self.tokenizer.token_raw(token_id)
        new_text = ""
        if raw is not None:
            special, payload = raw
            if special:
                new_text = slot.dec.decode(b"", True) + payload
                slot.dec.reset()
            else:
                new_text = slot.dec.decode(payload)
        held = slot.text_held + new_text
        if req.stop:
            hits = [j for j in (held.find(s) for s in req.stop) if j >= 0]
            if hits:
                cut = min(hits)
                if cut > 0:
                    req.out.put((held[:cut], None))
                slot.text_held = ""
                slot.drop_tail = True
                self._finish(slot_ix, "stop")
                return
            safe = len(held) - max(map(len, req.stop)) + 1
        else:
            safe = len(held)
        if safe > 0:
            req.out.put((held[:safe], None))
            slot.text_held = held[safe:]
        else:
            slot.text_held = held
        if len(req.token_ids) >= req.max_tokens:
            self._finish(slot_ix, "length")

    def _finish(self, slot_ix: int, reason: str) -> None:
        slot = self._slots[slot_ix]
        if slot is None:
            return
        tail = ""
        if not slot.drop_tail:
            tail = slot.text_held + slot.dec.decode(b"", True)
        req = slot.request
        span = {
            "prompt_tokens": len(req.prompt_ids),
            "completion_tokens": len(req.token_ids),
            "finish": reason,
            "ttft_ms": (round((req.first_token_ts - req.submit_ts) * 1e3, 1)
                        if req.first_token_ts else None),
            "queue_ms": (round((req.admit_ts - req.submit_ts) * 1e3, 1)
                         if req.admit_ts else None),
            "total_ms": round((time.monotonic() - req.submit_ts) * 1e3, 1),
        }
        with self._lock:
            if not req.internal:
                self.stats["completion_tokens"] += len(req.token_ids)
                self._spans.append(span)
        self._slots[slot_ix] = None
        # a record dispatched before this finish must not emit into the
        # slot's next occupant (see _BurstRecord.epochs)
        self._slot_epoch[slot_ix] += 1
        # release the lane and park its write position before the client
        # hears of the finish
        j = self._local(slot_ix)
        if j is not None:
            self._active[j] = False
            self._positions[j] = self._park
        if slot_ix in self._pen_slots:
            self._pen_slots.discard(slot_ix)
            if self._pen_slots and j is not None:
                # a later admission must not inherit this slot's rows
                v, dev = self.cfg.vocab_size, self.device
                generate.set_penalty_slot(
                    self._pstate, j,
                    torch.zeros(v, dtype=torch.int32, device=dev), 0.0, 0.0,
                    torch.zeros(v, dtype=torch.float32, device=dev), 1.0,
                    torch.zeros(v, dtype=torch.bool, device=dev))
            elif not self._pen_slots:
                self._pstate = None  # back to the penalty-free loop
        req.out.put((tail or None, reason))

    # ---- the loop ----

    def _loop_guarded(self) -> None:
        """An engine-thread error must not strand waiting requests: every
        in-flight and queued request gets an error finish."""
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 — the thread's boundary
            traceback.print_exc()
            self._fail_all_requests(f"error: engine died: {e}")
        finally:
            if self.capturer is not None:
                self.capturer.close()

    def _fail_all_requests(self, msg: str) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
            self._fail_msg = msg
            self._shutdown = True
        try:
            # tokens the device already made reach their requests first
            self._drain_pending_burst()
        except Exception:  # noqa: BLE001 — the device may be what failed
            self._pending_burst = None
        for slot_ix, slot in enumerate(self._slots):
            if slot is not None:
                slot.request.out.put((None, msg))
                self._slots[slot_ix] = None
        for req in self._backlog:
            req.out.put((None, msg))
        self._backlog.clear()
        while True:
            try:
                self._queue.get_nowait().out.put((None, msg))
            except queue.Empty:
                break

    def _watchdog(self) -> None:
        """A peer that dies INSIDE a collective leaves this rank's loop
        blocked there: no exception, and the broadcast timeout never fires
        because the loop never reaches the next broadcast. Poll the peers'
        liveness counters (HostSync.dead_peers); after two polls that see
        a dead peer, fail every request. The stuck loop thread is
        abandoned (an abandoned collective cannot be taken back)."""
        sync = self._sync
        poll = min(2.0, sync.timeout / 4)
        misses = 0
        while not self._shutdown:
            time.sleep(poll)
            try:
                dead = sync.dead_peers()
            except Exception:  # noqa: BLE001 — a failed probe is fatal
                dead = [p for p in range(sync.num_processes)
                        if p != sync.process_index]
            if not dead:
                misses = 0
                continue
            # one confirming poll guards against a single starved read
            misses += 1
            if misses >= 2:
                self._fail_all_requests(
                    f"error: peer rank(s) {dead} lost: tensor-parallel "
                    f"serving cannot continue (liveness counter stalled "
                    f"past {sync.timeout:.0f}s)")
                return

    def _compose_plan(self, admitting: Optional[_Admission]
                      ) -> Optional[dict]:
        """The leader's (or the single process's) decisions for one
        iteration: cancellations and deadlines, then a burst admission or
        one single admission (with its donor prefix) when no admission is
        in flight, then the decode burst's steps. Everything read from a
        clock or the ingress queue is decided here, so a follower that
        executes the plan makes the same device calls. None when there is
        nothing to do."""
        plan: dict = {}
        live = [i for i, s in enumerate(self._slots) if s is not None]
        cancels = [i for i in live if self._slots[i].request.cancelled]
        overdue = [i for i in live if i not in cancels
                   and self._slack(self._slots[i].request) <= 0]
        if cancels:
            plan["cancel"] = cancels
        if overdue:
            plan["deadline"] = overdue
        freed = set(cancels + overdue)
        self._drain_ingress()
        pending = admitting
        if admitting is not None and admitting.req.cancelled:
            plan["cancel_admission"] = True
            pending = None
        group: list[Request] = []
        free = [i for i, s in enumerate(self._slots)
                if s is None or i in freed]
        if pending is None:
            burst = self._select_burst(freed)
            if burst is not None:
                sched, slots, group = burst
                self._burst_reqs = group
                now = time.monotonic()
                for r in group:
                    r.admit_ts = now
                plan["burst"] = {
                    "sched": sched, "slots": slots,
                    "prompts": [list(r.prompt_ids) for r in group],
                    "metas": [self._req_meta(r) for r in group]}
            else:
                req = self._pop_next_admission() if free else None
                if req is not None:
                    req.admit_ts = time.monotonic()
                    self._pending_admit = req
                    donor, common = self._find_donor(req.prompt_ids, free[0])
                    plan["admit"] = {"slot": free[0],
                                     "ids": list(req.prompt_ids),
                                     "meta": self._req_meta(req),
                                     "donor": donor, "common": common}
        if admitting is None and not group and "admit" not in plan \
                and not live:
            return None
        # short decode bursts while an admission is in flight, and after a
        # burst admission while requests still wait for a free slot: their
        # TTFT sits behind the decode burst (the reference counts single
        # admissions only, and decodes a long burst after each burst
        # admission)
        waiting = bool(self._backlog or not self._queue.empty())
        busy = (pending is not None or "admit" in plan
                or (bool(group) and waiting and len(free) > len(group)))
        steps = (self.ec.steps_per_call_busy if busy
                 else self.ec.steps_per_call)
        if not busy and waiting:
            # requests wait for a slot: stop at the nearest predictable
            # free-up (a slot reaching max_tokens), a power of two
            remaining = [self._slots[i].request.max_tokens
                         - len(self._slots[i].request.token_ids)
                         for i in live if i not in freed]
            remaining += [r.max_tokens for r in group]
            if remaining:
                tgt = max(1, min(steps, min(remaining)))
                steps = 1 << (tgt.bit_length() - 1)
        plan["steps"] = steps
        return plan

    def _execute_plan(self, plan: dict, admitting: Optional[_Admission]
                      ) -> Optional[_Admission]:
        """One iteration's device calls and host bookkeeping, the same on
        every rank (followers rebuild the plan's requests as stubs): the
        plan's finishes, its burst or single admission, at most one
        prefill chunk, then one decode burst, its fetch and its emission,
        each a phase of the iteration's clock. Returns the admission still
        in flight."""
        clock = self._clock
        with tracing.span("engine.admit"):
            for i in plan.get("cancel", ()):
                self._finish(i, "cancelled")
            for i in plan.get("deadline", ()):
                self._finish(i, "deadline")
            if plan.get("cancel_admission") and admitting is not None:
                self._drop_admission(admitting, "cancelled")
                admitting = None
            follower = self._multi and not self._sync.is_leader
            if "burst" in plan:
                spec = plan["burst"]
                if follower:
                    group = [self._stub_request(p, m)
                             for p, m in zip(spec["prompts"], spec["metas"])]
                else:
                    group, self._burst_reqs = self._burst_reqs, None
                self._execute_burst(spec["sched"], spec["slots"], group)
            if "admit" in plan:
                spec = plan["admit"]
                if follower:
                    req = self._stub_request(spec["ids"], spec["meta"])
                else:
                    req, self._pending_admit = self._pending_admit, None
                admitting = self._start_admission(
                    spec["slot"], req, spec["donor"], spec["common"])
            if admitting is not None:
                try:
                    if self._prefill_one_chunk(admitting):
                        self._finish_admission(admitting)
                        admitting = None
                except (ValueError, IndexError, KeyError, PoolExhausted) as e:
                    # a request the model cannot take (e.g. a token id
                    # outside the vocab) or the pool cannot back: fail it
                    # alone, keep serving the rest
                    self._drop_admission(admitting, f"error: {e}")
                    admitting = None
            self._filling = ({admitting.slot_ix} if admitting is not None
                             else set())
        # the burst's wall, dispatch to fetch, starts here
        t_call = clock.lap(tracing.ADMIT)
        if not any(s is not None for s in self._slots):
            self._drain_pending_burst()  # no follow-up burst is coming
            return admitting

        steps = plan["steps"]
        with tracing.span("engine.decode"):
            if self._paged:
                # back every live slot's rows past this burst's furthest
                # possible write (a verify macro-step writes its whole
                # block, which extends past the last accepted position); a
                # slot the pool cannot back finishes now, its text so far
                # delivered
                span = ((self.ec.speculate_tokens + 1) if self._spec_enabled
                        else 1)
                for i, s in enumerate(self._slots):
                    if s is None:
                        continue
                    horizon = (s.prompt_len + len(s.request.token_ids)
                               + self._lag() + steps * span + span + 1)
                    if not self._ensure_pages(i, horizon):
                        self._finish(i, "length")
                if not any(s is not None for s in self._slots):
                    self._drain_pending_burst()
                    return admitting
            pre_tokens = self._tokens
            window = self._attn_window(steps)
            first_slots = tuple(i for i, s in enumerate(self._slots)
                                if s is not None and s.first_pending)
            # top_logprobs: when a live request asked for alternatives, the
            # loops also return exact top-k rows, at a width bucketed to
            # {5, 10, 20}; each request takes its own k from them
            n_top = _n_top_bucket(max(s.request.top_logprobs
                                      for s in self._slots if s is not None))
            # penalized batches take the plain loop: a draft's argmax would
            # need counts that evolve inside the verify block
            speculate = (self._spec_enabled and self._pstate is None
                         and not self._probe_plain_now())
            if speculate:
                dl = self.ec.speculate_tokens
                (out_em, out_n, out_lp, self._tokens, self._positions,
                 self._active, out_top_lp, out_top_ids) = \
                    generate.spec_decode_loop(
                        self.params, self.cfg, self._tokens,
                        self._positions, self._active, self._cache,
                        self._sstate, self._history, steps, dl,
                        self._eos_ids, window=window, n_top=n_top)
            else:
                (out_tokens, out_active, out_lp, self._tokens,
                 self._positions, self._active, out_top_lp,
                 out_top_ids) = generate.decode_loop(
                    self.params, self.cfg, self._tokens, self._positions,
                    self._active, self._cache, self._sstate, steps,
                    eos_ids=self._eos_ids, window=window, n_top=n_top,
                    pstate=self._pstate)
                with self._lock:
                    self.stats["decode_steps"] += steps
        clock.lap(tracing.DECODE)
        clock.steps = steps
        if speculate:
            # ONE host transfer per burst; it also ends the timed window
            with tracing.span("engine.fetch"):
                packed = self._host_view(generate.pack_spec_host_view(
                    out_em, out_n, self._active, pre_tokens, out_lp,
                    self._first_lp, out_top_lp, out_top_ids),
                    generate.spec_view_segments(steps, dl + 1, n_top)
                ).numpy()
            self._spec_step_s.append((clock.lap(tracing.FETCH) - t_call)
                                     / steps)
            with tracing.span("engine.emit"):
                self._process_spec_burst(packed, steps, dl + 1, n_top,
                                         first_slots)
                self._maybe_disable_spec()
            return admitting
        with tracing.span("engine.fetch"):
            rec = self._record(generate.pack_host_view(
                out_tokens, out_active, self._active, pre_tokens, out_lp,
                self._first_lp, out_top_lp, out_top_ids), steps, n_top,
                first_slots)
        t_fetched = clock.lap(tracing.FETCH)
        if self._pipeline:
            # the previous record's copy finished under this burst's
            # dispatch: read it now, this one next iteration
            pending, self._pending_burst = self._pending_burst, rec
            if pending is not None:
                self._process_burst(pending)
        else:
            if self._pstate is None:
                # penalty-free plain bursts only: the penalized loop costs
                # more and would skew the auto break-even's denominator (a
                # pipelined burst is never timed: its dispatch-to-fetch
                # does not bound one burst)
                self._plain_step_s.append((t_fetched - t_call) / steps)
            self._process_burst(rec)
        self._maybe_reprobe_spec()
        return admitting

    def _turn(self, admitting: Optional[_Admission], leader: bool = True,
              waited: bool = False, stopping: bool = False
              ) -> tuple[Optional[dict], Optional[_Admission]]:
        """One iteration of the loop, a `gabby.engine.iteration` span: the
        plan, composed by the leader (the shutdown plan when `stopping`;
        with more than one process, a no-op once an idle leader has
        `waited`) or received by a follower, then its execution, which
        logs one iteration record. Returns (the plan, None when the leader
        has nothing to do; the admission still in flight)."""
        clock = self._clock
        with tracing.span("engine.iteration"):
            clock.start()
            plan = None
            if leader:
                with tracing.span("engine.compose"):
                    plan = ({"op": "shutdown"} if stopping
                            else self._compose_plan(admitting))
                if plan is None:
                    if not (self._multi and waited):
                        return None, admitting
                    # an idle leader sends a no-op plan every <= 2 s, so
                    # that no follower waits in a broadcast near its
                    # timeout
                    plan = {"op": "noop"}
            if self._multi:
                plan = self._sync.broadcast(plan)
            if leader:
                clock.lap(tracing.COMPOSE)
            else:
                clock.start()  # a follower's iteration starts at its plan
            if "op" in plan:
                return plan, admitting
            admitting = self._execute_plan(plan, admitting)
            clock.lap(tracing.EMIT)
            rec = clock.close()
            with self._lock:
                self.stats["iterations"] += 1
                for name in tracing.PHASES:
                    self.stats[name + "_s"] += getattr(rec, name)
        return plan, admitting

    def _iteration(self, admitting: Optional[_Admission]
                   ) -> tuple[bool, Optional[_Admission]]:
        """One single-process loop iteration, for driving a stopped engine
        step by step: (did work, the admission still in flight)."""
        plan, admitting = self._turn(admitting)
        if plan is None:
            self._drain_pending_burst()  # idle: settle it now
            return False, admitting
        return True, admitting

    def _record(self, packed: torch.Tensor, steps: int, n_top: int,
                first_slots: tuple) -> _BurstRecord:
        """A burst's record. Synchronous: the host copy, read now.
        Pipelined on the card: an asynchronous copy into pinned host
        memory, enqueued before the next burst, and an event after it, so
        that reading the record waits for this copy alone."""
        rec = _BurstRecord(packed=packed, steps=steps, n_top=n_top,
                           epochs=tuple(self._slot_epoch),
                           first_slots=first_slots)
        if not packed.is_cuda and self._dp == 1:
            return rec
        if not self._pipeline:
            rec.packed = self._host_view(
                packed, generate.view_segments(steps, n_top))
            return rec
        rec.packed = torch.empty(packed.shape, dtype=packed.dtype,
                                 pin_memory=True)
        rec.packed.copy_(packed, non_blocking=True)
        rec.ready = torch.cuda.Event()
        rec.ready.record()
        return rec

    def _drain_pending_burst(self) -> None:
        """Process the outstanding pipelined record now (no slot live, the
        loop idle, shutdown, failure): no request may wait on a record
        whose follow-up burst is not coming."""
        pending, self._pending_burst = self._pending_burst, None
        if pending is not None:
            self._process_burst(pending)

    def _claimed(self, slot_ix: int, epochs: Optional[tuple]) -> bool:
        """The slot is live and, for a record (`epochs`), the occupant it
        was dispatched for."""
        return self._slots[slot_ix] is not None and (
            epochs is None or self._slot_epoch[slot_ix] == epochs[slot_ix])

    def _emit_first_tokens(self, first_slots, first_toks: np.ndarray,
                           first_lps: np.ndarray,
                           epochs: Optional[tuple] = None) -> None:
        """First tokens of fresh admissions come before the burst's own."""
        for slot_ix in first_slots:
            slot = self._slots[slot_ix]
            if self._claimed(slot_ix, epochs) and slot.first_pending:
                slot.first_pending = False
                top = None
                if slot.first_top is not None:
                    lp, ids = slot.first_top
                    top = (ids.tolist(), lp.tolist())
                self._emit_token(slot_ix, int(first_toks[slot_ix]),
                                 float(first_lps[slot_ix]), top)

    def _finish_stopped_lanes(self, active_host: np.ndarray,
                              epochs: Optional[tuple] = None) -> None:
        """A lane the device stopped without an EOS hit the cache capacity."""
        for slot_ix in range(len(self._slots)):
            if self._claimed(slot_ix, epochs) and not active_host[slot_ix]:
                self._finish(slot_ix, "length")

    @staticmethod
    def _unpack_floats(packed: np.ndarray, base: int, n_cand: int, b: int,
                       n_top: int) -> tuple:
        """The float part of a packed view that starts at `base`: the
        candidates' logprobs [n_cand], the first tokens' [B], the top rows'
        logprobs [n_cand, n_top] and ids [n_cand, n_top]."""
        lp = packed[base:base + n_cand + b].view(np.float32)
        base += n_cand + b
        top_lp = packed[base:base + n_cand * n_top].view(np.float32)
        top_ids = packed[base + n_cand * n_top:base + 2 * n_cand * n_top]
        return (lp[:n_cand], lp[n_cand:], top_lp.reshape(n_cand, n_top),
                top_ids.reshape(n_cand, n_top))

    def _process_burst(self, rec: _BurstRecord) -> None:
        """Host bookkeeping of one plain burst: first tokens, then the
        burst's tokens, then capacity finishes, each only into the slots
        the record was dispatched for. A pipelined record's copy is waited
        for first (the fetch phase)."""
        if rec.ready is not None:
            with tracing.span("engine.fetch"):
                rec.ready.synchronize()  # this record's copy, nothing later
            self._clock.lap(tracing.FETCH)
        with tracing.span("engine.emit"):
            packed = rec.packed.numpy()
            steps, n_top, epochs = rec.steps, rec.n_top, rec.epochs
            b = len(self._slots)
            kb = steps * b
            toks = packed[:kb].reshape(steps, b)
            emitted = packed[kb:2 * kb].reshape(steps, b) != 0
            active_host = packed[2 * kb:2 * kb + b] != 0
            lps, first_lps, top_lp, top_ids = self._unpack_floats(
                packed, 2 * kb + 2 * b, kb, b, n_top)
            self._emit_first_tokens(rec.first_slots,
                                    packed[2 * kb + b:2 * kb + 2 * b],
                                    first_lps, epochs)
            for step in range(steps):
                for slot_ix in range(b):
                    if (emitted[step, slot_ix]
                            and self._claimed(slot_ix, epochs)):
                        i = step * b + slot_ix
                        self._emit_token(
                            slot_ix, int(toks[step, slot_ix]),
                            float(lps[i]),
                            (top_ids[i], top_lp[i]) if n_top else None)
            self._finish_stopped_lanes(active_host, epochs)

    def _process_spec_burst(self, packed: np.ndarray, steps: int, t_blk: int,
                            n_top: int, first_slots: tuple) -> None:
        """Host bookkeeping of one speculative burst: candidate tokens
        [K, B, T] of which the first counts[k, b] were emitted."""
        b = len(self._slots)
        kbt, kb = steps * b * t_blk, steps * b
        em = packed[:kbt].reshape(steps, b, t_blk)
        counts = packed[kbt:kbt + kb].reshape(steps, b)
        active_host = packed[kbt + kb:kbt + kb + b] != 0
        lps, first_lps, top_lp, top_ids = self._unpack_floats(
            packed, kbt + kb + 2 * b, kbt, b, n_top)
        with self._lock:
            self.stats["decode_steps"] += steps
            self.stats["spec_macro_steps"] += int(np.sum(counts > 0))
            self.stats["spec_tokens"] += int(np.sum(counts))
        self._emit_first_tokens(first_slots,
                                packed[kbt + kb + b:kbt + kb + 2 * b],
                                first_lps)
        for step in range(steps):
            for slot_ix in range(b):
                for t in range(int(counts[step, slot_ix])):
                    if self._slots[slot_ix] is None:
                        break  # finished mid-block (max_tokens, stop string)
                    i = (step * b + slot_ix) * t_blk + t
                    self._emit_token(
                        slot_ix, int(em[step, slot_ix, t]), float(lps[i]),
                        (top_ids[i], top_lp[i]) if n_top else None)
        self._finish_stopped_lanes(active_host)

    # ---- speculation economics ----

    def _probe_plain_now(self) -> bool:
        """spec_auto_breakeven needs PLAIN-burst wall samples, but with
        speculation on every burst takes the speculative branch: until the
        plain window holds 8 samples every 16th burst runs plain, and after
        that every 128th still does, so the denominator follows the current
        batch occupancy. Output-safe: the two loops are interchangeable per
        burst. Single-process only: ranks must dispatch the same programs,
        and wall timings are local."""
        if not self.ec.spec_auto_breakeven or self._multi:
            return False
        self._plain_probe_ctr += 1
        period = 16 if len(self._plain_step_s) < 8 else 128
        return self._plain_probe_ctr % period == 0

    def _spec_breakeven_now(self) -> float:
        """The break-even in force: the measured verify/plain per-step cost
        ratio once both rolling windows hold 8 samples (spec_auto_breakeven,
        single process), else the configured prior: ranks must switch
        speculation at the same plan, and wall timings are local."""
        if (not self.ec.spec_auto_breakeven or self._multi
                or len(self._plain_step_s) < 8
                or len(self._spec_step_s) < 8):
            return self.ec.spec_breakeven
        plain = statistics.median(self._plain_step_s)
        if plain <= 0:
            return self.ec.spec_breakeven
        return max(1.0, statistics.median(self._spec_step_s) / plain)

    def _maybe_disable_spec(self) -> None:
        """Speculation must PAY for its wider verify pass: if the measured
        tokens per macro-step stay below the break-even over a fair sample
        of 128 slot-macro-steps, fall back to the plain decode loop. With
        spec_reprobe_steps > 0 the engine re-probes later; 0 keeps the
        disable for the engine's life."""
        breakeven = self._spec_breakeven_now()
        with self._lock:
            ms = self.stats["spec_macro_steps"] - self._spec_probe_base[0]
            tk = self.stats["spec_tokens"] - self._spec_probe_base[1]
            self.stats["spec_breakeven_derived"] = round(breakeven, 3)
        if ms >= 128 and tk < breakeven * ms:
            self._spec_enabled = False
            with self._lock:
                self._spec_off_since = self.stats["decode_steps"]
                self.stats["spec_on"] = 0
                self.stats["spec_disables"] += 1
            print(f"[engine] speculation disabled: acceptance "
                  f"{tk / max(ms, 1):.2f} tokens/verify over {ms} steps "
                  f"(break-even {breakeven:.2f})", file=sys.stderr,
                  flush=True)

    def _maybe_reprobe_spec(self) -> None:
        """Re-enable a disabled speculation for another acceptance sample
        once enough plain decode steps have passed (spec_reprobe_steps)."""
        if (self._spec_enabled or self.ec.speculate_tokens <= 0
                or self.ec.spec_reprobe_steps <= 0
                or self._spec_off_since is None):
            return
        with self._lock:
            steps_off = self.stats["decode_steps"] - self._spec_off_since
            base = (self.stats["spec_macro_steps"],
                    self.stats["spec_tokens"])
        if steps_off >= self.ec.spec_reprobe_steps:
            self._spec_probe_base = base
            self._spec_off_since = None
            self._spec_enabled = True
            with self._lock:
                self.stats["spec_on"] = 1
            print(f"[engine] speculation re-probe after {steps_off} plain "
                  f"steps", file=sys.stderr, flush=True)

    def _loop(self) -> None:
        admitting: Optional[_Admission] = None
        leader = not self._multi or self._sync.is_leader
        waited = False
        while True:
            if self.capturer is not None:
                self.capturer.tick()  # a plan boundary: open or close a trace
            plan, admitting = self._turn(admitting, leader, waited,
                                         stopping=self._shutdown)
            waited = plan is None
            if plan is None:
                self._drain_pending_burst()  # idle: settle it now
                self._wake.wait(timeout=2.0 if self._multi else 0.05)
                self._wake.clear()
                continue
            if plan.get("op") == "shutdown":
                break
        self._shutdown = True  # followers: the leader's shutdown plan
        # the tokens the device already made come before the aborts
        self._drain_pending_burst()
        if admitting is not None:
            self._drop_admission(admitting, "abort")
        for slot_ix in range(len(self._slots)):
            if self._slots[slot_ix] is not None:
                self._finish(slot_ix, "abort")
        for req in self._backlog:
            req.out.put((None, "abort"))
        self._backlog.clear()
        while True:
            try:
                self._queue.get_nowait().out.put((None, "abort"))
            except queue.Empty:
                break
