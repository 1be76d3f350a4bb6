"""Serving entry point of the PyTorch port: `python -m gabby_tpu_torch.server`.

The C++ HTTP front-end (cpp/, via gabby_tpu_torch.bridge) serving OpenAI
chat completions, backed by the PyTorch continuous-batching engine. The
flags are the reference server's (gabby_tpu/server.py) plus `--device`
(default cuda). `--pair-kv` defaults to AUTO as there: the paired kv-head
cache layout whenever the kv-head count is even (`--no-pair-kv` reverts),
dense and paged. `--act-fp8`, `--prefill-int8-shadow` and
`--pipeline-fetch` are the reference's options, off by default.

Tensor and data parallelism: `--tp T` (and `--dp D`) on one host starts
D x T - 1 follower processes of the same command (rank i on cuda:i; every
rank on the CPU with `--device cpu`): dp replicas of a tp group, rank r =
d x T + t. `--coordinator host:port --num-processes P --process-id i`
starts one rank of a run over P = D x T processes, as the reference's
multi-host flags do. Rank 0 serves HTTP and broadcasts the engine's plans;
a follower opens no port. Under `--dp` the decode slots shard over the
replicas, and admission chunks of at least `--sp-prefill-tokens` run as
sequence-parallel prefill (`--sp-ring`: ring attention).
`--profiler-port P` serves torch.profiler captures of the engine thread
(runtime/profiler.py: GET /capture?duration_ms=N on port P, the gzipped
Chrome trace back); rank i of a multi-process run serves port P + i.

Examples:
  python -m gabby_tpu_torch.tools.quantize --model-dir ~/hf/Llama-3.2-1B \\
      --out ~/gabby/llama1b-int8 --bits 8
  python -m gabby_tpu_torch.server --model-dir ~/gabby/llama1b-int8 --kv-quant
  python -m gabby_tpu_torch.server --model-dir ~/hf/Llama-3.2-1B --quant 8
  python -m gabby_tpu_torch.server --preset llama32_1b --random-weights \\
      --quant 4 --kv-quant
  python -m gabby_tpu_torch.server --preset llama32_1b --random-weights \\
      --quant 4 --kv-quant --speculate 7 --paged-pages 33 --page-size 512
  python -m gabby_tpu_torch.server --preset llama32_1b --random-weights \\
      --quant 4 --kv-quant --act-fp8 --prefill-int8-shadow --pipeline-fetch
  python -m gabby_tpu_torch.server --preset tiny --random-weights \\
      --device cpu --port 0
  python -m gabby_tpu_torch.server --preset llama32_1b --random-weights \\
      --quant 4 --kv-quant --tp 2
  python -m gabby_tpu_torch.server --preset llama32_1b --random-weights \\
      --quant 4 --kv-quant --dp 2 --tp 2 --sp-prefill-tokens 512
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import subprocess
import sys
import threading
from typing import Callable, Optional

import torch

from gabby_tpu_torch.runtime.engine import RequestError

def _build_engine(args, group=None, sync=None):
    """The engine of one rank: `group` (a parallel.TPGroup, None for a
    single process) picks the rank's device and weight shard; `sync` (its
    HostSync) keeps the ranks in lockstep."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch import resolve_device
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.parallel import (bind_group, shard_params,
                                          sharded_put_fn)
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    if args.act_fp8:
        # read wherever a projection runs: set before any weights are built
        quant.set_act_fp8(True)
    tp = 1 if group is None else group.size
    dp = 1 if group is None else group.dp_size
    if (tp > 1 or dp > 1) and args.pair_kv:
        sys.exit("--pair-kv: pair_kv_heads is single-device only for now "
                 "(unvalidated under tensor parallelism)")
    device = resolve_device(args.device) if group is None else group.device
    if args.model_dir:
        # an HF-layout directory (quantized at load when --quant is given)
        # or one written by tools.quantize (its own metadata decides);
        # under tp each leaf is cut to this rank's block as it is read
        from gabby_tpu_torch.loader import load_model_dir
        cfg, params, tokenizer = load_model_dir(
            args.model_dir, dtype=torch.bfloat16,
            quant_bits=args.quant or None, max_seq_len=args.max_seq,
            device=device, tp=tp, device_put_fn=(
                sharded_put_fn(group.rank, tp, device) if tp > 1
                else None))
        if tokenizer is None:
            sys.exit(f"{args.model_dir} has no tokenizer.json")
        dtype = torch.bfloat16
    else:
        if not args.random_weights:
            sys.exit("no --model-dir given: pass --random-weights to serve "
                     "a randomly initialized model (smoke tests only)")
        cfg = getattr(cfglib, args.preset)(max_seq_len=args.max_seq)
        dtype = torch.float32 if args.preset == "tiny" else torch.bfloat16
        params = llama.init_params(cfg, dtype=dtype, device=device)
        if args.quant:
            # the bench headline recipe: int4 weights come with the
            # group-256 int4 unembed
            unembed = ({"unembed_bits": 4, "unembed_group": 256}
                       if args.quant == 4 else {})
            params = quant.quantize_tree(params, args.quant, **unembed)
        tokenizer = Tokenizer.byte_fallback(cfg.vocab_size)
        if tp > 1:
            params = shard_params(params, group.rank, tp)
    # fuse qkv and gate/up into single products. A rank's shard fuses to
    # its own block of the tree fused with tp (the per-shard layout of
    # fuse_projections): one plain block, as local_config says
    params = llama.fuse_projections(params)
    if tp > 1:
        params = bind_group(params, group)
    if args.pair_kv and cfg.num_kv_heads % 2:
        sys.exit("--pair-kv: pair_kv_heads needs an even kv-head count")
    econfig = EngineConfig(
        batch_slots=args.slots, max_seq=args.max_seq,
        steps_per_call=args.steps_per_call,
        steps_per_call_busy=args.steps_per_call_busy,
        default_max_tokens=args.max_tokens, kv_quantized=args.kv_quant,
        cache_dtype="float32" if dtype == torch.float32 else "bfloat16",
        paged_pages=args.paged_pages, page_size=args.page_size,
        speculate_tokens=args.speculate, spec_breakeven=args.spec_breakeven,
        spec_reprobe_steps=args.spec_reprobe_steps,
        prefill_int8_shadow=args.prefill_int8_shadow,
        pipeline_fetch=args.pipeline_fetch,
        # sequence-parallel prefill for long admissions under dp > 1
        # (parallel/sp.py; ring attention with --sp-ring, parallel/ring.py)
        sp_prefill_tokens=args.sp_prefill_tokens,
        sp_prefill_ring=args.sp_ring,
        # auto: on whenever eligible (one process and an even kv-head
        # count), dense and paged
        pair_kv_heads=(args.pair_kv if args.pair_kv is not None
                       else tp == 1 and dp == 1
                       and cfg.num_kv_heads % 2 == 0))
    return Engine(cfg, params, tokenizer, econfig, device=device,
                  sync=sync), cfg


def _start_ranks(args, argv: list[str]):
    """Join this process's rank: with --coordinator, rank --process-id of
    --num-processes (dp x tp); with --tp T and --dp D alone, rank 0 of D x
    T, after starting ranks 1..D x T - 1 as processes of the same command
    line. Returns (TPGroup, follower processes)."""
    from gabby_tpu_torch import resolve_device
    from gabby_tpu_torch.parallel import init_distributed

    device = resolve_device(args.device)
    timeout = args.sync_timeout or None
    dp = args.dp
    if args.coordinator:
        n, rank = args.num_processes, args.process_id
        if n < 1 or not 0 <= rank < n:
            sys.exit("--coordinator needs --num-processes P >= 1 and "
                     "--process-id in [0, P)")
        if n % dp:
            # one device a process: the global device count is P
            sys.exit(f"--dp {dp} must divide the global device count {n}")
        if args.tp not in (1, n // dp):
            sys.exit(f"--tp {args.tp} differs from --num-processes {n} / "
                     f"--dp {dp}: dp x tp is the number of processes")
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        return init_distributed(args.coordinator, n, rank, dp=dp,
                                device=device, timeout=timeout), []
    n = dp * args.tp
    if device.type == "cuda" and n > torch.cuda.device_count():
        # the reference's mesh takes dp * tp devices (its
        # parallel/mesh.py: "dp*tp = D*T != N devices")
        what = f"--dp {dp} --tp {args.tp}" if dp > 1 else f"--tp {n}"
        sys.exit(f"{what} needs {n} visible cards; "
                 f"{torch.cuda.device_count()} visible (dp*tp = "
                 f"{dp}*{args.tp} != {torch.cuda.device_count()} devices)")
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout or 1800))
    coordinator = f"127.0.0.1:{store.port}"
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    followers = [subprocess.Popen(
        [sys.executable, "-m", "gabby_tpu_torch.server", *argv,
         "--coordinator", coordinator, "--num-processes", str(n),
         "--process-id", str(i)], env=env) for i in range(1, n)]
    try:
        if device.type == "cuda":
            device = torch.device("cuda", 0)
        group = init_distributed(coordinator, n, 0, dp=dp, store=store,
                                 device=device, timeout=timeout)
    except BaseException:
        _stop_followers(followers, 0)
        raise
    return group, followers


def _stop_followers(followers, grace: float) -> None:
    """Wait up to `grace` seconds for the followers (the leader's shutdown
    plan releases them), then kill what is left."""
    for p in followers:
        try:
            p.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            pass
        if p.poll() is None:
            p.kill()
            p.wait()


def _top_entries(engine, rows):
    """OpenAI `top_logprobs` payload: per generated token, the top-k
    alternatives of its distribution as [{token, logprob}] (rows are the
    engine's (id, logprob) pairs)."""
    return [[{"token": engine.tokenizer.decode([i]),
              "logprob": round(lp, 6)} for i, lp in row]
            for row in rows]


def _logprob_fields(engine, req, lo: int, hi: int) -> dict:
    """token_logprobs, tokens and (when asked for) top_logprobs of the
    request's tokens [lo, hi)."""
    out = {"token_logprobs": [round(x, 6)
                              for x in req.token_logprobs[lo:hi]],
           "tokens": [engine.tokenizer.decode([i])
                      for i in req.token_ids[lo:hi]]}
    if req.top_logprobs:
        out["top_logprobs"] = _top_entries(engine, req.token_top[lo:hi])
    return out


def make_handler(engine):
    """Adapts bridge requests to the engine (the Generator seam)."""

    def handler(request: dict, emit) -> None:
        kw = dict(
            max_tokens=request.get("max_tokens") or None,
            temperature=(request["temperature"]
                         if request.get("temperature", -1) >= 0 else None),
            top_k=(request["top_k"] if request.get("top_k", -1) >= 0
                   else None),
            top_p=(request["top_p"]
                   if 0 < request.get("top_p", -1) <= 1 else None),
            stop=request.get("stop") or None,
            priority=int(request.get("priority") or 0),
            deadline_s=(request["deadline_ms"] / 1e3
                        if request.get("deadline_ms") else None),
            top_logprobs=int(request.get("top_logprobs") or 0),
            presence_penalty=float(request.get("presence_penalty") or 0.0),
            frequency_penalty=float(request.get("frequency_penalty")
                                    or 0.0),
            logit_bias=request.get("logit_bias") or None,
            repetition_penalty=float(request.get("repetition_penalty")
                                     or 1.0),
            seed=(int(request["seed"]) if request.get("seed", -1) >= 0
                  else None),
        )
        try:
            if request.get("raw"):
                req = engine.submit_raw(request.get("prompt", ""), **kw)
            else:
                req = engine.submit(request["messages"], **kw)
        except RequestError as e:
            emit({"error": str(e), "status": 400, "done": True})
            return
        streaming = bool(request.get("stream"))
        want_lp = bool(request.get("logprobs"))
        lp_seen = 0  # tokens whose logprobs went out in earlier chunks
        parts: list[str] = []
        while True:
            delta, fin = req.out.get()
            if delta:
                if streaming:
                    chunk = {"delta": delta}
                    if want_lp:
                        # the tokens delivered since the last chunk (the
                        # engine appends before each push). token_top is
                        # appended after token_logprobs: clamp to the
                        # shorter list, or a row read between the two
                        # appends would misalign every later chunk
                        upto = len(req.token_logprobs)
                        if req.top_logprobs:
                            upto = min(upto, len(req.token_top))
                        chunk.update(_logprob_fields(engine, req, lp_seen,
                                                     upto))
                        lp_seen = upto
                    if not emit(chunk):
                        # client went away: free the slot, then drain
                        engine.cancel(req)
                        while fin is None:
                            _, fin = req.out.get()
                        return
                else:
                    parts.append(delta)
            if fin is None:
                continue
            if fin.startswith("error"):
                err = {"error": fin, "done": True}
                if "deadline" in fin:
                    err["status"] = 408
                emit(err)
                return
            if fin == "abort":
                emit({"error": "engine shut down", "status": 503,
                      "done": True})
                return
            final = {
                "delta": "" if streaming else "".join(parts),
                "done": True,
                "finish_reason": ("stop" if fin == "stop" else
                                  "deadline" if fin == "deadline"
                                  else "length"),
                "prompt_tokens": len(req.prompt_ids),
                "completion_tokens": req.completion_tokens,
            }
            if want_lp and req.token_logprobs:
                # per generated token: its string and log-prob under the
                # full softmax (the whole list, as the reference sends it)
                final.update(_logprob_fields(engine, req, 0,
                                             len(req.token_logprobs)))
            emit(final)
            return

    return handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gabby_tpu_torch.server")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--read-timeout-millis", type=int, default=60000)
    p.add_argument("--write-timeout-millis", type=int, default=600000)
    p.add_argument("--model-dir", default="",
                   help="checkpoint directory: HF layout (safetensors + "
                        "config.json + tokenizer.json), or one written by "
                        "gabby_tpu_torch.tools.quantize")
    p.add_argument("--preset", default="llama32_1b",
                   choices=["tiny", "llama32_1b", "llama32_3b", "llama3_8b",
                            "llama3_70b"])
    p.add_argument("--random-weights", action="store_true",
                   help="serve random weights made from seed 0")
    p.add_argument("--quant", type=int, default=0, choices=[0, 4, 8],
                   help="weight-only quantization bits (0 = bf16). With "
                        "--model-dir the unembed becomes int8 per channel; "
                        "with --random-weights, 4 also quantizes the "
                        "unembed to int4 with group-256 scales")
    p.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu for tests)")
    p.add_argument("--slots", type=int, default=8,
                   help="continuous-batching decode slots")
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--max-tokens", type=int, default=512,
                   help="default completion cap")
    p.add_argument("--steps-per-call", type=int, default=8)
    p.add_argument("--steps-per-call-busy", type=int, default=8,
                   help="decode steps per burst while a request prefills")
    p.add_argument("--model-id", default="")
    p.add_argument("--log-level", type=int, default=3,
                   help="front-end log level (0 off .. 4 debug)")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="rehearse the engine before /readyz reports ready")
    p.add_argument("--paged-pages", type=int, default=0,
                   help="> 0: paged KV cache with this many pool pages "
                        "(one of them the scratch page) instead of the "
                        "dense slots x max-seq cache")
    p.add_argument("--page-size", type=int, default=512,
                   help="rows per KV page (a multiple of 32 on the GPU)")
    p.add_argument("--speculate", type=int, default=0,
                   help="> 0: n-gram speculative decoding with this many "
                        "draft tokens per step (greedy requests only)")
    p.add_argument("--spec-breakeven", type=float, default=1.2,
                   help="tokens per verify step below which speculation "
                        "is switched off (the prior until the engine has "
                        "measured its own ratio)")
    p.add_argument("--spec-reprobe-steps", type=int, default=8192,
                   help="re-probe a disabled speculation after this many "
                        "plain decode steps (0 = stay off)")
    p.add_argument("--pair-kv", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="paired kv-head cache layout (dense and paged "
                        "caches; see EngineConfig.pair_kv_heads). Default: "
                        "auto, on when the kv-head count is even. "
                        "--no-pair-kv reverts")
    p.add_argument("--act-fp8", action="store_true",
                   help="pass activations through the fp8 (e4m3) grid with "
                        "per-token scales before every matmul (BASELINE "
                        "config 5; the products keep the weight path's "
                        "kernels)")
    p.add_argument("--prefill-int8-shadow", action="store_true",
                   help="prefill through an exact int8 shadow of int4 "
                        "weights (2x the int4 weight bytes on the card, "
                        "same numerics; short chunks take the stacked "
                        "int8 kernel; see EngineConfig.prefill_int8_shadow)")
    p.add_argument("--pipeline-fetch", action="store_true",
                   help="dispatch decode burst N+1 before reading burst "
                        "N's host view, which is copied to pinned memory "
                        "behind an event (host bookkeeping lags one burst; "
                        "off under --speculate and tensor parallelism; see "
                        "EngineConfig.pipeline_fetch)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: ranks 1..N-1 start as "
                        "processes of this command, one card each (all on "
                        "the CPU with --device cpu)")
    p.add_argument("--coordinator", default="",
                   help="multi-process: rank 0's host:port (start the same "
                        "command for every rank; rank 0 serves HTTP, the "
                        "rest follow its plan broadcasts)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="multi-process: the number of ranks (dp x tp)")
    p.add_argument("--process-id", type=int, default=-1,
                   help="multi-process: this rank")
    p.add_argument("--sync-timeout", type=float, default=60.0,
                   help="multi-process: seconds a plan broadcast or a "
                        "collective may block before the peer is declared "
                        "dead and in-flight requests fail (0 = wait "
                        "forever)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (decode slots shard over dp "
                        "replicas of the tp group, dp x tp processes; "
                        "requires --slots %% dp == 0)")
    p.add_argument("--sp-prefill-tokens", type=int, default=1024,
                   help="sequence-parallel prefill threshold: admission "
                        "chunks >= this many tokens shard their token axis "
                        "over the data-parallel replicas when --dp > 1 "
                        "(Ulysses-style; 0 disables)")
    p.add_argument("--sp-ring", action="store_true",
                   help="use ring attention for sequence-parallel prefill "
                        "instead of the K/V all-gather: per-replica chunk "
                        "K/V memory drops to O(T/dp) for prompts whose "
                        "gathered K/V would not fit")
    p.add_argument("--profiler-port", type=int, default=0,
                   help="serve torch.profiler captures of the engine thread "
                        "on this port (GET /capture?duration_ms=N answers "
                        "the gzipped Chrome trace; 0 = off); rank i of a "
                        "multi-process run serves this port + i")
    p.add_argument("--compile-cache", default="")
    return p


def main(argv: Optional[list[str]] = None,
         on_ready: Optional[Callable[[int], None]] = None,
         stop: Optional[threading.Event] = None) -> int:
    """Serve until SIGINT/SIGTERM, or until `stop` is set. Embedders may
    pass `on_ready`, called with the bound port once warm-up is done."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    from gabby_tpu_torch.parallel.multihost import HostSync

    if args.dp < 1:
        sys.exit(f"--dp {args.dp} must be >= 1")
    if args.slots % args.dp != 0:
        sys.exit(f"--slots {args.slots} must be divisible by --dp "
                 f"{args.dp} (slots shard over the data axis)")
    profiler = _start_profiler(args)
    group = sync = None
    followers: list = []
    try:
        if args.coordinator or args.tp > 1 or args.dp > 1:
            group, followers = _start_ranks(args, argv)
            sync = HostSync(group, timeout=args.sync_timeout or None)
        return _serve(args, group, sync, on_ready, stop, profiler)
    finally:
        _stop_followers(followers, 60)
        if profiler is not None:
            profiler.close()


def _start_profiler(args):
    """The capture endpoint of --profiler-port (None when 0), bound before
    anything else starts: rank i of a multi-process run binds the port plus
    i, since its ranks may share a host. A port that is taken exits."""
    if not args.profiler_port:
        return None
    from gabby_tpu_torch.runtime.profiler import ProfilerServer
    port = args.profiler_port + max(args.process_id, 0)
    try:
        return ProfilerServer(port)
    except OSError as e:
        sys.exit(f"--profiler-port: cannot serve captures on port {port}: "
                 f"{e.strerror or e}")


def _serve(args, group, sync, on_ready, stop, profiler=None) -> int:
    from gabby_tpu_torch.bridge import NativeServer

    engine, _ = _build_engine(args, group, sync)
    if profiler is not None:
        profiler.attach(engine)
    if sync is not None and not sync.is_leader:
        # no HTTP front door: the engine thread replays the leader's plans
        # until its shutdown plan arrives
        print(f"follower {sync.process_index}/{sync.num_processes} "
              "serving leader plans", flush=True)
        engine._thread.join()
        return 0
    server = NativeServer(
        make_handler(engine), port=args.port, workers=args.workers,
        model_id=args.model_id or (
            os.path.basename(os.path.normpath(args.model_dir))
            if args.model_dir else args.preset),
        read_timeout_millis=args.read_timeout_millis,
        write_timeout_millis=args.write_timeout_millis,
        log_level=args.log_level, stats_fn=engine.stats_snapshot)
    # warm-up is single-process only (Engine.warmup)
    do_warmup = args.warmup and sync is None
    if do_warmup:
        server.set_ready(False)
    port = server.start()
    print(f"listening on port {port}", flush=True)
    if do_warmup:
        secs = engine.warmup()
        server.set_ready(True)
        print(f"ready (warm-up {secs:.1f}s)", flush=True)
    elif args.warmup:
        print("warm-up skipped (multi-process)", flush=True)
    stop = stop or threading.Event()

    def on_signal(sig, frame):
        del sig, frame
        stop.set()

    try:
        signal.signal(signal.SIGINT, on_signal)
        signal.signal(signal.SIGTERM, on_signal)
    except ValueError:
        pass  # embedded off the main thread: the embedder sets `stop`
    if on_ready is not None:
        on_ready(port)
    while not stop.is_set():
        stop.wait(0.2)
    server.close()
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
