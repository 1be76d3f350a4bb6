#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gabby_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure is an uncaught exception and
a non-zero exit:
  1. card        the GPU's name and power limit (nvidia-smi);
  2. build       nvcc builds gabby_tpu_torch/csrc/*.cu (one process per
                 source, all started together);
  3. kernels     each kernel (K1-K41) at the serving path's shapes for
                 Llama-3.2-1B (8 slots, context 1024 in a 2048-row cache,
                 int8 for K3-K21, K34, K35, K38, K39, bf16 for K22-K32,
                 K36, K37, K40, K41; the no-fresh-row forms K34-K41 read
                 rows j <= 1024, K34 also at positions 0 to 2047 and
                 within a window of 512; prefill at T=512,
                 offset 512, K22 and K23 also at T=64 over 1024 rows (the
                 split key range); K7 at one 512-token chunk; the verify
                 kernels at a block of 8; the paged ones through a shuffled table
                 of 512-row pages; K1, K33, K5, K8, K2 and K6 also at M
                 = 64, the verify-sized products, and twice on the same
                 inputs, bit for bit; K1, K33, K5 and K8 also by
                 projection)
                 against its
                 plain PyTorch version on the same inputs (the attention
                 kernels within 2e-2 relative plus a share of the plain
                 row's RMS, 5e-2 for the bf16/f32 forms and 1e-2 for the
                 s8 forms; K8 by equality, on its output and its
                 int32 accumulator; a paired kernel also
                 against the unpaired one on the same rows re-laid, by
                 equality where the body is the same; an s8 kernel also
                 against the dequantized contract at 6e-2, and further
                 than its own tolerance from the bf16/f32 kernel and from
                 the s8 form at half the chunk size, so that the tolerance
                 tells those apart; K33 also against K1 at 4e-2; the
                 single-position kernels of decode_attention.cuh by
                 equality against their unpaired dense forms (K12 and
                 K16 against K3, K24 against K32, K25 against K24, K17
                 against K10, K29 against K28; the s8 forms K15 against
                 K14, K20 against K19, and K19 against K14 on the same
                 rows at a quantization chunk a page; the no-fresh-row
                 forms K34 and K36 against themselves on one layer's
                 cache alone, K35 against K34, K37 against K36, K38 and
                 K40 against K34 and K36 on the pool's rows gathered,
                 K39 against K38, K41 against K40; the verify forms
                 K13 against K9, K11 against K9 and K30 against K26 on
                 the pool's rows gathered, K18 against K11, K27 against
                 K26, K31 against K30) and twice on the same inputs, bit
                 for bit; K3 also at unequal positions,
                 16 to 2000 rows), timed with
                 CUDA events, eagerly and replayed from a CUDA graph (the
                 device's share of the eager time), beside the plain
                 version, one PyTorch library
                 call computing the same function (yardstick only; the
                 attention rows time it eagerly and from a graph), and the
                 least time the card could take (bytes at 3.35 TB/s or
                 operations at the tensor-core peak of the operand type,
                 whichever is larger; every library call also from a
                 graph); then one case per attention source
                 at Llama-3.2-3B's heads (24 q heads over 8 kv heads of
                 128 dims, 28 layers: K3, K16, K34, K32, K36, K13, K17,
                 K15, K20, K21, and K27, K22 and K23 over a bf16 cache;
                 K17 by equality against
                 K12 on the same rows, K20 against K15 at a chunk a page,
                 K27 against K26, K23 against K22)
                 and K1 at
                 its four projections x 28 layers, the same way, on lines
                 of their own; then K42, the decode layer's attention
                 prologue, at SmolLM2-1.7B's and Mistral-7B's heads (64
                 slots, one layer of a 4096-row paired int8 cache)
                 against the eager chain it replaces by equality, timed
                 the same way, and one decode step at those widths (2
                 layers) through K42 and through the eager chain: equal
                 logits, its top-level aten ops and host ms (`"phase":
                 "prologue"` lines);
  4. model       the 1B model's prefill + decode on the card (kernels)
                 against the same functions on the CPU (plain versions),
                 same weights (unpaired cache, bf16/f32 decode attention):
                 for the int4 tree, the loaded int8 tree, and the loaded
                 int4 tree with both int4 switches on; and, on the card
                 alone, one `verify_step`
                 over [t0, d1 .. d7] against the eight sequential
                 `decode_step`s the drafts came from, on the dense and on
                 the paged cache, and the paged `decode_step` against the
                 dense one; the same four on the paired caches against the
                 unpaired ones, and the paired decode paths with the s8
                 form on against off; and the int4 tree with the
                 raw-byte-dot switch on (K33 in place of K1);
  5. engine      Engine(batch_slots=8, max_seq=2048, int8 KV) serving 10
                 concurrent chat requests whose prompts hit every prefill
                 bucket and three multi-chunk ones, 32 new tokens each,
                 on the unpaired cache with the bf16/f32 form; K1-K4 must
                 all launch during this run. Then the reference server's
                 default configuration (`pair_kv_heads=True`, s8 on) on
                 the same ten requests, dense (K15, K21) and with
                 `paged_pages=33, page_size=512` (K20; its ten prompts
                 all admit in bursts), then the admission phase in that
                 configuration (below), the dense one
                 again with `set_int4_rawdot(True)` on three requests
                 (K33 and K2 must launch, K1 must not; every other int4
                 run must not launch K33), and eleven runs of
                 three requests (a 64 bucket, a 256 bucket, 512 + 256) that
                 give every other attention kernel a path of its own:
                 unpaired with `speculate_tokens=7` dense (K9), paged
                 (K11), paged without speculation (K10); paired with
                 speculation dense (K13) and paged (K18); paired with s8
                 off dense (K12) and paged (K17); unpaired with s8 on dense
                 (K14) and paged (K19); unpaired with `attn_multi` on
                 and the s8 switch left on (K16: the slot-batched launch is
                 taken first, as in the reference). Speculation is kept on
                 (`spec_auto_breakeven=False, spec_breakeven=1.0`) and its
                 tokens per verify step are printed. Then the reference
                 server's literal defaults: the bf16 weights on a bf16
                 paired cache, held card against CPU, then the ten
                 requests (K23, K25), and nine runs of three requests for
                 every other bf16-cache kernel (unpaired K22, K24;
                 speculation K26, K27; 33 pages of 512 K28, K29; both
                 K30, K31; slot-batched K32). Then `int4_3b`:
                 Llama-3.2-3B at full width and depth, int4 weights,
                 paired int8 cache, s8 (K1, K2, K15, K21), three requests,
                 and the card against the CPU on 2 of its 28 layers (int8
                 and bf16 paired caches). In every run an attention kernel
                 that is not the run's own must not launch;
     admission   burst admission and prefix reuse on the same weights
                 and configuration, dense and over 33 pages of 512: at the
                 model level `prefill_batch_chunk` for six prompts of
                 530-570 tokens against `prefill_slot` of each alone, and
                 a 700-token prompt's rows copied (`copy_slot_prefix`) or
                 its first page adopted, then a suffix prefill, against a
                 cold prefill, each within 0.05 of the largest logit with
                 the first greedy token equal; the burst's launches (K2,
                 not K1, no attention kernel) and the suffix's (K21);
                 then the engine: the six prompts submitted together (at
                 least 2 burst admissions), the 700-token prompt, then
                 three with its prefix and 40-token suffixes (3 prefix
                 hits reusing 3 x 688 tokens dense, 3 x 512 paged; the
                 pool's pages add up), TTFT p50 and wall printed, and how
                 many burst streams equal the same prompts served alone;
     features    penalties and logit_bias, logprobs and top_logprobs, and
                 the per-request seed on the same weights and
                 configuration (dense): apply_penalties, penalize_row,
                 token_logprob, top_candidates and the seeded draw on the
                 card's own decode logits against the CPU's (1e-5
                 relative, top ids equal but at exact ties, seeded tokens
                 equal); a {t: 100} logit_bias emits t only; a greedy
                 penalized request beside 7 plain ones equals its replay
                 through `decode_loop` one step at a time on the same
                 slot with the same PenaltyState (near-ties within
                 TIE_BAND, counted), K1 64, K2 1 and K15 16 launches a
                 replayed step with the features on and off; top_logprobs
                 1, 5 and 20 give k sorted rows headed by the token, the
                 first included, on the plain loop and with speculation
                 7; a seeded request gives the same tokens alone and
                 beside 7 unseeded neighbours (single admission both
                 times), three seeds at least two streams; then the ten
                 chat requests with and without a penalized and a
                 top_logprobs 5 request, in turns (without, with, with,
                 without), ms a decode step printed;
     options     the reference's three single-card runtime options on
                 the same weights and configuration: fp8 activations
                 (the grid pass on the card's own [8, 2048] and [8, 8192]
                 bf16 decode activations equal to the CPU's bit for bit;
                 2 of the 16 layers card against CPU, fp8 off within
                 0.05 and on within 0.10, fp8's own effect printed; K1 64,
                 K2 1 and K15 16 launches a decode step with fp8 on and
                 off, ms a step; the ten chat requests off, on, on, off);
                 the int8 prefill shadow (its bytes against the codes; a
                 64-token chunk through the engine's single admission
                 launches K5 and no K1, a 512-token one neither K1 nor
                 K7, decode still K1 64 a step and no K5; the chunks'
                 logits through the shadow within 0.05 of the int4
                 path's, first token equal; ms a 64- and a 512-token
                 chunk through the int4 path, the shadow and K7); and
                 dispatch-ahead fetches (the ten chat requests, dense and
                 over 33 pages of 512, synchronous, pipelined, pipelined,
                 synchronous, on a stopped engine driven an iteration at
                 a time: every stream equal; ms a decode step, TTFT p50);
     switches    the reference's kernel switches on the same weights and
                 the default cache (`switches_phase`): with the kernels
                 off (GABBY_KERNELS=0) a prefill + 4 decode steps and
                 three requests launch no kernel, within 0.05 of the
                 kernels-on steps, their greedy tokens printed beside the
                 kernels-on run's; with GABBY_PREFILL_PAIR=0 a paired
                 prefill leaves K21 at 0 while K1, K2 and K15 count;
  6. checkpoint  the same seed-0 weights written as an HF-layout directory
                 (bf16 safetensors, config.json, generation_config.json,
                 the BPE tokenizer of tests/fixtures) into a temporary
                 directory; `python -m gabby_tpu_torch.tools.quantize`
                 turns it into an int8 and an int4 `gabby-quant` directory
                 (two processes side by side);
                 the HF directory is deleted;
  7. engine      the int8 directory through load_model_dir ->
                 fuse_projections -> the same engine and the same ten
                 prompt lengths: K5, K6, K3, K4 must launch; then three
                 requests (one with a 512-token chunk) from the int4
                 directory with `w4a8` and `int4_prefill_kernel` on: K7, K8
                 and K6 must launch;
  8. http        `python -m gabby_tpu_torch.server` four times side by
                 side, each in its own process: once on the literal
                 default command line (`--preset llama32_1b
                 --random-weights`: bf16 weights, bf16 paired cache), once
                 with random int4 weights and `--kv-quant` (paired cache,
                 s8; and `--act-fp8 --prefill-int8-shadow
                 --pipeline-fetch`), once with `--model-dir <int8
                 directory> --kv-quant
                 --no-pair-kv` and GABBY_ATTN_S8=0, and once with random
                 int4 weights, `--kv-quant --speculate 7 --paged-pages
                 33`, one chat completion each through the
                 C++ front-end (the random int4 one also a completion with
                 logprobs, top_logprobs 3 and a seed, as many logprob
                 entries as completion tokens), then SIGTERM, where cmake
                 exists to build it (else a skip line saying why);
     nofresh     K34-K41's path: a decode step of 16 layers at the 1B
                 heads over 8 slots of 2048-row int8 and bf16 caches
                 (positions 0 to 2047) through the reference's public
                 decode ops without fresh rows: each layer writes the
                 token's row, then `cache_attention_quantized` /
                 `cache_attention` (stacked, one layer, paired) and
                 `paged_decode_attention(..., fresh_k=None)` over 33
                 pages of 512, paired or not; the launches counted (each
                 form's kernel, no other attention kernel), then the
                 forms' bits against the stacked unpaired dense form and
                 each dense form within the attention tolerance of the
                 fresh-row kernel (K3, K24) on the same rows;
     profiler    `python -m gabby_tpu_torch.server --profiler-port P` on
                 the int4 1B model in the server's default configuration
                 (8 slots): the ten chat requests, then again with one
                 capture of 1000 ms posted with them; the gzipped trace's
                 `aten::` ops on one thread (the engine's), its kernel
                 events naming K1, K2 and K15, and the ten completions
                 equal to those without the capture;
     profile_decode
                 `python -m gabby_tpu_torch.tools.profile_decode --config
                 int4_1b`: its table on earlier lines, then the device's
                 total against the wall of its 3 traced calls;
  9. tensor-parallel
                 the 1B int4 model at full width and depth (seed 0) in
                 the server's default configuration apart from pairing
                 (unpaired int8 cache, s8; 8 slots, max_seq 2048) over two
                 ranks: (a) K1 at one rank's four projections at tp = 2
                 and tp = 4 and K2 at a tp = 2 rank's vocab shard, each
                 against its plain version with the kernels phase's
                 tolerance (kernel-only, this process); then two rank
                 processes on the one card (spawned; gloo, as the
                 backend rule picks for ranks that share a card) that
                 must hold (b) a 64-token prefill and 16 decode steps fed
                 the tp = 1 greedy tokens within ADMIT_TOL of the tp = 1
                 logits on the card, both ranks bit for bit equal; (c)
                 rank 0's engine serving the ten chat requests, the
                 follower replaying its plans, dense and over 33 pages of
                 512: identical token streams on both ranks; (d) K1 64,
                 K2 1 and K14 16 (K19 16 paged) launches and 34
                 all-reduces a decode step on each rank, and K1 64, K2 1,
                 K14 16 and no all-reduce at tp = 1; (e) ms a decode step
                 and the ten-request wall at tp = 2 against tp = 1, beside
                 the card's name and power limit (two ranks share one
                 card here: no speed on two cards is measured);
 10. data-parallel
                 the same model and configuration over two replicas (dp =
                 2, tp = 1; 4 slots each): (a) K1 at one replica's lanes
                 (M = 4) and K14 over its 4 slots at context 1024, each
                 against its plain version with the kernels phase's
                 tolerance (kernel-only, this process); then two replica
                 processes on the one card (spawned, gloo) that must hold
                 (b) K1 64, K2 1 and K14 16 (K19 16 paged) launches a
                 decode step over a replica's 4 slots, and one dp gather
                 a decode burst in the engine runs; (c) rank 0's engine
                 serving the ten chat requests, the other replica
                 replaying its plans, dense and over 33 pages of 512:
                 identical records on both ranks, every kernel of the path
                 launched on both, the streams compared with the
                 tensor-parallel phase's single-process ones and the first
                 diverging one walked (a `"diagnosis"` line: near-tie or
                 not); (d) a 1024-token prompt in 512-token chunks into
                 replica 1's slot 5 by sequence-parallel prefill, all-gather
                 and ring, against the single-rank prefill_slot: the
                 final logits within ADMIT_TOL of the largest and equal on
                 both ranks, the owner's rows within ADMIT_TOL, and each
                 route's peak bytes printed; (e) ms a decode step and the
                 ten-request wall at dp = 2 against dp = 1 (two replicas
                 share one card here: no speed on two cards is measured);
 11. summary     the kernels line (forty-one kernels; K1, K33, K5, K8 and
                 K2 on two rows each, M = 8 and 64, K34 on three), then
                 {"ok": true, "device": {...}} last.

Weights are random (Llama-3.2-1B at full width and depth, seed 0). The
first engine run serves them as int4 weights fused into wqkv/w_gup with
the int4 group-256 unembed and keeps its ten requests; the second and
third serve them from the checkpoints, whose unembed is int8 per channel.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
INT8_OP_PER_S = 1979e12     # dense int8 tensor-core peak, same source
TOL = dict(rtol=2e-2, atol=2e-2)  # the matmuls: bf16 outputs of O(1) values
# The attention kernels: at the serving shapes a row of the output has an
# RMS near 0.05, so the absolute part is a share of the plain row's RMS.
# bf16/f32 forms: each side rounds to bf16 (2^-7 relative a step) and the
# plain version rounds the dequantized rows to bf16 first (f32 differences
# near 0.003 of the RMS). s8 forms: integer products are exact on both
# sides, so what is left is a bf16 step where the f32 sums differ in order,
# or one probability code (1/127 of its chunk's largest) on a rounding
# boundary. The s8 form lies 0.1-0.3 of the RMS from the bf16/f32 form and
# from itself at another chunk size, which `apart` holds it to.
ATTN_TOL = dict(rtol=2e-2, atol_rms=5e-2)
S8_TOL = dict(rtol=2e-2, atol_rms=1e-2)
S8_CONTRACT_TOL = dict(rtol=6e-2, atol=6e-2)  # s8 form vs dequantized form


def emit(obj) -> None:
    # one write per line: the http phase emits from three threads
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def time_ms(fn, iters: int = 10) -> float:
    """Mean ms per call of fn over `iters` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Mean ms per replay of fn's launches captured once in a CUDA graph:
    their time on the device alone, where `time_ms` of the eager calls
    also holds whatever the host needs to enqueue them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def beyond(out, ref, tol):
    """Elements of `out` further from `ref` than `tol` allows: rtol * |ref|
    plus atol, or plus atol_rms times the RMS of ref's row (last axis)."""
    atol = tol.get("atol", 0.0)
    if "atol_rms" in tol:
        atol = atol + tol["atol_rms"] * ref.pow(2).mean(-1, keepdim=True).sqrt()
    return (out - ref).abs() > atol + tol["rtol"] * ref.abs()


def check(name: str, outs, refs, tol=TOL) -> float:
    """Max |kernel - plain| over pairs; raises beyond `tol`."""
    err = 0.0
    for out, ref in zip(outs, refs):
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        bad = beyond(out, ref, tol)
        if bad.any():
            worst = (out - ref).abs()[bad].max().item()
            raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} "
                                 f"elements beyond {tol}, the worst by "
                                 f"{worst}")
        err = max(err, (out - ref).abs().max().item())
    return err


def check_apart(name: str, outs, others, tol) -> float:
    """The opposite of `check`: every pair must hold elements beyond `tol`,
    so that `tol` would tell the two functions apart. Returns the largest
    difference."""
    far = 0.0
    for out, other in zip(outs, others):
        out, other = out.float(), other.float()
        if not beyond(out, other, tol).any():
            raise AssertionError(f"{name}: within {tol}, which therefore "
                                 f"cannot tell them apart")
        far = max(far, (out - other).abs().max().item())
    return far


def bound(nbytes: float, ops: float,
          peak: float = BF16_FLOP_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_ops
            else dict(bound_ms=t_ops, bound_by="operations"))


@contextlib.contextmanager
def attn_chunk(rows: int):
    """GABBY_ATTN_CHUNK set to `rows` for the calls made inside."""
    old = os.environ.get("GABBY_ATTN_CHUNK")
    os.environ["GABBY_ATTN_CHUNK"] = str(rows)
    try:
        yield
    finally:
        if old is None:
            del os.environ["GABBY_ATTN_CHUNK"]
        else:
            os.environ["GABBY_ATTN_CHUNK"] = old


def library_graph(library, nl: int, iters: int) -> dict:
    """The library call's `nl` launches replayed from a CUDA graph, so that
    a kernel's graph time has a graph time beside it; where the call
    cannot be captured, None and the reason."""
    try:
        return dict(library_graph_ms=graph_ms(
            lambda: [library(i) for i in range(nl)], iters))
    except RuntimeError as e:  # a capture the library call refuses
        torch.cuda.synchronize()
        return dict(library_graph_ms=None,
                    library_graph_error=str(e).splitlines()[0])


def attn_case_into(results, nl, name, shapes, source, replaces, kernel, plain,
                   library, nbytes, ops, *, iters=10, peak=BF16_FLOP_PER_S,
                   equal=None, close=None, contract=None, tol=ATTN_TOL,
                   apart=(), case=None, repeat=False):
    """One attention kernel's `nl` launches (one per layer; kernel, plain
    and library take the layer) against its plain version, timed
    beside it and beside the library call, eagerly (`ms`, what the
    engine pays today) and replayed from a CUDA graph (`graph_ms`, the
    device's share; the library call's as `library_graph_ms`); the result
    is appended to `results`. `equal`: another
    kernel whose outputs must be the same bit for bit (the same body on
    the same rows, re-laid or read through a table, under the same launch
    plan); `close`: one held to `tol`; `contract`: the
    dequantized form, held to S8_CONTRACT_TOL; `apart`: (what, function)
    pairs of other forms of the same attention, from each of which the
    kernel must lie further than `tol` in every layer; `case`: a second
    timing of a kernel at other shapes, listed under its name with the
    case beside it; `repeat`: every layer's call made again must give the
    same bits."""
    outs = [kernel(i) for i in range(nl)]
    err = check(name, outs, [plain(i) for i in range(nl)], tol)
    if repeat and not all(torch.equal(o, kernel(i))
                          for i, o in enumerate(outs)):
        raise AssertionError(f"{name}: a repeat on the same inputs differs")
    far = {what: check_apart(f"{name} and {what}", outs,
                             [other(i) for i in range(nl)], tol)
           for what, other in apart}
    if equal is not None and not all(
            torch.equal(o, equal(i)) for i, o in enumerate(outs)):
        raise AssertionError(f"{name}: differs from the same kernel on "
                             f"the same rows")
    if close is not None:
        check(name + " vs the unpaired kernel", outs,
              [close(i) for i in range(nl)], tol)
    if contract is not None:
        check(name + " vs the dequantized contract", outs,
              [contract(i) for i in range(nl)], S8_CONTRACT_TOL)
    del outs
    results.append(dict(
        name=name if case is None else f"{name} ({case})", counter=name,
        shapes=shapes, route="cuda", source=source,
        replaces=replaces, max_abs_err=err, tol=tol, apart=far,
        ms=time_ms(lambda: [kernel(i) for i in range(nl)], iters),
        graph_ms=graph_ms(lambda: [kernel(i) for i in range(nl)], iters),
        plain_ms=time_ms(lambda: [plain(i) for i in range(nl)], 3),
        library_ms=time_ms(lambda: [library(i) for i in range(nl)],
                           iters),
        **library_graph(library, nl, iters), **bound(nbytes, ops, peak)))


def stacked_case_into(results, g, nl, projs, name, source, replaces, kernel,
                      plain, *, bits, m, what, iters=10, exact=None,
                      peak=BF16_FLOP_PER_S, default=None, close=None,
                      by_projection=False, repeat=False, case=None,
                      equal=False):
    """One call set of a stacked-weight kernel: the projections `projs` (K,
    N) x `nl` layers at M = m, random codes from `g`, against its plain
    version, timed, with the dequantized bf16 `torch.matmul` as the library
    yardstick; the result is appended to `results`. `exact` names a keyword
    that makes kernel and plain version also return an integer tensor that
    must be equal. `default`: the port's own path for the same products
    when the kernel is switched off, timed as `default_path_ms`. With
    `by_projection` (or `default`) the kernel's and the library's graph
    times are also given by projection. `close`: (what, kernel, tol),
    another kernel that must agree with this one within tol on the same
    inputs. `repeat`: every call made twice must give the same bits. `case`:
    the name's suffix for a second call set of a kernel (its counter keeps
    the name). `equal`: the outputs must equal the plain version's bit for
    bit."""
    dev = g.device
    rows = 2 if bits == 4 else 1  # weight rows per packed byte row

    def rand_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    mats = []
    for k, n in projs:
        mats.append((rand_bytes(nl, k // rows, n),
                     torch.rand((nl, n), generator=g, device=dev)
                     * (0.02 if bits == 4 else 0.002),
                     torch.randn((m, k), generator=g,
                                 device=dev).bfloat16()))
    calls = [(x, q, sc, layer) for layer in range(nl)
             for q, sc, x in mats]
    if exact:
        outs, accs = zip(*[kernel(*c, **{exact: True}) for c in calls])
        refs, ref_accs = zip(*[plain(*c, **{exact: True})
                               for c in calls])
        for acc, ref_acc in zip(accs, ref_accs):
            if not torch.equal(acc, ref_acc):
                raise AssertionError(f"{name}: integer accumulators "
                                     f"differ")
        del accs, ref_accs
    else:
        outs = [kernel(*c) for c in calls]
        refs = [plain(*c) for c in calls]
    err = check(name, outs, refs)
    extra = {}
    if equal:
        if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
            raise AssertionError(f"{name}: outputs differ from the plain "
                                 f"version's bits")
        extra["plain_equal"] = True
    if repeat:
        if not all(torch.equal(o, kernel(*c)) for o, c in zip(outs, calls)):
            raise AssertionError(f"{name}: a repeat on the same inputs "
                                 f"differs")
        extra["repeat_equal"] = True
    if close is not None:
        other, fn, tol = close
        extra[f"max_abs_err_vs_{other}"] = check(
            f"{name} vs {other}", outs, [fn(*c) for c in calls], tol)
    del outs, refs
    from gabby_tpu_torch.ops.quant import unpack_int4
    dense = [(q if bits == 8 else torch.stack(
        [unpack_int4(q[i]) for i in range(nl)])).bfloat16()
        * sc[:, None, :].bfloat16() for q, sc, _ in mats]
    if default is not None:
        extra["default_path_ms"] = time_ms(
            lambda: [default(*c) for c in calls], iters)
    if default is not None or by_projection:
        extra["by_projection_graph_ms"] = {
            f"{k}x{n}": [graph_ms(lambda: [kernel(x, q, sc, layer)
                                           for layer in range(nl)],
                                  iters),
                         graph_ms(lambda: [torch.matmul(x, w[layer])
                                           for layer in range(nl)],
                                  iters)]
            for (k, n), (q, sc, x), w in zip(projs, mats, dense)}
    nbytes = sum(nl * (q[0].numel() + sc[0].numel() * 4 + x.numel() * 2
                       + m * q.shape[2] * 2) for q, sc, x in mats)
    ops = sum(nl * 2 * m * x.shape[1] * q.shape[2] for q, sc, x in mats)

    def library():
        return [torch.matmul(x, w[layer]) for layer in range(nl)
                for w, (_, _, x) in zip(dense, mats)]

    results.append(dict(
        name=name if case is None else f"{name} ({case})", counter=name,
        shapes=f"{what}: wqkv, wo, w_gup, w_down x {nl} layers, M={m}",
        route="cuda", source=source, replaces=replaces, max_abs_err=err,
        ms=time_ms(lambda: [kernel(*c) for c in calls], iters),
        graph_ms=graph_ms(lambda: [kernel(*c) for c in calls], iters),
        plain_ms=time_ms(lambda: [plain(*c) for c in calls], 3),
        library_ms=time_ms(library, iters),
        library_graph_ms=graph_ms(library, iters),
        **extra, **bound(nbytes, ops, peak)))


def projections(cfg) -> list:
    """The four projections of a layer, (K, N): wqkv, wo, w_gup, w_down."""
    d = cfg.hidden_size
    return [(d, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, d),
            (d, 2 * cfg.intermediate_size), (cfg.intermediate_size, d)]


def kernel_phase(cfg, dev):
    """K1-K41 at the 1B serving shapes against their plain versions."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.ops.attention import gather_layer, gather_pages
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    from gabby_tpu_torch.ops.quant import unpack_int4
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

    g = torch.Generator(device=dev).manual_seed(1)
    nl, d, b = cfg.num_layers, cfg.hidden_size, 8
    nq, nk, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    results = []

    def rand_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    projs = projections(cfg)

    def stacked_case(*args, **kw):
        stacked_case_into(results, g, nl, projs, *args, **kw)

    def attn_case(*args, **kw):
        attn_case_into(results, nl, *args, **kw)

    pa = "gabby_tpu/ops/pallas/attention.py"
    csrc = "gabby_tpu_torch/csrc/"
    qm = "gabby_tpu/ops/pallas/quant_matmul.py"
    # K1: one decode step's 64 launches (4 projections x 16 layers), M = 8,
    # then a verify macro-step's (8 slots x 8 rows: M = 64); each call
    # twice, bit for bit (K split over a cluster, summed in rank order)
    k1 = "gabby_tpu_torch/csrc/quant_matmul_stacked.cu"
    for m, what in ((b, "one decode step"), (64, "one verify macro-step")):
        stacked_case("int4_matmul_stacked", k1, qm + ":424",
                     cqm.qmatmul_int4_stacked, cqm.int4_stacked_plain,
                     bits=4, m=m, what=what, by_projection=True, repeat=True,
                     case=None if m == b else f"M={m}")
    # K33: K1's call sets through the raw-byte-dot form, also against K1 on
    # the same inputs within the two forms' distance (one bf16 rounding of
    # x_even - x_odd / 16; tests/test_pallas_kernels.py:371 holds the TPU
    # kernels to 4e-2)
    for m, what in ((b, "one decode step"), (64, "one verify macro-step")):
        stacked_case("int4_matmul_stacked_rawdot", k1, qm + ":455",
                     cqm.qmatmul_int4_stacked_rawdot,
                     cqm.int4_stacked_rawdot_plain, bits=4, m=m, what=what,
                     by_projection=True, repeat=True,
                     case=None if m == b else f"M={m}",
                     close=("int4_matmul_stacked", cqm.qmatmul_int4_stacked,
                            dict(rtol=4e-2, atol=4e-2)))
    # K5: the same call sets on int8 stacks (M = 64: the int8 directory's
    # 64-token prefill bucket), each call twice, bit for bit (K split over
    # a cluster, summed in rank order)
    for m, what in ((b, "one decode step"), (64, "a 64-token prefill "
                                                "chunk")):
        stacked_case("int8_matmul_stacked",
                     csrc + "quant_matmul_int8_stacked.cu", qm + ":504",
                     cqm.qmatmul_int8_stacked, cqm.int8_stacked_plain,
                     bits=8, m=m, what=what, by_projection=True,
                     repeat=True, case=None if m == b else f"M={m}")
    # K7: one 512-token prefill chunk's 64 launches; beside it the port's
    # default for the same products (`qlinear` with the switch off: unpack
    # the layer, then torch.matmul)
    def qlinear_default(x, q, sc, layer):
        ck.set_int4_prefill_kernel(False)
        try:
            return quant.qlinear(x, quant.QTensor(q=q, scale=sc, bits=4,
                                                  group=0), layer)
        finally:
            ck.set_int4_prefill_kernel(None)

    stacked_case("int4_matmul",
                 "gabby_tpu_torch/csrc/quant_matmul_prefill.cu", qm + ":321",
                 cqm.qmatmul_int4, cqm.int4_plain, bits=4, m=512,
                 what="one 512-token prefill chunk", iters=3,
                 default=qlinear_default)
    # K7's repeat: the same call twice, bit for bit (one fixed order of sums)
    x7 = torch.randn((512, 8192), generator=g, device=dev).bfloat16()
    w7 = rand_bytes(2, 4096, 2048)
    s7 = torch.rand((2, 2048), generator=g, device=dev) * 0.02
    if not torch.equal(cqm.qmatmul_int4(x7, w7, s7, 1),
                       cqm.qmatmul_int4(x7, w7, s7, 1)) or not torch.equal(
            cqm.qmatmul_int4(x7, w7, s7, 1),
            cqm.qmatmul_int4(x7, w7[1].contiguous(), s7[1].contiguous())):
        raise AssertionError("int4_matmul: a repeat or the 2-D launch "
                             "differs from the stacked one")
    del x7, w7, s7
    # K8: K1's call sets with x quantized to int8 inside the launch and
    # integer products (M = 64: a W4A8 verify macro-step); the int32
    # accumulator and the output equal the plain version's bit for bit,
    # and a repeat's; the int8 tensor-core rate is the operations peak of
    # its operand type
    for m, what in ((b, "one decode step"), (64, "one verify macro-step")):
        stacked_case("int4_matmul_w4a8_stacked",
                     csrc + "quant_matmul_w4a8.cu", qm + ":766",
                     cqm.qmatmul_int4_w4a8_stacked,
                     cqm.int4_w4a8_stacked_plain, bits=4, m=m, what=what,
                     exact="return_acc", equal=True, repeat=True,
                     by_projection=True, peak=INT8_OP_PER_S,
                     case=None if m == b else f"M={m}")

    # K2: the int4 unembed, one launch per decode step (M = 8) and per
    # speculative verify step of 8 slots x 8 rows (M = 64); then the same
    # call twice, bit for bit (one fixed order of sums, no atomics)
    kp, vpad, group = d // 2, 129024, 256
    up = rand_bytes(kp, vpad)
    us = torch.rand((d // group, vpad), generator=g, device=dev) * 0.02
    uw = (unpack_int4(up).float()
          * torch.repeat_interleave(us, group, dim=0)).bfloat16()
    for m in (b, 64):
        ux = torch.randn((m, d), generator=g, device=dev).bfloat16()
        err = check("int4_matmul_grouped",
                    [cqm.qmatmul_int4_grouped(ux, up, us, group)],
                    [cqm.int4_grouped_plain(ux, up, us, group)])
        if not torch.equal(cqm.qmatmul_int4_grouped(ux, up, us, group),
                           cqm.qmatmul_int4_grouped(ux, up, us, group)):
            raise AssertionError(f"int4_matmul_grouped: a repeat at M = {m} "
                                 f"differs")
        nbytes = up.numel() + us.numel() * 4 + ux.numel() * 2 + m * vpad * 2
        results.append(dict(
            name="int4_matmul_grouped" + ("" if m == b else f" (M={m})"),
            counter="int4_matmul_grouped", shapes="unembed [2048 -> "
            f"129024], group 256, M={m}", route="cuda",
            source="gabby_tpu_torch/csrc/quant_matmul_unembed.cu",
            replaces="gabby_tpu/ops/pallas/quant_matmul.py:640",
            max_abs_err=err,
            ms=time_ms(lambda: cqm.qmatmul_int4_grouped(ux, up, us, group)),
            graph_ms=graph_ms(lambda: cqm.qmatmul_int4_grouped(ux, up, us,
                                                               group)),
            plain_ms=time_ms(lambda: cqm.int4_grouped_plain(ux, up, us,
                                                            group), 3),
            library_ms=time_ms(lambda: torch.matmul(ux, uw)),
            library_graph_ms=graph_ms(lambda: torch.matmul(ux, uw)),
            **bound(nbytes, 2 * m * d * vpad)))
    del up, us, uw
    ux = torch.randn((b, d), generator=g, device=dev).bfloat16()

    # K6: the int8 unembed of a loaded checkpoint (vocab not padded), one
    # launch per decode step (M = 8) and per verify macro-step of 8 slots x
    # 8 rows (M = 64); then the same call twice, bit for bit (K2's machine:
    # one fixed order of sums, no atomics)
    v = cfg.vocab_size
    uc = rand_bytes(d, v)
    us = torch.rand((v,), generator=g, device=dev) * 0.002
    uw = uc.bfloat16() * us.bfloat16()
    for m in (b, 64):
        ux = torch.randn((m, d), generator=g, device=dev).bfloat16()
        got = cqm.qmatmul_int8(ux, uc, us)
        err = check("int8_matmul", [got], [cqm.int8_plain(ux, uc, us)])
        if not torch.equal(got, cqm.qmatmul_int8(ux, uc, us)):
            raise AssertionError("int8_matmul: a repeat on the same inputs "
                                 "differs")
        nbytes = uc.numel() + us.numel() * 4 + ux.numel() * 2 + m * v * 2
        results.append(dict(
            name="int8_matmul" + ("" if m == b else f" (M={m})"),
            counter="int8_matmul",
            shapes=f"unembed [2048 -> 128256], M={m}", route="cuda",
            source="gabby_tpu_torch/csrc/quant_matmul_int8_unembed.cu",
            replaces=qm + ":287", max_abs_err=err,
            ms=time_ms(lambda: cqm.qmatmul_int8(ux, uc, us)),
            graph_ms=graph_ms(lambda: cqm.qmatmul_int8(ux, uc, us)),
            plain_ms=time_ms(lambda: cqm.int8_plain(ux, uc, us), 3),
            library_ms=time_ms(lambda: torch.matmul(ux, uw)),
            library_graph_ms=graph_ms(lambda: torch.matmul(ux, uw)),
            **bound(nbytes, 2 * m * d * v)))
    del uc, us, uw

    # the int8 cache of one 2048-row engine: [16, 8, 8, 2048, 64]
    s = 2048
    kc, ks = quantize_kv(torch.randn((nl, b, nk, s, h), generator=g,
                                     device=dev))
    vc, vs = quantize_kv(torch.randn((nl, b, nk, s, h), generator=g,
                                     device=dev))

    # K3: one decode step's 16 launches at context 1024 on all 8 slots
    ctx = 1024
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, nq, h), generator=g, device=dev).bfloat16()
    fk = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    fv = torch.randn((b, nk, h), generator=g, device=dev).bfloat16()
    kw = dict(fresh_k=fk, fresh_v=fv)
    kd = [torch.cat([(kc[i, :, :, :ctx].float() * ks[i, :, :, :ctx, None])
                     .bfloat16(), fk[:, :, None]], dim=2) for i in range(nl)]
    vd = [torch.cat([(vc[i, :, :, :ctx].float() * vs[i, :, :, :ctx, None])
                     .bfloat16(), fv[:, :, None]], dim=2) for i in range(nl)]
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes_decode = nl * (2 * b * nk * ctx * (h + 4) + 2 * b * nq * h * 2
                          + 2 * b * nk * h * 2)
    flops = nl * 4 * b * nq * (ctx + 1) * h

    # the same cache with adjacent kv heads side by side: [16, 8, 4, 2048,
    # 128]; scales stay per head
    kcp, vcp = pair_heads(kc), pair_heads(vc)
    pf = "gabby_tpu/ops/pallas/prefill_attention.py:142"
    dense_shapes = ("16 layers x [8 slots, 32 q heads, 8 kv heads, context "
                    "1024, head 64], int8 cache of 2048 rows")

    def decode_case(name, fn, plain, k_, v_, what, **extra):
        attn_case(
            name, dense_shapes + what, extra.pop("source"),
            extra.pop("replaces"),
            lambda i: fn(q, k_, v_, ks, vs, pos, layer=i, window=ctx + 1,
                         **kw),
            lambda i: plain(q, k_, v_, ks, vs, pos, layer=i, **kw),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nbytes_decode, flops, **extra)

    def k3(i):
        return cattn.decode_attention(q, kc, vc, ks, vs, pos, layer=i,
                                      window=ctx + 1, **kw)

    def contract(i):
        return cattn.decode_attention_plain(q, kc, vc, ks, vs, pos, layer=i,
                                            **kw)

    def s8_half_chunks(i):
        """The s8 form with a probability scale per 512 rows, not 1024."""
        return cattn.s8_attention_core(q, kc[i], vc[i], ks[i], vs[i], pos,
                                       fk, fv, h ** -0.5, 512)

    s8_dense = dict(tol=S8_TOL, peak=INT8_OP_PER_S, contract=contract,
                    source=csrc + "attention_s8.cu", replaces=pa + ":256",
                    apart=[("the bf16/f32 kernel", k3),
                           ("the s8 form in chunks of 512", s8_half_chunks)],
                    repeat=True)

    decode_case("decode_attention", cattn.decode_attention,
                cattn.decode_attention_plain, kc, vc, "",
                source=csrc + "decode_attention.cu", replaces=pa + ":256",
                repeat=True)
    # K12: K3's work on the paired cache, K3's kernel and plan: K3's bits
    decode_case("decode_attention_paired", cattn.decode_attention,
                cattn.decode_attention_plain, kcp, vcp, ", paired",
                source=csrc + "decode_attention.cu", replaces=pa + ":256",
                equal=k3, repeat=True)
    # K14, K15: the s8 form, one 1024-row quantization chunk a slot; the
    # operations are integer ones, so the int8 peak bounds them. K15 is
    # K14's kernel on the same rows re-laid, at K14's plan: K14's bits
    decode_case("decode_attention_s8", cattn.decode_attention_s8,
                cattn.decode_attention_s8_plain, kc, vc, ", s8 dots",
                **s8_dense)
    decode_case("decode_attention_s8_paired", cattn.decode_attention_s8,
                cattn.decode_attention_s8_plain, kcp, vcp,
                ", paired, s8 dots", **s8_dense,
                equal=lambda i: cattn.decode_attention_s8(
                    q, kc, vc, ks, vs, pos, layer=i, window=ctx + 1, **kw))
    # K16: K3's work through the slot-batched entry point (the same launch
    # plan, so the same bits)
    decode_case("decode_attention_multi", cattn.decode_attention_multi,
                cattn.decode_attention_plain, kc, vc, ", slot-batched",
                source=csrc + "decode_attention.cu", replaces=pa + ":460",
                equal=k3, repeat=True)
    del kd, vd
    # K3 at unequal positions, 16 to 2000 rows (window: the whole cache);
    # the library call is given the rows below the longest slot and a mask
    spread = torch.tensor([2000, 16, 1024, 300, 1700, 64, 1300, 700],
                          dtype=torch.int32, device=dev)
    top = int(spread.max())
    smask = torch.cat([torch.arange(top, device=dev)[None, :]
                       < spread[:, None],
                       torch.ones((b, 1), dtype=torch.bool, device=dev)],
                      dim=1)[:, None, None, :]
    kd = [torch.cat([(kc[i, :, :, :top].float() * ks[i, :, :, :top, None])
                     .bfloat16(), fk[:, :, None]], dim=2) for i in range(nl)]
    vd = [torch.cat([(vc[i, :, :, :top].float() * vs[i, :, :, :top, None])
                     .bfloat16(), fv[:, :, None]], dim=2) for i in range(nl)]
    live = int(spread.sum())
    attn_case(
        "decode_attention", "16 layers x [8 slots at 16-2000 rows, 32 q "
        "heads, 8 kv heads, head 64], int8 cache of 2048 rows",
        csrc + "decode_attention.cu", pa + ":256",
        lambda i: cattn.decode_attention(q, kc, vc, ks, vs, spread, layer=i,
                                         window=s, **kw),
        lambda i: cattn.decode_attention_plain(q, kc, vc, ks, vs, spread,
                                               layer=i, **kw),
        lambda i: sdpa(qt, kd[i], vd[i], attn_mask=smask, enable_gqa=True),
        nl * (2 * nk * live * (h + 4) + 2 * b * nq * h * 2
              + 2 * b * nk * h * 2),
        nl * 4 * nq * h * (live + b), case="spread positions", repeat=True)
    del kd, vd, smask

    # K34, K35: the no-fresh-row form (the cache holds the current token:
    # rows j <= positions[b]; the reference's public ops without fresh
    # rows), K3's rows and plan, 1025 live rows a slot at window ctx + 1;
    # K34 gives the same bits on one layer's cache alone, K35 (paired)
    # K34's; then K34 at unequal positions from 0 (one row) to 2047 (the
    # whole cache), and within a window of 512 rows
    nf_rows = ctx + 1
    kd = [(kc[i, :, :, :nf_rows].float() * ks[i, :, :, :nf_rows, None])
          .bfloat16() for i in range(nl)]
    vd = [(vc[i, :, :, :nf_rows].float() * vs[i, :, :, :nf_rows, None])
          .bfloat16() for i in range(nl)]

    def nofresh_bytes(rows: int, row_bytes: int) -> int:
        return nl * (2 * nk * rows * row_bytes + 2 * b * nq * h * 2)

    def k34(i):
        return cattn.decode_attention(q, kc, vc, ks, vs, pos, layer=i,
                                      window=nf_rows)

    for name, k_, v_, what, same in (
            ("decode_attention_nofresh", kc, vc, "",
             lambda i: cattn.decode_attention(q, kc[i], vc[i], ks[i], vs[i],
                                              pos, window=nf_rows)),
            ("decode_attention_nofresh_paired", kcp, vcp, ", paired", k34)):
        attn_case(
            name, dense_shapes + what + ", no fresh row: rows j <= 1024",
            csrc + "decode_attention.cu", pa + ":256",
            lambda i, k_=k_, v_=v_: cattn.decode_attention(
                q, k_, v_, ks, vs, pos, layer=i, window=nf_rows),
            lambda i, k_=k_, v_=v_: cattn.decode_attention_plain(
                q, k_, v_, ks, vs, pos, layer=i),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nofresh_bytes(b * nf_rows, h + 4), nl * 4 * b * nq * nf_rows * h,
            equal=same, repeat=True)
    del kd, vd
    spread0 = torch.tensor([0, 16, 1024, 300, 2047, 64, 1300, 700],
                           dtype=torch.int32, device=dev)
    for wpos, window, case in ((spread0, None, "positions 0 to 2047"),
                               (spread0.clamp(max=511), 512,
                                "positions 0 to 511, window 512")):
        top = int(wpos.max()) + 1
        smask = (torch.arange(top, device=dev)[None, :]
                 <= wpos[:, None])[:, None, None, :]
        kd = [(kc[i, :, :, :top].float() * ks[i, :, :, :top, None])
              .bfloat16() for i in range(nl)]
        vd = [(vc[i, :, :, :top].float() * vs[i, :, :, :top, None])
              .bfloat16() for i in range(nl)]
        live = int(wpos.sum()) + b
        attn_case(
            "decode_attention_nofresh", "16 layers x [8 slots at 1-2048 "
            "rows, 32 q heads, 8 kv heads, head 64], int8 cache of 2048 "
            "rows, no fresh row", csrc + "decode_attention.cu", pa + ":256",
            lambda i, wpos=wpos, window=window: cattn.decode_attention(
                q, kc, vc, ks, vs, wpos, layer=i, window=window),
            lambda i, wpos=wpos: cattn.decode_attention_plain(
                q, kc, vc, ks, vs, wpos, layer=i),
            lambda i, kd=kd, vd=vd, smask=smask: sdpa(
                qt, kd[i], vd[i], attn_mask=smask, enable_gqa=True),
            nofresh_bytes(live, h + 4), nl * 4 * nq * h * live, case=case,
            repeat=True)
        del kd, vd, smask

    def prefill_inputs(t, off):
        """One slot's chunk of t tokens at offset off (slot 3), and what
        the library call is given ready-made: the dequantized past rows
        and the fresh block in bf16, and the causal mask."""
        q4 = torch.randn((1, t, nq, h), generator=g, device=dev).bfloat16()
        fk4 = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
        fv4 = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
        mask = torch.cat([torch.ones((t, off), dtype=torch.bool, device=dev),
                          torch.ones((t, t), dtype=torch.bool,
                                     device=dev).tril()], dim=1)
        kd = [torch.cat([(kc[i, 3, :, :off].float()
                          * ks[i, 3, :, :off, None]).bfloat16(), fk4],
                        dim=1)[None] for i in range(nl)]
        vd = [torch.cat([(vc[i, 3, :, :off].float()
                          * vs[i, 3, :, :off, None]).bfloat16(), fv4],
                        dim=1)[None] for i in range(nl)]
        keys = t * off + t * (t + 1) // 2  # (query, key) pairs kept
        nbytes = nl * (2 * nk * off * (h + 4) + 2 * t * nq * h * 2
                       + 2 * nk * t * h * 2)
        return dict(t=t, off=off, q=q4, kw=dict(fresh_k=fk4, fresh_v=fv4),
                    mask=mask, kd=kd, vd=vd, qt=q4.transpose(1, 2),
                    nbytes=nbytes, ops=nl * 4 * nq * h * keys)

    def prefill_case(name, k_, v_, what, pi, **extra):
        t, off, q4, kw4 = pi["t"], pi["off"], pi["q"], pi["kw"]
        attn_case(
            name, f"16 layers x [T={t} at offset {off}, 32 q heads, 8 kv "
            "heads, head 64], one slot" + what, csrc + "prefill_attention.cu",
            pf,
            lambda i: cpfa.prefill_attention(q4, k_, v_, ks, vs, 3, off,
                                             layer=i, **kw4),
            lambda i: cpfa.prefill_attention_plain(q4, k_, v_, ks, vs, 3,
                                                   off, layer=i, **kw4),
            lambda i: sdpa(pi["qt"], pi["kd"][i], pi["vd"][i],
                           attn_mask=pi["mask"], enable_gqa=True),
            pi["nbytes"], pi["ops"], iters=3, **extra)

    def k4_of(pi):
        return lambda i: cpfa.prefill_attention(
            pi["q"], kc, vc, ks, vs, 3, pi["off"], layer=i, **pi["kw"])

    # K4: one 512-token prefill chunk at offset 512 (16 launches)
    pi = prefill_inputs(512, 512)
    prefill_case("prefill_attention", kc, vc, "", pi)
    # K21: K4's work on the paired cache
    prefill_case("prefill_attention_paired", kcp, vcp, ", paired", pi,
                 equal=k4_of(pi))
    # K21 at a short bucket over a long past: 32 blocks of 16 past tiles
    pi = prefill_inputs(64, 1024)
    prefill_case("prefill_attention_paired", kcp, vcp, ", paired", pi,
                 equal=k4_of(pi), case="T=64, offset 1024")
    # both rebuilt bodies repeat their bits
    for k_, v_ in ((kc, vc), (kcp, vcp)):
        again = [cpfa.prefill_attention(pi["q"], k_, v_, ks, vs, 3, 1024,
                                        layer=0, **pi["kw"])
                 for _ in range(2)]
        if not torch.equal(*again):
            raise AssertionError("prefill attention: a repeat differs")
    del pi, again

    # K9: one verify step's 16 launches, a block of 8 (speculate 7) on all
    # 8 slots at context 1024
    tv = 8
    qv = torch.randn((b, tv, nq, h), generator=g, device=dev).bfloat16()
    fkv = torch.randn((b, nk, tv, h), generator=g, device=dev).bfloat16()
    fvv = torch.randn((b, nk, tv, h), generator=g, device=dev).bfloat16()
    kwv = dict(fresh_k=fkv, fresh_v=fvv)
    vmask = torch.cat([torch.ones((tv, ctx), dtype=torch.bool, device=dev),
                       torch.ones((tv, tv), dtype=torch.bool,
                                  device=dev).tril()], dim=1)

    def dequantized(codes, scales, fresh):
        """Rows j < ctx of a [B, Nk, S, H] int8 layer in bf16, then the
        fresh rows: what the library call is given ready-made."""
        return torch.cat([(codes[:, :, :ctx].float()
                           * scales[:, :, :ctx, None]).bfloat16(), fresh],
                         dim=2)

    kd = [dequantized(kc[i], ks[i], fkv) for i in range(nl)]
    vd = [dequantized(vc[i], vs[i], fvv) for i in range(nl)]
    qtv = qv.transpose(1, 2)
    # cache rows and scales once, q and the output, the fresh block
    vbytes = nl * (2 * b * nk * ctx * (h + 4) + 2 * b * tv * nq * h * 2
                   + 2 * b * nk * tv * h * 2)
    vflops = nl * 4 * b * nq * h * (tv * ctx + tv * (tv + 1) // 2)

    def verify_case(name, k_, v_, what, **extra):
        attn_case(
            name, "16 layers x [8 slots, block of 8, 32 q heads, 8 kv "
            "heads, context 1024, head 64], int8 cache of 2048 rows" + what,
            csrc + "verify_attention.cu", pa + ":649",
            lambda i: cattn.verify_attention(qv, k_, v_, ks, vs, pos, layer=i,
                                             window=2048, **kwv),
            lambda i: cattn.verify_attention_plain(qv, k_, v_, ks, vs, pos,
                                                   layer=i, **kwv),
            lambda i: sdpa(qtv, kd[i], vd[i], attn_mask=vmask,
                           enable_gqa=True),
            vbytes, vflops, **extra)

    # K9 (the verify form of decode_attention.cuh), each call repeated bit
    # for bit
    verify_case("verify_attention", kc, vc, "", repeat=True)
    # K13: K9's work on the paired cache: K9's bits
    verify_case("verify_attention_paired", kcp, vcp, ", paired",
                equal=lambda i: cattn.verify_attention(
                    qv, kc, vc, ks, vs, pos, layer=i, window=2048, **kwv),
                repeat=True)
    del kd, vd, kc, vc, ks, vs, kcp, vcp
    torch.cuda.empty_cache()

    # the paged pool of the paged engine runs: 33 pages of 512 rows (the
    # dense cache's 32 plus the scratch page), each slot's four logical
    # pages scattered over the pool by a shuffled table
    page, npages = 512, 33
    kp, kps = quantize_kv(torch.randn((npages, nl, nk, page, h), generator=g,
                                      device=dev))
    vp, vps = quantize_kv(torch.randn((npages, nl, nk, page, h), generator=g,
                                      device=dev))
    table = (torch.randperm(npages - 1, generator=g, device=dev) + 1
             ).reshape(b, s // page).to(torch.int32).contiguous()
    pool = (kp, vp, table, pos, kps, vps)
    tbytes = nl * b * (s // page) * 4  # the table, read once a launch

    def gathered(codes, scales, layer, fresh):
        idx = table[:, :ctx // page].long()
        rows = codes[:, layer][idx].movedim(1, 2).reshape(b, nk, ctx, h)
        sc = scales[:, layer][idx].movedim(1, 2).reshape(b, nk, ctx)
        return torch.cat([(rows.float() * sc[..., None]).bfloat16(), fresh],
                         dim=2)

    kd = [gathered(kp, kps, i, fk[:, :, None]) for i in range(nl)]
    vd = [gathered(vp, vps, i, fv[:, :, None]) for i in range(nl)]

    # the same pool paired: [33, 16, 4, 512, 128]
    kpp, vpp = pair_heads(kp), pair_heads(vp)
    pool_p = (kpp, vpp, table, pos, kps, vps)
    pool_shapes = ("16 layers x [8 slots, 32 q heads, 8 kv heads, context "
                   "1024, head 64], int8 pool of 33 pages of 512 rows, "
                   "shuffled table")

    def paged_case(name, fn, plain, pl, what, replaces, **extra):
        attn_case(
            name, pool_shapes + what, extra.pop("source"), replaces,
            lambda i: fn(q, *pl, layer=i, **kw),
            lambda i: plain(q, *pl, layer=i, **kw),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nbytes_decode + tbytes, flops, **extra)

    def paged_contract(i):
        return cpaged.paged_decode_attention_plain(q, *pool, layer=i, **kw)

    def k10(i):
        return cpaged.paged_decode_attention(q, *pool, layer=i, **kw)

    def s8_half_pages(i):
        """The s8 form with a probability scale per 256 rows, not a page."""
        return cattn.s8_attention_core(
            q, *gather_layer(kp, vp, table, kps, vps, i, h), pos, fk, fv,
            h ** -0.5, page // 2)

    s8_paged = dict(tol=S8_TOL, peak=INT8_OP_PER_S, contract=paged_contract,
                    source=csrc + "attention_s8.cu",
                    apart=[("the bf16/f32 kernel", k10),
                           ("the s8 form in chunks of 256", s8_half_pages)],
                    repeat=True)
    # the pool's rows gathered into a dense cache as long as its read bound
    # (4 pages of 512 a slot)
    dense_pool = [torch.stack([gather_pages(x, table, i) for i in range(nl)])
                  for x in (kp, vp, kps, vps)]

    def k14_at_page_chunks(i):
        """K14 on the gathered rows, a quantization chunk a page: K19's
        plan, tiles and chunk maxima, so K19's bits."""
        with attn_chunk(page):
            return cattn.decode_attention_s8(q, *dense_pool[:2],
                                             *dense_pool[2:], pos, layer=i,
                                             **kw)

    # K10: K3's work read through the table (K3's kernel, paged)
    paged_case("paged_decode_attention", cpaged.paged_decode_attention,
               cpaged.paged_decode_attention_plain, pool, "", pa + ":800",
               source=csrc + "decode_attention.cu", repeat=True)
    # K17: K10's work on the paired pool: K10's bits
    paged_case("paged_decode_attention_paired",
               cpaged.paged_decode_attention,
               cpaged.paged_decode_attention_plain, pool_p, ", paired",
               pa + ":800", source=csrc + "decode_attention.cu",
               equal=lambda i: cpaged.paged_decode_attention(
                   q, *pool, layer=i, **kw), repeat=True)
    # K19, K20: the s8 form through the table, one chunk a page; K19 gives
    # K14's bits on the same rows at a chunk a page, K20 K19's
    paged_case("paged_decode_attention_s8", cpaged.paged_decode_attention_s8,
               cpaged.paged_decode_attention_s8_plain, pool, ", s8 dots",
               pa + ":800", **s8_paged, equal=k14_at_page_chunks)
    paged_case("paged_decode_attention_s8_paired",
               cpaged.paged_decode_attention_s8,
               cpaged.paged_decode_attention_s8_plain, pool_p,
               ", paired, s8 dots", pa + ":800", **s8_paged,
               equal=lambda i: cpaged.paged_decode_attention_s8(
                   q, *pool, layer=i, **kw))

    # K38, K39: K34's work through the table (rows j <= 1024 of a slot's
    # four pages); K38 gives K34's bits on the pool's rows gathered into a
    # dense cache as long as its read bound (the same plan), K39 K38's
    idx_nf = table[:, :ctx // page + 1].long()  # the pages of rows <= ctx

    def nofresh_rows(rows, scales, layer):
        """Rows j <= ctx of one layer of a pool through the table, in bf16
        (dequantized when scales are given): the library call's input."""
        got = rows[:, layer][idx_nf].movedim(1, 2).reshape(
            b, nk, -1, h)[:, :, :nf_rows]
        if scales is None:
            return got
        sc = scales[:, layer][idx_nf].movedim(1, 2).reshape(
            b, nk, -1)[:, :, :nf_rows]
        return (got.float() * sc[..., None]).bfloat16()

    kd = [nofresh_rows(kp, kps, i) for i in range(nl)]
    vd = [nofresh_rows(vp, vps, i) for i in range(nl)]
    for name, pl, what, same in (
            ("paged_decode_attention_nofresh", pool, "",
             lambda i: cattn.decode_attention(q, *dense_pool[:2],
                                              *dense_pool[2:], pos,
                                              layer=i)),
            ("paged_decode_attention_nofresh_paired", pool_p, ", paired",
             lambda i: cpaged.paged_decode_attention(q, *pool, layer=i))):
        attn_case(
            name, pool_shapes + what + ", no fresh row: rows j <= 1024",
            csrc + "paged_attention.cu", pa + ":800",
            lambda i, pl=pl: cpaged.paged_decode_attention(q, *pl, layer=i),
            lambda i, pl=pl: cpaged.paged_decode_attention_plain(q, *pl,
                                                                 layer=i),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nofresh_bytes(b * nf_rows, h + 4) + tbytes,
            nl * 4 * b * nq * nf_rows * h, equal=same, repeat=True)

    # K11: K9's work read through the table; K18: on the paired pool
    kd = [gathered(kp, kps, i, fkv) for i in range(nl)]
    vd = [gathered(vp, vps, i, fvv) for i in range(nl)]

    def paged_verify_case(name, pl, what, **extra):
        attn_case(
            name, "16 layers x [8 slots, block of 8, 32 q heads, 8 kv "
            "heads, context 1024, head 64], int8 pool of 33 pages of 512 "
            "rows, shuffled table" + what, csrc + "paged_attention.cu",
            pa + ":842",
            lambda i: cpaged.paged_verify_attention(qv, *pl, layer=i, **kwv),
            lambda i: cpaged.paged_verify_attention_plain(qv, *pl, layer=i,
                                                          **kwv),
            lambda i: sdpa(qtv, kd[i], vd[i], attn_mask=vmask,
                           enable_gqa=True),
            vbytes + tbytes, vflops, **extra)

    # K11 gives K9's bits on the pool's rows gathered into a dense cache as
    # long as its read bound (the same plan), K18 K11's; each call repeated
    paged_verify_case("paged_verify_attention", pool, "",
                      equal=lambda i: cattn.verify_attention(
                          qv, *dense_pool[:2], *dense_pool[2:], pos,
                          layer=i, window=2048, **kwv), repeat=True)
    paged_verify_case("paged_verify_attention_paired", pool_p, ", paired",
                      equal=lambda i: cpaged.paged_verify_attention(
                          qv, *pool, layer=i, **kwv), repeat=True)
    del kd, vd, kp, vp, kps, vps, kpp, vpp, pool, pool_p, dense_pool
    torch.cuda.empty_cache()

    # K22-K32: the bf16 cache of one 2048-row engine [16, 8, 8, 2048, 64]
    # (no scales: the reference's k_scale=None forms), the same calls
    kb = torch.randn((nl, b, nk, s, h), generator=g, device=dev).bfloat16()
    vb = torch.randn((nl, b, nk, s, h), generator=g, device=dev).bfloat16()
    kbp, vbp = pair_heads(kb), pair_heads(vb)
    bf16_shapes = ("16 layers x [8 slots, 32 q heads, 8 kv heads, context "
                   "1024, head 64], bf16 cache of 2048 rows")
    # rows j < ctx of k and v once, q and the output, the fresh rows
    bbytes = nl * (2 * b * nk * ctx * h * 2 + 2 * b * nq * h * 2
                   + 2 * b * nk * h * 2)
    kd = [torch.cat([kb[i, :, :, :ctx], fk[:, :, None]], dim=2)
          for i in range(nl)]
    vd = [torch.cat([vb[i, :, :, :ctx], fv[:, :, None]], dim=2)
          for i in range(nl)]

    def bf16_decode_case(name, fn, k_, v_, what, source, replaces, **extra):
        attn_case(
            name, bf16_shapes + what, source, replaces,
            lambda i: fn(q, k_, v_, None, None, pos, layer=i, window=ctx + 1,
                         **kw),
            lambda i: cattn.decode_attention_plain(q, k_, v_, None, None, pos,
                                                   layer=i, **kw),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True), bbytes, flops,
            **extra)

    def k24(i):
        return cattn.decode_attention(q, kb, vb, None, None, pos, layer=i,
                                      window=ctx + 1, **kw)

    def k32(i):
        return cattn.decode_attention_multi(q, kb, vb, None, None, pos,
                                            layer=i, window=ctx + 1, **kw)

    # K24, K25: dense decode over the bf16 cache, K32's kernel and plan:
    # K24 gives K32's bits, K25 (paired) K24's
    bf16_decode_case("decode_attention_bf16", cattn.decode_attention, kb, vb,
                     "", csrc + "decode_attention.cu", pa + ":256",
                     equal=k32, repeat=True)
    bf16_decode_case("decode_attention_bf16_paired", cattn.decode_attention,
                     kbp, vbp, ", paired", csrc + "decode_attention.cu",
                     pa + ":256", equal=k24, repeat=True)
    # K32: the slot-batched launch over the unpaired bf16 cache
    bf16_decode_case("decode_attention_multi_bf16",
                     cattn.decode_attention_multi, kb, vb, ", slot-batched",
                     csrc + "decode_attention.cu", pa + ":460", repeat=True)
    # K36, K37: the no-fresh-row form over the bf16 cache (the reference's
    # public cache_attention without fresh rows), rows j <= 1024; K36 gives
    # the same bits on one layer's cache alone, K37 (paired) K36's
    kd = [kb[i, :, :, :nf_rows] for i in range(nl)]
    vd = [vb[i, :, :, :nf_rows] for i in range(nl)]

    def k36(i):
        return cattn.decode_attention(q, kb, vb, None, None, pos, layer=i,
                                      window=nf_rows)

    for name, k_, v_, what, same in (
            ("decode_attention_nofresh_bf16", kb, vb, "",
             lambda i: cattn.decode_attention(q, kb[i], vb[i], None, None,
                                              pos, window=nf_rows)),
            ("decode_attention_nofresh_bf16_paired", kbp, vbp, ", paired",
             k36)):
        attn_case(
            name, bf16_shapes + what + ", no fresh row: rows j <= 1024",
            csrc + "decode_attention.cu", pa + ":256",
            lambda i, k_=k_, v_=v_: cattn.decode_attention(
                q, k_, v_, None, None, pos, layer=i, window=nf_rows),
            lambda i, k_=k_, v_=v_: cattn.decode_attention_plain(
                q, k_, v_, None, None, pos, layer=i),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nofresh_bytes(b * nf_rows, 2 * h),
            nl * 4 * b * nq * nf_rows * h, equal=same, repeat=True)
    # K26, K27: verify, a block of 8
    kd = [torch.cat([kb[i, :, :, :ctx], fkv], dim=2) for i in range(nl)]
    vd = [torch.cat([vb[i, :, :, :ctx], fvv], dim=2) for i in range(nl)]
    vbbytes = nl * (2 * b * nk * ctx * h * 2 + 2 * b * tv * nq * h * 2
                    + 2 * b * nk * tv * h * 2)

    def bf16_verify_case(name, k_, v_, what, **extra):
        attn_case(
            name, "16 layers x [8 slots, block of 8, 32 q heads, 8 kv "
            "heads, context 1024, head 64], bf16 cache of 2048 rows" + what,
            csrc + "verify_attention.cu", pa + ":649",
            lambda i: cattn.verify_attention(qv, k_, v_, None, None, pos,
                                             layer=i, window=2048, **kwv),
            lambda i: cattn.verify_attention_plain(qv, k_, v_, None, None,
                                                   pos, layer=i, **kwv),
            lambda i: sdpa(qtv, kd[i], vd[i], attn_mask=vmask,
                           enable_gqa=True),
            vbbytes, vflops, **extra)

    bf16_verify_case("verify_attention_bf16", kb, vb, "", repeat=True)
    bf16_verify_case("verify_attention_bf16_paired", kbp, vbp, ", paired",
                     equal=lambda i: cattn.verify_attention(
                         qv, kb, vb, None, None, pos, layer=i, window=2048,
                         **kwv), repeat=True)
    # K22, K23 (TMA + wgmma, prefill_attention_bf16.cu): one 512-token
    # prefill chunk at offset 512 of slot 3, then a 64-token chunk over
    # 1024 rows (the key range split across blocks); K23 gives K22's bits
    def bf16_prefill_inputs(t, off):
        q4 = torch.randn((1, t, nq, h), generator=g, device=dev).bfloat16()
        fk4 = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
        fv4 = torch.randn((nk, t, h), generator=g, device=dev).bfloat16()
        mask = torch.cat([torch.ones((t, off), dtype=torch.bool, device=dev),
                          torch.ones((t, t), dtype=torch.bool,
                                     device=dev).tril()], dim=1)
        keys = t * off + t * (t + 1) // 2
        return dict(t=t, off=off, q=q4, kw=dict(fresh_k=fk4, fresh_v=fv4),
                    mask=mask, qt=q4.transpose(1, 2),
                    kd=[torch.cat([kb[i, 3, :, :off], fk4], dim=1)[None]
                        for i in range(nl)],
                    vd=[torch.cat([vb[i, 3, :, :off], fv4], dim=1)[None]
                        for i in range(nl)],
                    nbytes=nl * (2 * nk * off * h * 2 + 2 * t * nq * h * 2
                                 + 2 * nk * t * h * 2),
                    ops=nl * 4 * nq * h * keys)

    def bf16_prefill_case(name, k_, v_, what, pi, **extra):
        t, off, q4, kw4 = pi["t"], pi["off"], pi["q"], pi["kw"]
        attn_case(
            name, f"16 layers x [T={t} at offset {off}, 32 q heads, 8 kv "
            "heads, head 64], one slot, bf16 cache" + what,
            csrc + "prefill_attention_bf16.cu", pf,
            lambda i: cpfa.prefill_attention(q4, k_, v_, None, None, 3, off,
                                             layer=i, **kw4),
            lambda i: cpfa.prefill_attention_plain(q4, k_, v_, None, None, 3,
                                                   off, layer=i, **kw4),
            lambda i: sdpa(pi["qt"], pi["kd"][i], pi["vd"][i],
                           attn_mask=pi["mask"], enable_gqa=True),
            pi["nbytes"], pi["ops"], iters=3, repeat=True, **extra)

    for t4, off4, label in ((512, 512, None),
                            (64, 1024, "T=64, offset 1024")):
        pi = bf16_prefill_inputs(t4, off4)
        bf16_prefill_case("prefill_attention_bf16", kb, vb, "", pi,
                          case=label)
        bf16_prefill_case(
            "prefill_attention_bf16_paired", kbp, vbp, ", paired", pi,
            case=label, equal=lambda i, pi=pi: cpfa.prefill_attention(
                pi["q"], kb, vb, None, None, 3, pi["off"], layer=i,
                **pi["kw"]))
    del pi
    del kd, vd, kbp, vbp
    # K28-K31: the same rows through a shuffled table of 512-row pages
    kpb = torch.randn((npages, nl, nk, page, h), generator=g,
                      device=dev).bfloat16()
    vpb = torch.randn((npages, nl, nk, page, h), generator=g,
                      device=dev).bfloat16()
    pool_b = (kpb, vpb, table, pos, None, None)
    pool_bp = (pair_heads(kpb), pair_heads(vpb), table, pos, None, None)
    idx = table[:, :ctx // page].long()

    def gathered_bf16(rows, layer, fresh):
        got = rows[:, layer][idx].movedim(1, 2).reshape(b, nk, ctx, h)
        return torch.cat([got, fresh], dim=2)

    bf16_pool = ("16 layers x [8 slots, 32 q heads, 8 kv heads, context "
                 "1024, head 64], bf16 pool of 33 pages of 512 rows, "
                 "shuffled table")
    dense_b = [torch.stack([gather_pages(x, table, i) for i in range(nl)])
               for x in (kpb, vpb)]
    for tq, fn, plain, replaces in (
            (1, cpaged.paged_decode_attention,
             cpaged.paged_decode_attention_plain, pa + ":800"),
            (tv, cpaged.paged_verify_attention,
             cpaged.paged_verify_attention_plain, pa + ":842")):
        qq, kwq, qqt = (q, kw, qt) if tq == 1 else (qv, kwv, qtv)
        fks = fk[:, :, None] if tq == 1 else fkv
        fvs = fv[:, :, None] if tq == 1 else fvv
        kd = [gathered_bf16(kpb, i, fks) for i in range(nl)]
        vd = [gathered_bf16(vpb, i, fvs) for i in range(nl)]
        name = ("paged_decode_attention_bf16" if tq == 1
                else "paged_verify_attention_bf16")
        work = ((bbytes, flops) if tq == 1 else (vbbytes, vflops))
        # K28, K29 (tq = 1) on decode_attention.cu, each call repeated
        # bit for bit; K30, K31 (verify) on paged_attention.cu
        # (K30 also K26's bits on the pool's rows gathered into a dense
        # cache as long as its read bound, where both take one plan)
        src = csrc + ("decode_attention.cu" if tq == 1
                      else "paged_attention.cu")
        same = {} if tq == 1 else dict(
            equal=lambda i: cattn.verify_attention(
                qv, *dense_b, None, None, pos, layer=i, window=2048,
                **kwv))
        for suffix, pl, extra in (
                ("", pool_b, same),
                ("_paired", pool_bp, dict(equal=lambda i, fn=fn, qq=qq,
                                          kwq=kwq: fn(qq, *pool_b, layer=i,
                                                      **kwq)))):
            attn_case(
                name + suffix, bf16_pool + (", paired" if suffix else "")
                + ("" if tq == 1 else ", block of 8"), src, replaces,
                lambda i, fn=fn, pl=pl, qq=qq, kwq=kwq: fn(qq, *pl, layer=i,
                                                           **kwq),
                lambda i, plain=plain, pl=pl, qq=qq, kwq=kwq: plain(
                    qq, *pl, layer=i, **kwq),
                lambda i, qqt=qqt, kd=kd, vd=vd, tq=tq: sdpa(
                    qqt, kd[i], vd[i], attn_mask=None if tq == 1 else vmask,
                    enable_gqa=True),
                work[0] + tbytes, work[1], repeat=True, **extra)
    # K40, K41: the no-fresh-row form through the table over the bf16
    # pools; K40 gives K36's bits on the pool's rows gathered (the same
    # plan), K41 K40's
    kd = [nofresh_rows(kpb, None, i) for i in range(nl)]
    vd = [nofresh_rows(vpb, None, i) for i in range(nl)]
    for name, pl, what, same in (
            ("paged_decode_attention_nofresh_bf16", pool_b, "",
             lambda i: cattn.decode_attention(q, *dense_b, None, None, pos,
                                              layer=i)),
            ("paged_decode_attention_nofresh_bf16_paired", pool_bp,
             ", paired",
             lambda i: cpaged.paged_decode_attention(q, *pool_b, layer=i))):
        attn_case(
            name, bf16_pool + what + ", no fresh row: rows j <= 1024",
            csrc + "paged_attention.cu", pa + ":800",
            lambda i, pl=pl: cpaged.paged_decode_attention(q, *pl, layer=i),
            lambda i, pl=pl: cpaged.paged_decode_attention_plain(q, *pl,
                                                                 layer=i),
            lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
            nofresh_bytes(b * nf_rows, 2 * h) + tbytes,
            nl * 4 * b * nq * nf_rows * h, equal=same, repeat=True)
    del dense_b, kd, vd
    for r in results:
        emit({"phase": "kernels", "tol": TOL, **r})
    return results


def head128_phase(cfg3, dev) -> list:
    """One case per attention source at Llama-3.2-3B's heads (24 q heads
    over 8 kv heads of 128 dims: G = 3) and depth (28 launches), over the
    int8 cache of the 3B engine run: K3, K16, K32 (over a bf16 cache of
    the same shape) and K17 paired paged decode (decode_attention.cu),
    K27 paired verify over the bf16 cache and K13 over the int8 one
    (verify_attention.cu), K15 paired s8 decode
    (attention_s8.cu, the 3B default) and K20 its paged form, K22 and
    K23 prefill over the bf16 cache (prefill_attention_bf16.cu) and K21
    paired prefill
    (prefill_attention.cu), each against its plain version, timed as the
    1B cases are; then K1 at the 3B's four projections x 28 layers, M = 8.
    Emitted on lines of their own."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

    g = torch.Generator(device=dev).manual_seed(3)
    nl, b, s, ctx, tv, page = cfg3.num_layers, 8, 2048, 1024, 8, 512
    nq, nk, h = cfg3.num_heads, cfg3.num_kv_heads, cfg3.head_dim
    results = []

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kc, ks = quantize_kv(rand(nl, b, nk, s, h))
    vc, vs = quantize_kv(rand(nl, b, nk, s, h))
    kcp, vcp = pair_heads(kc), pair_heads(vc)
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = rand(b, 1, nq, h).bfloat16()
    fk, fv = rand(b, nk, h).bfloat16(), rand(b, nk, h).bfloat16()
    kw = dict(fresh_k=fk, fresh_v=fv)
    qv = rand(b, tv, nq, h).bfloat16()
    fkv, fvv = rand(b, nk, tv, h).bfloat16(), rand(b, nk, tv, h).bfloat16()
    kwv = dict(fresh_k=fkv, fresh_v=fvv)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pa = "gabby_tpu/ops/pallas/attention.py"
    csrc = "gabby_tpu_torch/csrc/"
    heads = f"{nl} layers x [8 slots, 24 q heads, 8 kv heads, head 128]"

    def deq(codes, scales, fresh):
        return torch.cat([(codes[:, :, :ctx].float()
                           * scales[:, :, :ctx, None]).bfloat16(), fresh],
                         dim=2)

    def case(*args, **extra):
        attn_case_into(results, nl, *args, **extra)

    dbytes = nl * (2 * b * nk * ctx * (h + 4) + 2 * b * nq * h * 2
                   + 2 * b * nk * h * 2)
    dflops = nl * 4 * b * nq * (ctx + 1) * h
    kd = [deq(kc[i], ks[i], fk[:, :, None]) for i in range(nl)]
    vd = [deq(vc[i], vs[i], fv[:, :, None]) for i in range(nl)]
    lib = (lambda i: sdpa(q.transpose(1, 2), kd[i], vd[i], enable_gqa=True))

    def k3(i):
        return cattn.decode_attention(q, kc, vc, ks, vs, pos, layer=i,
                                      window=ctx + 1, **kw)

    case("decode_attention", heads + ", context 1024, int8 cache",
         csrc + "decode_attention.cu", pa + ":256", k3,
         lambda i: cattn.decode_attention_plain(q, kc, vc, ks, vs, pos,
                                                layer=i, **kw),
         lib, dbytes, dflops, repeat=True)
    # K16: the same through the slot-batched entry point, bit for bit
    case("decode_attention_multi", heads + ", context 1024, int8 cache, "
         "slot-batched", csrc + "decode_attention.cu", pa + ":460",
         lambda i: cattn.decode_attention_multi(q, kc, vc, ks, vs, pos,
                                                layer=i, window=ctx + 1,
                                                **kw),
         lambda i: cattn.decode_attention_plain(q, kc, vc, ks, vs, pos,
                                                layer=i, **kw),
         lib, dbytes, dflops, equal=k3, repeat=True)
    # K34: the no-fresh-row form over the same int8 rows, j <= 1024
    nf_rows = ctx + 1
    kdn = [(kc[i, :, :, :nf_rows].float() * ks[i, :, :, :nf_rows, None])
           .bfloat16() for i in range(nl)]
    vdn = [(vc[i, :, :, :nf_rows].float() * vs[i, :, :, :nf_rows, None])
           .bfloat16() for i in range(nl)]
    qbytes = nl * 2 * b * nq * h * 2
    case("decode_attention_nofresh", heads + ", context 1024, int8 cache, "
         "no fresh row: rows j <= 1024", csrc + "decode_attention.cu",
         pa + ":256",
         lambda i: cattn.decode_attention(q, kc, vc, ks, vs, pos, layer=i,
                                          window=nf_rows),
         lambda i: cattn.decode_attention_plain(q, kc, vc, ks, vs, pos,
                                                layer=i),
         lambda i: sdpa(q.transpose(1, 2), kdn[i], vdn[i], enable_gqa=True),
         nl * 2 * b * nk * nf_rows * (h + 4) + qbytes,
         nl * 4 * b * nq * nf_rows * h, repeat=True)
    del kdn, vdn
    # K32: the slot-batched launch over a bf16 cache of the same shape
    kb, vb = rand(nl, b, nk, s, h).bfloat16(), rand(nl, b, nk, s, h).bfloat16()
    kdb = [torch.cat([kb[i, :, :, :ctx], fk[:, :, None]], dim=2)
           for i in range(nl)]
    vdb = [torch.cat([vb[i, :, :, :ctx], fv[:, :, None]], dim=2)
           for i in range(nl)]
    case("decode_attention_multi_bf16", heads + ", context 1024, bf16 cache, "
         "slot-batched", csrc + "decode_attention.cu", pa + ":460",
         lambda i: cattn.decode_attention_multi(q, kb, vb, None, None, pos,
                                                layer=i, window=ctx + 1,
                                                **kw),
         lambda i: cattn.decode_attention_plain(q, kb, vb, None, None, pos,
                                                layer=i, **kw),
         lambda i: sdpa(q.transpose(1, 2), kdb[i], vdb[i], enable_gqa=True),
         nl * (2 * b * nk * ctx * h * 2 + 2 * b * nq * h * 2
               + 2 * b * nk * h * 2), dflops, repeat=True)
    # K36: the no-fresh-row form over the same bf16 rows, j <= 1024
    case("decode_attention_nofresh_bf16", heads + ", context 1024, bf16 "
         "cache, no fresh row: rows j <= 1024", csrc + "decode_attention.cu",
         pa + ":256",
         lambda i: cattn.decode_attention(q, kb, vb, None, None, pos,
                                          layer=i, window=nf_rows),
         lambda i: cattn.decode_attention_plain(q, kb, vb, None, None, pos,
                                                layer=i),
         lambda i: sdpa(q.transpose(1, 2), kb[i, :, :, :nf_rows],
                        vb[i, :, :, :nf_rows], enable_gqa=True),
         nl * 2 * b * nk * nf_rows * h * 2 + qbytes,
         nl * 4 * b * nq * nf_rows * h, repeat=True)
    # K27: verify, a block of 8, over the same bf16 rows paired; K26's
    # bits on the unpaired rows
    kdb = [torch.cat([kb[i, :, :, :ctx], fkv], dim=2) for i in range(nl)]
    vdb = [torch.cat([vb[i, :, :, :ctx], fvv], dim=2) for i in range(nl)]
    kbp, vbp = pair_heads(kb), pair_heads(vb)
    vmask = torch.cat([torch.ones((tv, ctx), dtype=torch.bool, device=dev),
                       torch.ones((tv, tv), dtype=torch.bool,
                                  device=dev).tril()], dim=1)
    case("verify_attention_bf16_paired", heads + ", block of 8, context "
         "1024, paired bf16 cache", csrc + "verify_attention.cu",
         pa + ":649",
         lambda i: cattn.verify_attention(qv, kbp, vbp, None, None, pos,
                                          layer=i, window=2048, **kwv),
         lambda i: cattn.verify_attention_plain(qv, kbp, vbp, None, None,
                                                pos, layer=i, **kwv),
         lambda i: sdpa(qv.transpose(1, 2), kdb[i], vdb[i], attn_mask=vmask,
                        enable_gqa=True),
         nl * (2 * b * nk * ctx * h * 2 + 2 * b * tv * nq * h * 2
               + 2 * b * nk * tv * h * 2),
         nl * 4 * b * nq * h * (tv * ctx + tv * (tv + 1) // 2),
         equal=lambda i: cattn.verify_attention(qv, kb, vb, None, None, pos,
                                                layer=i, window=2048, **kwv),
         repeat=True)
    # K22, K23 (prefill_attention_bf16.cu): one 512-token chunk at offset
    # 512 of slot 3 over the same bf16 rows; K23 (paired) gives K22's bits
    tb, offb = 512, 512
    qb = rand(1, tb, nq, h).bfloat16()
    kwb = dict(fresh_k=rand(nk, tb, h).bfloat16(),
               fresh_v=rand(nk, tb, h).bfloat16())
    maskb = torch.cat([torch.ones((tb, offb), dtype=torch.bool, device=dev),
                       torch.ones((tb, tb), dtype=torch.bool,
                                  device=dev).tril()], dim=1)
    kdb = [torch.cat([kb[i, 3, :, :offb], kwb["fresh_k"]], dim=1)[None]
           for i in range(nl)]
    vdb = [torch.cat([vb[i, 3, :, :offb], kwb["fresh_v"]], dim=1)[None]
           for i in range(nl)]
    for name, k_, v_, what, same in (
            ("prefill_attention_bf16", kb, vb, "", None),
            ("prefill_attention_bf16_paired", kbp, vbp, " paired",
             lambda i: cpfa.prefill_attention(qb, kb, vb, None, None, 3,
                                              offb, layer=i, **kwb))):
        case(name, f"{nl} layers x [T={tb} at offset {offb}, 24 q heads, 8 "
             f"kv heads, head 128], one slot,{what} bf16 cache",
             csrc + "prefill_attention_bf16.cu",
             "gabby_tpu/ops/pallas/prefill_attention.py:142",
             lambda i, k_=k_, v_=v_: cpfa.prefill_attention(
                 qb, k_, v_, None, None, 3, offb, layer=i, **kwb),
             lambda i, k_=k_, v_=v_: cpfa.prefill_attention_plain(
                 qb, k_, v_, None, None, 3, offb, layer=i, **kwb),
             lambda i: sdpa(qb.transpose(1, 2), kdb[i], vdb[i],
                            attn_mask=maskb, enable_gqa=True),
             nl * (2 * nk * offb * h * 2 + 2 * tb * nq * h * 2
                   + 2 * nk * tb * h * 2),
             nl * 4 * nq * h * (tb * offb + tb * (tb + 1) // 2), iters=3,
             equal=same, repeat=True)
    del kb, vb, kbp, vbp, kdb, vdb
    case("decode_attention_s8_paired", heads + ", context 1024, paired int8 "
         "cache, s8 dots", csrc + "attention_s8.cu", pa + ":256",
         lambda i: cattn.decode_attention_s8(q, kcp, vcp, ks, vs, pos,
                                             layer=i, window=ctx + 1, **kw),
         lambda i: cattn.decode_attention_s8_plain(q, kcp, vcp, ks, vs, pos,
                                                   layer=i, **kw),
         lib, dbytes, dflops, tol=S8_TOL, peak=INT8_OP_PER_S,
         equal=lambda i: cattn.decode_attention_s8(
             q, kc, vc, ks, vs, pos, layer=i, window=ctx + 1, **kw),
         repeat=True)
    # the same rows through a shuffled table of 512-row pages, paired
    npages = b * s // page + 1
    table = (torch.randperm(npages - 1, generator=g, device=dev) + 1
             ).reshape(b, s // page).to(torch.int32).contiguous()

    def paged(x):
        """[L, B, Nk(/2), S, *] as a pool [P, L, Nk(/2), page, *] behind
        `table` (page 0 the unused scratch page)."""
        pool = torch.zeros((npages, nl, *x.shape[2:3], page, *x.shape[4:]),
                           dtype=x.dtype, device=dev)
        split = x.reshape(nl, b, x.shape[2], s // page, page, *x.shape[4:])
        pool[table.long()] = split.permute(1, 3, 0, 2, 4,
                                           *range(5, split.dim()))
        return pool

    pool = (paged(kcp), paged(vcp), table, pos, paged(ks), paged(vs))
    # K17 gives K12's bits on the same rows: one kernel, and the pool's
    # read bound (4 pages of 512) is the dense cache's (2048 rows)
    case("paged_decode_attention_paired", heads + ", context 1024, paired "
         "int8 pool of 33 pages of 512, shuffled table",
         csrc + "decode_attention.cu", pa + ":800",
         lambda i: cpaged.paged_decode_attention(q, *pool, layer=i, **kw),
         lambda i: cpaged.paged_decode_attention_plain(q, *pool, layer=i,
                                                       **kw),
         lib, dbytes + nl * b * (s // page) * 4, dflops,
         equal=lambda i: cattn.decode_attention(
             q, kcp, vcp, ks, vs, pos, layer=i, window=2048, **kw),
         repeat=True)

    def k15_at_page_chunks(i):
        """K15 on the same rows, window 2048, a quantization chunk a page:
        K20's plan, tiles and chunk maxima, so K20's bits."""
        with attn_chunk(page):
            return cattn.decode_attention_s8(q, kcp, vcp, ks, vs, pos,
                                             layer=i, window=2048, **kw)

    # K20, the paged default, gives K15's bits at a chunk a page
    case("paged_decode_attention_s8_paired", heads + ", context 1024, "
         "paired int8 pool of 33 pages of 512, shuffled table, s8 dots",
         csrc + "attention_s8.cu", pa + ":800",
         lambda i: cpaged.paged_decode_attention_s8(q, *pool, layer=i, **kw),
         lambda i: cpaged.paged_decode_attention_s8_plain(q, *pool, layer=i,
                                                          **kw),
         lib, dbytes + nl * b * (s // page) * 4, dflops, tol=S8_TOL,
         peak=INT8_OP_PER_S, equal=k15_at_page_chunks, repeat=True)
    del pool
    kd = [deq(kc[i], ks[i], fkv) for i in range(nl)]
    vd = [deq(vc[i], vs[i], fvv) for i in range(nl)]
    case("verify_attention_paired", heads + ", block of 8, context 1024, "
         "paired int8 cache", csrc + "verify_attention.cu", pa + ":649",
         lambda i: cattn.verify_attention(qv, kcp, vcp, ks, vs, pos, layer=i,
                                          window=2048, **kwv),
         lambda i: cattn.verify_attention_plain(qv, kcp, vcp, ks, vs, pos,
                                                layer=i, **kwv),
         lambda i: sdpa(qv.transpose(1, 2), kd[i], vd[i], attn_mask=vmask,
                        enable_gqa=True),
         nl * (2 * b * nk * ctx * (h + 4) + 2 * b * tv * nq * h * 2
               + 2 * b * nk * tv * h * 2),
         nl * 4 * b * nq * h * (tv * ctx + tv * (tv + 1) // 2),
         equal=lambda i: cattn.verify_attention(qv, kc, vc, ks, vs, pos,
                                                layer=i, window=2048, **kwv),
         repeat=True)
    t4, off4 = 512, 512
    q4 = rand(1, t4, nq, h).bfloat16()
    fk4, fv4 = rand(nk, t4, h).bfloat16(), rand(nk, t4, h).bfloat16()
    kw4 = dict(fresh_k=fk4, fresh_v=fv4)
    mask4 = torch.cat([torch.ones((t4, off4), dtype=torch.bool, device=dev),
                       torch.ones((t4, t4), dtype=torch.bool,
                                  device=dev).tril()], dim=1)
    kd = [torch.cat([(kc[i, 3, :, :off4].float()
                      * ks[i, 3, :, :off4, None]).bfloat16(), fk4],
                    dim=1)[None] for i in range(nl)]
    vd = [torch.cat([(vc[i, 3, :, :off4].float()
                      * vs[i, 3, :, :off4, None]).bfloat16(), fv4],
                    dim=1)[None] for i in range(nl)]
    keys4 = t4 * off4 + t4 * (t4 + 1) // 2
    case("prefill_attention_paired", f"{nl} layers x [T={t4} at offset "
         f"{off4}, 24 q heads, 8 kv heads, head 128], one slot, paired int8 "
         "cache", csrc + "prefill_attention.cu",
         "gabby_tpu/ops/pallas/prefill_attention.py:142",
         lambda i: cpfa.prefill_attention(q4, kcp, vcp, ks, vs, 3, off4,
                                          layer=i, **kw4),
         lambda i: cpfa.prefill_attention_plain(q4, kcp, vcp, ks, vs, 3,
                                                off4, layer=i, **kw4),
         lambda i: sdpa(q4.transpose(1, 2), kd[i], vd[i], attn_mask=mask4,
                        enable_gqa=True),
         nl * (2 * nk * off4 * (h + 4) + 2 * t4 * nq * h * 2
               + 2 * nk * t4 * h * 2), nl * 4 * nq * h * keys4, iters=3,
         equal=lambda i: cpfa.prefill_attention(q4, kc, vc, ks, vs, 3, off4,
                                                layer=i, **kw4))
    del kc, vc, ks, vs, kcp, vcp, kd, vd
    # K1 at the 3B's four projections, one decode step (28 layers, M = 8)
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    stacked_case_into(results, g, nl, projections(cfg3),
                      "int4_matmul_stacked",
                      csrc + "quant_matmul_stacked.cu",
                      "gabby_tpu/ops/pallas/quant_matmul.py:424",
                      cqm.qmatmul_int4_stacked, cqm.int4_stacked_plain,
                      bits=4, m=b, what="one decode step", by_projection=True,
                      repeat=True)
    for r in results:
        emit({"phase": "kernels_h128", "model": "llama32_3b", **r})
    return results


# (configuration, head_dim, q heads, kv heads, layers, hidden, intermediate,
# vocab, rope_theta) of the benchmark's two configurations
PROLOGUE_MODELS = (
    ("smollm2-1.7b", 64, 32, 32, 24, 2048, 8192, 49152, 130000.0),
    ("mistral7b-v0.3", 128, 32, 8, 32, 4096, 14336, 32768, 1e6))


def step_ops(fn) -> dict:
    """The top-level aten ops that one call of fn issues (an op inside
    another op is not counted), split into those inside the products' and
    the attention's entries (`gabby.matmul`, `gabby.attn`: on the card a
    launch each, with the wrapper's allocations) and the rest: the glue
    the host issues between the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    glue = inside = 0
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        up, wrapped = e.cpu_parent, False
        while up is not None:
            if up.name.startswith("aten::"):
                break
            wrapped = wrapped or up.name in ("gabby.matmul", "gabby.attn")
            up = up.cpu_parent
        if up is None:
            inside += wrapped
            glue += not wrapped
    return {"glue": glue, "in_matmul_and_attn": inside}


def prologue_phase(dev, gpu_line: str) -> None:
    """K42, the decode layer's attention prologue, at the heads of the
    benchmark's two configurations: 64 slots, one layer of a 4096-row
    paired int8 cache of random rows, positions 0-4095 (the last row among
    them). The kernel against the eager chain it replaces
    (`decode_prologue_plain` on the card) by equality (q, fresh rows,
    codes, scales), timed eagerly and from a graph beside the eager chain,
    with its least time (bytes at 3.35 TB/s). Then one decode step of 64
    slots at the configuration's widths, 2 layers (int4 fused weights, the
    paired int8 cache, s8), through K42 and through the eager chain (the
    route turned off): equal logits, the top-level aten ops it issues
    (`step_ops`) and its host ms (10 steps issued, then one synchronize),
    each route in turn, twice."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.ops.cuda import decode_prologue as cprologue
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    b, s, layer = 64, 4096, 0
    for name, h, nq, nk, layers, hidden, inter, vocab, theta in \
            PROLOGUE_MODELS:
        cfg = cfglib.tiny(num_heads=nq, num_kv_heads=nk, head_dim=h,
                          hidden_size=hidden, intermediate_size=inter,
                          vocab_size=vocab, num_layers=2, rope_theta=theta,
                          max_seq_len=s)
        g = torch.Generator(device=dev).manual_seed(42)
        cache = create_cache(dataclasses.replace(cfg, num_layers=1), b, s,
                             quantized=True, paired=True, device=dev)
        for codes in (cache.k, cache.v):
            codes.copy_(torch.randint(-127, 128, codes.shape, generator=g,
                                      device=dev))
        for scales in (cache.k_scale, cache.v_scale):
            scales.copy_(torch.rand(scales.shape, generator=g, device=dev)
                         * 0.02 + 0.005)
        qkv = torch.randn((b, 1, (nq + 2 * nk) * h), generator=g,
                          device=dev).to(torch.bfloat16)
        positions = torch.randint(0, s, (b,), generator=g, device=dev,
                                  dtype=torch.int32)
        positions[0] = s - 1
        inv_freq = llama._inv_freq(cfg, dev)
        args = (qkv, positions, inv_freq, cache.k, cache.v, cache.k_scale,
                cache.v_scale)
        kw = dict(layer=layer, num_heads=nq, num_kv_heads=nk)
        tensors = [cache.k, cache.v, cache.k_scale, cache.v_scale]
        start = [x.clone() for x in tensors]
        got = cprologue.decode_prologue(*args, **kw)
        got_rows = [x.clone() for x in tensors]
        for x, x0 in zip(tensors, start):
            x.copy_(x0)
        want = cprologue.decode_prologue_plain(*args, **kw)
        torch.cuda.synchronize()
        for x, y in zip(list(got) + got_rows, list(want) + tensors):
            if not torch.equal(x, y):
                raise AssertionError(f"prologue ({name}): K42 differs from "
                                     f"the eager chain")
        nbytes = (2 * 2 * b * (nq + 2 * nk) * h + 4 * b + 2 * h
                  + 2 * b * nk * h + 2 * 4 * b * nk)
        emit({"phase": "prologue", "model": name, "kernel": "K42",
              "source": "csrc/decode_prologue.cu",
              "work": f"[{b}, 1, {(nq + 2 * nk) * h}] bf16 product, "
                      f"{nq}/{nk} heads of {h}, one layer of a {s}-row "
                      f"paired int8 cache",
              "equal_to_eager_chain": True,
              "ms": time_ms(lambda: cprologue.decode_prologue(*args, **kw),
                            200),
              "graph_ms": graph_ms(
                  lambda: cprologue.decode_prologue(*args, **kw), 200),
              "plain_ms": time_ms(
                  lambda: cprologue.decode_prologue_plain(*args, **kw), 50),
              "plain_graph_ms": graph_ms(
                  lambda: cprologue.decode_prologue_plain(*args, **kw), 50),
              **bound(nbytes, 0.0), "bytes": nbytes,
              "launches_a_step": layers, "card": gpu_line})
        del cache, start, got_rows, tensors, args
        torch.cuda.empty_cache()

        params = llama.fuse_projections(quant.quantize_tree(
            llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dtype=torch.bfloat16, device=dev),
            4, unembed_bits=4, unembed_group=256))
        step_cache = create_cache(cfg, b, s, quantized=True, paired=True,
                                  device=dev)
        tokens = torch.randint(2, vocab, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        positions = torch.randint(512, 1536, (b,), generator=g, device=dev,
                                  dtype=torch.int32)
        real = llama._prologue_kernel

        def route(fused):
            llama._prologue_kernel = real if fused else (lambda *a: False)

        def step():
            return llama.decode_step(params, cfg, tokens, positions,
                                     step_cache, window=2048)[0]

        def host_ms():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 100.0

        line = {"phase": "prologue", "model": name, "check": "one decode "
                "step, 64 slots, 2 layers, int4, paired int8 cache, s8"}
        try:
            logits = {}
            for fused in (True, False):
                route(fused)
                ck.reset_launch_counts()
                logits[fused] = step()
                torch.cuda.synchronize()
                line[f"launches_{'fused' if fused else 'eager'}"] = \
                    ck.launch_counts["decode_prologue"]
            line["logits_equal"] = torch.equal(logits[True], logits[False])
            for fused in (True, False, False, True):
                route(fused)
                key = "fused" if fused else "eager"
                line.setdefault(f"ops_{key}", step_ops(step))
                line.setdefault(f"host_ms_{key}", []).append(host_ms())
        finally:
            llama._prologue_kernel = real
        line["card"] = gpu_line
        emit(line)
        if not (line["logits_equal"] and line["launches_fused"] == 2
                and line["launches_eager"] == 0):
            raise AssertionError(f"prologue ({name}): {line}")
        del params, step_cache
        torch.cuda.empty_cache()


def to_cpu(tree):
    """A params tree copied to the CPU."""
    from gabby_tpu_torch.ops.quant import QTensor

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.to("cpu")
    return None if tree is None else tree.cpu()


def model_phase(cfg, params, dev, label: str, tol: float = 0.05, *,
                kv_quantized: bool = True, paired: bool = False,
                rawdot: bool = False):
    """The card's forward (kernels) against the CPU's (plain versions) on
    the same weights: a 16-token prefill, then 3 greedy decode steps, on
    the unpaired int8 cache with the bf16/f32 form of decode attention (the
    paired layout and the s8 form are held against these on the card, in
    `steps_model_phase`), or on the cache `kv_quantized` and `paired` ask
    for; with `rawdot` the stacked int4 products (prefill and decode: M <=
    64) take the raw-byte-dot form on both sides. `tol` bounds the largest
    logit difference relative to the largest logit."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    cpu_params = to_cpu(params)
    caches = {key: create_cache(cfg, 1, 64, quantized=kv_quantized,
                                paired=paired, device=dv)
              for key, dv in (("card", dev), ("cpu", "cpu"))}
    ps = {"card": params, "cpu": cpu_params}
    ids = torch.arange(16) * 7919 % 128000 + 100
    logits = {}
    ck.set_attn_s8(False)
    ck.set_int4_rawdot(rawdot)
    try:
        for key, dv in (("card", dev), ("cpu", "cpu")):
            logits[key], _ = llama.prefill_slot(ps[key], cfg, ids.to(dv), 16,
                                                0, 0, caches[key])
        worst, agree, steps = 0.0, 0, 4
        for step in range(steps):
            a, r = logits["card"].float().cpu(), logits["cpu"].float()
            if not torch.isfinite(a).all() or a.shape != (cfg.vocab_size,):
                raise AssertionError("model: bad logits")
            worst = max(worst,
                        (a - r).abs().max().item() / r.abs().max().item())
            agree += int(a.argmax() == r.argmax())
            if step == steps - 1:
                break
            tok = a.argmax().reshape(1).to(torch.int32)
            pos = torch.tensor([16 + step], dtype=torch.int32)
            for key, dv in (("card", dev), ("cpu", "cpu")):
                logits[key], _ = llama.decode_step(
                    ps[key], cfg, tok.to(dv), pos.to(dv), caches[key])
                logits[key] = logits[key][0]
    finally:
        ck.set_attn_s8(None)
        ck.set_int4_rawdot(None)
    emit({"phase": "model", "weights": label, "steps": steps,
          "kv_quantized": kv_quantized, "paired": paired, "rawdot": rawdot,
          "argmax_agree": agree, "max_rel_logit_err": worst})
    # bf16 activations through 16 layers on the card vs the CPU's bf16
    # rounding in other places: a few percent of the logit range
    if worst > tol or agree < steps - 1:
        raise AssertionError(f"model ({label}): card and CPU disagree "
                             f"({worst}, {agree}/{steps} argmax)")


def card_steps(cfg, params, dev, *, paired: bool, s8: bool, fed=None):
    """On the card: eight `decode_step`s after a 16-token prefill, on the
    dense cache and on the paged one (pages of 512 rows behind a scattered
    table), then ONE `verify_step` over the eight tokens those steps were
    fed, from the caches as the prefill left them, dense and paged. Lane 1
    is parked, as the engine parks a free slot. `fed` None: the steps are
    greedy on the dense logits and the tokens fed come back; else `fed` is
    fed again, so that two layouts or two forms see the same tokens.
    Returns ({name: [8, V] logits}, fed)."""
    import copy

    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.runtime.paged import create_paged_cache

    n, steps, page = 16, 8, 512
    caches = {"dense": create_cache(cfg, 2, 2048, quantized=True,
                                    paired=paired, device=dev),
              "paged": create_paged_cache(cfg, 2, 2048, 9, quantized=True,
                                          page_size=page, paired=paired,
                                          device=dev)}
    caches["paged"].page_table.copy_(torch.tensor(
        [[5, 2, 7, 1], [3, 8, 4, 6]], dtype=torch.int32))
    ids = (torch.arange(n) * 7919 % 128000 + 100).to(dev)
    park = torch.tensor([0, 2047], dtype=torch.int32, device=dev)
    read = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    lane0 = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    out = {}
    ck.set_attn_s8(s8)
    try:
        first = {}
        for kind, bucket in (("dense", n), ("paged", page)):
            chunk = torch.zeros(bucket, dtype=torch.int64, device=dev)
            chunk[:n] = ids
            first[kind], _ = llama.prefill_slot(params, cfg, chunk, n, 0, 0,
                                                caches[kind])
        after_prefill = copy.deepcopy(caches)
        greedy = fed is None
        fed = [int(first["dense"].argmax())] if greedy else list(fed)
        seq = {"dense": [], "paged": []}
        for step in range(steps):
            tok = torch.tensor([fed[step], 0], dtype=torch.int32, device=dev)
            pos = park + lane0 * (n + step)
            for kind in seq:
                lg, _ = llama.decode_step(
                    params, cfg, tok, pos, caches[kind],
                    attn_positions=read + lane0 * (n + step))
                seq[kind].append(lg[0].float())
            if greedy:
                fed.append(int(seq["dense"][-1].argmax()))
        tokens_bt = torch.tensor([fed[:steps], [0] * steps],
                                 dtype=torch.int32, device=dev)
        for kind in seq:
            lg, _ = llama.verify_step(params, cfg, tokens_bt, park + lane0 * n,
                                      after_prefill[kind],
                                      attn_positions=read + lane0 * n)
            out[kind + " verify_step"] = lg[0].float()
            out[kind + " decode_step"] = torch.stack(seq[kind])
    finally:
        ck.set_attn_s8(None)
    torch.cuda.synchronize()
    return out, fed[:steps]


def compare_steps(cfg, what: str, got, want, tol: float) -> dict:
    """`got` [8, V] against `want`: `tol` bounds the largest logit
    difference relative to the largest logit; a step passes when the argmax
    agrees or the token chosen is within 2 * tol of the best in `want`
    (each side may be off by tol: with random weights the two best logits
    are sometimes a near-tie). Returns the line it printed."""
    steps = want.shape[0]
    if got.shape != (steps, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"model ({what}): bad logits")
    top = want.abs().max()
    worst = ((got - want).abs().max() / top).item()
    chosen = got.argmax(-1, keepdim=True)
    gap = (want.max(-1).values - want.gather(1, chosen)[:, 0]) / top
    agree = int((gap == 0).sum())
    ties = int(((gap > 0) & (gap <= 2 * tol)).sum())
    line = {"phase": "model", "check": what, "steps": steps,
            "argmax_agree": agree, "near_ties": ties,
            "max_rel_logit_err": worst, "bound": tol}
    emit(line)
    if worst > tol or agree + ties < steps:
        raise AssertionError(f"model ({what}): disagrees ({worst}, "
                             f"{agree}/{steps} argmax, {ties} near-ties)")
    return line


def steps_model_phase(cfg, params, dev, tol: float = 0.05):
    """`card_steps` three times. Unpaired, bf16/f32 form (K3, K10, K9,
    K11): the paged logits and both verify passes against the dense
    sequential ones; the kernels reassociate sums and the verify matmuls
    run at M = 16 instead of M = 2, hence `tol`. Paired, bf16/f32 form
    (K12, K17, K13, K18, K21), fed the same tokens: each of the four
    against its unpaired counterpart, same `tol` (each paired kernel is
    its unpaired kernel's body). Paired with the s8 form on (K15, K20):
    the two decode paths against the paired bf16/f32 ones at 2 * tol,
    since s8 rounds q and the probabilities to 1/127 of their row's range
    in every layer, as W4A8 rounds activations."""
    base, fed = card_steps(cfg, params, dev, paired=False, s8=False)
    want = base["dense decode_step"]
    for name in ("paged decode_step", "dense verify_step",
                 "paged verify_step"):
        compare_steps(cfg, f"{name} vs dense sequential decode", base[name],
                      want, tol)
    paired, _ = card_steps(cfg, params, dev, paired=True, s8=False, fed=fed)
    for name, got in paired.items():
        compare_steps(cfg, f"paired {name} vs unpaired", got, base[name], tol)
    s8, _ = card_steps(cfg, params, dev, paired=True, s8=True, fed=fed)
    for name in ("dense decode_step", "paged decode_step"):
        compare_steps(cfg, f"paired s8 {name} vs paired bf16/f32 form",
                      s8[name], paired[name], 2 * tol)


ADMIT_TOL = 0.05  # the model phase's bound on the largest logit difference
# a first greedy token that differs passes only as a near-tie, its logit in
# `want` within this share of the largest logit of the best one (the widest
# gap measured on the H100 is 0.0065, a dense row copy against a cold
# prefill). It is fixed, not 2 * ADMIT_TOL: every row within ADMIT_TOL has
# its chosen token within 2 * ADMIT_TOL of the best
TIE_BAND = 0.01


def stream(i: int, n: int, vocab: int) -> list:
    """n token ids of a deterministic stream; distinct i, distinct
    streams from the first token on."""
    return [(i * 7919 + j * 104729) % (vocab - 16) + 1 for j in range(n)]


def compare_logits(what: str, got, want, tol: float = ADMIT_TOL) -> dict:
    """Logits [rows, V] of one path against another's for the same
    prompts: the largest difference relative to the largest logit within
    `tol`, and each row's first greedy token equal (an exact tie in `want`
    counts as equal), or within TIE_BAND of the best logit of `want` (a
    near-tie of random weights, which bf16 on two paths can flip); each
    near-tie's gap is printed."""
    got, want = got.float().cpu().reshape(-1, got.shape[-1]), \
        want.float().cpu().reshape(-1, want.shape[-1])
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"admission ({what}): bad logits")
    top = want.abs().max()
    worst = ((got - want).abs().max() / top).item()
    gap = ((want.max(-1).values
            - want.gather(1, got.argmax(-1, keepdim=True))[:, 0]) / top)
    agree = int((gap == 0).sum())
    ties = [g for g in gap.tolist() if 0 < g <= TIE_BAND]
    line = {"phase": "admission", "check": what, "rows": got.shape[0],
            "max_rel_logit_err": worst, "bound": tol,
            "first_token_agree": agree, "near_tie_gaps": ties,
            "tie_band": TIE_BAND}
    emit(line)
    if worst > tol or agree + len(ties) < got.shape[0]:
        raise AssertionError(f"admission ({what}): disagrees ({worst}, "
                             f"{agree}/{got.shape[0]} first tokens, "
                             f"near-ties {ties})")
    return line


def prefill_alone(params, cfg, cache, ids, slot, sched):
    """`ids` prefilled into one slot chunk by chunk (`sched` its (offset,
    bucket) chunks), as a single admission does; returns the last chunk's
    logits."""
    from gabby_tpu_torch.models import llama

    dev = cache.k.device
    logits = None
    for off, bucket in sched:
        take = min(bucket, len(ids) - off)
        chunk = torch.zeros(bucket, dtype=torch.int64)
        chunk[:take] = torch.tensor(ids[off:off + take])
        logits, _ = llama.prefill_slot(params, cfg, chunk.to(dev), take,
                                       slot, off, cache)
    return logits


def admit_alone(eng, slot: int, ids) -> tuple:
    """`ids` admitted into `slot` of a stopped engine through its single
    admission: `_find_donor` and `_start_admission` (which copies or adopts
    the resident donor's prefix), `_prefill_one_chunk` until the prompt is in,
    `_finish_admission` (which registers the prompt as a donor). Returns
    (the offset the prefill started at, the last chunk's logits)."""
    from gabby_tpu_torch.runtime.engine import Request

    adm = eng._start_admission(slot, Request(
        prompt_ids=list(ids), max_tokens=1, temperature=0.0, top_k=0,
        top_p=1.0), *eng._find_donor(list(ids)))
    start = adm.offset
    while not eng._prefill_one_chunk(adm):
        pass
    eng._finish_admission(adm)
    return start, adm.last_logits


def admission_model_checks(cfg, params, tok, dev, paged: bool, burst,
                           prefix, hit) -> dict:
    """(c) and (d) of the admission phase in the server's default
    configuration (8 slots, 2048 rows, paired int8; dense, or 33 pages of
    512), s8 on: `prefill_batch_chunk` over the burst's prompts in lanes
    0-5 against `prefill_slot` of each prompt alone; then, on an engine
    whose loop is stopped (`admit_alone`), `prefix` admitted into slot 0
    and `hit` into slot 1, which must start past their common prefix
    (dense: the donor's rows copied by `copy_slot_prefix`; paged: its
    whole prefix pages shared, each then held twice), against `hit`
    admitted cold into a second such engine. The burst's launches are
    counted apart: the unembed of its [8, 1, D] last rows must reach K2,
    its projections (M = 8 x 512) must not reach K1, and no attention
    kernel may launch (the batched attention is the plain
    `causal_attention`, as in the reference); the suffix prefill must
    reach K21. Returns the counts."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime import generate
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.runtime.paged import create_paged_cache

    b, s, page = 8, 2048, 512
    if paged:
        def fresh():
            c = create_paged_cache(cfg, b, s, 33, quantized=True,
                                   page_size=page, paired=True, device=dev)
            c.page_table.copy_(torch.arange(1, 33, dtype=torch.int32)
                               .reshape(b, 4))
            return c
        sched = ((0, 512), (512, 512))
        common = page
    else:
        def fresh():
            return create_cache(cfg, b, s, quantized=True, paired=True,
                                device=dev)
        sched = ((0, 512), (512, 64))
        common = (len(prefix) // 16) * 16
    config = EngineConfig(batch_slots=b, max_seq=s, kv_quantized=True,
                          pair_kv_heads=True,
                          **(dict(paged_pages=33, page_size=page)
                             if paged else {}))

    def stopped():
        eng = Engine(cfg, params, tok, config, device=dev)
        eng.shutdown()  # its loop ends; `admit_alone` drives the admission
        return eng

    label = "33 pages of 512" if paged else "dense"
    out = {}
    ck.set_attn_s8(True)
    try:
        cache = fresh()
        n = len(burst)
        lengths = torch.ones(b, dtype=torch.int32)
        mask = torch.zeros(b, dtype=torch.bool)
        lengths[:n] = torch.tensor([len(p) for p in burst])
        mask[:n] = True
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        for off, bucket in sched:
            chunk = torch.zeros((b, bucket), dtype=torch.int64)
            for lane, p in enumerate(burst):
                take = min(bucket, len(p) - off)
                chunk[lane, :take] = torch.tensor(p[off:off + take])
            logits, _ = generate.prefill_batch_chunk(
                params, cfg, chunk.to(dev), lengths.to(dev), mask.to(dev),
                cache, off)
        torch.cuda.synchronize()
        out["burst"] = dict(ck.launch_counts)
        alone = fresh()
        singles = torch.stack([
            prefill_alone(params, cfg, alone, p, lane, sched)
            for lane, p in enumerate(burst)])
        compare_logits(f"{label}: prefill_batch_chunk vs prefill_slot "
                       f"alone, {n} prompts", logits[:n], singles)
        del cache, alone

        eng = stopped()
        admit_alone(eng, 0, prefix)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        start, warm = admit_alone(eng, 1, hit)
        torch.cuda.synchronize()
        out["suffix"] = dict(ck.launch_counts)
        if start != common:
            raise AssertionError(f"admission ({label}): the hit started at "
                                 f"{start}, not past {common} tokens")
        if paged:
            held = eng._slot_pages[1][:common // page]
            if (held != eng._slot_pages[0][:common // page]
                    or any(eng._alloc.refs[p] != 2 for p in held)):
                raise AssertionError(f"admission ({label}): pages "
                                     f"{eng._slot_pages[:2]} not shared")
        del eng
        cold_start, cold = admit_alone(stopped(), 0, hit)
        if cold_start:
            raise AssertionError(f"admission ({label}): the cold admission "
                                 f"found a donor")
        compare_logits(f"{label}: {'adopted pages' if paged else 'copy_slot_prefix'}"
                       f" + suffix prefill from {common} vs cold admission",
                       warm, cold)
    finally:
        ck.set_attn_s8(None)
    burst_counts, suffix_counts = out["burst"], out["suffix"]
    stray = [k for k, v in burst_counts.items() if v and "attention" in k]
    if (burst_counts["int4_matmul_grouped"] == 0
            or burst_counts["int4_matmul_stacked"] or stray
            or suffix_counts["prefill_attention_paired"] == 0):
        raise AssertionError(f"admission ({label}): launches {out}")
    emit({"phase": "admission", "cache": label,
          "burst_launches": {k: v for k, v in burst_counts.items() if v},
          "suffix_launches": {k: v for k, v in suffix_counts.items() if v}})
    return out


def admission_engine_run(cfg, params, tok, dev, gpu_line, label, burst,
                         prefix, hits, min_reused, **engine_kw):
    """(a) and (b) through the engine in the server's default configuration
    (8 slots, max_seq 2048, paired int8 cache, s8 on), launch counts set to
    0 just before and read just after: the burst prompts submitted
    together into the idle engine, 32 new tokens each, which must take at
    least 2 burst admissions; then `prefix` served to completion and the
    `hits` submitted together, which must all be prefix hits reusing at
    least `min_reused` tokens in all. On the paged cache the pool's pages
    must add up after the drain. Then the burst prompts are served one at
    a time on a fresh engine, and how many of their token streams equal
    the burst's is printed, not required."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig

    def drain(reqs):
        for req in reqs:
            while True:
                _, fin = req.out.get(timeout=600)
                if fin is not None:
                    break
            if fin not in ("length", "stop"):
                raise AssertionError(f"admission ({label}): request "
                                     f"finished {fin}")
        return [list(r.token_ids) for r in reqs]

    def ttft_p50(reqs):
        return statistics.median(
            (r.first_token_ts - r.submit_ts) * 1e3 for r in reqs)

    config = EngineConfig(batch_slots=8, max_seq=2048, kv_quantized=True,
                          pair_kv_heads=True, **engine_kw)
    ck.set_attn_s8(True)
    eng = Engine(cfg, params, tok, config, device=dev)
    try:
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        wave = [eng.submit_ids(p, max_tokens=NEW_TOKENS) for p in burst]
        texts = drain(wave)
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        mid = eng.stats_snapshot()
        t0 = time.perf_counter()
        donor = eng.submit_ids(prefix, max_tokens=NEW_TOKENS)
        drain([donor])
        hit_reqs = [eng.submit_ids(p, max_tokens=NEW_TOKENS) for p in hits]
        drain(hit_reqs)
        torch.cuda.synchronize()
        prefix_s = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
        stats = eng.stats_snapshot()
    finally:
        eng.shutdown()
    pool = None
    if eng._paged:
        held = collections.Counter(p for pages in eng._slot_pages
                                   for p in pages)
        pool = {"available": eng._alloc.available(),
                "resident": len(held), "pages": len(eng._alloc.refs)}
        if (any(eng._alloc.refs[p] != k for p, k in held.items())
                or pool["available"] + len(held) != pool["pages"] - 1):
            raise AssertionError(f"admission ({label}): the pool does not "
                                 f"add up: {pool}")
    eng = Engine(cfg, params, tok, config, device=dev)
    try:
        solo = [drain([eng.submit_ids(p, max_tokens=NEW_TOKENS)])[0]
                for p in burst]
    finally:
        eng.shutdown()
        ck.set_attn_s8(None)
    line = {"phase": "admission", "engine": label,
            "burst_prompt_tokens": [len(p) for p in burst],
            "burst_admissions": mid["burst_admissions"],
            "burst_ttft_p50_ms": ttft_p50(wave), "burst_wall_s": burst_s,
            "burst_texts_equal_to_alone": sum(
                a == b for a, b in zip(texts, solo)),
            "prefix_tokens": len(prefix),
            "hit_prompt_tokens": [len(p) for p in hits],
            "prefix_hits": stats["prefix_hits"],
            "prefix_tokens_reused": stats["prefix_tokens_reused"],
            "prefix_ttft_p50_ms": ttft_p50(hit_reqs),
            "prefix_wall_s": prefix_s, "pool": pool,
            "launches": {k: v for k, v in counts.items() if v},
            "card": gpu_line}
    emit(line)
    must = ["int4_matmul_stacked", "int4_matmul_grouped",
            "prefill_attention_paired",
            "paged_decode_attention_s8_paired" if eng._paged
            else "decode_attention_s8_paired"]
    stray = [k for k, v in counts.items()
             if v and "attention" in k and k not in must]
    if (mid["burst_admissions"] < 2 or stats["prefix_hits"] < len(hits)
            or stats["prefix_tokens_reused"] < min_reused
            or any(counts[k] == 0 for k in must) or stray):
        raise AssertionError(f"admission ({label}): {line}")


def admission_phase(cfg, params, dev, gpu_line: str) -> None:
    """Burst admission and prefix reuse on the 1B int4 model at full width
    and depth, in the server's default configuration, dense and over 33
    pages of 512: six distinct prompts of 530-570 tokens (on the dense
    cache the chunks (0, 512), (512, 64); on the paged one (0, 512),
    (512, 512)) and a 700-token prompt followed by three with its prefix
    and distinct 40-token suffixes. Model level first (`admission_model_
    checks`), then the engine (`admission_engine_run`)."""
    from gabby_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    v = cfg.vocab_size
    burst = [stream(100 + i, 530 + 8 * i, v) for i in range(6)]
    prefix = stream(200, 700, v)
    hits = [prefix + stream(300 + k, 40, v) for k in range(3)]
    tok = Tokenizer.byte_fallback(v)
    for paged, label, kw, reused in (
            (False, "paired, s8; dense", {}, 3 * 688),
            (True, "paired, s8; 33 pages of 512",
             dict(paged_pages=33, page_size=512), 3 * 512)):
        admission_model_checks(cfg, params, tok, dev, paged, burst, prefix,
                               hits[0])
        torch.cuda.empty_cache()
        admission_engine_run(cfg, params, tok, dev, gpu_line, label, burst,
                             prefix, hits, reused, **kw)
        torch.cuda.empty_cache()
    emit({"phase": "admission", "seconds": time.perf_counter() - t0})


# ---- request features: penalties and logit_bias, logprobs and
# top_logprobs, the per-request seed --------------------------------------

FEATURE_TOL = 1e-5  # relative: the card's f32 elementwise work vs the CPU's
# per decode step of the 1B model: four stacked projections a layer (K1),
# one unembed (K2), one s8 paired decode attention a layer (K15)
STEP_LAUNCHES = {"int4_matmul_stacked": 64, "int4_matmul_grouped": 1,
                 "decode_attention_s8_paired": 16, "decode_prologue": 16}
FEATURE_WINDOW = 1024  # the engine's attention window below 990 live rows


def feature_check(line: dict, ok: bool) -> None:
    """One line per check of the request-features phase; a failed check
    fails the run."""
    line = {"phase": "features", **line, "ok": bool(ok)}
    emit(line)
    if not ok:
        raise AssertionError(f"features: {line}")


def rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def step_launches(counts: dict, steps: int) -> dict:
    """Each kernel of STEP_LAUNCHES's launches a decode step."""
    return {k: counts[k] / steps for k in STEP_LAUNCHES}


def feature_function_checks(cfg, params, dev) -> None:
    """apply_penalties, penalize_row, token_logprob, top_candidates and the
    seeded draw on the card's own decode logits ([8, V] f32 from one
    `decode_step` of 8 prefilled slots, paired int8 cache, s8) against the
    same functions on the CPU on those logits: FEATURE_TOL relative, top
    ids equal except at exact ties, the seeded tokens equal."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import sampling
    from gabby_tpu_torch.runtime import generate

    b, v = 8, cfg.vocab_size
    ck.set_attn_s8(True)
    try:
        cache, first, positions = eight_slots(cfg, params, dev, 400)
        logits, _ = llama.decode_step(params, cfg, first, positions, cache,
                                      window=FEATURE_WINDOW)
    finally:
        ck.set_attn_s8(None)
    lens = positions.tolist()
    logits = logits.float()
    host = logits.cpu()
    g = torch.Generator().manual_seed(16)
    bias = torch.zeros((b, v))
    cols = torch.randint(0, v, (b, 300), generator=g)
    bias.scatter_(1, cols, torch.rand((b, 300), generator=g) * 200 - 100)
    state = dict(
        counts=(torch.randint(1, 4, (b, v), generator=g, dtype=torch.int32)
                * (torch.rand((b, v), generator=g) < 1e-3)).to(torch.int32),
        presence=torch.rand(b, generator=g) * 4 - 2,
        frequency=torch.rand(b, generator=g) * 4 - 2, bias=bias,
        rep=torch.rand(b, generator=g) * 2 + 0.5,
        prompt_mask=torch.rand((b, v), generator=g) < 2e-3)
    cpu_state = generate.PenaltyState(**state)
    card_state = generate.PenaltyState(**{k: t.to(dev)
                                          for k, t in state.items()})
    adj = generate.apply_penalties(logits, card_state)
    host_adj = generate.apply_penalties(host, cpu_state)
    err = rel_err(adj, host_adj)
    feature_check({"check": "apply_penalties, card vs CPU",
                   "max_rel_err": err, "bound": FEATURE_TOL},
                  err <= FEATURE_TOL)
    row = 3
    rows = [state[k][row] for k in ("counts", "presence", "frequency",
                                    "bias", "rep", "prompt_mask")]
    got = generate.penalize_row(logits[row], rows[0].to(dev),
                                float(rows[1]), float(rows[2]),
                                rows[3].to(dev), float(rows[4]),
                                rows[5].to(dev))
    want = generate.penalize_row(host[row], rows[0], float(rows[1]),
                                 float(rows[2]), rows[3], float(rows[4]),
                                 rows[5])
    err = rel_err(got, want)
    feature_check({"check": "penalize_row, card vs CPU",
                   "max_rel_err": err, "bound": FEATURE_TOL},
                  err <= FEATURE_TOL and rel_err(got, host_adj[row]) <=
                  FEATURE_TOL)
    ids = torch.cat([host_adj.argmax(-1, keepdim=True),
                     torch.randint(0, v, (b, 4), generator=g)], dim=1)
    err = rel_err(
        generate.token_logprob(adj[:, None].expand(-1, 5, -1), ids.to(dev)),
        generate.token_logprob(host_adj[:, None].expand(-1, 5, -1), ids))
    feature_check({"check": "token_logprob, card vs CPU",
                   "max_rel_err": err, "bound": FEATURE_TOL},
                  err <= FEATURE_TOL)
    t_lp, t_ids = generate.top_candidates(adj, 20)
    h_lp, h_ids = generate.top_candidates(host_adj, 20)
    t_ids = t_ids.cpu()
    differ = (t_ids != h_ids).nonzero().tolist()
    adj_host = adj.cpu()
    ties = [(r, c) for r, c in differ
            if host_adj[r, t_ids[r, c]] == host_adj[r, h_ids[r, c]]
            or adj_host[r, t_ids[r, c]] == adj_host[r, h_ids[r, c]]]
    err = rel_err(t_lp, h_lp)
    feature_check({"check": "top_candidates(20), card vs CPU",
                   "max_rel_err": err, "bound": FEATURE_TOL,
                   "ids_differ": len(differ), "exact_ties": len(ties)},
                  err <= FEATURE_TOL and len(ties) == len(differ))
    # the seeded draw: integer hashing on both, the same adjusted logits
    kw = dict(temperature=torch.full((b,), 0.8),
              top_k=torch.tensor([0, 0, 40, 40, 0, 0, 5, 0]),
              top_p=torch.tensor([1.0, 0.9] * 4),
              lane_seeds=torch.tensor([0, 1, 7, 2 ** 31 - 1, 42, 42, 9, 3]),
              lane_positions=torch.tensor(lens) + 1000)
    card = sampling.sample(adj, torch.Generator(device=dev).manual_seed(0),
                           **{k: t.to(dev) for k, t in kw.items()})
    cpu = sampling.sample(adj_host, torch.Generator().manual_seed(0), **kw)
    feature_check({"check": "seeded draw, card vs CPU",
                   "tokens": card.tolist()},
                  torch.equal(card.cpu(), cpu))


def serve_all(reqs) -> None:
    for req in reqs:
        while True:
            _, fin = req.out.get(timeout=600)
            if fin is not None:
                break
        if fin not in ("length", "stop"):
            raise AssertionError(f"features: a request finished {fin}")


def wait_first_token(req) -> None:
    end = time.monotonic() + 300
    while not req.token_ids:
        if time.monotonic() > end:
            raise AssertionError("features: no first token")
        time.sleep(0.002)


def replay_penalized(cfg, params, tok, dev, ids, got, kw) -> None:
    """The penalized stream `got` of prompt `ids` (slot 0 of an engine run)
    replayed on a stopped engine of the same configuration: the prompt
    admitted into slot 0 by the engine's own single admission (its first
    token from the penalty-adjusted prefill row, counted), then
    `decode_loop` one step at a time with the engine's PenaltyState and
    the run's window, fed the run's tokens. Each step must choose the
    run's token, or one within TIE_BAND of the best adjusted logit (the
    gap measured by a `decode_step` at the same row). The replay's
    launches a step, and those of 4 steps with the features off (no
    PenaltyState, n_top 0), must be STEP_LAUNCHES."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime import generate
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, params, tok, EngineConfig(
        batch_slots=8, max_seq=2048, kv_quantized=True, pair_kv_heads=True),
        device=dev)
    eng.shutdown()
    adm = eng._start_admission(0, Request(
        prompt_ids=list(ids), max_tokens=len(got), temperature=0.0, top_k=0,
        top_p=1.0, **kw), *eng._find_donor(list(ids)))
    while not eng._prefill_one_chunk(adm):
        pass
    eng._finish_admission(adm)
    near = []

    def settle(step, chose, row_logits):
        """The run's token where the replay chose another: a near-tie or a
        failure; the counts and the fed token follow the run."""
        want = got[step]
        if chose == want:
            return
        top = row_logits.abs().max()
        gap = ((row_logits.max() - row_logits[want]) / top).item()
        near.append({"step": step, "gap": gap})
        if gap > TIE_BAND:
            raise AssertionError(f"features: the penalized replay chose "
                                 f"{chose} at step {step}, the run {want} "
                                 f"(gap {gap})")
        eng._pstate.counts[0, chose] -= 1
        eng._pstate.counts[0, want] += 1
        eng._tokens[0] = want

    settle(0, int(eng._tokens[0]), adm.last_logits.float())
    totals = collections.Counter()
    for step in range(1, len(got)):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        pos = eng._positions.clone()
        tok_in = eng._tokens.clone()
        out, _, _, eng._tokens, eng._positions, eng._active, _, _ = \
            generate.decode_loop(params, cfg, eng._tokens, eng._positions,
                                 eng._active, eng._cache, eng._sstate, 1,
                                 eos_ids=eng._eos_ids, window=FEATURE_WINDOW,
                                 n_top=5, pstate=eng._pstate)
        torch.cuda.synchronize()
        totals.update(ck.launch_counts)
        chose = int(out[0, 0])
        if chose != got[step]:
            # the step's adjusted logits, before its own count
            eng._pstate.counts[0, chose] -= 1
            row, _ = llama.decode_step(params, cfg, tok_in, pos, eng._cache,
                                       window=FEATURE_WINDOW)
            row = generate.apply_penalties(row.float(), eng._pstate)[0]
            eng._pstate.counts[0, chose] += 1
            settle(step, chose, row)
    steps = len(got) - 1
    on = step_launches(totals, steps)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    generate.decode_loop(params, cfg, eng._tokens, eng._positions,
                         eng._active, eng._cache, eng._sstate, 4,
                         eos_ids=eng._eos_ids, window=FEATURE_WINDOW)
    torch.cuda.synchronize()
    off = step_launches(ck.launch_counts, 4)
    feature_check({"check": "penalized stream = decode_loop replay, one "
                   "step at a time, same slot and PenaltyState",
                   "tokens": len(got), "near_ties": near,
                   "tie_band": TIE_BAND}, True)
    feature_check({"check": "launches a decode step, features on (penalties"
                   ", n_top 5) and off", "on": on, "off": off,
                   "want": STEP_LAUNCHES},
                  on == off == {k: float(n) for k, n
                                in STEP_LAUNCHES.items()})


def top_rows_check(label: str, reqs) -> None:
    """Every token, the first included, carries the request's k rows,
    sorted and all <= 0, headed (greedy) by the token itself within 1e-3
    of its token_logprobs entry, or by another id of exactly the token's
    logprob: the bf16 logits of random weights tie exactly, and the argmax
    and the top-k may then pick different ids (counted)."""
    bad, ties = [], 0
    for r in reqs:
        if len(r.token_top) != len(r.token_ids) or not r.token_ids:
            bad.append(("rows", len(r.token_top), len(r.token_ids)))
        for i, (tid, lp, row) in enumerate(zip(r.token_ids, r.token_logprobs,
                                               r.token_top)):
            xs = [x for _, x in row]
            tie = row[0][0] != tid and row[0][1] == lp
            ties += tie
            if (len(row) != r.top_logprobs or xs != sorted(xs, reverse=True)
                    or xs[0] > 0 or (row[0][0] != tid and not tie)
                    or abs(row[0][1] - lp) > 1e-3):
                bad.append((r.top_logprobs, i, tid, lp, row[:2]))
    feature_check({"check": f"top_logprobs rows ({label})",
                   "ks": [r.top_logprobs for r in reqs],
                   "tokens": [len(r.token_ids) for r in reqs],
                   "heads_tied_exactly": ties, "bad": bad[:4]}, not bad)


def features_phase(cfg, params, dev, gpu_line: str) -> None:
    """Penalties and logit_bias, logprobs and top_logprobs, and the
    per-request seed on the 1B int4 model at full width and depth, in the
    server's default configuration (8 slots, max_seq 2048, paired int8
    cache, s8): the functions on the card against the CPU
    (`feature_function_checks`), then the engine: a forcing logit_bias; a
    penalized request beside 7 plain ones against its `decode_loop` replay
    (`replay_penalized`); top_logprobs 1, 5 and 20 on the plain loop and
    with speculation 7; a seeded request alone and beside 7 unseeded
    neighbours, and three seeds; then the ten chat requests without and
    with a penalized and a top_logprobs request, in turns, ms a decode
    step."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    v = cfg.vocab_size
    tok = Tokenizer.byte_fallback(v)
    feature_function_checks(cfg, params, dev)
    torch.cuda.empty_cache()
    default = dict(batch_slots=8, max_seq=2048, kv_quantized=True,
                   pair_kv_heads=True)

    def engine(**kw):
        return Engine(cfg, params, tok, EngineConfig(**default, **kw),
                      device=dev)

    def window_line(label, eng, stats0, counts):
        steps = eng.stats_snapshot()["decode_steps"] - stats0["decode_steps"]
        emit({"phase": "features", "window": label, "decode_steps": steps,
              "launches": {k: counts[k] for k in STEP_LAUNCHES},
              "launches_a_step_with_prefill": step_launches(counts, steps)})

    ck.set_attn_s8(True)
    try:
        # logit_bias: a +100 bias forces its token from the first on
        forced = 12345
        eng = engine()
        try:
            req = eng.submit_ids(stream(500, 100, v), max_tokens=16,
                                 logit_bias={forced: 100.0})
            serve_all([req])
        finally:
            eng.shutdown()
        feature_check({"check": "logit_bias {%d: 100}, greedy" % forced,
                       "tokens": req.token_ids},
                      req.token_ids == [forced] * 16)

        # penalties: a greedy penalized request in slot 0 beside 7 plain
        pen_kw = dict(presence_penalty=1.5, frequency_penalty=1.2,
                      repetition_penalty=1.3)
        pen_ids = stream(510, 120, v)
        eng = engine()
        try:
            ck.reset_launch_counts()
            stats0 = eng.stats_snapshot()
            pen = eng.submit_ids(pen_ids, max_tokens=NEW_TOKENS, **pen_kw)
            wait_first_token(pen)
            plain = [eng.submit_ids(stream(520 + i, 60 + 20 * i, v),
                                    max_tokens=NEW_TOKENS) for i in range(7)]
            serve_all([pen] + plain)
            torch.cuda.synchronize()
            window_line("penalized + 7 plain", eng, stats0,
                        dict(ck.launch_counts))
            if eng._pstate is not None:
                raise AssertionError("features: the PenaltyState outlived "
                                     "its request")
        finally:
            eng.shutdown()
        replay_penalized(cfg, params, tok, dev, pen_ids, pen.token_ids,
                         pen_kw)
        torch.cuda.empty_cache()

        # top_logprobs on the plain loop and with speculation
        keep_spec = dict(speculate_tokens=7, spec_auto_breakeven=False,
                         spec_breakeven=1.0)
        for label, kw in (("plain", {}), ("speculate 7", keep_spec)):
            eng = engine(**kw)
            try:
                ck.reset_launch_counts()
                stats0 = eng.stats_snapshot()
                reqs = [eng.submit_ids(stream(600 + i, 50 + 40 * i, v),
                                       max_tokens=NEW_TOKENS,
                                       top_logprobs=k)
                        for i, k in enumerate((1, 5, 20, 5, 1))]
                serve_all(reqs)
                torch.cuda.synchronize()
                window_line(f"top_logprobs, {label}", eng, stats0,
                            dict(ck.launch_counts))
                stats = eng.stats_snapshot()
            finally:
                eng.shutdown()
            if kw and not stats["spec_macro_steps"]:
                raise AssertionError("features: speculation did not run")
            top_rows_check(label, reqs)

        # the seed: alone, then beside 7 unseeded sampled neighbours
        sampled = dict(max_tokens=NEW_TOKENS, temperature=1.0)
        seed_ids = stream(700, 90, v)

        def seeded(seed, neighbours):
            eng = engine()
            try:
                req = eng.submit_ids(seed_ids, seed=seed, **sampled)
                others = []
                if neighbours:
                    wait_first_token(req)
                    others = [eng.submit_ids(stream(710 + i, 40 + 30 * i, v),
                                             **sampled) for i in range(7)]
                serve_all([req] + others)
            finally:
                eng.shutdown()
            return req.token_ids

        alone = seeded(11, False)
        beside = seeded(11, True)
        feature_check({"check": "seed 11: alone = beside 7 unseeded",
                       "tokens": len(alone),
                       "equal": sum(a == b for a, b in zip(alone, beside))},
                      alone == beside)
        streams = {tuple(alone), tuple(seeded(12, False)),
                   tuple(seeded(13, False))}
        feature_check({"check": "seeds 11, 12, 13: distinct streams",
                       "distinct": len(streams)}, len(streams) >= 2)
        torch.cuda.empty_cache()
    finally:
        ck.set_attn_s8(None)

    # wall: the ten chat requests, and the same with request 0 penalized
    # and request 1 asking for top_logprobs 5, in turns (plain, features,
    # features, plain)
    runs = {"plain": None,
            "penalized + top_logprobs 5": {0: pen_kw,
                                           1: dict(top_logprobs=5)}}
    walls = collections.defaultdict(list)
    for label in ("plain", "penalized + top_logprobs 5",
                  "penalized + top_logprobs 5", "plain"):
        report = {}
        engine_phase(cfg, params, tok, dev, gpu_line,
                     f"int4, in memory; paired, s8; features: {label}",
                     buckets=[16, 64, 256, 512], s8=True, pair_kv_heads=True,
                     must_launch=["int4_matmul_stacked",
                                  "int4_matmul_grouped",
                                  "decode_attention_s8_paired"],
                     may_launch=["prefill_attention_paired"],
                     request_kw=runs[label], report=report)
        walls[label].append({
            "wall_s": report["wall_s"],
            "decode_steps": report["decode_steps"],
            "ms_a_decode_step": 1e3 * report["wall_s"]
            / report["decode_steps"]})
    emit({"phase": "features", "wall": walls, "card": gpu_line,
          "seconds": time.perf_counter() - t0})


# ---- the runtime options: fp8 activations, the int8 prefill shadow,
# dispatch-ahead fetches ---------------------------------------------------


def option_check(line: dict, ok: bool) -> None:
    """One line per check of the options phase; a failed check fails the
    run."""
    line = {"phase": "options", **line, "ok": bool(ok)}
    emit(line)
    if not ok:
        raise AssertionError(f"options: {line}")


def first_layers(params, n: int):
    """The params with their first n layers (copies, so that no kernel's
    cached tensor map points into the full stack)."""
    from gabby_tpu_torch.ops.quant import QTensor

    def cut(v):
        if isinstance(v, QTensor):
            return dataclasses.replace(v, q=v.q[:n].clone(),
                                       scale=v.scale[:n].clone())
        return v[:n].clone()

    return {**params, "blocks": {k: cut(v)
                                 for k, v in params["blocks"].items()}}


def median_ms(fn, reps: int = 5) -> float:
    """Median wall ms of `fn` with the card synchronized around each call
    (eager: host time included), after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def eight_slots(cfg, params, dev, streams: int):
    """8 slots prefilled with streams `streams` + slot (24-59 tokens, one
    64-token chunk each) on a paired int8 cache of 2048 rows: (cache,
    first greedy tokens, positions) for a decode step."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    lens = [24 + 5 * s for s in range(8)]
    cache = create_cache(cfg, 8, 2048, quantized=True, paired=True,
                         device=dev)
    first = torch.zeros(8, dtype=torch.int32)
    for slot, n in enumerate(lens):
        chunk = torch.zeros(64, dtype=torch.int64)
        chunk[:n] = torch.tensor(stream(streams + slot, n, cfg.vocab_size))
        row, _ = llama.prefill_slot(params, cfg, chunk.to(dev), n, slot, 0,
                                    cache)
        first[slot] = int(row.argmax())
    return cache, first.to(dev), torch.tensor(lens, dtype=torch.int32,
                                              device=dev)


def fp8_model_check(cfg, params, dev) -> None:
    """`model_phase`'s walk (a 16-token prefill, then 3 decode steps, the
    unpaired int8 cache, the bf16/f32 form) on the card and on the CPU,
    each with fp8 off and on, every run fed the card's fp8-off greedy
    tokens: the card against the CPU with fp8 off and with it on, and
    fp8's own effect on each side, as the largest logit difference
    relative to the largest logit. With fp8 off the card must stay within
    ADMIT_TOL of the CPU with 3 of 4 argmaxes equal. With fp8 on the bound
    is model_phase's W4A8 one, 2 x ADMIT_TOL, for the same reason: where
    the card's bf16 activations and the CPU's differ by a bf16 step (the
    kernels sum in another order), the grid can round them to
    neighbouring e4m3 values (steps of 1/8 to 1/16 of a value), and the
    two sides' grid errors stop cancelling; the argmaxes are printed, not
    held (random weights' near-ties flip under fp8 on the CPU alone)."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    ps = {"card": params, "cpu": to_cpu(params)}
    ids = torch.arange(16) * 7919 % 128000 + 100
    feed = None
    rows = {}
    ck.set_attn_s8(False)
    try:
        for on in (False, True):
            for side, dv in (("card", dev), ("cpu", "cpu")):
                quant.set_act_fp8(on)
                try:
                    cache = create_cache(cfg, 1, 64, quantized=True,
                                         device=dv)
                    row, _ = llama.prefill_slot(ps[side], cfg, ids.to(dv),
                                                16, 0, 0, cache)
                    out = [row.float().cpu()]
                    for step in range(3):
                        tok = (out[-1].argmax() if feed is None
                               else feed[step]).reshape(1)
                        row, _ = llama.decode_step(
                            ps[side], cfg, tok.to(torch.int32).to(dv),
                            torch.tensor([16 + step], dtype=torch.int32,
                                         device=dv), cache)
                        out.append(row[0].float().cpu())
                finally:
                    quant.set_act_fp8(False)
                rows[side, on] = torch.stack(out)
                if feed is None:
                    feed = [r.argmax() for r in out[:3]]
    finally:
        ck.set_attn_s8(None)

    def err(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def agree(a, b):
        return int((a.argmax(-1) == b.argmax(-1)).sum())

    pairs = {"card vs CPU, fp8 off": (("card", False), ("cpu", False)),
             "card vs CPU, fp8 on": (("card", True), ("cpu", True)),
             "fp8 on vs off, card": (("card", True), ("card", False)),
             "fp8 on vs off, CPU": (("cpu", True), ("cpu", False))}
    got = {k: {"max_rel_logit_err": err(rows[a], rows[b]),
               "argmax_agree": agree(rows[a], rows[b])}
           for k, (a, b) in pairs.items()}
    off, on = got["card vs CPU, fp8 off"], got["card vs CPU, fp8 on"]
    option_check({"check": f"{cfg.num_layers} layers card vs CPU, fp8 off "
                  f"and on, 4 rows", **got,
                  "bound_off": ADMIT_TOL, "bound_on": 2 * ADMIT_TOL},
                 off["max_rel_logit_err"] <= ADMIT_TOL
                 and off["argmax_agree"] >= 3
                 and on["max_rel_logit_err"] <= 2 * ADMIT_TOL)


def fp8_checks(cfg, params, tok, dev, gpu_line: str) -> None:
    """fp8 activations on the 1B int4 model: the grid pass on the card
    against the CPU on the card's own decode activations, bit for bit; two
    layers card against CPU with fp8 on; the launches of a decode step
    with fp8 on (the kernels' counts are those without); ms a step and of
    the grid pass alone; the ten chat requests without and with fp8, in
    turns."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant

    grid = quant.maybe_fp8_activation
    widths = [cfg.hidden_size, cfg.intermediate_size]
    seen = {}

    def capture(x):
        if x.shape[-1] in widths and x.shape[-1] not in seen:
            seen[x.shape[-1]] = x.reshape(-1, x.shape[-1]).clone()
        return grid(x)

    ck.set_attn_s8(True)
    try:
        cache, tokens, positions = eight_slots(cfg, params, dev, 800)
        quant.maybe_fp8_activation = capture
        try:
            llama.decode_step(params, cfg, tokens, positions, cache,
                              window=FEATURE_WINDOW)
        finally:
            quant.maybe_fp8_activation = grid
        for width, x in sorted(seen.items()):
            card = quant.fp8_activation(x).cpu()
            host = quant.fp8_activation(x.cpu())
            differ = int((card.view(torch.int16)
                          != host.view(torch.int16)).sum())
            option_check({"check": f"fp8_activation, card vs CPU, the "
                          f"card's decode activations {list(x.shape)} "
                          f"{str(x.dtype)[6:]}", "elements_differ": differ,
                          "grid_ms": median_ms(
                              lambda x=x: quant.fp8_activation(x), 20)},
                         x.shape[0] == 8 and x.dtype == torch.bfloat16
                         and differ == 0)
        option_check({"check": "decode activations captured at the "
                      "model's widths", "widths": sorted(seen)},
                     sorted(seen) == widths)

        def steps(n):
            for i in range(n):
                llama.decode_step(params, cfg, tokens, positions + i, cache,
                                  window=FEATURE_WINDOW)

        per_step = {}
        for on in (False, True, True, False):
            quant.set_act_fp8(on)
            try:
                torch.cuda.synchronize()
                ck.reset_launch_counts()
                steps(4)
                torch.cuda.synchronize()
                launches = step_launches(ck.launch_counts, 4)
                per_step.setdefault(on, []).append(
                    median_ms(lambda: steps(1), 5))
            finally:
                quant.set_act_fp8(False)
            option_check({"check": f"launches a decode step, fp8 "
                          f"{'on' if on else 'off'}", "launches": launches,
                          "want": STEP_LAUNCHES},
                         launches == {k: float(n) for k, n
                                      in STEP_LAUNCHES.items()})
        emit({"phase": "options", "fp8": "ms a decode_step (8 slots, eager,"
              " synchronized), off, on, on, off",
              "off_ms": per_step[False], "on_ms": per_step[True],
              "card": gpu_line})
        del cache
    finally:
        ck.set_attn_s8(None)
        quant.set_act_fp8(False)
    fp8_model_check(dataclasses.replace(cfg, num_layers=2),
                    first_layers(params, 2), dev)
    walls = collections.defaultdict(list)
    for on in (False, True, True, False):
        report = {}
        quant.set_act_fp8(on)
        try:
            engine_phase(cfg, params, tok, dev, gpu_line,
                         f"int4, in memory; paired, s8; fp8 activations "
                         f"{'on' if on else 'off'}",
                         buckets=[16, 64, 256, 512], s8=True,
                         pair_kv_heads=True,
                         must_launch=list(STEP_LAUNCHES),
                         may_launch=["prefill_attention_paired"],
                         report=report)
        finally:
            quant.set_act_fp8(False)
        walls["on" if on else "off"].append({
            "wall_s": report["wall_s"],
            "decode_steps": report["decode_steps"],
            "p50_ttft_ms": report["p50_ttft_ms"],
            "ms_a_decode_step": 1e3 * report["wall_s"]
            / report["decode_steps"]})
    emit({"phase": "options", "fp8": "the ten chat requests, off, on, on, "
          "off", "wall": walls, "card": gpu_line})


def shadow_checks(cfg, params, tok, dev, gpu_line: str) -> None:
    """The int8 prefill shadow on the 1B int4 model, default configuration:
    its bytes; a 64-token chunk through the engine's single admission
    launches K5 and no K1, a 512-token one neither K1 nor K7, and decode
    still launches K1 64 a step and no K5; the chunks' logits through the
    shadow against the int4 path's; ms a 512-token chunk through the int4
    path, the shadow and K7."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig, Request
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    shadow = quant.promote_int4_to_int8(params)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - m0
    codes = sum(v.q.numel() for k, v in shadow["blocks"].items()
                if isinstance(v, quant.QTensor) and v.bits == 8)
    d, f, q = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    want = cfg.num_layers * (d * (q + 2 * cfg.num_kv_heads * cfg.head_dim)
                             + q * d + d * 2 * f + f * d)
    option_check({"check": "shadow bytes: memory_allocated after "
                  "promote_int4_to_int8 - before, against the int8 codes",
                  "bytes": got, "codes": codes, "card": gpu_line},
                 codes == want and abs(got - codes) <= codes // 1000)

    ck.set_attn_s8(True)
    try:
        # chunk logits and time: the int4 path, the shadow, K7
        out = {}
        for bucket, take in ((64, 50), (512, 500)):
            ids = torch.tensor(stream(900 + bucket, bucket,
                                      cfg.vocab_size)).to(dev)
            for label, p in (("int4", params), ("shadow", shadow),
                             ("K7", params)):
                if label == "K7" and bucket == 64:
                    continue
                ck.set_int4_prefill_kernel(label == "K7")
                try:
                    cache = create_cache(cfg, 1, 2048, quantized=True,
                                         paired=True, device=dev)

                    def chunk(p=p, cache=cache):
                        return llama.prefill_slot(p, cfg, ids, take, 0, 0,
                                                  cache)[0]

                    torch.cuda.synchronize()
                    ck.reset_launch_counts()
                    out[bucket, label] = chunk()
                    torch.cuda.synchronize()
                    counts = dict(ck.launch_counts)
                    ms = median_ms(chunk, 5)
                finally:
                    ck.set_int4_prefill_kernel(None)
                emit({"phase": "options", "shadow": f"{bucket}-token "
                      f"chunk ({take} live), {label}", "ms": ms,
                      "launches": {k: n for k, n in counts.items() if n},
                      "card": gpu_line})
            a, r = out[bucket, "shadow"].float().cpu(), \
                out[bucket, "int4"].float().cpu()
            err = ((a - r).abs().max() / r.abs().max()).item()
            option_check({"check": f"{bucket}-token chunk's logits, shadow"
                          f" vs int4", "max_rel_logit_err": err,
                          "bound": 0.05,
                          "first_token": [int(a.argmax()), int(r.argmax())]},
                         err <= 0.05 and int(a.argmax()) == int(r.argmax()))
        del shadow, out

        # the engine's own prefill entries
        eng = Engine(cfg, params, tok, EngineConfig(
            batch_slots=8, max_seq=2048, kv_quantized=True,
            pair_kv_heads=True, prefill_int8_shadow=True), device=dev)
        eng.shutdown()
        eng._shutdown = False
        try:
            for slot, (n, want, none) in enumerate((
                    (50, "int8_matmul_stacked", ["int4_matmul_stacked"]),
                    (500, None, ["int4_matmul_stacked", "int4_matmul",
                                 "int8_matmul_stacked"]))):
                ids = stream(950 + slot, n, cfg.vocab_size)
                adm = eng._start_admission(slot, Request(
                    prompt_ids=ids, max_tokens=8, temperature=0.0, top_k=0,
                    top_p=1.0), *eng._find_donor(ids))
                torch.cuda.synchronize()
                ck.reset_launch_counts()
                while not eng._prefill_one_chunk(adm):
                    pass
                torch.cuda.synchronize()
                counts = dict(ck.launch_counts)
                eng._finish_admission(adm)
                option_check(
                    {"check": f"engine with the shadow: a {n}-token prompt's"
                     f" chunk launches {want or 'no stacked product'}"
                     f", not {none}",
                     "launches": {k: c for k, c in counts.items() if c}},
                    (want is None or counts[want] == 4 * cfg.num_layers)
                    and not any(counts[k] for k in none))
            steps0 = eng.stats["decode_steps"]
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            eng._iteration(None)  # one decode burst, no admission
            torch.cuda.synchronize()
            steps = eng.stats["decode_steps"] - steps0
            launches = step_launches(ck.launch_counts, steps)
            option_check({"check": "engine with the shadow: decode "
                          "launches K1 64 a step and no K5",
                          "steps": steps, "launches": launches,
                          "int8_matmul_stacked":
                              ck.launch_counts["int8_matmul_stacked"]},
                         steps > 0 and launches == {
                             k: float(n) for k, n in STEP_LAUNCHES.items()}
                         and ck.launch_counts["int8_matmul_stacked"] == 0)
        finally:
            eng._shutdown = True
    finally:
        ck.set_attn_s8(None)


def last_finish(req) -> str | None:
    """The finish reason among the items left in a request's queue."""
    fin = None
    while not req.out.empty():
        fin = req.out.get_nowait()[1] or fin
    return fin


def drive(eng, reqs) -> dict:
    """Serve `reqs` (already submitted) on an engine whose loop is stopped,
    an iteration at a time in this thread, until every one has finished
    and no record is pending: the admissions then do not depend on when
    the requests reached the engine. Returns the wall, each request's
    first-token time on the host and the counts."""
    t0 = time.perf_counter()
    first = {}
    admitting = None
    while (admitting is not None or eng._backlog or not eng._queue.empty()
           or any(s is not None for s in eng._slots)
           or eng._pending_burst is not None):
        _, admitting = eng._iteration(admitting)
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            if i not in first and (r.token_ids or not r.out.empty()):
                first[i] = now - t0
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "ttft_ms": [1e3 * first.get(i, float("nan"))
                        for i in range(len(reqs))]}


def pipeline_checks(cfg, params, tok, dev, gpu_line: str) -> None:
    """Dispatch-ahead fetches: the ten chat requests on the default
    configuration, dense and over 33 pages of 512, synchronous, pipelined,
    pipelined, synchronous; each run on a stopped engine driven an
    iteration at a time (`drive`), so that every run admits the same
    groups and every stream must be equal. ms a decode step (wall over
    decode steps, prefill included) and TTFT p50 (host time to each
    request's first token, from the start of the drive)."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig

    ck.set_attn_s8(True)
    try:
        for label, extra, attention in (
                ("dense", {}, "decode_attention_s8_paired"),
                ("33 pages of 512", dict(paged_pages=33, page_size=512),
                 "paged_decode_attention_s8_paired")):
            streams, rows = {}, []
            for pipelined in (False, True, True, False):
                eng = Engine(cfg, params, tok, EngineConfig(
                    batch_slots=8, max_seq=2048, kv_quantized=True,
                    pair_kv_heads=True, pipeline_fetch=pipelined, **extra),
                    device=dev)
                eng.shutdown()
                eng._shutdown = False
                try:
                    drive(eng, [eng.submit([{"role": "user",
                                             "content": "warm up"}],
                                           max_tokens=4)])
                    stats0 = eng.stats_snapshot()
                    torch.cuda.synchronize()
                    ck.reset_launch_counts()
                    reqs = [eng.submit(
                        [{"role": "user",
                          "content": "".join(chr(97 + (i * 7 + j) % 26)
                                             for j in range(n))}],
                        max_tokens=NEW_TOKENS)
                        for i, n in enumerate(CONTENT_SIZES)]
                    run = drive(eng, reqs)
                    counts = dict(ck.launch_counts)
                    stats = eng.stats_snapshot()
                finally:
                    eng._shutdown = True
                got = [tuple(r.token_ids) for r in reqs]
                fins = [last_finish(r) for r in reqs]
                missing = [k for k in ("int4_matmul_stacked",
                                       "int4_matmul_grouped", attention)
                           if not counts[k]]
                option_check({"check": f"the run's kernels launched and "
                              f"every request answered ({label}, "
                              f"{'pipelined' if pipelined else 'sync'})",
                              "never_launched": missing, "finishes": fins},
                             not missing and all(f in ("length", "stop")
                                                 for f in fins))
                steps = stats["decode_steps"] - stats0["decode_steps"]
                rows.append({"pipelined": pipelined,
                             "wall_s": run["wall_s"], "decode_steps": steps,
                             "ms_a_decode_step": 1e3 * run["wall_s"] / steps,
                             "ttft_p50_ms": statistics.median(
                                 run["ttft_ms"]),
                             "burst_admissions": (
                                 stats["burst_admissions"]
                                 - stats0["burst_admissions"]),
                             "tokens": sum(map(len, got))})
                streams.setdefault(pipelined, []).append(got)
            emit({"phase": "options", "pipeline": label, "runs": rows,
                  "card": gpu_line})
            runs = streams[False] + streams[True]
            option_check({"check": f"pipelined and synchronous streams "
                          f"equal ({label}, 10 requests, 4 runs)",
                          "tokens": [len(g) for g in runs[0]],
                          "runs_equal_to_the_first": sum(
                              r == runs[0] for r in runs)},
                         all(r == runs[0] for r in runs))
    finally:
        ck.set_attn_s8(None)


def options_phase(cfg, params, dev, gpu_line: str) -> None:
    """The reference's three single-card runtime options on the 1B int4
    weights in the server's default configuration (8 slots, 2048 rows,
    paired int8 cache, s8): `--act-fp8` (`fp8_checks`),
    `--prefill-int8-shadow` (`shadow_checks`) and `--pipeline-fetch`
    (`pipeline_checks`)."""
    from gabby_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    tok = Tokenizer.byte_fallback(cfg.vocab_size)
    fp8_checks(cfg, params, tok, dev, gpu_line)
    torch.cuda.empty_cache()
    shadow_checks(cfg, params, tok, dev, gpu_line)
    torch.cuda.empty_cache()
    pipeline_checks(cfg, params, tok, dev, gpu_line)
    torch.cuda.empty_cache()
    emit({"phase": "options", "seconds": time.perf_counter() - t0})


# chat prompts of the first engine run: content lengths in characters. A
# chat prompt is its content plus 23 template tokens under the byte
# tokenizer; the chunk schedules cover buckets 64, 256 and 512, multi-chunk
# prompts (512 + 16, 512 + 256, 512 + 512) and with them bucket 16
CONTENT_SIZES = [20, 40, 150, 200, 400, 450, 502, 600, 900, 5]
NEW_TOKENS = 32


def engine_phase(cfg, params, tok, dev, gpu_line: str, label: str, *,
                 prompt_lens=None, must_launch, may_launch=(), buckets,
                 s8: bool = False,
                 multi: bool = False, rawdot: bool = False,
                 kv_quantized: bool = True, request_kw=None, report=None,
                 **engine_kw):
    """Serves one batch of concurrent requests through the engine with the
    launch counts set to 0 just before and read just after. The prompts
    are chat messages (prompt_lens None: CONTENT_SIZES) or token ids of
    the given lengths; the cache is int8 (`kv_quantized`) or bf16;
    `engine_kw` are further EngineConfig fields (`pair_kv_heads` among
    them, off unless given); `s8` and `multi` set the two
    decode-attention switches for the run, `rawdot` the raw-byte-dot form
    of the stacked int4 products. Every attention kernel outside
    `must_launch` and `may_launch` must stay at 0: each has a path of its
    own; so must the
    stacked int4 form the run did not ask for (K1 with `rawdot`, K33
    without). `request_kw` maps a request's index to further submit
    arguments; `report` receives the printed line. Returns (counts,
    prompt lengths)."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig

    ck.set_attn_s8(s8)
    ck.set_attn_multi(multi)
    ck.set_int4_rawdot(rawdot)
    eng = Engine(cfg, params, tok, EngineConfig(
        batch_slots=8, max_seq=2048, kv_quantized=kv_quantized,
        **engine_kw), device=dev)
    try:
        warm = eng.submit([{"role": "user", "content": "warm up"}],
                          max_tokens=4)
        while warm.out.get()[1] is None:
            pass
        ck.reset_launch_counts()
        stats0 = eng.stats_snapshot()
        t0 = time.perf_counter()
        extra = request_kw or {}
        if prompt_lens is None:
            reqs = [eng.submit(
                [{"role": "user",
                  "content": "".join(chr(97 + (i * 7 + j) % 26)
                                     for j in range(n))}],
                max_tokens=NEW_TOKENS, **extra.get(i, {}))
                for i, n in enumerate(CONTENT_SIZES)]
        else:
            span = min(cfg.vocab_size, tok.vocab_size) - 16
            reqs = [eng.submit_ids(
                [(i * 7919 + j * 104729) % span + 1 for j in range(n)],
                max_tokens=NEW_TOKENS, **extra.get(i, {}))
                for i, n in enumerate(prompt_lens)]
        fins = []
        for req in reqs:
            while True:
                _, fin = req.out.get(timeout=600)
                if fin is not None:
                    fins.append(fin)
                    break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
        stats = eng.stats_snapshot()
    finally:
        eng.shutdown()
        ck.set_attn_s8(None)
        ck.set_attn_multi(None)
        ck.set_int4_rawdot(None)
    for req, fin in zip(reqs, fins):
        want = NEW_TOKENS if fin == "length" else None
        if fin not in ("length", "stop") or (
                want is not None and req.completion_tokens != want):
            raise AssertionError(f"engine ({label}): request finished {fin} "
                                 f"with {req.completion_tokens} tokens")
    missing = [k for k in must_launch if counts[k] == 0]
    if missing:
        raise AssertionError(f"engine ({label}): kernels never launched: "
                             f"{missing}; counts {counts}")
    not_asked = ("int4_matmul_stacked" if rawdot
                 else "int4_matmul_stacked_rawdot")
    stray = [k for k, n in counts.items()
             if n and ("attention" in k or k == not_asked)
             and k not in must_launch and k not in may_launch]
    if stray:
        raise AssertionError(f"engine ({label}): {stray} launched on a path "
                             f"that is not their own; counts {counts}")
    lens = [len(r.prompt_ids) for r in reqs]
    schedules = [eng._chunk_schedule(n) for n in lens]
    seen = sorted({bkt for sch in schedules for _, bkt in sch})
    if seen != buckets or max(map(len, schedules)) < 2:
        raise AssertionError(f"engine ({label}): prompts {lens} give "
                             f"buckets {seen}, wanted {buckets} and a "
                             f"multi-chunk admission")
    out_tokens = sum(r.completion_tokens for r in reqs)
    line = {"phase": "engine", "weights": label, "requests": len(reqs),
            "model": f"{cfg.num_layers} layers, hidden {cfg.hidden_size}",
            "kv_quantized": kv_quantized,
            "prompt_tokens": lens, "output_tokens": out_tokens,
            "wall_s": wall, "output_tok_per_s": out_tokens / wall,
            "p50_ttft_ms": stats.get("p50_ttft_ms"),
            "decode_steps": stats["decode_steps"] - stats0["decode_steps"],
            "burst_admissions": (stats["burst_admissions"]
                                 - stats0["burst_admissions"]),
            "launches": counts, "card": gpu_line}
    if engine_kw.get("speculate_tokens"):
        # acceptance is reported, not asserted: random weights seldom
        # repeat what the prompt repeats
        macro = stats["spec_macro_steps"] - stats0["spec_macro_steps"]
        emitted = stats["spec_tokens"] - stats0["spec_tokens"]
        if not macro or not stats["spec_on"]:
            raise AssertionError(f"engine ({label}): speculation did not "
                                 f"stay on ({stats})")
        line.update(spec_macro_steps=macro, spec_tokens=emitted,
                    tokens_per_macro_step=emitted / macro)
    emit(line)
    if report is not None:
        report.update(line)
    return counts, lens


HF_NAMES = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk",
            "self_attn.v_proj": "wv", "self_attn.o_proj": "wo",
            "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
            "mlp.down_proj": "w_down"}
# ids of the fixture tokenizer's <|begin_of_text|>, <|end_of_text|>, <|eot_id|>
BOS_ID, EOS_IDS = 853, [854, 857]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def checkpoint_phase(cfg, params, root: str) -> dict:
    """Writes `params` (bf16, unfused) as an HF-layout directory under
    `root`, quantizes it twice with tools.quantize as a user would (two
    processes at once), and deletes the HF directory. Returns {8: int8 dir, 4: int4 dir}."""
    from gabby_tpu_torch import loader

    free = shutil.disk_usage(root).free
    emit({"phase": "checkpoint", "tmp": "free space", "free_gb": free / 1e9})
    if free < 6e9:
        raise RuntimeError(f"checkpoint: {free / 1e9:.1f} GB free under "
                           f"{root}, about 6 GB are needed")
    hf = os.path.join(root, "llama32-1b-hf")
    os.makedirs(hf)
    t0 = time.perf_counter()
    blk = params["blocks"]
    t = {"model.embed_tokens.weight": params["embed"]}
    for layer in range(cfg.num_layers):
        pre = f"model.layers.{layer}."
        for name, ours in HF_NAMES.items():
            t[f"{pre}{name}.weight"] = blk[ours][layer].T  # HF: [out, in]
        t[pre + "input_layernorm.weight"] = blk["attn_norm"][layer]
        t[pre + "post_attention_layernorm.weight"] = blk["mlp_norm"][layer]
    t["model.norm.weight"] = params["final_norm"]
    loader.write_safetensors(os.path.join(hf, "model.safetensors"), t)
    del t
    rs = cfg.rope_scaling
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps,
            "rope_theta": cfg.rope_theta,
            "rope_scaling": {
                "rope_type": "llama3", "factor": rs.factor,
                "low_freq_factor": rs.low_freq_factor,
                "high_freq_factor": rs.high_freq_factor,
                "original_max_position_embeddings":
                    rs.original_max_position_embeddings},
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "bos_token_id": 128000, "eos_token_id": 128009,
            "torch_dtype": "bfloat16"}, f)
    with open(os.path.join(hf, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": BOS_ID, "eos_token_id": EOS_IDS}, f)
    shutil.copy(os.path.join(ROOT, "tests", "fixtures",
                             "multilingual_tokenizer.json"),
                os.path.join(hf, "tokenizer.json"))
    emit({"phase": "checkpoint", "wrote": "hf", "gb": dir_bytes(hf) / 1e9,
          "seconds": time.perf_counter() - t0})
    # the two quantizations run side by side, each in its own process
    dirs = {bits: os.path.join(root, f"llama32-1b-int{bits}")
            for bits in (8, 4)}
    t0 = time.perf_counter()
    procs = {bits: subprocess.Popen(
        [sys.executable, "-m", "gabby_tpu_torch.tools.quantize",
         "--model-dir", hf, "--out", dirs[bits], "--bits", str(bits)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for bits in dirs}
    try:
        for bits, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"tools.quantize --bits {bits} exited "
                                   f"with {proc.returncode}:\n{err[-4000:]}")
            emit({"phase": "checkpoint", "wrote": f"int{bits}",
                  "gb": dir_bytes(dirs[bits]) / 1e9,
                  "seconds_since_both_started": time.perf_counter() - t0,
                  "files": sorted(os.listdir(dirs[bits]))})
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(hf)
    return dirs


def load_checkpoint(path: str, bits: int, source, dev):
    """load_model_dir -> fuse_projections, after holding what was loaded
    against the weights the directory was made from: one layer's codes
    must equal a fresh quantization of `source`'s, bit for bit, and the
    unembed is the 2-D int8 table over the unpadded vocab."""
    from gabby_tpu_torch import loader
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant

    t0 = time.perf_counter()
    cfg, params, tok = loader.load_model_dir(path, max_seq_len=2048,
                                             device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name, layer in (("wq", 3), ("w_down", 15)):
        want = quant.quantize(source["blocks"][name][layer], bits)
        got = params["blocks"][name]
        if got.bits != bits or not torch.equal(got.q[layer], want.q) \
                or not torch.equal(got.scale[layer], want.scale):
            raise AssertionError(f"checkpoint int{bits}: {name}[{layer}] "
                                 f"differs from a fresh quantization")
    head = params["lm_head"]
    if (head.bits, head.group, tuple(head.q.shape)) != (
            8, 0, (cfg.hidden_size, cfg.vocab_size)):
        raise AssertionError(f"checkpoint int{bits}: unembed is "
                             f"{head.bits}-bit {tuple(head.q.shape)}")
    if (cfg.bos_token_id, list(cfg.eos_token_ids)) != (BOS_ID, EOS_IDS) \
            or tok is None or tok.token_id("<|eot_id|>") != EOS_IDS[1]:
        raise AssertionError(f"checkpoint int{bits}: config or tokenizer "
                             f"did not come from the directory")
    emit({"phase": "checkpoint", "loaded": f"int{bits}", "seconds": secs})
    return cfg, llama.fuse_projections(params), tok


def http_phase(label: str, weights_args: list, env=None,
               features: bool = False):
    """`python -m gabby_tpu_torch.server` as a user starts it (its own
    process, the server on its main thread; `env` adds to its
    environment) with `weights_args` and a small engine, one chat
    completion through the C++ front-end (with `features`, then a second
    one with `logprobs`, `top_logprobs` 3 and a `seed`, which must carry
    as many logprob entries, each with 3 alternatives, as completion
    tokens), then SIGTERM."""
    if shutil.which("cmake") is None:
        emit({"phase": "http", "weights": label,
              "skipped": "cmake is not installed, so the "
              "C++ front-end (cpp/) cannot be built here"})
        return
    import http.client
    import queue

    proc = subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-m",
         "gabby_tpu_torch.server", *weights_args,
         "--slots", "2", "--max-seq", "512", "--port", "0", "--no-warmup",
         "--log-level", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, **(env or {})})
    out: list[str] = []
    ports: "queue.Queue[int]" = queue.Queue()

    def read() -> None:
        for line in proc.stdout:
            out.append(line)
            if line.startswith("listening on port"):
                ports.put(int(line.split()[-1]))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    ok = False
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ports.get(timeout=300),
                                          timeout=300)
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "model": "m", "max_tokens": 8,
            "messages": [{"role": "user", "content": "hello"}]}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        if resp.status != 200 or body["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"http ({label}): {resp.status} {body}")
        if features:
            conn = http.client.HTTPConnection("127.0.0.1", conn.port,
                                              timeout=300)
            conn.request("POST", "/v1/chat/completions", body=json.dumps({
                "model": "m", "max_tokens": 8, "temperature": 1.0,
                "seed": 7, "logprobs": True, "top_logprobs": 3,
                "messages": [{"role": "user", "content": "hello"}]}))
            lp_resp = conn.getresponse()
            lp_body = json.loads(lp_resp.read())
            conn.close()
            entries = ((lp_body.get("choices") or [{}])[0].get("logprobs")
                       or {}).get("content", [])
            n = lp_body.get("usage", {}).get("completion_tokens", 0)
            emit({"phase": "http", "weights": label,
                  "request": "logprobs, top_logprobs 3, seed 7",
                  "status": lp_resp.status, "completion_tokens": n,
                  "logprob_entries": len(entries)})
            if (lp_resp.status != 200 or n < 1 or len(entries) != n
                    or any(len(e["top_logprobs"]) != 3 for e in entries)):
                raise AssertionError(f"http ({label}): {lp_resp.status} "
                                     f"{lp_body}")
        ok = True
    finally:
        proc.terminate()
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        reader.join(10)
        if not ok or rc != 0:
            print("".join(out[-60:]), file=sys.stderr, flush=True)
    if rc != 0:
        raise AssertionError(f"http ({label}): the server exited with {rc}")
    emit({"phase": "http", "weights": label, "status": resp.status,
          "completion_tokens": body["usage"]["completion_tokens"]})


def ptxas_lines(log: str, src: str) -> list:
    """The registers, shared memory and spills `-Xptxas -v` reported for
    the kernels of one source, from the verbose build's output, and any
    wgmma serialization ptxas injected."""
    keep, on = [], False
    for line in log.splitlines():
        if line.startswith("[nvcc "):
            on = line == f"[nvcc {src}]"
        elif on and any(w in line for w in ("Compiling entry", "Used",
                                            "spill", "injected")):
            keep.append(" ".join(line.split()))
    return keep

# ---- tensor parallelism --------------------------------------------------

TP = 2
# the server's default configuration apart from pairing (refused under tp)
TP_ENGINE = dict(batch_slots=8, max_seq=2048, kv_quantized=True)
TP_PAGED = dict(paged_pages=33, page_size=512)
# per decode step of one rank at tp = 2 (or of the one process at tp = 1):
# K1, K2 and the unpaired s8 decode attention, dense and paged
TP_STEP = {"int4_matmul_stacked": 64, "int4_matmul_grouped": 1}
TP_ATTN = {False: "decode_attention_s8", True: "paged_decode_attention_s8"}


def tp_check(line: dict, ok: bool) -> None:
    """One line per check of the tensor-parallel phase; a failed check
    fails the run."""
    line = {"phase": "tensor-parallel", **line, "ok": bool(ok)}
    emit(line)
    if not ok:
        raise AssertionError(f"tensor-parallel: {line}")


def int4_1b(cfg, dev):
    """The 1B model's int4 tree (group-256 int4 unembed) from seed 0,
    unfused."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant

    source = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    return quant.quantize_tree(source, 4, unembed_bits=4, unembed_group=256)


def tp_kernel_checks(cfg, dev, gpu_line: str) -> None:
    """(a) K1 at one rank's four projections at tp = 2 and tp = 4 (16
    layers, M = 8), K2 at a tp = 2 rank's vocab shard of the padded
    unembed, [8, 2048] x [2048, 64512] with group-256 scales, and the
    attention kernels at a tp = 2 rank's heads (`tp_attention_checks`),
    each against its plain version with the kernels phase's tolerance, K2
    twice bit for bit, on random codes; kernel-only, in this process."""
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    from gabby_tpu_torch.ops.quant import unpack_int4
    from gabby_tpu_torch.parallel import local_config

    g = torch.Generator(device=dev).manual_seed(3)
    for tp in (2, 4):
        results: list = []
        projs = projections(local_config(cfg, tp))
        stacked_case_into(
            results, g, cfg.num_layers, projs, "int4_matmul_stacked",
            "gabby_tpu_torch/csrc/quant_matmul_stacked.cu",
            "gabby_tpu/ops/pallas/quant_matmul.py:424",
            cqm.qmatmul_int4_stacked, cqm.int4_stacked_plain, bits=4, m=8,
            what=f"one rank's decode step at tp = {tp}", repeat=True)
        tp_check({"check": f"K1 at the tp = {tp} shard shapes",
                  "projections_k_n": projs, "card": gpu_line,
                  **results[0]}, True)
    d, group, b = cfg.hidden_size, 256, 8
    vs = 129024 // TP
    up = torch.randint(-128, 128, (d // 2, vs), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    us = torch.rand((d // group, vs), generator=g, device=dev) * 0.02
    ux = torch.randn((b, d), generator=g, device=dev).bfloat16()
    uw = (unpack_int4(up).float()
          * torch.repeat_interleave(us, group, dim=0)).bfloat16()
    got = cqm.qmatmul_int4_grouped(ux, up, us, group)
    err = check("int4_matmul_grouped at the vocab shard", [got],
                [cqm.int4_grouped_plain(ux, up, us, group)])
    nbytes = up.numel() + us.numel() * 4 + ux.numel() * 2 + b * vs * 2
    tp_check({"check": "K2 at a tp = 2 rank's vocab shard",
              "shapes": f"[{b}, {d}] x [{d}, {vs}], group {group}",
              "max_abs_err": err, "tol": TOL,
              "repeat_equal": torch.equal(
                  got, cqm.qmatmul_int4_grouped(ux, up, us, group)),
              "ms": time_ms(lambda: cqm.qmatmul_int4_grouped(ux, up, us,
                                                             group)),
              "graph_ms": graph_ms(lambda: cqm.qmatmul_int4_grouped(
                  ux, up, us, group)),
              "plain_ms": time_ms(lambda: cqm.int4_grouped_plain(
                  ux, up, us, group), 3),
              "library_ms": time_ms(lambda: torch.matmul(ux, uw)),
              "card": gpu_line, **bound(nbytes, 2 * b * d * vs)},
             torch.equal(got, cqm.qmatmul_int4_grouped(ux, up, us, group)))
    del up, us, ux, uw
    tp_attention_checks(local_config(cfg, TP), dev, gpu_line, g)


def tp_attention_checks(lcfg, dev, gpu_line: str, g) -> None:
    """(a) continued: the attention kernels a tp = 2 rank launches, at its
    heads (`lcfg`: 16 q over 4 kv heads of 64 for 1B), on 8 slots of 2048
    rows: K14 (the unpaired s8 decode attention, dense) and K19 (the same
    through the page table of 33 pages of 512) at context 1024, K4 (the
    unpaired int8 prefill attention) on a 512-token chunk at offset 512.
    Each against its plain version with the kernels phase's tolerance
    (S8_TOL for the s8 forms, ATTN_TOL for K4) and repeated bit for bit,
    timed beside the plain version and the library call."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    from gabby_tpu_torch.ops.cuda import prefill_attention as cpfa
    from gabby_tpu_torch.runtime.kv_cache import quantize_kv

    nl, b, s, ctx, page = lcfg.num_layers, 8, 2048, 1024, 512
    nq, nk, h = lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim
    heads = f"{nq} q heads, {nk} kv heads, head {h}"
    pa = "gabby_tpu/ops/pallas/attention.py"
    csrc = "gabby_tpu_torch/csrc/"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results: list = []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kc, ks = quantize_kv(randn(nl, b, nk, s, h))
    vc, vs = quantize_kv(randn(nl, b, nk, s, h))
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = randn(b, 1, nq, h).bfloat16()
    fk, fv = randn(b, nk, h).bfloat16(), randn(b, nk, h).bfloat16()
    kw = dict(fresh_k=fk, fresh_v=fv)
    qt = q.transpose(1, 2)
    nbytes = nl * (2 * b * nk * ctx * (h + 4) + 2 * b * nq * h * 2
                   + 2 * b * nk * h * 2)
    ops = nl * 4 * b * nq * (ctx + 1) * h
    s8 = dict(peak=INT8_OP_PER_S, tol=S8_TOL, repeat=True)

    def dense_rows(codes, scales, fresh):
        """Rows j < ctx of a [B, Nk, S, H] int8 layer in bf16, then the
        fresh row: what the library call is given ready-made."""
        return torch.cat([(codes[:, :, :ctx].float()
                           * scales[:, :, :ctx, None]).bfloat16(),
                          fresh[:, :, None]], dim=2)

    kd = [dense_rows(kc[i], ks[i], fk) for i in range(nl)]
    vd = [dense_rows(vc[i], vs[i], fv) for i in range(nl)]
    attn_case_into(
        results, nl, "decode_attention_s8",
        f"{nl} layers x [{b} slots, {heads}, context {ctx}], int8 cache "
        f"of {s} rows, s8 dots", csrc + "attention_s8.cu", pa + ":256",
        lambda i: cattn.decode_attention_s8(q, kc, vc, ks, vs, pos, layer=i,
                                            window=ctx + 1, **kw),
        lambda i: cattn.decode_attention_s8_plain(q, kc, vc, ks, vs, pos,
                                                  layer=i, **kw),
        lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True), nbytes, ops,
        **s8)
    del kd, vd

    # K4: slot 3's 512-token chunk at offset 512
    t, off = 512, 512
    q4 = randn(1, t, nq, h).bfloat16()
    kw4 = dict(fresh_k=randn(nk, t, h).bfloat16(),
               fresh_v=randn(nk, t, h).bfloat16())
    mask = torch.cat([torch.ones((t, off), dtype=torch.bool, device=dev),
                      torch.ones((t, t), dtype=torch.bool,
                                 device=dev).tril()], dim=1)
    kd = [torch.cat([(kc[i, 3, :, :off].float()
                      * ks[i, 3, :, :off, None]).bfloat16(),
                     kw4["fresh_k"]], dim=1)[None] for i in range(nl)]
    vd = [torch.cat([(vc[i, 3, :, :off].float()
                      * vs[i, 3, :, :off, None]).bfloat16(),
                     kw4["fresh_v"]], dim=1)[None] for i in range(nl)]
    keys = t * off + t * (t + 1) // 2  # (query, key) pairs kept
    attn_case_into(
        results, nl, "prefill_attention",
        f"{nl} layers x [T={t} at offset {off}, {heads}], one slot",
        csrc + "prefill_attention.cu",
        "gabby_tpu/ops/pallas/prefill_attention.py:142",
        lambda i: cpfa.prefill_attention(q4, kc, vc, ks, vs, 3, off,
                                         layer=i, **kw4),
        lambda i: cpfa.prefill_attention_plain(q4, kc, vc, ks, vs, 3, off,
                                               layer=i, **kw4),
        lambda i: sdpa(q4.transpose(1, 2), kd[i], vd[i], attn_mask=mask,
                       enable_gqa=True),
        nl * (2 * nk * off * (h + 4) + 2 * t * nq * h * 2
              + 2 * nk * t * h * 2), nl * 4 * nq * h * keys, iters=3,
        repeat=True)
    del kd, vd, kc, vc, ks, vs, q4, kw4

    # K19: the pool of the paged engine runs, each slot's four logical
    # pages scattered over it by a shuffled table
    npages = s // page * b + 1
    kp, kps = quantize_kv(randn(npages, nl, nk, page, h))
    vp, vps = quantize_kv(randn(npages, nl, nk, page, h))
    table = (torch.randperm(npages - 1, generator=g, device=dev) + 1
             ).reshape(b, s // page).to(torch.int32).contiguous()
    pool = (kp, vp, table, pos, kps, vps)

    def paged_rows(codes, scales, layer, fresh):
        idx = table[:, :ctx // page].long()
        rows = codes[:, layer][idx].movedim(1, 2).reshape(b, nk, ctx, h)
        sc = scales[:, layer][idx].movedim(1, 2).reshape(b, nk, ctx)
        return torch.cat([(rows.float() * sc[..., None]).bfloat16(),
                          fresh[:, :, None]], dim=2)

    kd = [paged_rows(kp, kps, i, fk) for i in range(nl)]
    vd = [paged_rows(vp, vps, i, fv) for i in range(nl)]
    attn_case_into(
        results, nl, "paged_decode_attention_s8",
        f"{nl} layers x [{b} slots, {heads}, context {ctx}], int8 pool of "
        f"{npages} pages of {page} rows, shuffled table, s8 dots",
        csrc + "attention_s8.cu", pa + ":800",
        lambda i: cpaged.paged_decode_attention_s8(q, *pool, layer=i, **kw),
        lambda i: cpaged.paged_decode_attention_s8_plain(q, *pool, layer=i,
                                                         **kw),
        lambda i: sdpa(qt, kd[i], vd[i], enable_gqa=True),
        nbytes + nl * b * (s // page) * 4, ops, **s8)
    del kd, vd, kp, vp, kps, vps, pool
    torch.cuda.empty_cache()
    for r in results:
        tp_check({"check": f"{r['name']} at a tp = 2 rank's heads",
                  "card": gpu_line, **r}, True)


def tp_forced(params, cfg, dev, fed=None, prompt=None) -> tuple:
    """(b)'s walk: `prompt` (64 tokens of a stream when None) prefilled
    into slot 0 of an unpaired int8 cache (s8 on), in chunks of 512 (one of
    64 for 64 tokens or fewer), then decode steps fed `fed`, or, with fed
    None, 16 fed the greedy tokens, which come back. Returns (fed, [1 +
    steps, V] f32 logits on the CPU: row j predicts the j-th new token)."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.parallel import local_config

    group = params.get("tp")
    lcfg = local_config(cfg, 1 if group is None else group.size)
    cache = create_cache(lcfg, 1, 2048, quantized=True, device=dev)
    ids = stream(900, 64, cfg.vocab_size) if prompt is None else prompt
    n = len(ids)
    bucket = 64 if n <= 64 else 512
    greedy = fed is None
    steps = 16 if greedy else len(fed)
    ck.set_attn_s8(True)
    try:
        row = prefill_alone(params, cfg, cache, ids, 0,
                            [(o, bucket) for o in range(0, n, bucket)])
        rows = [row]
        fed = [int(row.argmax())] if greedy else list(fed)
        for step in range(steps):
            lg, _ = llama.decode_step(
                params, cfg, torch.tensor([fed[step]], dtype=torch.int32,
                                          device=dev),
                torch.tensor([n + step], dtype=torch.int32, device=dev),
                cache)
            rows.append(lg[0])
            if greedy and step < steps - 1:
                fed.append(int(lg[0].argmax()))
    finally:
        ck.set_attn_s8(None)
    return fed, torch.stack(rows).float().cpu()


def tp_decode_costs(params, cfg, dev, paged: bool, slots: int = 8) -> dict:
    """(d) and (e): `slots` slots (8; one replica's 4 at dp = 2) prefilled
    (24-59 tokens) on an unpaired int8 cache, dense or 33 pages of 512
    (four a slot), then 4 decode steps with the launch and all-reduce
    counts set to 0 just before and read just after: each a step; then ms
    a step (median of 5, synchronized, eager)."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.parallel import collectives, local_config
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.runtime.paged import create_paged_cache

    group = params.get("tp")
    lcfg = local_config(cfg, 1 if group is None else group.size)
    if paged:
        cache = create_paged_cache(lcfg, slots, 2048, 33, quantized=True,
                                   page_size=512, device=dev)
        cache.page_table.copy_(1 + torch.arange(4 * slots, dtype=torch.int32)
                               .reshape(slots, 4))
    else:
        cache = create_cache(lcfg, slots, 2048, quantized=True, device=dev)
    lens = [24 + 5 * s for s in range(slots)]
    first = []
    ck.set_attn_s8(True)
    try:
        for slot, n in enumerate(lens):
            chunk = torch.zeros(512 if paged else 64, dtype=torch.int64)
            chunk[:n] = torch.tensor(stream(950 + slot, n, cfg.vocab_size))
            row, _ = llama.prefill_slot(params, cfg, chunk.to(dev), n, slot,
                                        0, cache)
            first.append(int(row.argmax()))
        tokens = torch.tensor(first, dtype=torch.int32, device=dev)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        window = None if paged else FEATURE_WINDOW

        def steps(n):
            for i in range(n):
                llama.decode_step(params, cfg, tokens, pos + i, cache,
                                  window=window)

        torch.cuda.synchronize()
        ck.reset_launch_counts()
        collectives.reset_counts()
        steps(4)
        torch.cuda.synchronize()
        names = {**TP_STEP, TP_ATTN[paged]: 16}
        launches = {k: ck.launch_counts[k] / 4 for k in names}
        all_reduces = collectives.counts["all_reduce"] / 4
        ms = median_ms(lambda: steps(1), 5)
    finally:
        ck.set_attn_s8(None)
    return {"launches": launches, "want": names, "all_reduces": all_reduces,
            "ms_a_step": ms}


def tp_engine_runs(cfg, params, dev, sync) -> dict:
    """(c): the ten chat requests of the engine phase (NEW_TOKENS each,
    greedy) through one Engine a configuration, dense and over 33 pages of
    512, after one warm-up request; the launch and all-reduce counts set
    to 0 after the warm-up on every rank (the follower's when the leader
    says so through the store, before the leader submits) and read after
    the run. Under a multi-rank `sync` rank 0 serves and the follower
    replays its plans. Returns per configuration the finished streams,
    counts, wall, decode steps and TTFT p50 (rank 0)."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.parallel import collectives
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.byte_fallback(cfg.vocab_size)
    multi = sync is not None and sync.num_processes > 1
    leader = not multi or sync.is_leader
    store = sync.group.store if multi else None
    out = {}
    ck.set_attn_s8(True)
    try:
        for label, extra in (("dense", {}), ("33 pages of 512", TP_PAGED)):
            eng = Engine(cfg, params, tok, EngineConfig(**TP_ENGINE, **extra),
                         device=dev, sync=sync)
            streams: list = []
            real_finish = eng._finish

            def finish(slot_ix, reason, real_finish=real_finish,
                       streams=streams, eng=eng):
                s = eng._slots[slot_ix]
                if s is not None:
                    streams.append((tuple(s.request.prompt_ids),
                                    list(s.request.token_ids)))
                real_finish(slot_ix, reason)

            eng._finish = finish
            # every decode burst reads one host view (`_host_view`)
            bursts = [0]

            def host_view(*a, real_view=eng._host_view, bursts=bursts):
                bursts[0] += 1
                return real_view(*a)

            eng._host_view = host_view
            row = {}
            if leader:
                warm = eng.submit([{"role": "user", "content": "warm up"}],
                                  max_tokens=4)
                while warm.out.get(timeout=600)[1] is None:
                    pass
                if multi:
                    store.set(f"smoke/warm/{label}", "1")
                    store.wait([f"smoke/reset/{label}"])
                ck.reset_launch_counts()
                collectives.reset_counts()
                bursts[0] = 0
                stats0 = eng.stats_snapshot()
                t0 = time.perf_counter()
                reqs = [eng.submit(
                    [{"role": "user",
                      "content": "".join(chr(97 + (i * 7 + j) % 26)
                                         for j in range(n))}],
                    max_tokens=NEW_TOKENS) for i, n in enumerate(CONTENT_SIZES)]
                fins = []
                for req in reqs:
                    while True:
                        _, fin = req.out.get(timeout=600)
                        if fin is not None:
                            fins.append(fin)
                            break
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stats = eng.stats_snapshot()
                row.update(
                    fins=fins, wall_s=wall,
                    decode_steps=stats["decode_steps"]
                    - stats0["decode_steps"],
                    p50_ttft_ms=stats.get("p50_ttft_ms"),
                    tokens=[r.completion_tokens for r in reqs])
                row["ms_a_decode_step"] = 1e3 * wall / row["decode_steps"]
                counts = dict(ck.launch_counts)
                coll = dict(collectives.counts)
                eng.shutdown()
            else:
                store.wait([f"smoke/warm/{label}"])
                ck.reset_launch_counts()
                collectives.reset_counts()
                bursts[0] = 0
                store.set(f"smoke/reset/{label}", "1")
                eng._thread.join()
                counts = dict(ck.launch_counts)
                coll = dict(collectives.counts)
            row.update(streams=sorted(streams), all_reduces=coll["all_reduce"],
                       collectives=coll, bursts=bursts[0],
                       launches={k: n for k, n in counts.items() if n})
            out[label] = row
    finally:
        ck.set_attn_s8(None)
    return out


def first_divergence(got: list, want: list):
    """The first stream of `got` whose tokens differ from `want`'s for the
    same prompt (both sorted (prompt ids, tokens) pairs): (prompt ids,
    want's tokens, got's tokens, the first position that differs), else
    None."""
    for (prompt, a), (prompt_w, b) in zip(got, want):
        if prompt != prompt_w:
            raise AssertionError("tensor-parallel: the runs finished other "
                                 "prompts")
        if a != b:
            p = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return list(prompt), list(b), list(a), p
    return None


def _tp_rank(rank: int, nprocs: int, store_path: str, fed: list,
             tp1_streams: dict) -> dict:
    """One rank of the tensor-parallel phase on cuda:0 (spawned): joins the
    group through a FileStore (the backend by the rule: ranks that share a
    card take gloo), cuts its shard of the seed-0 int4 tree, and runs (b),
    (d) and (c); then, for each configuration whose streams differ from
    `tp1_streams` (the tp = 1 run's), the first diverging stream's walk
    (`tp_forced` fed the tp = 1 tokens up to the first position that
    differs; both ranks hold the same streams, so both walk it). Returns
    what the parent checks."""
    import torch.distributed as dist

    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.parallel import (bind_group, init_distributed,
                                          shard_params)
    from gabby_tpu_torch.parallel.multihost import HostSync

    dev = torch.device("cuda", 0)
    group = init_distributed(None, nprocs, rank, device=dev, timeout=600,
                             store=dist.FileStore(store_path, nprocs))
    cfg = cfglib.llama32_1b(max_seq_len=2048)
    params = bind_group(llama.fuse_projections(shard_params(
        int4_1b(cfg, dev), rank, nprocs)), group)
    torch.cuda.empty_cache()
    _, logits = tp_forced(params, cfg, dev, fed)
    costs = {paged: tp_decode_costs(params, cfg, dev, paged)
             for paged in (False, True)}
    runs = tp_engine_runs(cfg, params, dev, HostSync(group, timeout=600))
    walks = {}
    for label, want in tp1_streams.items():
        d = first_divergence(runs[label]["streams"], want)
        if d is not None:
            prompt, tokens, _, p = d
            _, rows = tp_forced(params, cfg, dev, tokens[:p], prompt)
            walks[label] = rows[p].numpy()
    # numpy, not a tensor: a tensor would cross by shared memory, which
    # needs this process alive after it returns
    return {"backend": group.backend, "logits": logits.numpy(),
            "costs": costs, "runs": runs, "walks": walks}


def tp_phase(cfg, dev, gpu_line: str) -> tuple:
    """The tensor-parallel phase, (a)-(e) of the docstring: the tp = 1
    sides on the card in this process, then two spawned ranks. Returns the
    single-process sides (decode costs, engine runs), which the
    data-parallel phase compares with too."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    tp_kernel_checks(cfg, dev, gpu_line)
    torch.cuda.empty_cache()
    params = llama.fuse_projections(int4_1b(cfg, dev))
    fed, want = tp_forced(params, cfg, dev)
    one = {paged: tp_decode_costs(params, cfg, dev, paged)
           for paged in (False, True)}
    one_runs = tp_engine_runs(cfg, params, dev, None)
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="gabby_tp_") as d:
        ranks = mesh.spawn_ranks(
            _tp_rank, TP, (os.path.join(d, "store"), fed,
                           {k: v["streams"] for k, v in one_runs.items()}),
            timeout=900)
    # (b)
    for rank, r in enumerate(ranks):
        got = torch.from_numpy(r["logits"])
        worst = ((got - want).abs().max() / want.abs().max()).item()
        tp_check({"check": f"rank {rank}: 64-token prefill + 16 fed decode "
                  f"steps, tp = 2 against tp = 1 on the card",
                  "backend": r["backend"], "rows": got.shape[0],
                  "max_rel_logit_err": worst, "bound": ADMIT_TOL,
                  "argmax_agree": int((got.argmax(-1)
                                       == want.argmax(-1)).sum())},
                 worst <= ADMIT_TOL and r["backend"] == "gloo")
    tp_check({"check": "both ranks' logits bit for bit equal"},
             (ranks[0]["logits"] == ranks[1]["logits"]).all())
    # (d)
    for paged in (False, True):
        where = "33 pages of 512" if paged else "dense"
        c = one[paged]
        tp_check({"check": f"tp = 1, {where}: launches and all-reduces a "
                  "decode step", **c},
                 c["launches"] == {k: float(n) for k, n in c["want"].items()}
                 and c["all_reduces"] == 0)
        for rank, r in enumerate(ranks):
            c = r["costs"][paged]
            tp_check({"check": f"rank {rank}, {where}: launches and "
                      "all-reduces a decode step", **c,
                      "want_all_reduces": 2 * cfg.num_layers + 2},
                     c["launches"] == {k: float(n)
                                       for k, n in c["want"].items()}
                     and c["all_reduces"] == 2 * cfg.num_layers + 2)
    # (c) and (e)
    for label in ("dense", "33 pages of 512"):
        lead, follow = (r["runs"][label] for r in ranks)
        attn = TP_ATTN[label != "dense"]
        path = list(TP_STEP) + [attn]
        tp_check({"check": f"{label}: the ten chat requests, rank 0 serving "
                  "and rank 1 replaying its plans: identical streams, "
                  "every kernel of the path and the all-reduces launched "
                  "on both ranks", "finished": lead["fins"],
                  "tokens": lead["tokens"],
                  "launches": [lead["launches"], follow["launches"]],
                  "all_reduces": [lead["all_reduces"],
                                  follow["all_reduces"]],
                  "streams_equal_to_tp_1": sum(
                      a == b for a, b in zip(lead["streams"],
                                             one_runs[label]["streams"]))},
                 lead["streams"] == follow["streams"]
                 and len(lead["streams"]) == len(CONTENT_SIZES) + 1
                 and all(f in ("stop", "length") for f in lead["fins"])
                 and all(lead["launches"].get(k, 0) > 0
                         and follow["launches"].get(k, 0) > 0 for k in path)
                 and lead["all_reduces"] == follow["all_reduces"] > 0
                 and one_runs[label]["all_reduces"] == 0)
        paged = label != "dense"
        emit({"phase": "tensor-parallel", "cost": label,
              "note": "two ranks share one card here: not the cost on two "
              "cards", "card": gpu_line,
              "ms_a_decode_step_model": {
                  "tp1": one[paged]["ms_a_step"],
                  "tp2": [r["costs"][paged]["ms_a_step"] for r in ranks]},
              "engine_ten_requests": {
                  key: {k: run[k] for k in ("wall_s", "decode_steps",
                                            "ms_a_decode_step",
                                            "p50_ttft_ms")}
                  for key, run in (("tp1", one_runs[label]),
                                   ("tp2", lead))}})
    tp_divergence(cfg, dev, gpu_line, one_runs, ranks[0])
    emit({"phase": "tensor-parallel", "seconds": time.perf_counter() - t0})
    return one, one_runs


def tp_divergence(cfg, dev, gpu_line: str, one_runs: dict, lead: dict) -> None:
    """Why a tp = 2 greedy stream leaves the tp = 1 one, printed, not
    judged: for the first diverging stream of each configuration, the
    tp = 1 walk over the same prompt and tokens (`tp_forced`) beside rank
    0's, at the first position that differs: the two streams' tokens
    there, the tp = 1 logits' gap between their best two tokens and
    between the two streams' tokens, the tp = 2 logits' gap between the
    same two, and the largest difference of the two rows, each relative
    to the row's largest logit. A gap below that difference is a near-tie
    that the sums' order can flip."""
    from gabby_tpu_torch.models import llama

    params = None
    for label, run in one_runs.items():
        got = lead["runs"][label]["streams"]
        d = first_divergence(got, run["streams"])
        if d is None:
            continue
        prompt, tokens, other, p = d
        if params is None:
            params = llama.fuse_projections(int4_1b(cfg, dev))
        _, rows = tp_forced(params, cfg, dev, tokens[:p], prompt)
        one, two = rows[p], torch.from_numpy(lead["walks"][label])
        top = one.abs().max().item()
        t1 = tokens[p] if p < len(tokens) else None
        t2 = other[p] if p < len(other) else None
        best = one.topk(2).values
        pair = t1 is not None and t2 is not None
        emit({"phase": "tensor-parallel", "diagnosis": label,
              "diverging_streams": sum(a != b for a, b in
                                       zip(got, run["streams"])),
              "prompt_tokens": len(prompt), "first_diverging_position": p,
              "tp1_token": t1, "tp2_token": t2,
              "walk_argmax": [int(one.argmax()), int(two.argmax())],
              "tp1_best_two_gap_rel": (best[0] - best[1]).item() / top,
              "tp1_gap_between_the_tokens_rel":
                  (one[t1] - one[t2]).item() / top if pair else None,
              "tp2_gap_between_the_tokens_rel":
                  (two[t2] - two[t1]).item() / top if pair else None,
              "walk_max_rel_logit_err": (two - one).abs().max().item() / top,
              "card": gpu_line})
    del params
    torch.cuda.empty_cache()



# ---- data parallelism ----------------------------------------------------

DP = 2
# (d): the SP threshold that the 512-token bucket meets, and the slot that
# replica 1 owns, so that its prior rows cross to replica 0
DP_SP_TOKENS = 512
DP_SP_SLOT = 5
DP_SP_PROMPT = 1024  # two 512-token chunks, the second past offset 512


def dp_check(line: dict, ok: bool) -> None:
    """One line per check of the data-parallel phase; a failed check fails
    the run."""
    line = {"phase": "data-parallel", **line, "ok": bool(ok)}
    emit(line)
    if not ok:
        raise AssertionError(f"data-parallel: {line}")


def dp_kernel_checks(cfg, dev, gpu_line: str) -> None:
    """(a) K1 at one replica's lanes (M = 4, the 1B's four projections x
    16 layers) and K14 over one replica's 4 slots (32 q over 8 kv heads,
    context 1024 in 2048 rows), each against its plain version with the
    kernels phase's tolerance and repeated bit for bit, timed eagerly and
    from a graph beside the plain version and the library call;
    kernel-only, in this process."""
    from gabby_tpu_torch.ops.cuda import attention as cattn
    from gabby_tpu_torch.ops.cuda import quant_matmul as cqm
    from gabby_tpu_torch.runtime.kv_cache import quantize_kv

    g = torch.Generator(device=dev).manual_seed(4)
    results: list = []
    b = TP_ENGINE["batch_slots"] // DP
    stacked_case_into(
        results, g, cfg.num_layers, projections(cfg), "int4_matmul_stacked",
        "gabby_tpu_torch/csrc/quant_matmul_stacked.cu",
        "gabby_tpu/ops/pallas/quant_matmul.py:524",
        cqm.qmatmul_int4_stacked, cqm.int4_stacked_plain, bits=4, m=b,
        what="one replica's decode step at dp = 2", repeat=True)
    nl, s, ctx = cfg.num_layers, 2048, 1024
    nq, nk, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kc, ks = quantize_kv(randn(nl, b, nk, s, h))
    vc, vs = quantize_kv(randn(nl, b, nk, s, h))
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = randn(b, 1, nq, h).bfloat16()
    fk, fv = randn(b, nk, h).bfloat16(), randn(b, nk, h).bfloat16()
    kw = dict(fresh_k=fk, fresh_v=fv)

    def rows(codes, scales, fresh):
        return torch.cat([(codes[:, :, :ctx].float()
                           * scales[:, :, :ctx, None]).bfloat16(),
                          fresh[:, :, None]], dim=2)

    kd = [rows(kc[i], ks[i], fk) for i in range(nl)]
    vd = [rows(vc[i], vs[i], fv) for i in range(nl)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_case_into(
        results, nl, "decode_attention_s8",
        f"{nl} layers x [{b} slots, {nq} q heads, {nk} kv heads, head {h}, "
        f"context {ctx}], int8 cache of {s} rows, s8 dots",
        "gabby_tpu_torch/csrc/attention_s8.cu",
        "gabby_tpu/ops/pallas/attention.py:256",
        lambda i: cattn.decode_attention_s8(q, kc, vc, ks, vs, pos, layer=i,
                                            window=ctx + 1, **kw),
        lambda i: cattn.decode_attention_s8_plain(q, kc, vc, ks, vs, pos,
                                                  layer=i, **kw),
        lambda i: sdpa(q.transpose(1, 2), kd[i], vd[i], enable_gqa=True),
        nl * (2 * b * nk * ctx * (h + 4) + 2 * b * nq * h * 2
              + 2 * b * nk * h * 2), nl * 4 * b * nq * (ctx + 1) * h,
        peak=INT8_OP_PER_S, tol=S8_TOL, repeat=True)
    del kd, vd, kc, vc, ks, vs
    torch.cuda.empty_cache()
    for r in results:
        dp_check({"check": f"{r['name']} at one replica's {b} lanes",
                  "card": gpu_line, **r}, True)


def dp_sp_prefill(params, cfg, dev, group, prompt: list) -> dict:
    """(d) on one rank: the prompt's 512-token chunks into slot
    DP_SP_SLOT through sp_prefill_slot, by the all-gather and by the ring,
    each on a fresh unpaired int8 cache of this replica's 4 slots, against
    the same chunks through the single-rank prefill_slot (the same
    weights, no collective) on a cache of one slot: the final logits'
    largest difference and the owner's rows' (dequantized), each relative
    to the largest; the bytes the call adds to the peak allocation (its
    activations and K/V buffers: `torch.cuda.max_memory_allocated` around
    it), its ms and its collectives."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.parallel import collectives, sp
    from gabby_tpu_torch.runtime.kv_cache import create_cache, dequantize_kv

    bl = TP_ENGINE["batch_slots"] // DP
    ids = torch.tensor(prompt, device=dev)
    n, t = len(prompt), DP_SP_TOKENS
    ref_cache = create_cache(cfg, 1, 2048, quantized=True, device=dev)
    for off in range(0, n, t):
        want, _ = llama.prefill_slot(params, cfg, ids[off:off + t], t, 0, off,
                                     ref_cache)
    want = want.float()

    def rows(cache, slot):
        return [dequantize_kv(codes[:, slot, :, :n], scales[:, slot, :, :n],
                              torch.float32)
                for codes, scales in ((cache.k, cache.k_scale),
                                      (cache.v, cache.v_scale))]

    ref_rows = rows(ref_cache, 0)
    out = {}
    for route, ring in (("all-gather", False), ("ring", True)):
        cache = create_cache(cfg, bl, 2048, quantized=True, device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_counts()
        t0 = time.perf_counter()
        for off in range(0, n, t):
            got, cache = sp.sp_prefill_slot(params, cfg, ids[off:off + t], t,
                                            DP_SP_SLOT, off, cache,
                                            group=group, ring=ring)
        torch.cuda.synchronize()
        row = {"ms": 1e3 * (time.perf_counter() - t0),
               "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
               "collectives": dict(collectives.counts),
               "logits": got.float().cpu().numpy(),
               "max_rel_logit_err": ((got.float() - want).abs().max()
                                     / want.abs().max()).item(),
               "argmax_equal": int(got.argmax()) == int(want.argmax())}
        if DP_SP_SLOT // bl == group.dp_rank:
            row["max_rel_row_err"] = max(
                ((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(rows(cache, DP_SP_SLOT % bl), ref_rows))
        out[route] = row
        del cache
        torch.cuda.empty_cache()
    return out


def _dp_rank(rank: int, nprocs: int, store_path: str, prompt: list) -> dict:
    """One replica of the data-parallel phase on cuda:0 (spawned): joins a
    dp = nprocs grid through a FileStore (gloo: the ranks share the card),
    builds the whole seed-0 int4 tree (weights are replicated over dp),
    and runs (b)'s and (e)'s model steps over its 4 slots, (d), then (c)'s
    engine runs. Returns what the parent checks, as numpy and plain
    Python."""
    import torch.distributed as dist

    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.parallel import init_distributed
    from gabby_tpu_torch.parallel.multihost import HostSync

    dev = torch.device("cuda", 0)
    group = init_distributed(None, nprocs, rank, dp=nprocs, device=dev,
                             timeout=600,
                             store=dist.FileStore(store_path, nprocs))
    cfg = cfglib.llama32_1b(max_seq_len=2048)
    params = llama.fuse_projections(int4_1b(cfg, dev))
    torch.cuda.empty_cache()
    costs = {paged: tp_decode_costs(params, cfg, dev, paged,
                                    slots=TP_ENGINE["batch_slots"] // nprocs)
             for paged in (False, True)}
    sp = dp_sp_prefill(params, cfg, dev, group, prompt)
    runs = tp_engine_runs(cfg, params, dev, HostSync(group, timeout=600))
    return {"backend": group.backend, "costs": costs, "sp": sp,
            "runs": runs}


def dp_divergence(cfg, dev, gpu_line: str, one_runs: dict,
                  lead: dict) -> None:
    """Where a dp = 2 greedy stream leaves the dp = 1 one, printed, not
    judged: the dp = 1 single-slot walk over the same prompt and the dp = 1
    tokens (`tp_forced`), at the first position that differs: the two
    streams' tokens, the walk's gap between them and between its best two,
    relative to the row's largest logit; a gap within TIE_BAND is a
    near-tie that a sum in another order can flip."""
    from gabby_tpu_torch.models import llama

    params = None
    for label, run in one_runs.items():
        got = lead["runs"][label]["streams"]
        d = first_divergence(got, run["streams"])
        if d is None:
            emit({"phase": "data-parallel", "diagnosis": label,
                  "diverging_streams": 0})
            continue
        prompt, tokens, other, p = d
        if params is None:
            params = llama.fuse_projections(int4_1b(cfg, dev))
        _, walk = tp_forced(params, cfg, dev, tokens[:p], prompt)
        row = walk[p]
        top = row.abs().max().item()
        t1 = tokens[p] if p < len(tokens) else None
        t2 = other[p] if p < len(other) else None
        best = row.topk(2).values
        gap = (abs(row[t1] - row[t2]).item() / top
               if t1 is not None and t2 is not None else None)
        emit({"phase": "data-parallel", "diagnosis": label,
              "diverging_streams": sum(a != b for a, b in
                                       zip(got, run["streams"])),
              "prompt_tokens": len(prompt), "first_diverging_position": p,
              "dp1_token": t1, "dp2_token": t2,
              "walk_argmax": int(row.argmax()),
              "dp1_best_two_gap_rel": (best[0] - best[1]).item() / top,
              "gap_between_the_tokens_rel": gap,
              "near_tie": gap is not None and gap <= TIE_BAND,
              "card": gpu_line})
    del params
    torch.cuda.empty_cache()


def dp_phase(cfg, dev, gpu_line: str, one: dict, one_runs: dict) -> None:
    """The data-parallel phase: (a) in this process, then two replicas
    spawned on the card; `one` and `one_runs` are the tensor-parallel
    phase's single-process decode costs and engine runs (dp = 1)."""
    from gabby_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    dp_kernel_checks(cfg, dev, gpu_line)
    prompt = stream(990, DP_SP_PROMPT, cfg.vocab_size)
    with tempfile.TemporaryDirectory(prefix="gabby_dp_") as d:
        ranks = mesh.spawn_ranks(_dp_rank, DP, (os.path.join(d, "store"),
                                                prompt), timeout=900)
    # (b)
    for rank, r in enumerate(ranks):
        for paged in (False, True):
            where = "33 pages of 512" if paged else "dense"
            c = r["costs"][paged]
            dp_check({"check": f"replica {rank}, {where}: launches a decode "
                      "step over its 4 slots", "backend": r["backend"],
                      **c},
                     c["launches"] == {k: float(n)
                                       for k, n in c["want"].items()}
                     and r["backend"] == "gloo")
        for label in ("dense", "33 pages of 512"):
            run = r["runs"][label]
            per = run["collectives"]["gather_slots"] / max(run["bursts"], 1)
            dp_check({"check": f"replica {rank}, {label}: dp gathers a "
                      "decode burst", "bursts": run["bursts"],
                      "collectives": run["collectives"],
                      "gathers_a_burst": per},
                     per == 1.0 and run["bursts"] > 0
                     and run["collectives"]["all_reduce"] == 0)
    # (c)
    for label in ("dense", "33 pages of 512"):
        lead, follow = (r["runs"][label] for r in ranks)
        path = list(TP_STEP) + [TP_ATTN[label != "dense"]]
        dp_check({"check": f"{label}: the ten chat requests, rank 0 serving "
                  "and rank 1 replaying its plans: identical records, every "
                  "kernel of the path launched on both replicas",
                  "finished": lead["fins"], "tokens": lead["tokens"],
                  "launches": [lead["launches"], follow["launches"]],
                  "streams_equal_to_dp_1": sum(
                      a == b for a, b in zip(lead["streams"],
                                             one_runs[label]["streams"])),
                  "streams": len(lead["streams"])},
                 lead["streams"] == follow["streams"]
                 and len(lead["streams"]) == len(CONTENT_SIZES) + 1
                 and all(f in ("stop", "length") for f in lead["fins"])
                 and all(lead["launches"].get(k, 0) > 0
                         and follow["launches"].get(k, 0) > 0
                         for k in path))
    dp_divergence(cfg, dev, gpu_line, one_runs, ranks[0])
    # (d)
    for route in ("all-gather", "ring"):
        got = [r["sp"][route] for r in ranks]
        owner = got[DP_SP_SLOT // (TP_ENGINE["batch_slots"] // DP)]
        dp_check({"check": f"SP prefill by the {route}: {DP_SP_PROMPT} "
                  f"tokens in chunks of {DP_SP_TOKENS} into slot "
                  f"{DP_SP_SLOT}, against the single-rank prefill_slot",
                  "bound": ADMIT_TOL, "card": gpu_line,
                  **{k: [g[k] for g in got] for k in (
                      "max_rel_logit_err", "argmax_equal", "ms",
                      "peak_extra_bytes", "collectives")},
                  "owner_max_rel_row_err": owner["max_rel_row_err"]},
                 all(g["max_rel_logit_err"] <= ADMIT_TOL for g in got)
                 and owner["max_rel_row_err"] <= ADMIT_TOL
                 and (got[0]["logits"] == got[1]["logits"]).all())
    emit({"phase": "data-parallel", "check": "SP peak bytes, ring beside "
          "all-gather", "card": gpu_line,
          "peak_extra_bytes": {route: [r["sp"][route]["peak_extra_bytes"]
                                       for r in ranks]
                               for route in ("all-gather", "ring")}})
    # (e)
    for paged in (False, True):
        label = "33 pages of 512" if paged else "dense"
        emit({"phase": "data-parallel", "cost": label,
              "note": "two replicas share one card here: not the cost on "
              "two cards", "card": gpu_line,
              "ms_a_decode_step_model": {
                  "dp1_8_slots": one[paged]["ms_a_step"],
                  "dp2_4_slots_each": [r["costs"][paged]["ms_a_step"]
                                       for r in ranks]},
              "engine_ten_requests": {
                  key: {k: run[k] for k in ("wall_s", "decode_steps",
                                            "ms_a_decode_step",
                                            "p50_ttft_ms")}
                  for key, run in (("dp1", one_runs[label]),
                                   ("dp2", ranks[0]["runs"][label]))}})
    emit({"phase": "data-parallel", "seconds": time.perf_counter() - t0})


# ---- the no-fresh-row forms' path, the profiler, the decode profile ------

NOFRESH_POSITIONS = [0, 16, 1024, 300, 2047, 64, 1300, 700]
NOFRESH_COUNTS = {  # launches a layer on the path: stacked and one layer
    "decode_attention_nofresh": 2, "decode_attention_nofresh_paired": 1,
    "decode_attention_nofresh_bf16": 2,
    "decode_attention_nofresh_bf16_paired": 1,
    "paged_decode_attention_nofresh": 1,
    "paged_decode_attention_nofresh_paired": 1,
    "paged_decode_attention_nofresh_bf16": 1,
    "paged_decode_attention_nofresh_bf16_paired": 1}


def nofresh_path_phase(cfg, dev, gpu_line: str) -> dict:
    """K34-K41's path: a decode step through the reference's public decode
    ops without fresh rows, at the 1B heads over 8 slots of 2048-row
    caches (int8 and bf16, positions 0 to 2047): every layer first writes
    the current token's k/v row into the cache (int8: quantized as the
    engine writes it), then attends rows j <= positions[b] through
    `cache_attention_quantized` / `cache_attention` (the stacked cache with
    `layer`, one layer's cache alone, the paired cache) and
    `paged_decode_attention(..., fresh_k=None)` (the same rows in 33 pages
    of 512 behind a shuffled table, paired or not). The launch counts are
    set to 0 just before and read just after: each form launches its
    kernel (NOFRESH_COUNTS a layer) and no other attention kernel
    launches. Then, outside the counted run: the one-layer, paired and
    paged forms give the stacked unpaired dense form's bits (one kernel,
    one plan), and each dense form is within ATTN_TOL of the fresh-row
    form of the bf16/f32 kernel (K3, K24) on the same rows, the token's
    row folded in last instead of read (int8: unquantized). Returns the
    counts."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops.attention import (cache_attention,
                                               cache_attention_quantized)
    from gabby_tpu_torch.ops.cuda import paged_attention as cpaged
    from gabby_tpu_torch.runtime.kv_cache import pair_heads, quantize_kv

    g = torch.Generator(device=dev).manual_seed(5)
    nl, b, s, page = cfg.num_layers, 8, 2048, 512
    nq, nk, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kc, ks = quantize_kv(randn(nl, b, nk, s, h))
    vc, vs = quantize_kv(randn(nl, b, nk, s, h))
    kb = randn(nl, b, nk, s, h).bfloat16()
    vb = randn(nl, b, nk, s, h).bfloat16()
    q = randn(nl, b, 1, nq, h).bfloat16()
    k_new = randn(nl, b, nk, h).bfloat16()
    v_new = randn(nl, b, nk, h).bfloat16()
    pos = torch.tensor(NOFRESH_POSITIONS, dtype=torch.int32, device=dev)
    lanes = torch.arange(b, device=dev)
    for i in range(nl):  # the cache holds the current token
        for codes, scales, new in ((kc, ks, k_new), (vc, vs, v_new)):
            rows, sc = quantize_kv(new[i].float())
            codes[i][lanes, :, pos.long()] = rows
            scales[i][lanes, :, pos.long()] = sc
        kb[i][lanes, :, pos.long()] = k_new[i]
        vb[i][lanes, :, pos.long()] = v_new[i]
    npages = b * s // page + 1
    table = (torch.randperm(npages - 1, generator=g, device=dev) + 1
             ).reshape(b, s // page).to(torch.int32).contiguous()

    def pooled(x):
        """[L, B, Nk(/2), S, *] as a pool [P, L, Nk(/2), page, *] behind
        `table` (page 0 unused)."""
        pool = torch.zeros((npages, nl, x.shape[2], page, *x.shape[4:]),
                           dtype=x.dtype, device=dev)
        split = x.reshape(nl, b, x.shape[2], s // page, page, *x.shape[4:])
        pool[table.long()] = split.permute(1, 3, 0, 2, 4,
                                           *range(5, split.dim()))
        return pool

    kcp, vcp, kbp, vbp = (pair_heads(x) for x in (kc, vc, kb, vb))
    pools = {"int8": (pooled(kc), pooled(vc), table, pos, pooled(ks),
                      pooled(vs)),
             "int8 paired": (pooled(kcp), pooled(vcp), table, pos,
                             pooled(ks), pooled(vs)),
             "bf16": (pooled(kb), pooled(vb), table, pos, None, None),
             "bf16 paired": (pooled(kbp), pooled(vbp), table, pos, None,
                             None)}
    calls = {
        "K34": lambda i: cache_attention_quantized(q[i], kc, vc, ks, vs, pos,
                                                   layer=i),
        "K34, one layer": lambda i: cache_attention_quantized(
            q[i], kc[i], vc[i], ks[i], vs[i], pos),
        "K35": lambda i: cache_attention_quantized(q[i], kcp, vcp, ks, vs,
                                                   pos, layer=i),
        "K36": lambda i: cache_attention(q[i], kb, vb, pos, layer=i),
        "K36, one layer": lambda i: cache_attention(q[i], kb[i], vb[i], pos),
        "K37": lambda i: cache_attention(q[i], kbp, vbp, pos, layer=i),
        "K38": lambda i: cpaged.paged_decode_attention(
            q[i], *pools["int8"], layer=i),
        "K39": lambda i: cpaged.paged_decode_attention(
            q[i], *pools["int8 paired"], layer=i),
        "K40": lambda i: cpaged.paged_decode_attention(
            q[i], *pools["bf16"], layer=i),
        "K41": lambda i: cpaged.paged_decode_attention(
            q[i], *pools["bf16 paired"], layer=i)}
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {name: [fn(i) for i in range(nl)] for name, fn in calls.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launch_counts)
    want = {k: n * nl for k, n in NOFRESH_COUNTS.items()}
    got = {k: counts[k] for k in want}
    stray = {k: n for k, n in counts.items()
             if n and "attention" in k and k not in want}
    if got != want or stray:
        raise AssertionError(f"nofresh path: launches {got}, wanted {want}; "
                             f"stray {stray}")
    for name, o in outs.items():
        if not all(torch.isfinite(x.float()).all() for x in o):
            raise AssertionError(f"nofresh path: {name} non-finite")
    same = {"K34, one layer": "K34", "K35": "K34", "K38": "K34",
            "K39": "K38", "K36, one layer": "K36", "K37": "K36",
            "K40": "K36", "K41": "K40"}
    for name, base in same.items():
        if not all(torch.equal(a, c) for a, c in zip(outs[name],
                                                     outs[base])):
            raise AssertionError(f"nofresh path: {name} differs from "
                                 f"{base} on the same rows")
    ck.set_attn_s8(False)
    try:
        fresh = {"K34": [cache_attention_quantized(
                     q[i], kc, vc, ks, vs, pos, layer=i, fresh_k=k_new[i],
                     fresh_v=v_new[i]) for i in range(nl)],
                 "K36": [cache_attention(
                     q[i], kb, vb, pos, layer=i, fresh_k=k_new[i],
                     fresh_v=v_new[i]) for i in range(nl)]}
    finally:
        ck.set_attn_s8(None)
    errs = {name: check(f"nofresh path: {name} vs the fresh-row form",
                        outs[name], ref, ATTN_TOL)
            for name, ref in fresh.items()}
    emit({"phase": "nofresh", "path": f"{nl} layers x [{b} slots at "
          f"positions {NOFRESH_POSITIONS}, {nq} q heads, {nk} kv heads, "
          f"head {h}], {s}-row caches: each layer writes the token's row, "
          "then the public decode ops without fresh rows (stacked, one "
          f"layer, paired; {npages} pages of {page})",
          "launches": got, "wall_s": wall,
          "max_abs_err_vs_fresh_row_form": errs,
          "equal_bits": sorted(same), "card": gpu_line})
    return counts


# K1, K2 and K15 of a decode step of the server's default int4 1B
# configuration, by the kernel names in a trace (K15: the s8 paired form
# of decode_attention_kernel at the 1B heads, G = 4, H = 64)
PROFILE_KERNELS = {"int4_matmul_stacked": "stacked_kernel",
                   "int4_matmul_grouped": "unembed_kernel",
                   "decode_attention_s8_paired":
                       "decode_attention_kernel<4, 64, true, false, true, "
                       "1, true,"}


# the server's default command line for the int4 1B model, and the
# decode profile's
PROFILE_SERVER = ["--preset", "llama32_1b", "--random-weights", "--quant",
                  "4", "--kv-quant"]
PROFILE_DECODE = ["--config", "int4_1b"]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def profiler_phase(gpu_line: str) -> None:
    """`python -m gabby_tpu_torch.server --profiler-port P` on the int4 1B
    model in the server's default configuration (paired int8 cache, s8; 8
    slots, max_seq 2048), its own process: the ten chat requests (32 new
    tokens each) through the C++ front-end, then again with one capture
    (GET /capture?duration_ms=1000) posted with them. The capture must
    answer 200 with a gzipped Chrome trace whose `aten::` ops lie on one
    thread (the engine's: the profiler is opened there) and whose kernel
    events name K1, K2 and K15 (PROFILE_KERNELS); the ten
    completions must equal those of the run without the capture. Then
    SIGTERM; the trace's directory is removed."""
    import gzip
    import http.client
    import queue

    if shutil.which("cmake") is None:
        raise AssertionError("profiler: cmake is not installed, so the C++ "
                             "front-end (cpp/) cannot be built here")
    from gabby_tpu_torch.bridge import build_native
    build_native()
    pport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-m",
         "gabby_tpu_torch.server", *PROFILE_SERVER, "--slots", "8",
         "--max-seq", "2048", "--port", "0", "--no-warmup", "--log-level",
         "0", "--profiler-port", str(pport)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out: list[str] = []
    ports: "queue.Queue[int]" = queue.Queue()

    def read() -> None:
        for line in proc.stdout:
            out.append(line)
            if line.startswith("listening on port"):
                ports.put(int(line.split()[-1]))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def chat(port: int, i: int, n: int) -> str:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "model": "m", "max_tokens": NEW_TOKENS, "messages": [
                {"role": "user", "content": "".join(
                    chr(97 + (i * 7 + j) % 26) for j in range(n))}]}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        if resp.status != 200:
            raise AssertionError(f"profiler: chat {i}: {resp.status} {body}")
        return body["choices"][0]["message"]["content"]

    def capture():
        conn = http.client.HTTPConnection("127.0.0.1", pport, timeout=600)
        conn.request("GET", "/capture?duration_ms=1000")
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, body, dict(resp.getheaders())

    ok, trace_dir = False, None
    try:
        port = ports.get(timeout=600)
        texts, walls = [], []
        with concurrent.futures.ThreadPoolExecutor(11) as pool:
            for traced in (False, True):
                t0 = time.perf_counter()
                got = [pool.submit(chat, port, i, n)
                       for i, n in enumerate(CONTENT_SIZES)]
                cap = pool.submit(capture) if traced else None
                texts.append([f.result() for f in got])
                walls.append(time.perf_counter() - t0)
        status, body, headers = cap.result()
        if status != 200:
            raise AssertionError(f"profiler: capture answered {status}: "
                                 f"{body[:500]!r}")
        trace_dir = os.path.dirname(headers["X-Trace-Path"])
        trace = json.loads(gzip.decompress(body))
        events = trace.get("traceEvents", [])
        ops = [e for e in events
               if str(e.get("name", "")).startswith("aten::")]
        kernels = sorted({e["name"] for e in events
                          if e.get("cat") == "kernel"})
        found = {k: [n[:120] for n in kernels if name in n][:2]
                 for k, name in PROFILE_KERNELS.items()}
        line = {"phase": "profiler", "trace_bytes_gz": len(body),
                "events": len(events), "aten_ops": len(ops),
                "aten_threads": len({e.get("tid") for e in ops}),
                "kernel_events": sum(1 for e in events
                                     if e.get("cat") == "kernel"),
                "kernel_names": len(kernels), "found": found,
                "start_ms": float(headers.get("X-Start-Ms", "nan")),
                "stop_ms": float(headers.get("X-Stop-Ms", "nan")),
                "export_ms": float(headers.get("X-Export-Ms", "nan")),
                "wall_s": walls, "streams_equal": texts[0] == texts[1],
                "card": gpu_line}
        emit(line)
        if not ops or line["aten_threads"] != 1:
            raise AssertionError(f"profiler: the trace's aten:: ops are not "
                                 f"one thread's: {line}")
        missing = [k for k, names in found.items() if not names]
        if missing:
            raise AssertionError(f"profiler: no kernel of {missing} in the "
                                 f"trace; its kernels: {kernels[:40]}")
        if texts[0] != texts[1]:
            raise AssertionError("profiler: the streams with a capture "
                                 "differ from those without")
        ok = True
    finally:
        proc.terminate()
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        reader.join(10)
        if trace_dir is not None:
            shutil.rmtree(trace_dir, ignore_errors=True)
        if not ok or rc != 0:
            print("".join(out[-60:]), file=sys.stderr, flush=True)
    if rc != 0:
        raise AssertionError(f"profiler: the server exited with {rc}")


def profile_decode_phase(gpu_line: str) -> None:
    """`python -m gabby_tpu_torch.tools.profile_decode --config int4_1b` in
    its own process: its table printed as it is (earlier lines), then its
    device total against the wall of its 3 traced calls, and against the
    wall of its one call outside the trace, on a JSON line."""
    import re
    run = subprocess.run(
        [sys.executable, "-m", "gabby_tpu_torch.tools.profile_decode",
         *PROFILE_DECODE], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr,
              flush=True)
        raise AssertionError(f"profile_decode exited with {run.returncode}")
    lines = run.stdout.strip().splitlines()
    head = [ln for ln in lines if " total " in ln and " wall " in ln]
    rows = [ln for ln in lines if " us/step " in ln]
    m = re.search(r"total ([\d.]+) ms over (\d+) calls x (\d+) steps, "
                  r"wall ([\d.]+) ms .*; one call untraced ([\d.]+) ms",
                  head[0] if head else "")
    if m is None or not rows:
        raise AssertionError(f"profile_decode printed no total or rows: "
                             f"{run.stdout[-2000:]}")
    for ln in [head[0]] + rows:
        print(ln, flush=True)
    device_ms, calls, steps, wall_ms, plain_ms = (
        float(m.group(1)), int(m.group(2)), int(m.group(3)),
        float(m.group(4)), float(m.group(5)))
    emit({"phase": "profile_decode", "argv": PROFILE_DECODE,
          "device_ms": device_ms, "wall_ms": wall_ms,
          "device_share": device_ms / wall_ms,
          "ms_a_step_wall": wall_ms / (calls * steps),
          "ms_a_step_device": device_ms / (calls * steps),
          "ms_a_step_untraced": plain_ms / steps,
          "device_share_untraced": device_ms / calls / plain_ms,
          "top": [[float(x.group(1)), int(x.group(2)), x.group(3)]
                  for x in (re.match(r"\s*([\d.]+) us/step\s+x\s*(\d+)\s+"
                                     r"(.*)", ln) for ln in rows[:10])],
          "card": gpu_line})


SWITCH_PROMPTS = [43, 173, 623]  # the engine's 64, 256 and 512 buckets
SWITCH_TOKENS = 16


def switches_phase(cfg, params, dev, gpu_line: str) -> None:
    """The reference's kernel switches on the card, on int4_1b (weights in
    memory) over the server's default cache (paired int8).
    Kernels off (`set_kernels(False)`, as GABBY_KERNELS=0): a 64-token
    prefill and 4 decode steps fed the kernels-on run's greedy tokens (s8
    off on both sides: the plain bodies have no s8 form), then three
    requests through the engine (greedy, 16 tokens each, s8 on): every
    launch counter stays 0; the prefill's logits (the first step) and each
    decode step's within ADMIT_TOL of the kernels-on steps', each step's
    greedy token equal or within 2 * ADMIT_TOL of the best
    (`compare_steps`); the requests' tokens printed beside the kernels-on
    run's, with
    how many agree. Then `set_prefill_pair(False)` (GABBY_PREFILL_PAIR=0)
    with s8 on: the same prefill and steps leave K21 at 0 (the plain body)
    while K1, K2 and K15 count; the prefill's logits within ADMIT_TOL of
    the kernels', the s8 steps within 2 * ADMIT_TOL (as
    `steps_model_phase` holds s8 against the bf16/f32 form).
    `"phase": "switches"` lines."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig
    from gabby_tpu_torch.runtime.kv_cache import create_cache
    from gabby_tpu_torch.tokenizer import Tokenizer

    n, steps = 64, 4
    ids = (torch.arange(n) * 7919 % 128000 + 100).to(dev)

    def model_steps(s8: bool, fed=None):
        cache = create_cache(cfg, 1, 2048, quantized=True, paired=True,
                             device=dev)
        ck.set_attn_s8(s8)
        try:
            ck.reset_launch_counts()
            logits, _ = llama.prefill_slot(params, cfg, ids, n, 0, 0, cache)
            rows = [logits.float()]
            greedy = fed is None
            fed = [int(rows[0].argmax())] if greedy else list(fed)
            for step in range(steps):
                lg, _ = llama.decode_step(
                    params, cfg,
                    torch.tensor([fed[step]], dtype=torch.int32, device=dev),
                    torch.tensor([n + step], dtype=torch.int32, device=dev),
                    cache)
                rows.append(lg[0].float())
                if greedy:
                    fed.append(int(rows[-1].argmax()))
            torch.cuda.synchronize()
        finally:
            ck.set_attn_s8(None)
        return torch.stack(rows), fed[:steps], dict(ck.launch_counts)

    def engine_tokens():
        eng = Engine(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size),
                     EngineConfig(batch_slots=8, max_seq=2048,
                                  kv_quantized=True, pair_kv_heads=True),
                     device=dev)
        try:
            warm = eng.submit_ids(stream(9, 20, cfg.vocab_size),
                                  max_tokens=4)
            while warm.out.get(timeout=600)[1] is None:
                pass
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            reqs = [eng.submit_ids(stream(i, m, cfg.vocab_size),
                                   max_tokens=SWITCH_TOKENS)
                    for i, m in enumerate(SWITCH_PROMPTS)]
            for req in reqs:
                while req.out.get(timeout=600)[1] is None:
                    pass
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ck.launch_counts)
        finally:
            eng.shutdown()
        return [list(r.token_ids) for r in reqs], counts, wall

    on_rows, fed, on_counts = model_steps(False)
    on_tokens, on_engine, on_wall = engine_tokens()
    for name, counts in (("decode_attention_paired", on_counts),
                         ("decode_attention_s8_paired", on_engine)):
        for k in ("int4_matmul_stacked", "int4_matmul_grouped", name,
                  "prefill_attention_paired"):
            if not counts[k]:
                raise AssertionError(f"switches: {k} never launched with "
                                     "the kernels on")
    ck.set_kernels(False)
    try:
        off_rows, _, off_counts = model_steps(False, fed)
        off_tokens, off_engine, off_wall = engine_tokens()
    finally:
        ck.set_kernels(None)
    launched = {k: v for k, v in {**off_counts, **off_engine}.items() if v}
    if launched:
        raise AssertionError(f"switches: kernels launched with the kernels "
                             f"off: {launched}")
    emit({"phase": "switches", "check": "kernels off (set_kernels(False))",
          "model_launches": sum(off_counts.values()),
          "engine_launches": sum(off_engine.values()),
          "first_step_rel_logit_err": compare_steps(
              cfg, "kernels off: the prefill's logits", off_rows[:1],
              on_rows[:1], ADMIT_TOL)["max_rel_logit_err"],
          "steps_rel_logit_err": compare_steps(
              cfg, "kernels off: prefill and 4 decode steps", off_rows,
              on_rows, ADMIT_TOL)["max_rel_logit_err"],
          "greedy_tokens_on": on_tokens, "greedy_tokens_off": off_tokens,
          "leading_tokens_agree": [
              next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                   min(len(x), len(y)))
              for x, y in zip(off_tokens, on_tokens)],
          "tokens_agree": sum(a == b for x, y in zip(off_tokens, on_tokens)
                              for a, b in zip(x, y)),
          "tokens": sum(map(len, on_tokens)),
          "engine_wall_s_on": on_wall, "engine_wall_s_off": off_wall,
          "card": gpu_line})
    ck.set_prefill_pair(False)
    try:
        pair_rows, _, pair_counts = model_steps(True, fed)
    finally:
        ck.set_prefill_pair(None)
    emit({"phase": "switches", "check": "prefill pair off "
          "(set_prefill_pair(False))",
          "launches": {k: v for k, v in pair_counts.items() if v},
          "first_step_rel_logit_err": compare_steps(
              cfg, "prefill pair off: the prefill's logits", pair_rows[:1],
              on_rows[:1], ADMIT_TOL)["max_rel_logit_err"],
          "s8_steps_rel_logit_err": compare_steps(
              cfg, "prefill pair off: 4 s8 decode steps", pair_rows[1:],
              on_rows[1:], 2 * ADMIT_TOL)["max_rel_logit_err"],
          "card": gpu_line})
    if (pair_counts["prefill_attention_paired"]
            or not pair_counts["decode_attention_s8_paired"]
            or not pair_counts["int4_matmul_stacked"]
            or not pair_counts["int4_matmul_grouped"]):
        raise AssertionError(f"switches: GABBY_PREFILL_PAIR=0 took "
                             f"{pair_counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself: fails (ImportError, non-zero exit) outside the repo
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    start = time.perf_counter()

    def clock(done: str) -> None:
        emit({"phase": "clock", "done": done,
              "seconds_since_start": time.perf_counter() - start})

    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    emit({"phase": "card", "nvidia_smi": gpu_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build(verbose=True)  # with -Xptxas -v
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for src in ("quant_matmul_prefill.cu", "prefill_attention.cu",
                "prefill_attention_bf16.cu",
                "quant_matmul_stacked.cu", "quant_matmul_int8_stacked.cu",
                "quant_matmul_w4a8.cu", "quant_matmul_unembed.cu",
                "quant_matmul_int8_unembed.cu", "decode_attention.cu",
                "attention_s8.cu", "verify_attention.cu",
                "paged_attention.cu", "decode_prologue.cu"):
        emit({"phase": "build", "ptxas": src,
              "lines": ptxas_lines(log.getvalue(), src)})

    cfg = cfglib.llama32_1b(max_seq_len=2048)
    cfg3 = cfglib.llama32_3b(max_seq_len=2048)
    kernels = kernel_phase(cfg, dev)
    torch.cuda.empty_cache()
    head128_phase(cfg3, dev)
    torch.cuda.empty_cache()
    prologue_phase(dev, gpu_line)
    torch.cuda.empty_cache()
    clock("build, kernels")

    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    source = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    params = llama.fuse_projections(quant.quantize_tree(
        source, 4, unembed_bits=4, unembed_group=256))
    torch.cuda.synchronize()
    emit({"phase": "weights", "seconds": time.perf_counter() - t0})

    # first path: int4 weights quantized in memory, int4 grouped unembed
    model_phase(cfg, params, dev, "int4, in memory")
    counts, lens = engine_phase(
        cfg, params, Tokenizer.byte_fallback(cfg.vocab_size), dev, gpu_line,
        "int4, in memory", buckets=[16, 64, 256, 512],
        must_launch=["int4_matmul_stacked", "int4_matmul_grouped",
                     "decode_attention", "prefill_attention"])

    # speculation and the paged cache on the same weights, unpaired and in
    # the bf16/f32 form: three requests each (a 64 bucket, a 256 bucket,
    # 512 + 256). Random weights accept few drafts, so the acceptance
    # probe would switch speculation off after 128 slot-macro-steps: the
    # runs keep it on with a break-even of 1.0 and no timing probes
    steps_model_phase(cfg, params, dev)
    byte_tok = Tokenizer.byte_fallback(cfg.vocab_size)
    keep_spec = dict(speculate_tokens=7, spec_auto_breakeven=False,
                     spec_breakeven=1.0)
    paged = dict(paged_pages=33, page_size=512)
    matmuls = ["int4_matmul_stacked", "int4_matmul_grouped"]
    short = dict(prompt_lens=[43, 173, 623], buckets=[64, 256, 512])
    short_paged = dict(prompt_lens=[43, 173, 623], buckets=[512])
    runs = {}

    def run(label, attention, *, size, **kw):
        runs[label], _ = engine_phase(
            cfg, params, byte_tok, dev, gpu_line, "int4, in memory; " + label,
            must_launch=matmuls + attention, **size, **kw)

    run("speculate 7", ["verify_attention", "prefill_attention"],
        size=short, **keep_spec)
    run("33 pages of 512; speculate 7",
        ["paged_verify_attention", "prefill_attention"], size=short_paged,
        **paged, **keep_spec)
    run("33 pages of 512", ["paged_decode_attention", "prefill_attention"],
        size=short_paged, **paged)

    # the reference server's default configuration: paired cache, s8 decode
    # attention; the ten requests of the first run, dense and paged
    full = dict(buckets=[16, 64, 256, 512])
    run("paired, s8", ["decode_attention_s8_paired",
                       "prefill_attention_paired"],
        size=full, pair_kv_heads=True, s8=True)
    # on the page grid the ten prompts have two chunk schedules, (0, 512)
    # and (0, 512), (512, 512): they admit in bursts, whose attention is
    # the plain batched one, so K21 runs only if one arrives alone
    run("paired, s8; 33 pages of 512", ["paged_decode_attention_s8_paired"],
        size=dict(buckets=[512]), pair_kv_heads=True, s8=True,
        may_launch=["prefill_attention_paired"], **paged)
    # burst admission and prefix reuse in the same configuration
    admission_phase(cfg, params, dev, gpu_line)
    torch.cuda.empty_cache()
    # penalties and logit_bias, logprobs and top_logprobs, the seed
    features_phase(cfg, params, dev, gpu_line)
    torch.cuda.empty_cache()
    # fp8 activations, the int8 prefill shadow, dispatch-ahead fetches
    options_phase(cfg, params, dev, gpu_line)
    torch.cuda.empty_cache()
    # the reference's kernel switches: the kernels off, paired prefill off
    switches_phase(cfg, params, dev, gpu_line)
    torch.cuda.empty_cache()
    # the same configuration with the raw-byte-dot form of the stacked
    # int4 products (GABBY_INT4_RAWDOT=1): K33 in place of K1, card against
    # CPU, then three requests
    model_phase(cfg, params, dev, "int4, in memory; raw-byte-dot",
                rawdot=True)
    runs["paired, s8; raw-byte-dot"], _ = engine_phase(
        cfg, params, byte_tok, dev, gpu_line,
        "int4, in memory; paired, s8; raw-byte-dot",
        must_launch=["int4_matmul_stacked_rawdot", "int4_matmul_grouped",
                     "decode_attention_s8_paired",
                     "prefill_attention_paired"],
        pair_kv_heads=True, s8=True, rawdot=True, **short)
    # every remaining form on a path of its own, three requests each
    run("paired; speculate 7",
        ["verify_attention_paired", "prefill_attention_paired"], size=short,
        pair_kv_heads=True, **keep_spec)
    run("paired; 33 pages of 512; speculate 7",
        ["paged_verify_attention_paired", "prefill_attention_paired"],
        size=short_paged, pair_kv_heads=True, **paged, **keep_spec)
    run("paired, bf16/f32 form",
        ["decode_attention_paired", "prefill_attention_paired"], size=short,
        pair_kv_heads=True)
    run("paired, bf16/f32 form; 33 pages of 512",
        ["paged_decode_attention_paired", "prefill_attention_paired"],
        size=short_paged, pair_kv_heads=True, **paged)
    run("unpaired, s8", ["decode_attention_s8", "prefill_attention"],
        size=short, s8=True)
    run("unpaired, s8; 33 pages of 512",
        ["paged_decode_attention_s8", "prefill_attention"], size=short_paged,
        s8=True, **paged)
    # with the s8 switch left on: the slot-batched launch is taken first
    run("unpaired, slot-batched",
        ["decode_attention_multi", "prefill_attention"], size=short,
        s8=True, multi=True)
    del params
    torch.cuda.empty_cache()

    # the reference server's literal defaults (no --quant, no --kv-quant):
    # bf16 weights (the source, fused) on a bf16 paired dense cache, ten
    # requests; then every other bf16-cache kernel on a path of its own,
    # three requests each
    bf16 = llama.fuse_projections(source)
    model_phase(cfg, bf16, dev, "bf16, bf16 paired cache",
                kv_quantized=False, paired=True)

    def run_bf16(label, attention, *, size, **kw):
        runs["bf16; " + label], _ = engine_phase(
            cfg, bf16, byte_tok, dev, gpu_line, "bf16; " + label,
            must_launch=attention, kv_quantized=False, **size, **kw)

    pre = ["prefill_attention_bf16"]
    pre_p = ["prefill_attention_bf16_paired"]
    run_bf16("paired, the literal defaults",
             ["decode_attention_bf16_paired"] + pre_p, size=full,
             pair_kv_heads=True)
    run_bf16("unpaired", ["decode_attention_bf16"] + pre, size=short)
    run_bf16("paired; speculate 7", ["verify_attention_bf16_paired"] + pre_p,
             size=short, pair_kv_heads=True, **keep_spec)
    run_bf16("unpaired; speculate 7", ["verify_attention_bf16"] + pre,
             size=short, **keep_spec)
    run_bf16("paired; 33 pages of 512",
             ["paged_decode_attention_bf16_paired"] + pre_p,
             size=short_paged, pair_kv_heads=True, **paged)
    run_bf16("unpaired; 33 pages of 512",
             ["paged_decode_attention_bf16"] + pre, size=short_paged,
             **paged)
    run_bf16("paired; 33 pages of 512; speculate 7",
             ["paged_verify_attention_bf16_paired"] + pre_p,
             size=short_paged, pair_kv_heads=True, **paged, **keep_spec)
    run_bf16("unpaired; 33 pages of 512; speculate 7",
             ["paged_verify_attention_bf16"] + pre, size=short_paged,
             **paged, **keep_spec)
    run_bf16("unpaired, slot-batched", ["decode_attention_multi_bf16"] + pre,
             size=short, multi=True)
    del bf16
    torch.cuda.empty_cache()

    # Llama-3.2-3B (head_dim 128, 24 q heads over 8 kv heads) at full width
    # and depth: int4 weights, the paired int8 cache and s8 decode, three
    # requests (bench.py's int4_3b); then the card against the CPU on 2 of
    # its 28 layers, on the int8 and on the bf16 paired cache
    t0 = time.perf_counter()
    params3 = llama.fuse_projections(quant.quantize_tree(llama.init_params(
        cfg3, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev), 4, unembed_bits=4,
        unembed_group=256))
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": "llama32_3b",
          "seconds": time.perf_counter() - t0})
    runs["int4_3b"], _ = engine_phase(
        cfg3, params3, Tokenizer.byte_fallback(cfg3.vocab_size), dev,
        gpu_line, "int4_3b: Llama-3.2-3B, int4, paired int8 cache, s8",
        must_launch=matmuls + ["decode_attention_s8_paired",
                               "prefill_attention_paired"],
        pair_kv_heads=True, s8=True, **short)
    del params3
    torch.cuda.empty_cache()
    cfg3s = dataclasses.replace(cfg3, num_layers=2)
    params3s = llama.fuse_projections(quant.quantize_tree(llama.init_params(
        cfg3s, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev), 4, unembed_bits=4,
        unembed_group=256))
    model_phase(cfg3s, params3s, dev, "int4_3b, 2 of 28 layers")
    model_phase(cfg3s, params3s, dev, "int4_3b, 2 of 28 layers",
                kv_quantized=False, paired=True)
    del params3s
    torch.cuda.empty_cache()
    clock("model and engine, weights in memory")

    with tempfile.TemporaryDirectory(prefix="gabby_smoke_") as root:
        dirs = checkpoint_phase(cfg, source, root)
        clock("checkpoint")

        # second path: the int8 checkpoint, the same ten prompt lengths
        cfg8, params8, tok8 = load_checkpoint(dirs[8], 8, source, dev)
        model_phase(cfg8, params8, dev, "int8 checkpoint")
        counts8, _ = engine_phase(
            cfg8, params8, tok8, dev, gpu_line, "int8 checkpoint",
            prompt_lens=lens, buckets=[16, 64, 256, 512],
            must_launch=["int8_matmul_stacked", "int8_matmul",
                         "decode_attention", "prefill_attention"])
        del params8
        torch.cuda.empty_cache()

        # third path: the int4 checkpoint with both int4 switches on; 64
        # tokens (W4A8 at M = 64), a 256 bucket, and 512 + 256
        cfg4, params4, tok4 = load_checkpoint(dirs[4], 4, source, dev)
        del source
        ck.set_w4a8(True)
        ck.set_int4_prefill_kernel(True)
        try:
            # W4A8 rounds every activation row to int8 codes: where the
            # card's bf16 activations and the CPU's differ by a code step
            # (1/127 of the row's range) the two sides' rounding errors no
            # longer cancel, so the bound is twice the bf16 paths'
            model_phase(cfg4, params4, dev, "int4 checkpoint, w4a8 + "
                        "int4 prefill kernel", tol=0.10)
            counts4, _ = engine_phase(
                cfg4, params4, tok4, dev, gpu_line, "int4 checkpoint, "
                "w4a8 + int4 prefill kernel", prompt_lens=[43, 173, 623],
                buckets=[64, 256, 512],
                must_launch=["int4_matmul", "int4_matmul_w4a8_stacked",
                             "int8_matmul", "decode_attention",
                             "prefill_attention"])
        finally:
            ck.set_w4a8(None)
            ck.set_int4_prefill_kernel(None)
        if counts4["int4_matmul_stacked"]:
            raise AssertionError("w4a8 is on but K1 launched")
        del params4
        torch.cuda.empty_cache()
        clock("model and engine, checkpoints")

        # the default command line (paired cache, s8 decode attention);
        # the checkpoint with both switched back; speculation and pages on
        # the default again. Three servers side by side, one process each
        if shutil.which("cmake") is not None:
            from gabby_tpu_torch.bridge import build_native
            build_native()
        random_int4 = ["--preset", "llama32_1b", "--random-weights",
                       "--quant", "4", "--kv-quant"]
        servers = [
            ("the literal defaults: random bf16, bf16 paired cache",
             ["--preset", "llama32_1b", "--random-weights"], None),
            ("random int4, --act-fp8 --prefill-int8-shadow "
             "--pipeline-fetch", random_int4 + [
                 "--act-fp8", "--prefill-int8-shadow", "--pipeline-fetch"],
             None, True),
            ("int8 checkpoint, --no-pair-kv, GABBY_ATTN_S8=0",
             ["--model-dir", dirs[8], "--kv-quant", "--no-pair-kv"],
             {"GABBY_ATTN_S8": "0"}),
            ("random int4, speculate 7, 33 pages",
             random_int4 + ["--speculate", "7", "--paged-pages", "33"], None)]
        with concurrent.futures.ThreadPoolExecutor(len(servers)) as pool:
            for done in [pool.submit(http_phase, *server)
                         for server in servers]:
                done.result()

    clock("http")
    # the reference's public decode ops without fresh rows (K34-K41)
    nofresh = nofresh_path_phase(cfg, dev, gpu_line)
    torch.cuda.empty_cache()
    # --profiler-port: a capture while the ten chat requests run
    profiler_phase(gpu_line)
    # the decode profile of the int4 1B model
    profile_decode_phase(gpu_line)
    clock("nofresh, profiler, profile_decode")
    # tensor parallelism over two ranks on this card
    one, one_runs = tp_phase(cfg, dev, gpu_line)
    clock("tensor-parallel")
    # data parallelism: two replicas on this card
    dp_phase(cfg, dev, gpu_line, one, one_runs)
    clock("data-parallel")
    # each kernel's launches come from the run of the path that is its own
    own = {"int8_matmul_stacked": counts8, "int8_matmul": counts8,
           "int4_matmul_stacked_rawdot": runs["paired, s8; raw-byte-dot"],
           "int4_matmul": counts4, "int4_matmul_w4a8_stacked": counts4,
           "verify_attention": runs["speculate 7"],
           "paged_verify_attention": runs["33 pages of 512; speculate 7"],
           "paged_decode_attention": runs["33 pages of 512"],
           "decode_attention_s8_paired": runs["paired, s8"],
           "prefill_attention_paired": runs["paired, s8"],
           "paged_decode_attention_s8_paired":
               runs["paired, s8; 33 pages of 512"],
           "verify_attention_paired": runs["paired; speculate 7"],
           "paged_verify_attention_paired":
               runs["paired; 33 pages of 512; speculate 7"],
           "decode_attention_paired": runs["paired, bf16/f32 form"],
           "paged_decode_attention_paired":
               runs["paired, bf16/f32 form; 33 pages of 512"],
           "decode_attention_s8": runs["unpaired, s8"],
           "paged_decode_attention_s8":
               runs["unpaired, s8; 33 pages of 512"],
           "decode_attention_multi": runs["unpaired, slot-batched"],
           "prefill_attention_bf16": runs["bf16; unpaired"],
           "decode_attention_bf16": runs["bf16; unpaired"],
           "prefill_attention_bf16_paired":
               runs["bf16; paired, the literal defaults"],
           "decode_attention_bf16_paired":
               runs["bf16; paired, the literal defaults"],
           "verify_attention_bf16": runs["bf16; unpaired; speculate 7"],
           "verify_attention_bf16_paired": runs["bf16; paired; speculate 7"],
           "paged_decode_attention_bf16":
               runs["bf16; unpaired; 33 pages of 512"],
           "paged_decode_attention_bf16_paired":
               runs["bf16; paired; 33 pages of 512"],
           "paged_verify_attention_bf16":
               runs["bf16; unpaired; 33 pages of 512; speculate 7"],
           "paged_verify_attention_bf16_paired":
               runs["bf16; paired; 33 pages of 512; speculate 7"],
           "decode_attention_multi_bf16":
               runs["bf16; unpaired, slot-batched"],
           **{name: nofresh for name in NOFRESH_COUNTS}}
    for k in kernels:
        name = k.get("counter", k["name"])
        k["launches"] = own.get(name, counts)[name]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")} for k in kernels]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
