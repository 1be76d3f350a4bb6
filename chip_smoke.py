#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gabby_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure is an uncaught exception and
a non-zero exit:
  1. card        the GPU's name and power limit (nvidia-smi);
  2. build       nvcc builds gabby_tpu_torch/csrc/*.cu (one process per
                 source, all started together);
  3. kernels     each kernel (K1-K21) at the serving path's shapes for
                 Llama-3.2-1B (8 slots, context 1024 in a 2048-row cache;
                 K4 and K21 at T=512, offset 512; K7 at one 512-token
                 chunk; the verify kernels at a block of 8; the paged ones
                 through a shuffled table of 512-row pages) against its
                 plain PyTorch version on the same inputs (the attention
                 kernels within 2e-2 relative plus a share of the plain
                 row's RMS, 5e-2 for the bf16/f32 forms and 1e-2 for the
                 s8 forms; K8 also on its
                 int32 accumulator, by equality; a paired kernel also
                 against the unpaired one on the same rows re-laid, by
                 equality where the body is the same; an s8 kernel also
                 against the dequantized contract at 6e-2, and further
                 than its own tolerance from the bf16/f32 kernel and from
                 the s8 form at half the chunk size, so that the tolerance
                 tells those apart; the
                 slot-batched kernel against K3 by equality), timed with
                 CUDA events, eagerly and replayed from a CUDA graph (the
                 device's share of the eager time), beside the plain
                 version, one PyTorch library
                 call computing the same function (yardstick only), and the
                 least time the card could take (bytes at 3.35 TB/s or
                 operations at the tensor-core peak of the operand type,
                 whichever is larger);
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
                 form on against off;
  5. engine      Engine(batch_slots=8, max_seq=2048, int8 KV) serving 10
                 concurrent chat requests whose prompts hit every prefill
                 bucket and three multi-chunk ones, 32 new tokens each,
                 on the unpaired cache with the bf16/f32 form; K1-K4 must
                 all launch during this run. Then the reference server's
                 default configuration (`pair_kv_heads=True`, s8 on) on
                 the same ten requests, dense (K15, K21) and with
                 `paged_pages=33, page_size=512` (K20), and eleven runs of
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
                 tokens per verify step are printed. In every run an
                 attention kernel that is not the run's own must not
                 launch;
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
  8. http        `python -m gabby_tpu_torch.server` three times side by
                 side, each in its own process:
                 once with random weights on the default command line
                 (paired cache, s8), once with `--model-dir <int8
                 directory> --kv-quant --no-pair-kv` and GABBY_ATTN_S8=0,
                 and once with random weights and `--speculate 7
                 --paged-pages 33`, one chat completion each through the
                 C++ front-end, then SIGTERM, where cmake exists to build
                 it (else a skip line saying why);
  9. summary     the kernels line (twenty-one kernels), then
                 {"ok": true, "device": {...}} last.

Weights are random (Llama-3.2-1B at full width and depth, seed 0). The
first engine run serves them as int4 weights fused into wqkv/w_gup with
the int4 group-256 unembed and keeps its ten requests; the second and
third serve them from the checkpoints, whose unembed is int8 per channel.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import shutil
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


def kernel_phase(cfg, dev):
    """K1-K21 at the 1B serving shapes against their plain versions."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops import quant
    from gabby_tpu_torch.ops.attention import gather_layer
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

    # the four projections of a layer: wqkv, wo, w_gup, w_down
    projs = [(d, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, d),
             (d, 2 * cfg.intermediate_size), (cfg.intermediate_size, d)]

    def stacked_case(name, source, replaces, kernel, plain, *, bits, m,
                     what, iters=10, exact=None, peak=BF16_FLOP_PER_S,
                     default=None):
        """One call set of a stacked-weight kernel: 4 projections x 16
        layers at M = m, against its plain version, timed, with the
        dequantized bf16 `torch.matmul` as the library yardstick. `exact`
        names a keyword that makes kernel and plain version also return an
        integer tensor that must be equal. `default`: the port's own path
        for the same products when the kernel is switched off, timed as
        `default_path_ms`; the kernel's and the library's graph times are
        then also given by projection."""
        rows = 2 if bits == 4 else 1  # weight rows per packed byte row
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
        del outs, refs
        dense = [(q if bits == 8 else torch.stack(
            [unpack_int4(q[i]) for i in range(nl)])).bfloat16()
            * sc[:, None, :].bfloat16() for q, sc, _ in mats]
        extra = {}
        if default is not None:
            extra["default_path_ms"] = time_ms(
                lambda: [default(*c) for c in calls], iters)
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
        results.append(dict(
            name=name, shapes=f"{what}: wqkv, wo, w_gup, w_down x 16 "
            f"layers, M={m}", route="cuda", source=source,
            replaces=replaces, max_abs_err=err,
            ms=time_ms(lambda: [kernel(*c) for c in calls], iters),
            graph_ms=graph_ms(lambda: [kernel(*c) for c in calls], iters),
            plain_ms=time_ms(lambda: [plain(*c) for c in calls], 3),
            library_ms=time_ms(lambda: [torch.matmul(x, w[layer])
                                        for layer in range(nl)
                                        for w, (_, _, x) in zip(dense,
                                                                mats)],
                               iters),
            **extra, **bound(nbytes, ops, peak)))

    def attn_case(name, shapes, source, replaces, kernel, plain, library,
                  nbytes, ops, *, iters=10, peak=BF16_FLOP_PER_S, equal=None,
                  close=None, contract=None, tol=ATTN_TOL, apart=(),
                  case=None):
        """One attention kernel's 16 launches (one per layer; kernel, plain
        and library take the layer) against its plain version, timed
        beside it and beside the library call, eagerly (`ms`, what the
        engine pays today) and replayed from a CUDA graph (`graph_ms`, the
        device's share). `equal`: another kernel
        whose outputs must be the same bit for bit (the same body on the
        same rows re-laid); `close`: one held to `tol`; `contract`: the
        dequantized form, held to S8_CONTRACT_TOL; `apart`: (what, function)
        pairs of other forms of the same attention, from each of which the
        kernel must lie further than `tol` in every layer; `case`: a second
        timing of a kernel at other shapes, listed under its name with the
        case beside it."""
        outs = [kernel(i) for i in range(nl)]
        err = check(name, outs, [plain(i) for i in range(nl)], tol)
        far = {what: check_apart(f"{name} and {what}", outs,
                                 [other(i) for i in range(nl)], tol)
               for what, other in apart}
        if equal is not None and not all(
                torch.equal(o, equal(i)) for i, o in enumerate(outs)):
            raise AssertionError(f"{name}: differs from the same kernel on "
                                 f"the unpaired rows")
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
            **bound(nbytes, ops, peak)))

    pa = "gabby_tpu/ops/pallas/attention.py"
    csrc = "gabby_tpu_torch/csrc/"
    qm = "gabby_tpu/ops/pallas/quant_matmul.py"
    # K1: one decode step's 64 launches (4 projections x 16 layers), M = 8
    stacked_case("int4_matmul_stacked",
                 "gabby_tpu_torch/csrc/quant_matmul.cu", qm + ":424",
                 cqm.qmatmul_int4_stacked, cqm.int4_stacked_plain, bits=4,
                 m=b, what="one decode step")
    # K5: the same call set on int8 stacks
    stacked_case("int8_matmul_stacked",
                 "gabby_tpu_torch/csrc/quant_matmul.cu", qm + ":504",
                 cqm.qmatmul_int8_stacked, cqm.int8_stacked_plain, bits=8,
                 m=b, what="one decode step")
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
    # K8: K1's call set with int8 activations and integer dots; the int8
    # tensor-core rate is the operations peak of its operand type
    stacked_case("int4_matmul_w4a8_stacked",
                 "gabby_tpu_torch/csrc/quant_matmul_w4a8.cu", qm + ":766",
                 cqm.qmatmul_int4_w4a8_stacked,
                 cqm.int4_w4a8_stacked_plain, bits=4, m=b,
                 what="one decode step", exact="return_acc",
                 peak=INT8_OP_PER_S)

    # K2: the int4 unembed, one launch per decode step, M = 8
    kp, vpad, group = d // 2, 129024, 256
    up = rand_bytes(kp, vpad)
    us = torch.rand((d // group, vpad), generator=g, device=dev) * 0.02
    ux = torch.randn((b, d), generator=g, device=dev).bfloat16()
    err = check("int4_matmul_grouped",
                [cqm.qmatmul_int4_grouped(ux, up, us, group)],
                [cqm.int4_grouped_plain(ux, up, us, group)])
    uw = (unpack_int4(up).float()
          * torch.repeat_interleave(us, group, dim=0)).bfloat16()
    nbytes = up.numel() + us.numel() * 4 + ux.numel() * 2 + b * vpad * 2
    results.append(dict(
        name="int4_matmul_grouped", shapes="unembed [2048 -> 129024], "
        "group 256, M=8", route="cuda",
        source="gabby_tpu_torch/csrc/quant_matmul.cu",
        replaces="gabby_tpu/ops/pallas/quant_matmul.py:640",
        max_abs_err=err,
        ms=time_ms(lambda: cqm.qmatmul_int4_grouped(ux, up, us, group)),
        graph_ms=graph_ms(lambda: cqm.qmatmul_int4_grouped(ux, up, us,
                                                           group)),
        plain_ms=time_ms(lambda: cqm.int4_grouped_plain(ux, up, us, group),
                         3),
        library_ms=time_ms(lambda: torch.matmul(ux, uw)),
        **bound(nbytes, 2 * b * d * vpad)))
    del up, us, uw

    # K6: the int8 unembed of a loaded checkpoint (vocab not padded), M = 8
    v = cfg.vocab_size
    uc = rand_bytes(d, v)
    us = torch.rand((v,), generator=g, device=dev) * 0.002
    err = check("int8_matmul", [cqm.qmatmul_int8(ux, uc, us)],
                [cqm.int8_plain(ux, uc, us)])
    uw = uc.bfloat16() * us.bfloat16()
    nbytes = uc.numel() + us.numel() * 4 + ux.numel() * 2 + b * v * 2
    results.append(dict(
        name="int8_matmul", shapes="unembed [2048 -> 128256], M=8",
        route="cuda", source="gabby_tpu_torch/csrc/quant_matmul.cu",
        replaces=qm + ":287", max_abs_err=err,
        ms=time_ms(lambda: cqm.qmatmul_int8(ux, uc, us)),
        graph_ms=graph_ms(lambda: cqm.qmatmul_int8(ux, uc, us)),
        plain_ms=time_ms(lambda: cqm.int8_plain(ux, uc, us), 3),
        library_ms=time_ms(lambda: torch.matmul(ux, uw)),
        **bound(nbytes, 2 * b * d * v)))
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
                           ("the s8 form in chunks of 512", s8_half_chunks)])

    decode_case("decode_attention", cattn.decode_attention,
                cattn.decode_attention_plain, kc, vc, "",
                source=csrc + "decode_attention.cu", replaces=pa + ":256")
    # K12: K3's work on the paired cache (the shared row body at T = 1)
    decode_case("decode_attention_paired", cattn.decode_attention,
                cattn.decode_attention_plain, kcp, vcp, ", paired",
                source=csrc + "verify_attention.cu", replaces=pa + ":256",
                close=k3)
    # K14, K15: the s8 form, one 1024-row quantization chunk a slot; the
    # operations are integer ones, so the int8 peak bounds them
    decode_case("decode_attention_s8", cattn.decode_attention_s8,
                cattn.decode_attention_s8_plain, kc, vc, ", s8 dots",
                **s8_dense)
    decode_case("decode_attention_s8_paired", cattn.decode_attention_s8,
                cattn.decode_attention_s8_plain, kcp, vcp,
                ", paired, s8 dots", **s8_dense,
                equal=lambda i: cattn.decode_attention_s8(
                    q, kc, vc, ks, vs, pos, layer=i, window=ctx + 1, **kw))
    # K16: K3's work, 4 slots of a kv head in a block
    decode_case("decode_attention_multi", cattn.decode_attention_multi,
                cattn.decode_attention_plain, kc, vc,
                f", {cattn.pick_slot_block(b)} slots a block",
                source=csrc + "decode_attention.cu", replaces=pa + ":460",
                equal=k3)
    del kd, vd

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

    verify_case("verify_attention", kc, vc, "")
    # K13: K9's work on the paired cache
    verify_case("verify_attention_paired", kcp, vcp, ", paired",
                equal=lambda i: cattn.verify_attention(
                    qv, kc, vc, ks, vs, pos, layer=i, window=2048, **kwv))
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
                           ("the s8 form in chunks of 256", s8_half_pages)])

    # K10: K3's work read through the table
    paged_case("paged_decode_attention", cpaged.paged_decode_attention,
               cpaged.paged_decode_attention_plain, pool, "", pa + ":800",
               source=csrc + "paged_attention.cu")
    # K17: K10's work on the paired pool
    paged_case("paged_decode_attention_paired",
               cpaged.paged_decode_attention,
               cpaged.paged_decode_attention_plain, pool_p, ", paired",
               pa + ":800", source=csrc + "paged_attention.cu",
               equal=lambda i: cpaged.paged_decode_attention(
                   q, *pool, layer=i, **kw))
    # K19, K20: the s8 form through the table, one chunk a page
    paged_case("paged_decode_attention_s8", cpaged.paged_decode_attention_s8,
               cpaged.paged_decode_attention_s8_plain, pool, ", s8 dots",
               pa + ":800", **s8_paged)
    paged_case("paged_decode_attention_s8_paired",
               cpaged.paged_decode_attention_s8,
               cpaged.paged_decode_attention_s8_plain, pool_p,
               ", paired, s8 dots", pa + ":800", **s8_paged,
               equal=lambda i: cpaged.paged_decode_attention_s8(
                   q, *pool, layer=i, **kw))

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

    paged_verify_case("paged_verify_attention", pool, "")
    paged_verify_case("paged_verify_attention_paired", pool_p, ", paired",
                      equal=lambda i: cpaged.paged_verify_attention(
                          qv, *pool, layer=i, **kwv))
    for r in results:
        emit({"phase": "kernels", "tol": TOL, **r})
    return results


def model_phase(cfg, params, dev, label: str, tol: float = 0.05):
    """The card's forward (kernels) against the CPU's (plain versions) on
    the same weights: a 16-token prefill, then 3 greedy decode steps, on
    the unpaired cache with the bf16/f32 form of decode attention (the
    paired layout and the s8 form are held against these on the card, in
    `steps_model_phase`). `tol` bounds the largest logit difference
    relative to the largest logit."""
    from gabby_tpu_torch.models import llama
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops.quant import QTensor
    from gabby_tpu_torch.runtime.kv_cache import create_cache

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return tree.to("cpu")
        return None if tree is None else tree.cpu()

    cpu_params = to_cpu(params)
    caches = {"card": create_cache(cfg, 1, 64, quantized=True, device=dev),
              "cpu": create_cache(cfg, 1, 64, quantized=True, device="cpu")}
    ps = {"card": params, "cpu": cpu_params}
    ids = torch.arange(16) * 7919 % 128000 + 100
    logits = {}
    ck.set_attn_s8(False)
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
    emit({"phase": "model", "weights": label, "steps": steps,
          "argmax_agree": agree,
          "max_rel_logit_err": worst})
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


def compare_steps(cfg, what: str, got, want, tol: float):
    """`got` [8, V] against `want`: `tol` bounds the largest logit
    difference relative to the largest logit; a step passes when the argmax
    agrees or the token chosen is within 2 * tol of the best in `want`
    (each side may be off by tol: with random weights the two best logits
    are sometimes a near-tie)."""
    steps = want.shape[0]
    if got.shape != (steps, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"model ({what}): bad logits")
    top = want.abs().max()
    worst = ((got - want).abs().max() / top).item()
    chosen = got.argmax(-1, keepdim=True)
    gap = (want.max(-1).values - want.gather(1, chosen)[:, 0]) / top
    agree = int((gap == 0).sum())
    ties = int(((gap > 0) & (gap <= 2 * tol)).sum())
    emit({"phase": "model", "check": what, "steps": steps,
          "argmax_agree": agree, "near_ties": ties,
          "max_rel_logit_err": worst, "bound": tol})
    if worst > tol or agree + ties < steps:
        raise AssertionError(f"model ({what}): disagrees ({worst}, "
                             f"{agree}/{steps} argmax, {ties} near-ties)")


def steps_model_phase(cfg, params, dev, tol: float = 0.05):
    """`card_steps` three times. Unpaired, bf16/f32 form (K3, K10, K9,
    K11): the paged logits and both verify passes against the dense
    sequential ones; the kernels reassociate sums and the verify matmuls
    run at M = 16 instead of M = 2, hence `tol`. Paired, bf16/f32 form
    (K12, K17, K13, K18, K21), fed the same tokens: each of the four
    against its unpaired counterpart, same `tol` (K13, K17, K18 and K21
    are their unpaired kernels' bodies; K12 sums in another order than
    K3). Paired with the s8 form on (K15, K20): the two decode paths
    against the paired bf16/f32 ones at 2 * tol, since s8 rounds q and the
    probabilities to 1/127 of their row's range in every layer, as W4A8
    rounds activations."""
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


# chat prompts of the first engine run: content lengths in characters. A
# chat prompt is its content plus 23 template tokens under the byte
# tokenizer; the chunk schedules cover buckets 64, 256 and 512, multi-chunk
# prompts (512 + 16, 512 + 256, 512 + 512) and with them bucket 16
CONTENT_SIZES = [20, 40, 150, 200, 400, 450, 502, 600, 900, 5]
NEW_TOKENS = 32


def engine_phase(cfg, params, tok, dev, gpu_line: str, label: str, *,
                 prompt_lens=None, must_launch, buckets, s8: bool = False,
                 multi: bool = False, **engine_kw):
    """Serves one batch of concurrent requests through the engine with the
    launch counts set to 0 just before and read just after. The prompts
    are chat messages (prompt_lens None: CONTENT_SIZES) or token ids of
    the given lengths; `engine_kw` are further EngineConfig fields
    (`pair_kv_heads` among them, off unless given); `s8` and `multi` set
    the two decode-attention switches for the run. Every attention kernel
    outside `must_launch` must stay at 0: each has a path of its own.
    Returns (counts, prompt lengths)."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.runtime.engine import Engine, EngineConfig

    ck.set_attn_s8(s8)
    ck.set_attn_multi(multi)
    eng = Engine(cfg, params, tok, EngineConfig(
        batch_slots=8, max_seq=2048, kv_quantized=True, **engine_kw),
        device=dev)
    try:
        warm = eng.submit([{"role": "user", "content": "warm up"}],
                          max_tokens=4)
        while warm.out.get()[1] is None:
            pass
        ck.reset_launch_counts()
        stats0 = eng.stats_snapshot()
        t0 = time.perf_counter()
        if prompt_lens is None:
            reqs = [eng.submit(
                [{"role": "user",
                  "content": "".join(chr(97 + (i * 7 + j) % 26)
                                     for j in range(n))}],
                max_tokens=NEW_TOKENS)
                for i, n in enumerate(CONTENT_SIZES)]
        else:
            span = min(cfg.vocab_size, tok.vocab_size) - 16
            reqs = [eng.submit_ids(
                [(i * 7919 + j * 104729) % span + 1 for j in range(n)],
                max_tokens=NEW_TOKENS) for i, n in enumerate(prompt_lens)]
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
    stray = [k for k, n in counts.items()
             if n and "attention" in k and k not in must_launch]
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
            "prompt_tokens": lens, "output_tokens": out_tokens,
            "wall_s": wall, "output_tok_per_s": out_tokens / wall,
            "p50_ttft_ms": stats.get("p50_ttft_ms"),
            "decode_steps": stats["decode_steps"] - stats0["decode_steps"],
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


def http_phase(label: str, weights_args: list, env=None):
    """`python -m gabby_tpu_torch.server` as a user starts it (its own
    process, the server on its main thread; `env` adds to its
    environment), one chat completion through the C++ front-end, then
    SIGTERM."""
    if shutil.which("cmake") is None:
        emit({"phase": "http", "weights": label,
              "skipped": "cmake is not installed, so the "
              "C++ front-end (cpp/) cannot be built here"})
        return
    import http.client
    import queue

    proc = subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-m",
         "gabby_tpu_torch.server", *weights_args, "--kv-quant",
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
    the kernels of one source, from the verbose build's output."""
    keep, on = [], False
    for line in log.splitlines():
        if line.startswith("[nvcc "):
            on = line == f"[nvcc {src}]"
        elif on and any(w in line for w in ("Compiling entry", "Used",
                                            "spill")):
            keep.append(" ".join(line.split()))
    return keep


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
    for src in ("quant_matmul_prefill.cu", "prefill_attention.cu"):
        emit({"phase": "build", "ptxas": src,
              "lines": ptxas_lines(log.getvalue(), src)})

    cfg = cfglib.llama32_1b(max_seq_len=2048)
    kernels = kernel_phase(cfg, dev)
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
    run("paired, s8; 33 pages of 512",
        ["paged_decode_attention_s8_paired", "prefill_attention_paired"],
        size=dict(buckets=[512]), pair_kv_heads=True, s8=True, **paged)
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
                       "--quant", "4"]
        servers = [
            ("random int4", random_int4, None),
            ("int8 checkpoint, --no-pair-kv, GABBY_ATTN_S8=0",
             ["--model-dir", dirs[8], "--no-pair-kv"],
             {"GABBY_ATTN_S8": "0"}),
            ("random int4, speculate 7, 33 pages",
             random_int4 + ["--speculate", "7", "--paged-pages", "33"], None)]
        with concurrent.futures.ThreadPoolExecutor(len(servers)) as pool:
            for done in [pool.submit(http_phase, *server)
                         for server in servers]:
                done.result()

    clock("http")
    # each kernel's launches come from the run of the path that is its own
    own = {"int8_matmul_stacked": counts8, "int8_matmul": counts8,
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
           "decode_attention_multi": runs["unpaired, slot-batched"]}
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
