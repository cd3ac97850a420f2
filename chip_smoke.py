#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``modelcompose_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
nonzero:

1. device: the card's name and power limit, TF32 off for the comparisons;
2. build: every hand-written kernel compiled by nvcc from ``csrc/``, one
   nvcc per source, all started together;
3. K1 (flash-attention forward) against its plain PyTorch version, at
   the vision path's 1,024 bucket and the composed path's 3,328, with its
   bound and the time of ``scaled_dot_product_attention`` on the same
   inputs (the yardstick, never called by the port);
4. K2 (split-KV flash-decode) against its plain PyTorch version, over the
   vision path's int8 cache of 1,056 positions and the composed path's
   3,360, timed cycling over the 32 layers of the stacked cache so that
   each launch finds its layer cold in L2, as decode does;
5. the serving path at Vicuna-7B width: a vision DAMC composition (CLIP
   ViT-L/14-336, linear projector, routed LoRA r=128) with random weights,
   int8 base, the default adapter mix folded into W, int8 KV cache,
   answering two image+question requests greedily through
   ``MultimodalLM.generate``; then prefill and teacher-forced decode on the
   plain path with the same weights and tokens, logits held to a bf16
   tolerance;
6. composed: the MCUB-4 composition (``configs.mcub4_damc_7b``: CLIP,
   BEATs + Q-Former, LanguageBind video and PointBERT towers, 9 stacked
   adapter rows, online-merge-reset 0.25 each) at Vicuna-7B width with
   random weights, in the same production variant plus the adapter stacks
   compacted to the batch's columns: one four-modality request of 3,287
   positions (the 3,328 bucket) answered with 32 greedy tokens; the time
   of each tower and projector, prefill, decode, peak memory, the kernel
   path's logits against the plain path's, and torch.profiler over the
   towers + prefill (``chiprun_out/composed_profile.txt``);
7. loader: four unimodal r=128 DAMC checkpoints and a sharded
   Vicuna-layout base at full width and 2 layers, written to disk, merged
   and loaded onto the card by the port; every loaded leaf held to what
   was written, then the int8 + folded load answers the MCUB-4 request;
8. K3 (flash-attention dQ) and K4 (dK, dV) against their plain versions,
   on K1's output and LSE, which are held against theirs at each of these
   shapes too: the shape K3/K4 have been timed at since their port, the
   train step's batch and its micro-batches, with SDPA's backward beside
   them (a boolean mask at B=2, ``is_causal`` at B=1);
9. the training path at Vicuna-7B width: the vision DAMC stage-2 recipe
   (bf16 base, modal+language LoRA r=128, 5+5 soft tokens, mlp2x_gelu
   projector, remat) built through the train entry, four
   ``make_train_step`` steps on two image+question+answer samples, one
   accumulation window of two micro-batches through
   ``make_grad_and_apply``, torch.profiler over one more step (device time
   by kernel, the K1/K3/K4 shares; the table goes to
   ``chiprun_out/train_profile.txt``), then the kernel path's loss and
   gradients against the plain path's on one micro-batch.

The line before the last is a JSON object with each kernel's launches on the
main paths, its largest error against the plain version, its time, the plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes over 3.35 TB/s and the operations over
989 TFLOP/s bf16, counting the valid causal pairs and the valid cache bytes
of this run's inputs; ``bound_by`` says which) and one library call's time
(``library_ms``, or null where no call computes the same function).  Each
row's own keys keep the shape and timing of earlier runs: K1 at the vision
bucket and K2 over the vision cache (CUDA events over warm launches), K3/K4
at B=2, L=2,048 with rows of 2,048 and 1,391; K1's and K2's ``mcub4`` hold
the composed path's shape, K2's ``*_cold`` keys its device time with every
launch on a cold layer, and K3's and K4's ``train_batch`` and
``micro_batch`` the train step's shapes.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits nonzero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

K1_SOURCE = "modelcompose_tpu_torch/csrc/flash_attention_fwd.cu"
K1_REPLACES = "modelcompose_tpu/ops/flash_attention.py:113"
K2_SOURCE = "modelcompose_tpu_torch/csrc/flash_decode.cu"
K2_REPLACES = "modelcompose_tpu/ops/flash_decode.py:50"
K34_SOURCE = "modelcompose_tpu_torch/csrc/flash_attention_bwd.cu"
K3_REPLACES = "modelcompose_tpu/ops/flash_attention.py:287"
K4_REPLACES = "modelcompose_tpu/ops/flash_attention.py:328"

# bf16 tolerances, relative to max |reference| on the compared rows: bf16
# keeps 8 mantissa bits (~0.4% per rounding); the kernel and its plain
# version round P, the output and (K2) the accumulation order differently.
ATTN_TOL = 2e-2
LSE_TOL = 1e-3      # fp32 statistics from identical bf16 operands
# Logits of the 7B path, relative to max |logit|.  The random 32-layer bf16
# network amplifies any rounding difference: on an H100 two plain PyTorch
# attentions (attention_reference vs the kernels' plain versions) gave
# logits 4.6% apart at every step, the kernel path 4.1-4.8% from either.
LOGIT_TOL = 8e-2
# The composed path at the 3,328 bucket: on an H100 the two plain PyTorch
# attentions gave MCUB-4 logits 3.4% (prefill) and up to 4.0% (decode)
# apart, inside the same bound.
COMPOSED_LOGIT_TOL = LOGIT_TOL
# Kernel path against plain path on the 7B train step: the same random
# network amplifies bf16 rounding (logits 4.6% apart between two plain
# attentions), so gradients are compared by direction and size.
GRAD_COS = 0.99
GRAD_NORM_TOL = 0.05

SEED = 0
NEW_TOKENS = 32
TRAIN_STEPS = 4
# The MCUB-4 prompt: 586 + 42 + 2,066 + 523 feature positions and 70 text
# tokens, packed in the 3,328 bucket; K1 at its prefill shape.
MCUB4_POSITIONS = 3287
MCUB4_K1 = dict(B=1, Lq=3328, S=3328, H=32, Hkv=32, D=128, q_offset=0,
                lengths=[MCUB4_POSITIONS])
# Adapter rows a 4-modal MCUB-4 prompt reaches after the fold: all but the
# dead 'default' (the JAX package's active_adapter_set gives the same on
# this table: tests/test_torch_compose.py).
MCUB4_ACTIVE = 8
LOADER_LAYERS = 2
# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3.  A card set below 700 W runs under them.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    import torch
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


def cuda_time_cycle_ms(fn, n: int, rounds: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``rounds`` passes of i = 0..n-1
    after a warm-up pass: with ``i`` a layer of a stacked cache larger than
    L2, every launch finds its operands cold, as a decode step does."""
    import torch
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for i in range(n):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * n)


def device_time_cycle_ms(fn, n: int, rounds: int = 2) -> float:
    """Device time of ``fn(i)`` per call, i cycling over 0..n-1 as in
    ``cuda_time_cycle_ms``: the sum of its kernels' durations from
    torch.profiler, so the host's launch gaps between calls (which event
    timing of a kernel of a few microseconds measures instead) drop out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for i in range(n):
                fn(i)
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type.name == "CUDA")
    return total_us / 1e3 / (rounds * n)


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what sets it)."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _valid_pairs(kw, Lq, S):
    """Query-key pairs the mask keeps, summed over the batch."""
    from modelcompose_tpu_torch.ops.flash_attention import _mask
    q_seg, kv_seg = kw["q_segment_ids"], kw["kv_segment_ids"]
    return int(_mask(q_seg, kv_seg, kw["causal"], kw["q_offset"], Lq, S,
                     q_seg.device).sum())


def _kernel_names(fn):
    """Names of the device kernels one call of ``fn`` launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.device_time_total > 0})


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false); nothing ran")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return torch.device("cuda", 0)


def phase_build():
    from modelcompose_tpu_torch import _build
    t0 = time.perf_counter()
    names = sorted(_build.SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        list(pool.map(_build.load, names))
    for name in names:
        log("build", kernel=name, seconds=f"{_build.build_seconds[name]:.1f}",
            ptxas=json.dumps(_ptxas_report(_build.build_log.get(name, ""))))
    k1, k2 = _build.load("flash_attention_fwd"), _build.load("flash_decode")
    k34 = _build.load("flash_attention_bwd")
    log("build", dynamic_smem_bytes=json.dumps({
        "flash_attention_fwd D128": k1.mc_flash_attention_fwd_smem(128),
        "flash_attention_fwd D64": k1.mc_flash_attention_fwd_smem(64),
        "flash_decode D128 int8 G1": k2.mc_flash_decode_smem(128, 1),
        "flash_decode D128 bf16 G1": k2.mc_flash_decode_smem(128, 0),
        "flash_attention_bwd dq D128": k34.mc_flash_attention_bwd_smem(0, 128),
        "flash_attention_bwd dkv D128":
            k34.mc_flash_attention_bwd_smem(1, 128)}))
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")


def _ptxas_report(text: str):
    """{instantiation: "registers, spills"} from nvcc's -Xptxas -v output:
    the kernel's name and template arguments as mangled (``ILi128ELi1EaE``:
    128, 1, int8)."""
    import re
    report, current = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '.*?([a-z]+_[a-z_]*_kernel)"
                      r"(I\w*?E)E", ln)
        if m:
            current = m.group(1) + m.group(2)
        elif current and "spill" in ln:
            report[current] = ln.strip()
        elif current and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            report[current] = f"{regs.group(1)} registers; " \
                + report.get(current, "")
    return report


def _rel_err(got, want, rows=None):
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs().max().item()
    return err, err / max(w.abs().max().item(), 1e-6)


def _k1_case(device, gen, *, B, Lq, S, H, Hkv, D, q_offset, lengths,
             library=False):
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v = rnd(B, Lq, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (torch.arange(S, device=device)[None]
              < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    name = f"B{B} Lq{Lq} S{S} H{H}/{Hkv} D{D} q_offset{q_offset}"
    err, rel, lse_err = _check_k1(name, q, k, v, kw, out, lse)
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, **kw))
    # What the outputs need, each moved once: q and k on valid rows (a
    # padding row reads no q, padding keys are masked for every row), all
    # of V (a padding row's output is the mean of V), out and the LSE
    # written, the segment ids read.
    n_q, n_k = int((q_seg != 0).sum()), int((kv_seg != 0).sum())
    nbytes = 2 * D * (H * n_q + Hkv * n_k) + 2 * (v.numel() + q.numel()) \
        + 4 * B * H * Lq + 4 * (B * Lq + B * S)
    bound_ms, bound_by = bound(4 * D * H * _valid_pairs(kw, Lq, S), nbytes)
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms,
               library_ms=_k1_library(q, k, v, kw, lengths) if library
               else None)
    log("K1", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        lse_err=f"{lse_err:.3g}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms:.3f}",
        library_ms=None if res["library_ms"] is None
        else f"{res['library_ms']:.4f}")
    return res


def _sdpa_inputs(q, k, v, kw, lengths, grad=False):
    """The case's q/k/v as [B, H, L, D] views for
    ``scaled_dot_product_attention``, with the causal flag at one row (on
    its valid rows only) or a boolean segment + causal mask."""
    from modelcompose_tpu_torch.ops.flash_attention import _mask
    B, Lq, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    if B == 1 and kw["q_offset"] == 0 and Lq == S:
        n = lengths[0]
        args = [t[:, :n].transpose(1, 2) for t in (q, k, v)]
        extra = dict(is_causal=True)
    else:
        args = [t.transpose(1, 2) for t in (q, k, v)]
        extra = dict(attn_mask=_mask(kw["q_segment_ids"],
                                     kw["kv_segment_ids"], True,
                                     kw["q_offset"], Lq, S, q.device))
    if grad:
        args = [t.detach().requires_grad_() for t in args]
    return args, extra


def _k1_library(q, k, v, kw, lengths):
    """ms of one ``scaled_dot_product_attention`` call computing the same
    attention (timed here only; the port never calls it), and the backend
    PyTorch picked, read from the kernels it launched."""
    import torch.nn.functional as F
    args, extra = _sdpa_inputs(q, k, v, kw, lengths)
    call = lambda: F.scaled_dot_product_attention(*args, **extra)  # noqa
    ms = cuda_time_ms(call)
    log("K1", library="scaled_dot_product_attention",
        mask="is_causal" if "is_causal" in extra else "bool segment+causal",
        kernels=json.dumps(_kernel_names(call)), library_ms=f"{ms:.4f}")
    return ms


def _check_k1(name, q, k, v, kw, out, lse):
    """K1's output and LSE against its plain version on the same inputs,
    on valid rows (padding rows are garbage on both sides): (max abs err
    of the output, its relative error, max abs err of the LSE)."""
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_reference)
    ref_out, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    valid = kw["q_segment_ids"] != 0
    err, rel = _rel_err(out, ref_out, valid)
    lse_err = (lse.transpose(1, 2)[valid] - ref_lse.transpose(1, 2)[valid]
               ).abs().max().item()
    lse_tol = LSE_TOL * max(ref_lse.transpose(1, 2)[valid].abs().max().item(),
                            1.0)
    if not (rel <= ATTN_TOL and lse_err <= lse_tol):
        raise AssertionError(f"K1 {name}: out rel err {rel:.3g} (tol "
                             f"{ATTN_TOL}), lse err {lse_err:.3g} (tol "
                             f"{lse_tol:.3g})")
    return err, rel, lse_err


def phase_k1(device, gen):
    """K1 at the vision path's bucket (B=2, 32 heads, D=128, Lq=S=1024, one
    row padded; the JSON row's own keys, as in earlier runs), at the
    composed path's (B=1, Lq=S=3328, 3287 valid; the row's ``mcub4``), each
    beside SDPA, then at a ragged length, with GQA group 4 and a query
    offset, and at D=64."""
    vision = _k1_case(device, gen, B=2, Lq=1024, S=1024, H=32, Hkv=32,
                      D=128, q_offset=0, lengths=[1024, 637], library=True)
    mcub4 = _k1_case(device, gen, library=True, **MCUB4_K1)
    errs = [mcub4["max_abs_err"], vision["max_abs_err"]]
    for case in (dict(B=2, Lq=150, S=150, H=32, Hkv=32, D=128, q_offset=0,
                      lengths=[150, 97]),
                 dict(B=2, Lq=256, S=1024, H=32, Hkv=8, D=128, q_offset=768,
                      lengths=[1024, 900]),
                 dict(B=2, Lq=150, S=150, H=8, Hkv=4, D=64, q_offset=0,
                      lengths=[150, 61])):
        errs.append(_k1_case(device, gen, **case)["max_abs_err"])
    return dict(vision, max_abs_err=max(errs),
                shape="B2 Lq=S=1024 (1024, 637 valid)",
                mcub4=dict(mcub4, shape="B1 Lq=S=3328 (3287 valid)"))


def _k2_case(device, gen, *, B, NL, S, H, Hkv, D, kv_len, quantized, layer):
    import torch
    from modelcompose_tpu_torch.core.llama import quantize_kv
    from modelcompose_tpu_torch.ops.attention import decode_attention
    from modelcompose_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q = rnd(B, 1, H, D)
    k, v = rnd(NL, B, S, Hkv, D), rnd(NL, B, S, Hkv, D)
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
    scale = D ** -0.5
    out = flash_decode_attention(q, k, v, kv, layer, sm_scale=scale)
    ref = flash_decode_reference(q, k, v, kv, layer, sm_scale=scale)
    loop = decode_attention(q, k, v, kv, layer_idx=layer, impl="reference")
    torch.cuda.synchronize()
    err, rel = _rel_err(out, ref)
    _, rel_loop = _rel_err(out, loop)
    name = (f"{'int8' if quantized else 'bf16'} B{B} NL{NL} S{S} H{H}/{Hkv} "
            f"D{D} kv_len{kv_len}")
    if not (rel <= ATTN_TOL and rel_loop <= ATTN_TOL):
        raise AssertionError(f"K2 {name}: rel err {rel:.3g} vs plain, "
                             f"{rel_loop:.3g} vs the chunked loop (tol "
                             f"{ATTN_TOL})")
    # ms / plain_ms as in earlier runs: CUDA events over 50 launches on
    # one layer, warm in L2 and paced by the host.  Cold: every launch on
    # another layer, 2 x NL x B x S x Hkv x D bytes of cache, far above the
    # 50 MB L2 at the main paths' shapes, timed by the kernels' device time
    # and by events (which add the host's gaps between calls).
    def kernel(i):
        return flash_decode_attention(q, k, v, kv, i, sm_scale=scale)

    def plain(i):
        return flash_decode_reference(q, k, v, kv, i, sm_scale=scale)
    ms = cuda_time_ms(lambda: kernel(layer), 50)
    plain_ms = cuda_time_ms(lambda: plain(layer), 50)
    device_ms_cold = device_time_cycle_ms(kernel, NL)
    events_ms_cold = cuda_time_cycle_ms(kernel, NL)
    plain_device_ms_cold = device_time_cycle_ms(plain, NL, rounds=1)
    # the valid cache bytes (and their scales), q and out; 4 flops a key
    # and head element (q.k and p.v)
    n_valid = sum(min(n, S) for n in kv_len)
    per_pos = 2 * Hkv * D * (1 if quantized else 2) \
        + (2 * Hkv * 4 if quantized else 0)
    bound_ms, bound_by = bound(4 * H * D * n_valid,
                               n_valid * per_pos + 4 * q.numel() + 4 * B)
    log("K2", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        rel_err_loop=f"{rel_loop:.3g}", ms_warm_events=f"{ms:.4f}",
        plain_ms_warm_events=f"{plain_ms:.4f}",
        device_ms_cold=f"{device_ms_cold:.4f}",
        events_ms_cold=f"{events_ms_cold:.4f}",
        plain_device_ms_cold=f"{plain_device_ms_cold:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound_cold=f"{bound_ms / device_ms_cold:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms,
                library_ms=None, device_ms_cold=device_ms_cold,
                events_ms_cold=events_ms_cold,
                plain_device_ms_cold=plain_device_ms_cold,
                share_of_bound_cold=bound_ms / device_ms_cold)


def phase_k2(device, gen):
    """K2 on bf16 and int8 caches with S not a multiple of 128, GQA group
    4 and per-row kv_len; then at the vision path's shape (32 layers, 32
    kv heads, the 1024 bucket plus 32 new tokens, int8; the JSON row's own
    keys, as in earlier runs) and at the composed path's (the 3328 bucket
    plus 32, 27 splits of 128, at the first and the last decode step's
    kv_len; the row's ``mcub4`` and ``mcub4_last_step``)."""
    errs = []
    for quantized in (False, True):
        errs.append(_k2_case(device, gen, B=2, NL=4, S=1000, H=32, Hkv=8,
                             D=128, kv_len=[1000, 517], quantized=quantized,
                             layer=2)["max_abs_err"])
    errs.append(_k2_case(device, gen, B=2, NL=4, S=333, H=8, Hkv=8, D=64,
                         kv_len=[1, 333], quantized=True,
                         layer=3)["max_abs_err"])
    cases = [_k2_case(device, gen, B=1, NL=32, S=3328 + NEW_TOKENS, H=32,
                      Hkv=32, D=128, kv_len=kv_len, quantized=True, layer=31)
             for kv_len in ([MCUB4_POSITIONS],
                            [MCUB4_POSITIONS + NEW_TOKENS - 1])]
    vision = _k2_case(device, gen, B=2, NL=32, S=1024 + NEW_TOKENS, H=32,
                      Hkv=32, D=128, kv_len=[660, 630], quantized=True,
                      layer=31)
    errs += [c["max_abs_err"] for c in cases] + [vision["max_abs_err"]]
    return dict(vision, max_abs_err=max(errs),
                shape="B2 int8 S=1056 kv_len 660/630",
                mcub4=dict(cases[0], shape="B1 int8 S=3360 kv_len 3287"),
                mcub4_last_step=dict(cases[1], shape="kv_len 3318"))


def _requests(cfg, device, gen):
    """Two image+question prompts of different text lengths: token ids on
    the host, normalized NHWC pixels on the card."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
    img = MODAL_TOKEN_INDEXES["vision"]
    rng = np.random.default_rng(SEED)

    def text(n):
        return rng.integers(3, cfg.vocab_size, n)
    ids = [np.concatenate([[1], text(34), [img], text(16)]),
           np.concatenate([[1], text(5), [img], text(12)])]
    pixels = torch.randn((2, 336, 336, 3), generator=gen, device=device)
    return ids, {"vision": pixels}


def _teacher_forced(model, ids, inputs, tokens, attn_impl, kv_quant=True):
    """Prefill + decode fed the given tokens; fp32 logits of every step."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.generate import _decode_step, _prefill
    embeds, plan = model.prepare_batch(ids, inputs)
    route_ids = torch.as_tensor(plan.route_ids, device=embeds.device)
    lengths = torch.as_tensor(plan.lengths, device=embeds.device)
    seg = torch.as_tensor(plan.segment_ids, device=embeds.device)
    table = torch.as_tensor(np.asarray(model.routing_table),
                            device=embeds.device)
    logits, cache = _prefill(model.params, model.cfg, embeds, route_ids,
                             table, seg, lengths,
                             embeds.shape[1] + NEW_TOKENS, attn_impl,
                             kv_quant=kv_quant)
    steps, kv_lens = [logits], lengths
    for t in range(tokens.shape[1] - 1):
        logits, cache, kv_lens = _decode_step(
            model.params, model.cfg, cache, tokens[:, t], kv_lens,
            model.decode_routing_table(), attn_impl)
        steps.append(logits)
    return torch.stack(steps, dim=1)  # [B, steps, V]


def _perturb(params, gen):
    """Small nonzero LoRA B and soft tokens, so every adapter changes the
    answer."""
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"].normal_(0.0, 0.01, generator=gen)
    for key in ("prefix_tokens", "suffix_tokens"):
        for t in params[key].values():
            t.normal_(0.0, 0.02, generator=gen)


def build_served_model(cfg, device, gen, phase):
    """``cfg`` at its full width with random weights, in the production
    decode variant, in the loader's order: int8 base, then the default
    adapter mix folded into W (generate adds the int8 KV cache and the
    compaction).  Device memory is logged after each step."""
    import torch
    from modelcompose_tpu_torch import MultimodalLM
    from modelcompose_tpu_torch.ops.quant import quantize_backbone
    from modelcompose_tpu_torch.ops.routed_lora import fold_dense

    def gib():
        return f"{torch.cuda.memory_allocated() / 2**30:.1f}"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():  # random tower weights are the point
        warnings.simplefilter("ignore")
        model = MultimodalLM.random_init(cfg, gen, device)
    mem = {"bf16": gib()}
    with torch.no_grad():
        _perturb(model.params, gen)
        model.params = quantize_backbone(model.params)
        mem["int8"] = gib()
        model.params, table = fold_dense(model.params, model.routing_table)
        model.routing_table = table.cpu().numpy()
        mem["folded"] = gib()
    torch.cuda.synchronize()
    assert model.decode_routing_table() is None  # decode skips adapters
    log(phase, setup_s=f"{time.perf_counter() - t0:.1f}",
        layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
        adapters=cfg.adapter_names(), gpu_mem_gb=json.dumps(mem),
        setup_peak_gb=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    return model


def build_main_model(device, gen):
    """The vision DAMC composition at Vicuna-7B width."""
    from modelcompose_tpu_torch import ModelConfig
    cfg = ModelConfig(lora_strategy="modal+language", lora_r=128,
                      lora_alpha=256, local_prefix_tokens=5,
                      local_suffix_tokens=5,
                      mm_vision_encoder="clip-vit-large-patch14-336",
                      mm_hidden_size=1024, dtype="bfloat16")
    return cfg, build_served_model(cfg, device, gen, "main")


def phase_main_path(device, gen):
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention

    cfg, model = build_main_model(device, gen)
    ids, inputs = _requests(cfg, device, gen)
    model.generate(ids, inputs, max_new_tokens=2, kv_quant=True)  # warm-up
    flash_attention_forward.launches = 0
    flash_decode_attention.launches = 0
    timings = {}
    answers = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                             kv_quant=True, timings=timings)
    launches = {"flash_attention_fwd": flash_attention_forward.launches,
                "flash_decode": flash_decode_attention.launches}
    n_layers = cfg.num_hidden_layers
    decode_steps = NEW_TOKENS - 1
    decode_tok_s = len(ids) * decode_steps / timings["decode_s"]
    log("main", prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_tok_s:.2f}",
        answer_lens=[len(a) for a in answers], launches=json.dumps(launches))
    if launches["flash_attention_fwd"] < n_layers:
        raise AssertionError(f"K1 launched {launches} < {n_layers} times")
    if launches["flash_decode"] < n_layers * decode_steps:
        raise AssertionError(f"K2 launched {launches} < "
                             f"{n_layers * decode_steps} times")
    _compare_logits("main", model, ids, inputs, answers, LOGIT_TOL)
    return launches


def _compare_logits(phase, model, ids, inputs, answers, tol):
    """Teacher-forced logits of the kernel path against the plain path on
    the tokens ``generate`` returned, held to ``tol`` of max |logit|."""
    import torch
    device = model.device
    # generate() keeps feeding EOS to a finished row: pad the answers the
    # same way, and hold argmax to the tokens only up to the EOS step.
    eos = model.cfg.eos_token_id
    tokens = torch.tensor([a + [eos] * (NEW_TOKENS - len(a)) for a in answers],
                          device=device)
    live = torch.arange(NEW_TOKENS, device=device)[None] <= torch.tensor(
        [len(a) for a in answers], device=device)[:, None]
    with torch.no_grad():
        kernel = _teacher_forced(model, ids, inputs, tokens, "auto")
        plain = _teacher_forced(model, ids, inputs, tokens, "reference")
    if not (torch.isfinite(kernel).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    if kernel.shape != (len(ids), NEW_TOKENS, model.cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(kernel.shape)}")
    if not torch.equal(kernel.argmax(-1)[live], tokens[live]):
        raise AssertionError("teacher-forced kernel path disagrees with the "
                             "tokens generate() returned")
    scale = plain.abs().amax(dim=-1)  # [B, steps]
    rel = ((kernel - plain).abs().amax(dim=-1) / scale)
    agree = (plain.argmax(-1) == tokens)[live].float().mean().item()
    log(phase, prefill_logit_rel_err=f"{rel[:, 0].max().item():.3g}",
        decode_logit_rel_err=f"{rel[:, 1:].max().item():.3g}",
        logit_tol=tol, greedy_id_agreement=f"{agree:.4f}")
    if rel.max().item() > tol:
        raise AssertionError(f"kernel path logits differ from the plain path "
                             f"by {rel.max().item():.3g} of max |logit|")
    return rel.max().item()


def _mcub4_request(cfg, device, gen):
    """One MCUB-4-shaped request: a 336 px image, 1,024 fbank frames x 128
    bins, 8 video frames of 224 px, 8,192 points (xyz, rgb) and 70 text
    tokens; ids on the host, inputs on the card."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
    rng = np.random.default_rng(SEED)

    def text(n):
        return rng.integers(3, cfg.vocab_size, n)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    marks = [MODAL_TOKEN_INDEXES[m] for m in ("vision", "video", "audio",
                                              "point")]
    ids = [np.concatenate([[1], text(35), marks, text(34)])]
    points = torch.cat([rnd(1, 8192, 3), torch.rand(
        (1, 8192, 3), generator=gen, device=device)], dim=-1)
    return ids, {
        "vision": rnd(1, 336, 336, 3),
        "audio": {"audio_inputs": rnd(1, 1024, 128),
                  "audio_padding_mask": torch.zeros(
                      (1, 1024), dtype=torch.bool, device=device)},
        "video": rnd(1, 8, 224, 224, 3),
        "point": points}


def _time_towers(phase, model, inputs):
    """Wall time of each tower and its projector (synchronized; the
    farthest-point sampling is a host loop of small launches)."""
    import torch
    from modelcompose_tpu_torch.models.projectors import apply_projector
    times = {}
    for modal, raw in inputs.items():
        spec = model.cfg.projector_type(modal)
        with torch.no_grad():
            for _ in range(2):  # the first pass warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = model.encode_tower(modal, raw)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                y = apply_projector(spec, model.projectors[modal], x)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        if not (x.is_cuda and torch.isfinite(y).all()):
            raise AssertionError(f"{modal}: tower output off the card or "
                                 f"not finite")
        times[modal] = {"tower_ms": round((t1 - t0) * 1e3, 3),
                        "projector_ms": round((t2 - t1) * 1e3, 3),
                        "tokens": int(x.shape[1]), "out": int(y.shape[1])}
    log(phase, towers=json.dumps(times))
    return times


def phase_composed(device, gen):
    """The MCUB-4 composition at Vicuna-7B width: one four-modality request
    answered with 32 greedy tokens in the production decode variant, then
    the kernel path's logits against the plain path's."""
    import torch
    from modelcompose_tpu_torch.configs import MCUB4_SPANS, mcub4_damc_7b
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention

    from modelcompose_tpu_torch.tree import tree_leaves

    cfg = mcub4_damc_7b()
    model = build_served_model(cfg, device, gen, "composed")
    if any(leaf.device.type != "cuda" for enc in model.encoders.values()
           for _, leaf in tree_leaves(enc.params)):
        raise AssertionError("a tower's weights are off the card")
    ids, inputs = _mcub4_request(cfg, device, gen)
    towers = _time_towers("composed", model, inputs)
    spans = {m: model.feature_span_len(m) for m in cfg.modalities()}
    if spans != MCUB4_SPANS:
        raise AssertionError(f"spans {spans} != {MCUB4_SPANS}")
    with torch.no_grad():
        embeds, plan = model.prepare_batch(ids, inputs)
    if (int(plan.lengths[0]), embeds.shape[1]) != (MCUB4_POSITIONS, 3328):
        raise AssertionError(f"packed {plan.lengths} in {embeds.shape[1]}")
    del embeds
    kw = dict(kv_quant=True, compact_adapters=True)
    model.generate(ids, inputs, max_new_tokens=2, **kw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    flash_attention_forward.launches = 0
    flash_decode_attention.launches = 0
    timings = {}
    answers = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                             timings=timings, **kw)
    launches = {"flash_attention_fwd": flash_attention_forward.launches,
                "flash_decode": flash_decode_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    active = list(model._compact_cache)
    decode_steps = NEW_TOKENS - 1
    log("composed", prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_steps / timings['decode_s']:.2f}",
        peak_mem_gb=f"{peak:.2f}", active_adapters=active,
        answer_len=len(answers[0]), launches=json.dumps(launches))
    if len(active) != 1 or len(active[0]) != MCUB4_ACTIVE:
        raise AssertionError(f"compacted to {active}, want {MCUB4_ACTIVE} "
                             f"columns")
    n_layers = cfg.num_hidden_layers
    if launches["flash_attention_fwd"] < n_layers:
        raise AssertionError(f"K1 launched {launches} < {n_layers} times")
    if launches["flash_decode"] < n_layers * decode_steps:
        raise AssertionError(f"K2 launched {launches} < "
                             f"{n_layers * decode_steps} times")
    rel = _compare_logits("composed", model, ids, inputs, answers,
                          COMPOSED_LOGIT_TOL)
    prof = _profile("composed_prefill", lambda: model.generate(
        ids, inputs, max_new_tokens=1, **kw), "composed_profile.txt")
    return {"launches": launches, "towers": towers,
            "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "peak_mem_gb": peak, "logit_rel_err": rel, "profile": prof}


def phase_loader(device, gen):
    """Composed-checkpoint formats at full width, 2 layers: a Vicuna-layout
    sharded base and four unimodal DAMC adapter directories (r=128, a
    projector each) written to disk, merged by the port's merge
    (online-merge-reset, 0.25 each), loaded onto the card by the port's
    loader; every loaded leaf held to what was written, then the int8 +
    folded load answers the MCUB-4 request."""
    import tempfile

    import numpy as np
    import torch
    from modelcompose_tpu_torch.compose.convert import (params_to_adapter,
                                                        params_to_hf_llama)
    from modelcompose_tpu_torch.compose.merge import merge_checkpoints
    from modelcompose_tpu_torch.configs import (MCUB4_RESET, MCUB4_TOWERS,
                                                damc_unimodal)
    from modelcompose_tpu_torch.core.llama import init_params, torch_dtype
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    from modelcompose_tpu_torch.models.projectors import init_projector
    from modelcompose_tpu_torch.tree import tree_leaves

    def save_bin(state, path, dtype=torch.float32):
        """A flat numpy state dict as a torch pickle (the reference's
        ``.bin`` layout)."""
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
                    for k, v in state.items()}, path)

    t0 = time.perf_counter()
    written = {}  # the composed adapter the merge should produce
    # the checkpoints live in a gitignored directory of the checkout
    with tempfile.TemporaryDirectory(prefix="tmp_loader_", dir=".") as root, \
            torch.no_grad():
        paths = []
        for modal in MCUB4_TOWERS:
            cfg = damc_unimodal(modal, num_hidden_layers=LOADER_LAYERS)
            params = init_params(cfg, gen, device)
            _perturb(params, gen)
            proj = init_projector(cfg.projector_type(modal), gen,
                                  cfg.projector_input_size(modal),
                                  cfg.hidden_size,
                                  dtype=torch_dtype(cfg.dtype), device=device)
            state = params_to_adapter(params, cfg, {modal: proj})
            paths.append(os.path.join(root, f"ckpt-{modal}"))
            os.makedirs(paths[-1])
            cfg.save(os.path.join(paths[-1], "config.json"))
            save_bin(state, os.path.join(paths[-1], "adapter_model.bin"))
            written.update({k.replace(".default.", f".default-{modal}."): v
                            for k, v in state.items()})
            del params, proj, state
        base_cfg = damc_unimodal("vision", num_hidden_layers=LOADER_LAYERS)
        base = params_to_hf_llama(init_params(base_cfg, gen, device),
                                  base_cfg)
        base_dir = os.path.join(root, "vicuna-7b-v1.5")
        os.makedirs(base_dir)
        keys = sorted(base)
        shards = {"pytorch_model-00001-of-00002.bin": keys[::2],
                  "pytorch_model-00002-of-00002.bin": keys[1::2]}
        for name, ks in shards.items():  # bf16 shards, as released
            save_bin({k: base[k] for k in ks}, os.path.join(base_dir, name),
                     torch.bfloat16)
        with open(os.path.join(base_dir, "pytorch_model.bin.index.json"),
                  "w") as f:
            json.dump({"weight_map": {k: n for n, ks in shards.items()
                                      for k in ks}}, f)
        t_write = time.perf_counter() - t0
        merged = os.path.join(root, "mcub4-damc-multimodal")
        merge_checkpoints(paths, merged, "online-merge-reset-" + MCUB4_RESET)
        t_merge = time.perf_counter() - t0 - t_write

        def load(**kw):
            with warnings.catch_warnings():  # random towers
                warnings.simplefilter("ignore")
                return load_pretrained_model(
                    merged, base_dir, load_tokenizer_fn=lambda _: None,
                    device=device, **kw)[1]
        model = load(load_8bit=False, fold_decode_dense=False)
        t_load = time.perf_counter() - t0 - t_write - t_merge
        cfg = model.cfg
        off = [p for p, t in tree_leaves(
                   {"p": model.params, "j": model.projectors,
                    "e": {m: e.params for m, e in model.encoders.items()}})
               if t.device.type != "cuda"]
        if off:
            raise AssertionError(f"leaves off the card: {off[:3]}")
        got = params_to_adapter(model.params, cfg, model.projectors)
        got_base = params_to_hf_llama(model.params, cfg)
        bad = [k for k in written if not np.array_equal(got[k], written[k])]
        bad += [k for k in base if not np.array_equal(got_base[k], base[k])]
        # the rest are the composition's 'default' rows, which no
        # checkpoint wrote: zero
        bad += [k for k in set(got) - set(written)
                if ".default." not in k or got[k].any()]
        log("loader", layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
            adapters=cfg.adapter_names(), leaves_checked=len(got)
            + len(base), mismatched=len(bad), write_s=f"{t_write:.1f}",
            merge_s=f"{t_merge:.1f}", load_s=f"{t_load:.1f}")
        if bad:
            raise AssertionError(f"loaded leaves differ from the written "
                                 f"ones: {bad[:3]}")
        del model
        model = load(load_8bit=True, fold_decode_dense=True)
        ids, inputs = _mcub4_request(cfg, device, gen)
        answers = model.generate(ids, inputs, max_new_tokens=8,
                                 kv_quant=True, compact_adapters=True)
    log("loader", int8_folded_answer=answers[0],
        total_s=f"{time.perf_counter() - t0:.1f}")
    if not answers[0] or len(answers[0]) > 8:
        raise AssertionError(f"the loaded model answered {answers}")
    return {"leaves_checked": len(written) + len(base)}


def _k34_case(device, gen, *, B, L, S, H, Hkv, D, q_offset, lengths,
              library=False):
    """K1 forward against its plain version at the case's shape, then K3
    and K4 on K1's output and LSE, with a cotangent zero on padding rows,
    against their plain versions on valid rows.  With ``library``, also
    the backward of ``scaled_dot_product_attention`` through autograd,
    which computes K3's and K4's outputs together."""
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        _di, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
        flash_attention_forward)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v = rnd(B, L, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (torch.arange(S, device=device)[None]
              < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    q_seg = kv_seg[:, q_offset:q_offset + L].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    name = f"B{B} L{L} S{S} H{H}/{Hkv} D{D} q_offset{q_offset}"
    k1_err, k1_rel, k1_lse_err = _check_k1(name, q, k, v, kw, out, lse)
    do = (rnd(B, L, H, D) * (q_seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    args = (q, k, v, do, lse, di)
    dq = flash_attention_bwd_dq(*args, **kw)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    ref_dq = flash_attention_bwd_dq_reference(*args, **kw)
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(*args, **kw)
    torch.cuda.synchronize()
    q_valid, kv_valid = q_seg != 0, kv_seg != 0
    errs = {n: _rel_err(g, w, rows) for n, g, w, rows in (
        ("dq", dq, ref_dq, q_valid), ("dk", dk, ref_dk, kv_valid),
        ("dv", dv, ref_dv, kv_valid))}
    bad = {n: r for n, (_, r) in errs.items() if not r <= ATTN_TOL}
    if bad:
        raise AssertionError(f"K3/K4 {name}: rel err {bad} (tol {ATTN_TOL})")
    res = {
        "fwd": dict(max_abs_err=k1_err),
        "dq": dict(max_abs_err=errs["dq"][0], ms=cuda_time_ms(
            lambda: flash_attention_bwd_dq(*args, **kw)),
            plain_ms=cuda_time_ms(
                lambda: flash_attention_bwd_dq_reference(*args, **kw))),
        "dkv": dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                    ms=cuda_time_ms(
                        lambda: flash_attention_bwd_dkv(*args, **kw)),
                    plain_ms=cuda_time_ms(
                        lambda: flash_attention_bwd_dkv_reference(*args,
                                                                  **kw)))}
    # K3: S, dP and dQ products (6 D flops a valid pair); K4: S, dP, dV and
    # dK (8 D).  Bytes: q, dO, LSE and Di on valid q rows and k, v on valid
    # kv rows read once (a padding row's gradient is zero and needs none of
    # them), the outputs written in full.
    pairs = _valid_pairs(kw, L, S)
    n_q, n_k = int(q_valid.sum()), int(kv_valid.sum())
    io = 2 * D * (2 * H * n_q + 2 * Hkv * n_k) + 8 * H * n_q
    for n, flops, nbytes in (("dq", 6, io + 2 * q.numel()),
                             ("dkv", 8, io + 2 * (k.numel() + v.numel()))):
        bms, by = bound(flops * D * H * pairs, nbytes)
        res[n].update(bound_ms=bms, bound_by=by,
                      share_of_bound=bms / res[n]["ms"], library_ms=None)
    if library:
        bwd = _k34_library(q, k, v, do, kw, lengths)
        res["dq"].update(bwd)
        res["dkv"].update(bwd)
    log("K3/K4", case=repr(name),
        k1_rel_err=f"{k1_rel:.3g}", k1_lse_err=f"{k1_lse_err:.3g}",
        rel_err=json.dumps({n: float(f"{r:.3g}") for n, (_, r) in
                            errs.items()}),
        k3_ms=f"{res['dq']['ms']:.4f}",
        k3_plain_ms=f"{res['dq']['plain_ms']:.4f}",
        k4_ms=f"{res['dkv']['ms']:.4f}",
        k4_plain_ms=f"{res['dkv']['plain_ms']:.4f}",
        k3_bound_ms=f"{res['dq']['bound_ms']:.4f}",
        k4_bound_ms=f"{res['dkv']['bound_ms']:.4f}")
    return res


def _k34_library(q, k, v, do, kw, lengths):
    """The backward of one ``scaled_dot_product_attention`` call (dQ, dK
    and dV together) through autograd, on the case's inputs: with a
    boolean mask, ``{"library_bwd_ms": ms}``; with ``is_causal`` on the
    valid rows of one batch row, ``{"library_bwd_causal_ms": ms}``; and
    the backend PyTorch picked, from the autograd node's name (the
    profiler shows no device kernels for a backward run by autograd)."""
    import torch.nn.functional as F
    args, extra = _sdpa_inputs(q, k, v, kw, lengths, grad=True)
    out = F.scaled_dot_product_attention(*args, **extra)
    g = do[:, :args[0].shape[2]].transpose(1, 2)

    def bwd():
        for t in args:
            t.grad = None
        out.backward(g, retain_graph=True)
    ms = cuda_time_ms(bwd)
    backend = type(out.grad_fn).__name__
    causal = "is_causal" in extra
    log("K3/K4", library="scaled_dot_product_attention backward",
        mask="is_causal" if causal else "bool segment+causal",
        backend=backend, library_bwd_ms=f"{ms:.4f}")
    key = "library_bwd_causal" if causal else "library_bwd"
    return {f"{key}_ms": ms, f"{key}_backend": backend}


# The train step's batch: the two samples of _train_samples (1,400 and
# 1,100 positions) in the 2,048 bucket; its micro-batches are its rows.
TRAIN_ROWS = [1400, 1100]


def phase_k34(device, gen):
    """K1, K3 and K4 at the training shapes, 32 heads, D=128, causal:
    B=2, L=2,048 with rows of 2,048 and 1,391 (the JSON row's own keys,
    the shape K3/K4 have been timed at since their port, beside SDPA's
    backward with a boolean mask), the train step's batch (B=2, L=2,048,
    rows of 1,400 and 1,100: the row's ``train_batch``) and its
    accumulation window's micro-batches (B=1, rows of 1,400 and 1,100; the
    first is the row's ``micro_batch``, beside SDPA's ``is_causal``
    backward on its valid rows); then at a ragged length, with GQA group 4
    and a query offset, and at D=64.  Returns the K3/K4 results with the
    largest error over all cases for K1 ('fwd'), K3 and K4."""
    shape = dict(S=2048, L=2048, H=32, Hkv=32, D=128, q_offset=0)
    main = _k34_case(device, gen, B=2, lengths=[2048, 1391], library=True,
                     **shape)
    train = _k34_case(device, gen, B=2, lengths=TRAIN_ROWS, **shape)
    micro = _k34_case(device, gen, B=1, lengths=TRAIN_ROWS[:1], library=True,
                      **shape)
    errs = {n: [r[n]["max_abs_err"] for r in (main, train, micro)]
            for n in main}
    for case in (dict(B=1, lengths=TRAIN_ROWS[1:], **shape),
                 dict(B=2, L=150, S=150, H=32, Hkv=32, D=128, q_offset=0,
                      lengths=[150, 97]),
                 dict(B=2, L=256, S=1024, H=32, Hkv=8, D=128, q_offset=768,
                      lengths=[1024, 900]),
                 dict(B=2, L=150, S=150, H=8, Hkv=4, D=64, q_offset=0,
                      lengths=[150, 61])):
        res = _k34_case(device, gen, **case)
        for n in errs:
            errs[n].append(res[n]["max_abs_err"])
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")
    out = {"fwd": dict(max_abs_err=max(errs["fwd"]))}
    for n in ("dq", "dkv"):
        out[n] = dict(
            main[n], max_abs_err=max(errs[n]),
            shape="B2 L=2048 (2048, 1391 valid)",
            train_batch=dict({k: train[n][k] for k in timed},
                             shape="B2 L=2048 (1400, 1100 valid)"),
            micro_batch=dict({k: micro[n][k] for k in timed},
                             shape="B1 L=2048 (1400 valid)",
                             **{k: v for k, v in micro[n].items()
                                if k.startswith("library_bwd_causal")}))
    return out


def _train_samples(cfg, rng):
    """Two image+question+answer samples of about 1,400 and 1,100 packed
    positions (the image is 576 patches + 5 + 5 soft tokens), labels on the
    answer span only; random ids and pixels from ``rng``."""
    import numpy as np
    from modelcompose_tpu_torch.core.packing import (IGNORE_INDEX,
                                                     MODAL_TOKEN_INDEXES)
    img = MODAL_TOKEN_INDEXES["vision"]
    ids, labels = [], []
    for before, question, answer in ((100, 400, 313), (50, 250, 213)):
        text = [rng.integers(3, cfg.vocab_size, n) for n in
                (before, question, answer)]
        ids.append(np.concatenate([[1], text[0], [img], text[1], text[2]]))
        labels.append(np.concatenate([
            np.full(2 + before + question, IGNORE_INDEX), text[2]]))
    pixels = rng.normal(size=(2, 336, 336, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": labels,
            "modal_inputs": {"vision": pixels}}


def _flat(grads, paths):
    import torch
    return torch.cat([grads[p].float().reshape(-1) for p in paths])


def _compare_grads(name, got, want):
    import torch
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    ratio = (got.norm() / want.norm()).item()
    log("train", compare=name, cosine=f"{cos:.5f}", norm_ratio=f"{ratio:.5f}")
    if not (cos >= GRAD_COS and abs(ratio - 1) <= GRAD_NORM_TOL):
        raise AssertionError(f"{name}: kernel-path gradient cosine {cos:.4f} "
                             f"(>= {GRAD_COS}), norm ratio {ratio:.4f} "
                             f"(1 +- {GRAD_NORM_TOL})")
    return {"cosine": cos, "norm_ratio": ratio}


def phase_train(device):
    """The DAMC stage-2 train step at Vicuna-7B width through the train
    entry, then kernel-path against plain-path gradients."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.train.train_multimodal import (
        build_arg_parser, build_model, build_model_config, make_batch)
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_grad_and_apply, make_optimizer,
        make_train_step, scale_grads, tree_leaves)

    counters = (flash_attention_forward, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():
        return {"flash_attention_fwd": flash_attention_forward.launches,
                "flash_attention_bwd_dq": flash_attention_bwd_dq.launches,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv.launches}

    args = build_arg_parser().parse_args([
        "--model_name_or_path", "vicuna-7b-v1.5", "--data_path", "-",
        "--output_dir", "-", "--random_init_backbone", "--seed", str(SEED),
        "--mm_vision_encoder", "clip-vit-large-patch14-336",
        "--mm_projector_type", "mlp2x_gelu", "--mm_vision_select_layer", "-2",
        "--lora_strategy", "modal+language", "--lora_r", "128",
        "--lora_alpha", "256", "--local_prefix_tokens", "5",
        "--local_suffix_tokens", "5", "--gradient_checkpointing", "True"])
    t0 = time.perf_counter()
    cfg = build_model_config(args)
    with warnings.catch_warnings():  # random tower weights are the point
        warnings.simplefilter("ignore")
        model = build_model(args, cfg, device)
    rng = np.random.default_rng(SEED)
    collated = _train_samples(cfg, rng)
    batch, layout = make_batch(model, collated)
    micro = [make_batch(model, {
        "input_ids": collated["input_ids"][i:i + 1],
        "labels": collated["labels"][i:i + 1],
        "modal_inputs": {"vision": collated["modal_inputs"]["vision"][
            i:i + 1]}}) for i in range(2)]
    tc = TrainConfig(learning_rate=2e-4, mm_projector_lr=2e-5,
                     mm_language_lr=1e-5, warmup_ratio=0.0)
    tx, _ = make_optimizer(cfg, tc, {"backbone": model.params,
                                     "projectors": model.projectors})
    state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
    params = state.params
    vision = cfg.adapter_names().index("vision")
    frozen = {"embed_tokens": params["backbone"]["embed_tokens"],
              "attn.q.w": params["backbone"]["layers"]["attn"]["q"]["w"],
              "tower.q.w": model.encoders["vision"].params["layers"]["q"]["w"],
              "tower.patch": model.encoders["vision"].params[
                  "patch_embedding"]}
    trained = {"lora_b.q": params["backbone"]["layers"]["attn"]["q"][
                   "lora_b"],
               "lora_a.down": params["backbone"]["layers"]["mlp"]["down"][
                   "lora_a"],
               "projector.w0": params["projectors"]["vision"]["layers"][0][
                   "w"],
               "prefix": params["backbone"]["prefix_tokens"]["vision"]}
    before = {n: t.detach().clone() for n, t in {**frozen, **trained}.items()}
    positions = int((batch["segment_ids"] != 0).sum())
    torch.cuda.synchronize()
    log("train", setup_s=f"{time.perf_counter() - t0:.1f}",
        bucket=tuple(batch["token_ids"].shape), positions=positions,
        lengths=[int(x) for x in (batch["segment_ids"] != 0).sum(1)],
        trainable_params=sum(p.numel() for _, p in tree_leaves(params)
                             if p.requires_grad),
        gpu_mem_gb=f"{torch.cuda.memory_allocated() / 2**30:.1f}")

    step = make_train_step(cfg, tc, tx)
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, launches = [], [], []
    for i in range(TRAIN_STEPS):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, layout)
        losses.append(float(loss))  # synchronizes
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read())
        log("train", step=i, loss=f"{losses[-1]:.6f}",
            step_s=f"{seconds[-1]:.4f}",
            tokens_per_s=f"{positions / seconds[-1]:.1f}",
            launches=json.dumps(launches[-1]))
    peak = torch.cuda.max_memory_allocated()

    grad_fn, apply_fn, _, grad_accum_fn = make_grad_and_apply(cfg, tc, tx)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0, acc = grad_fn(state.params, *micro[0])
    loss1, acc = grad_accum_fn(state.params, acc, *micro[1])
    state = apply_fn(state, scale_grads(acc, 0.5))
    torch.cuda.synchronize()
    accum_s = time.perf_counter() - t0
    accum_launches = read()
    del acc
    log("train", accum_window_s=f"{accum_s:.4f}",
        micro_losses=[f"{float(loss0):.6f}", f"{float(loss1):.6f}"],
        launches=json.dumps(accum_launches), steps_taken=state.step,
        peak_mem_gb=f"{peak / 2**30:.2f}")

    n_layers = cfg.num_hidden_layers
    for i, counts in enumerate(launches + [accum_launches]):
        if min(counts.values()) < n_layers \
                or counts["flash_attention_fwd"] < 2 * n_layers:
            raise AssertionError(f"step {i}: kernel launches {counts}: K1 "
                                 f"must run twice per layer under remat, "
                                 f"K3 and K4 once per layer")
    if not all(np.isfinite(losses + [float(loss0), float(loss1)])):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses}")
    for n in frozen:
        if not torch.equal(frozen[n], before[n]):
            raise AssertionError(f"frozen {n} changed")
    for n in trained:
        if torch.equal(trained[n], before[n]):
            raise AssertionError(f"trainable {n} did not change")
    del before

    _profile("train_step", lambda: step(state, batch, layout),
             "train_profile.txt")

    # The kernel path against the plain path on one micro-batch, same weights.
    reset()
    loss_k, grads_k = grad_fn(state.params, *micro[0])
    k_launches = read()
    plain_fn = make_grad_and_apply(cfg, tc, tx, attn_impl="reference")[0]
    loss_p, grads_p = plain_fn(state.params, *micro[0])
    if read() != k_launches:
        raise AssertionError("the plain path launched a kernel")
    lora_b = [p for p in grads_k if p[-1] == "lora_b"]
    proj = [p for p in grads_k if p[0] == "projectors"]
    soft = [p for p in grads_k if p[1] in ("prefix_tokens", "suffix_tokens")]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log("train", compare="loss", kernel=f"{float(loss_k):.6f}",
        plain=f"{float(loss_p):.6f}", rel=f"{loss_rel:.3g}")
    if not loss_rel <= GRAD_NORM_TOL:
        raise AssertionError(f"kernel-path loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    parity = {"loss_rel": loss_rel}
    for name, paths, select in (
            ("projector", proj, None), ("soft_tokens", soft, None),
            ("lora_b_vision_layer0", lora_b, 0),
            ("lora_b_vision_layer31", lora_b, n_layers - 1)):
        if select is None:
            got, want = _flat(grads_k, paths), _flat(grads_p, paths)
        else:
            got = torch.cat([grads_k[p][select, vision].float().reshape(-1)
                             for p in paths])
            want = torch.cat([grads_p[p][select, vision].float().reshape(-1)
                              for p in paths])
        parity[name] = _compare_grads(name, got, want)
    step_s = float(np.median(seconds[1:]))
    return {"launches": launches, "accum_launches": accum_launches,
            "losses": losses, "step_s": seconds,
            "tokens_per_s": positions / step_s,
            "peak_mem_gb": peak / 2**30, "parity": parity}


# Kernel-name fragments of each profile split: the hand-written kernels,
# and the library GEMMs (cuBLAS nvjet / xmma, magma) and convolutions.
PROFILE_SPLITS = {"K1": ("fa_fwd_kernel",), "K2": ("fd_split_kernel",),
                  "K3": ("fa_bwd_dq_kernel",), "K4": ("fa_bwd_dkv_kernel",),
                  "gemm": ("gemm", "nvjet"), "conv": ("conv",)}


def _profile(name, fn, out_file):
    """torch.profiler over one call of ``fn``: device time by kernel and
    the shares of PROFILE_SPLITS, the table written to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = {e.key: e.device_time_total for e in events
           if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    total = sum(dev.values())
    share = {name: round(sum(t for k, t in dev.items()
                             if any(f in k.lower() for f in frags)) / total, 4)
             for name, frags in PROFILE_SPLITS.items()} if total else {}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_file), "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    log("profile", run=name, wall_s=f"{wall:.4f}",
        device_kernel_s=f"{total / 1e6:.4f}", shares=json.dumps(share))
    return {"wall_s": wall, "device_kernel_s": total / 1e6, "shares": share}


def main() -> int:
    try:
        import torch
        import modelcompose_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from the repository root ({e})")
    device = phase_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    phase_build()
    k1 = phase_k1(device, gen)
    k2 = phase_k2(device, gen)
    launches = phase_main_path(device, gen)
    gc.collect()
    torch.cuda.empty_cache()  # each served model is gone before the next
    composed = phase_composed(device, gen)
    gc.collect()
    torch.cuda.empty_cache()
    phase_loader(device, gen)
    gc.collect()
    torch.cuda.empty_cache()
    k34 = phase_k34(device, gen)
    train = phase_train(device)
    if {"jax", "modelcompose_tpu"} & set(sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    # Launches on the main paths: the two serving runs, plus every step of
    # the training run (train steps and the accumulation window).
    trained = train["launches"] + [train["accum_launches"]]

    def train_launches(name):
        return sum(c[name] for c in trained)

    def served(name):
        return launches[name] + composed["launches"][name]
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES,
             launches=served("flash_attention_fwd")
             + train_launches("flash_attention_fwd"),
             **dict(k1, max_abs_err=max(k1["max_abs_err"],
                                        k34["fwd"]["max_abs_err"]))),
        dict(name="flash_decode", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES, launches=served("flash_decode"), **k2),
        dict(name="flash_attention_bwd_dq", route="cuda", source=K34_SOURCE,
             replaces=K3_REPLACES,
             launches=train_launches("flash_attention_bwd_dq"), **k34["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=K34_SOURCE,
             replaces=K4_REPLACES,
             launches=train_launches("flash_attention_bwd_dkv"),
             **k34["dkv"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
