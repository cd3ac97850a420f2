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
   3,360, and at beam search's shape (a bf16 cache of 3 rows of 3,360),
   timed cycling over the 32 layers of the stacked cache so that each
   launch finds its layer cold in L2, as decode does;
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
6b. decode variants on phase 6's model and request: sampled (temperature
   0.2), sampled with top-p 0.7 (every drawn token inside its step's
   nucleus), the ``concat`` fold (its ids against the unfolded decode's),
   beam search and beam sampling (3 beams, 16 tokens, K2 over a bf16
   cache of 3 rows), each with its answer, launches, decode tokens/s and
   peak memory;
7. loader: four unimodal r=128 DAMC checkpoints and a sharded
   Vicuna-layout base at full width and 2 layers, written to disk, merged
   and loaded onto the card by the port; every loaded leaf held to what
   was written, then the int8 + folded load answers the MCUB-4 request;
7b. qa-loader: the eval entry (``eval_model``, as ``python -m
   modelcompose_tpu_torch.eval.model_multimodal_qa_loader`` runs it) on
   phase 7's merged checkpoint, then its question loop
   (``run_questions``) on phase 6's 32-layer model, each over an audio, a
   point-cloud and a text-only question, by beam search under the
   benchmark protocol and sampled with top-p; seconds per question;
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
   gradients against the plain path's on one micro-batch;
10. train_entry: the DAMC train entry (``train()``, what ``python -m
   modelcompose_tpu_torch.train.train_multimodal`` runs) at Vicuna-7B v1.5
   width and depth: a random fp16 base written to disk in the released
   layout (two shards, index, config.json), a 48-sample point dataset
   (8,192 x 6 clouds), stage 1 as ``run_pretrain_point.sh`` (B=16, 3
   steps, projector only), stage 2 as ``run_finetune_point_damc.sh`` on
   its export (B=4, 4 steps, checkpoint-4), the same flags resumed to 6
   steps, then the export loaded by ``load_pretrained_model`` and one
   point question decoded greedily; base write and load, setup, step,
   loader-wait, checkpoint and restore seconds, positions/s, peak memory,
   export bytes, a profile of one stage-2 step
   (``chiprun_out/train_entry_profile.txt``); K1 (twice a layer under
   remat), K3 and K4 on every micro-batch, frozen leaves bit-unchanged,
   the trained ones changed, the restored state and the served leaves
   bit-equal to the checkpoint and the trained state, ``train()``'s steady
   window equal to the steps seen; then K1 + K3 + K4 and K2 against their
   plain versions at the inputs the path gave them.  The PointBERT tower
   is random from SEED 0 in both the trainer (bf16) and the loader (fp32):
   the same draws.

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
``micro_batch`` the train step's shapes, and K2's ``beam`` beam search's;
each kernel's ``launches_by_path`` splits its launches by phase.  The last
line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits nonzero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
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
# The decode variants: beam search's width and length, the sampling knobs
NUM_BEAMS = 3
BEAM_TOKENS = 16
SAMPLE_TEMPERATURE = 0.2
SAMPLE_TOP_P = 0.7
BEAM_SAMPLE_TEMPERATURE = 0.7
QA_TOKENS = 16  # --max-new-tokens of the question-file runs
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
    # beam search's shape: a bf16 cache (beam search never quantizes it)
    # tiled to num_beams rows, at the first decode step of MCUB-4
    beam = _k2_case(device, gen, B=NUM_BEAMS, NL=32, S=3328 + NEW_TOKENS,
                    H=32, Hkv=32, D=128, kv_len=[MCUB4_POSITIONS] * NUM_BEAMS,
                    quantized=False, layer=31)
    errs += [c["max_abs_err"] for c in cases + [vision, beam]]
    return dict(vision, max_abs_err=max(errs),
                shape="B2 int8 S=1056 kv_len 660/630",
                mcub4=dict(cases[0], shape="B1 int8 S=3360 kv_len 3287"),
                mcub4_last_step=dict(cases[1], shape="kv_len 3318"),
                beam=dict(beam, shape="B3 bf16 S=3360 kv_len 3287"))


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


def _teacher_forced(model, ids, inputs, tokens, attn_impl, kv_quant=True,
                    fold_concat=False):
    """Prefill + decode fed the given tokens; fp32 logits of every step.
    With ``fold_concat`` the decode steps run the default-route adapters
    folded into one concatenated pair, as ``fold_decode='concat'`` does."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.generate import _decode_step, _prefill
    from modelcompose_tpu_torch.ops.routed_lora import fold_decode_adapters
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
    decode_params, decode_table = model.params, model.decode_routing_table()
    if fold_concat:
        decode_params, decode_table = fold_decode_adapters(model.params,
                                                           table[0])
    steps, kv_lens = [logits], lengths
    for t in range(tokens.shape[1] - 1):
        logits, cache, kv_lens = _decode_step(
            decode_params, model.cfg, cache, tokens[:, t], kv_lens,
            decode_table, attn_impl)
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
            "peak_mem_gb": peak, "logit_rel_err": rel,
            "profile": prof}, model, (ids, inputs)


def _attention_counters():
    """(reset, read) of K1's and K2's launch counts."""
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention

    def reset():
        flash_attention_forward.launches = 0
        flash_decode_attention.launches = 0

    def read():
        return {"flash_attention_fwd": flash_attention_forward.launches,
                "flash_decode": flash_decode_attention.launches}
    return reset, read


class _KernelInputs:
    """Records, while active, the inputs the kernels are launched at,
    through the wrappers' input checks (the launch counts stay the
    wrappers' own): for every distinct K1/K3/K4 shape ``(B, Lq, H, D, S,
    Hkv)`` its first call's (q, kv) segment ids, and for every distinct K2
    cache ``(NL, B, S, Hkv, D, H, dtype)`` its first call's kv_len.  The
    copies stay on the device: recording adds no host sync."""

    def __enter__(self):
        from modelcompose_tpu_torch.ops import flash_attention, flash_decode
        self.modules = (flash_attention, flash_decode)
        attention_check, decode_check = self.checks = tuple(
            m._check_cuda_inputs for m in self.modules)
        self.attention, self.decode = {}, {}

        def attention(q, k, v, q_seg, kv_seg):
            key = tuple(q.shape) + tuple(k.shape[1:3])
            if key not in self.attention:
                self.attention[key] = (q_seg.clone(), kv_seg.clone())
            return attention_check(q, k, v, q_seg, kv_seg)

        def decode(q, k_q, v_q, k_s, v_s, kv_len):
            key = tuple(k_q.shape) + (q.shape[2], str(k_q.dtype))
            if key not in self.decode:
                self.decode[key] = kv_len.clone()
            return decode_check(q, k_q, v_q, k_s, v_s, kv_len)
        flash_attention._check_cuda_inputs = attention
        flash_decode._check_cuda_inputs = decode
        return self

    def __exit__(self, *exc):
        for module, check in zip(self.modules, self.checks):
            module._check_cuda_inputs = check

    def decode_rows_dtype(self):
        """Sorted (batch rows, cache dtype) of the K2 launches seen."""
        return sorted({(key[1], key[-1]) for key in self.decode})


def _variant(name, model, ids, inputs, **kw):
    """One ``MultimodalLM.generate`` call of a decode variant with its
    answer, K1/K2 launches, the batch rows and cache dtype K2 ran at,
    decode tokens/s and peak memory; the launch minimums of phase 6."""
    import torch
    reset, read = _attention_counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    timings = {}
    with _KernelInputs() as shapes:
        answers = model.generate(ids, inputs, timings=timings, **kw)
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_layers = model.cfg.num_hidden_layers
    steps = launches["flash_decode"] // n_layers  # decode steps run
    res = {"answer": answers[0], "launches": launches,
           "k2_rows_dtype": shapes.decode_rows_dtype(),
           "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
           "decode_steps": steps,
           "decode_tok_per_s": steps / timings["decode_s"],
           "peak_mem_gb": peak}
    log("decode_variants", variant=name, answer=answers[0],
        launches=json.dumps(launches), k2_at=json.dumps(res["k2_rows_dtype"]),
        prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}", decode_steps=steps,
        decode_tok_per_s=f"{res['decode_tok_per_s']:.2f}",
        peak_mem_gb=f"{peak:.2f}")
    want_steps = (kw["max_new_tokens"] - 1 if kw.get("num_beams", 1) == 1
                  else max(len(answers[0]) - 1, 1))
    if len(answers) != 1 or len(answers[0]) > kw["max_new_tokens"]:
        raise AssertionError(f"{name}: answers {answers}")
    if launches["flash_attention_fwd"] < n_layers:
        raise AssertionError(f"{name}: K1 launched {launches} < {n_layers} "
                             f"times")
    if launches["flash_decode"] < n_layers * want_steps:
        raise AssertionError(f"{name}: K2 launched {launches} < "
                             f"{n_layers * want_steps} times")
    return res, answers


def _nucleus_check(model, ids, inputs, answers):
    """Every token variant (b) drew lies in the top-p nucleus of its step's
    logits, recomputed by teacher forcing on the kernel path (the same
    computation as the run: no compaction, the same cache length); the
    share that also lies in the plain path's nucleus is reported."""
    import torch
    from modelcompose_tpu_torch.core.sampling import top_p_filter
    eos = model.cfg.eos_token_id
    tokens = torch.tensor([a + [eos] * (NEW_TOKENS - len(a)) for a in answers],
                          device=model.device)
    n_live = min(len(answers[0]) + 1, NEW_TOKENS)  # the EOS step included
    lowest = torch.finfo(torch.float32).min
    inside = {}
    with torch.no_grad():
        for impl in ("auto", "reference"):
            logits = _teacher_forced(model, ids, inputs, tokens, impl)
            kept = top_p_filter(logits / SAMPLE_TEMPERATURE,
                                SAMPLE_TOP_P) > lowest
            hit = kept.gather(-1, tokens[..., None])[..., 0][:, :n_live]
            inside[impl] = (int(hit.sum()), int(kept[:, :n_live].sum(-1)
                                                .float().mean()))
    log("decode_variants", variant="b nucleus", tokens=n_live,
        inside_kernel_path=inside["auto"][0],
        inside_plain_path=inside["reference"][0],
        mean_nucleus_size=inside["auto"][1])
    if inside["auto"][0] != n_live:
        raise AssertionError(f"sampled tokens outside the top-p nucleus: "
                             f"{n_live - inside['auto'][0]} of {n_live}")
    return {"tokens": n_live, "inside_kernel_path": inside["auto"][0],
            "inside_plain_path": inside["reference"][0]}


def _concat_check(model, ids, inputs, unfolded, concat):
    """Variant (c) against the unfolded decode on the same weights: the ids
    must agree; where they diverge, both decoders are teacher-forced on the
    unfolded run's tokens, their logits held to COMPOSED_LOGIT_TOL, and the
    diverging step named."""
    import torch
    if unfolded == concat:
        log("decode_variants", variant="c concat vs unfolded",
            identical_tokens=len(concat))
        return {"identical": True, "tokens": len(concat)}
    step = next(i for i, (a, b) in enumerate(zip(unfolded + [None],
                                                  concat + [None])) if a != b)
    eos = model.cfg.eos_token_id
    tokens = torch.tensor([unfolded + [eos] * (NEW_TOKENS - len(unfolded))],
                          device=model.device)
    with torch.no_grad():
        plain = _teacher_forced(model, ids, inputs, tokens, "auto")
        folded = _teacher_forced(model, ids, inputs, tokens, "auto",
                                 fold_concat=True)
    rel = ((folded - plain).abs().amax(-1) / plain.abs().amax(-1)).max()
    top2 = plain[0, step].topk(2).values
    log("decode_variants", variant="c concat vs unfolded", diverge_step=step,
        unfolded_token=unfolded[step] if step < len(unfolded) else "eos",
        concat_token=concat[step] if step < len(concat) else "eos",
        top2_gap=f"{(top2[0] - top2[1]).item():.4g}",
        logit_rel_err=f"{rel.item():.3g}", logit_tol=COMPOSED_LOGIT_TOL)
    if rel.item() > COMPOSED_LOGIT_TOL:
        raise AssertionError(f"concat-fold logits differ from the unfolded "
                             f"decode by {rel.item():.3g} of max |logit|")
    return {"identical": False, "diverge_step": step,
            "logit_rel_err": rel.item()}


def phase_decode_variants(model, request):
    """Phase 6's MCUB-4 model answering its request through the other
    decode variants: sampled (a), sampled with top-p (b, every draw inside
    its step's nucleus), the ``concat`` fold (c, against the unfolded
    decode on the same weights), beam search (d, K2 over a bf16 cache of
    NUM_BEAMS rows) and beam sampling (e)."""
    import torch
    ids, inputs = request
    cfg = model.cfg

    def gen(seed):
        return torch.Generator(device=model.device).manual_seed(seed)
    out, answers = {}, {}
    sampled = dict(max_new_tokens=NEW_TOKENS, kv_quant=True,
                   temperature=SAMPLE_TEMPERATURE)
    out["a_sampled"], _ = _variant(
        "a sampled", model, ids, inputs, top_p=1.0, generator=gen(1),
        compact_adapters=True, **sampled)
    out["b_top_p"], answers["b"] = _variant(
        "b top_p", model, ids, inputs, top_p=SAMPLE_TOP_P, generator=gen(2),
        **sampled)
    out["b_top_p"]["nucleus"] = _nucleus_check(model, ids, inputs,
                                               answers["b"])
    # (c) needs a live default route: the folded base with the routing
    # table's default row restored, so decode runs the adapter branch
    folded_table = model.routing_table
    model.routing_table = cfg.routing_table()
    try:
        greedy = dict(max_new_tokens=NEW_TOKENS, kv_quant=True)
        out["c_unfolded"], answers["c0"] = _variant(
            "c unfolded", model, ids, inputs, fold_decode=False, **greedy)
        out["c_concat"], answers["c"] = _variant(
            "c concat", model, ids, inputs, fold_decode="concat", **greedy)
        out["c_concat"]["vs_unfolded"] = _concat_check(
            model, ids, inputs, answers["c0"][0], answers["c"][0])
    finally:
        model.routing_table = folded_table
    beams = dict(max_new_tokens=BEAM_TOKENS, num_beams=NUM_BEAMS,
                 compact_adapters=True)
    out["d_beam"], _ = _variant("d beam", model, ids, inputs, **beams)
    out["e_beam_sample"], _ = _variant(
        "e beam sample", model, ids, inputs, generator=gen(3),
        temperature=BEAM_SAMPLE_TEMPERATURE, **beams)
    for key in ("d_beam", "e_beam_sample"):
        if out[key]["k2_rows_dtype"] != [(NUM_BEAMS, "torch.bfloat16")]:
            raise AssertionError(f"{key}: K2 ran at "
                                 f"{out[key]['k2_rows_dtype']}, want "
                                 f"{NUM_BEAMS} bf16 rows")
    for key in ("a_sampled", "b_top_p", "c_unfolded", "c_concat"):
        if out[key]["k2_rows_dtype"] != [(1, "torch.int8")]:
            raise AssertionError(f"{key}: K2 ran at "
                                 f"{out[key]['k2_rows_dtype']}")
    return out


def phase_loader(device, gen, root):
    """Composed-checkpoint formats at full width, 2 layers: a Vicuna-layout
    sharded base and four unimodal DAMC adapter directories (r=128, a
    projector each) written under ``root``, merged by the port's merge
    (online-merge-reset, 0.25 each), loaded onto the card by the port's
    loader; every loaded leaf held to what was written, then the int8 +
    folded load answers the MCUB-4 request.  Returns the merged
    checkpoint's and the base's directories."""
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
    with torch.no_grad():
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
    return merged, base_dir


class WordHashTokenizer:
    """A stand-in for the Vicuna tokenizer (the card's machine has no
    ``transformers``): BOS, then one id per word from the word's CRC32,
    with ``</s>`` as EOS; ``decode`` writes the ids as ``t<id>``."""
    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    model_max_length = 2048

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def __call__(self, text, **_):
        import re
        import types
        import zlib
        ids = [self.bos_token_id]
        for part in re.split(r"(</s>)", text):
            if part == "</s>":
                ids.append(self.eos_token_id)
            elif part:
                ids.extend(3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
                           for w in part.split())
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids)


def _question_file(root, rng):
    """Three MCUB-4-style questions: a 10.24 s clip as a 16-bit .wav (read
    by ``wave``), an 8,192-point cloud as .npy, and text only (the card's
    machine has neither PIL nor cv2 for images and videos)."""
    import wave

    import numpy as np
    wav, npy = os.path.join(root, "clip.wav"), os.path.join(root, "cloud.npy")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.normal(size=163840) * 3000).astype(
            np.int16).tobytes())
    np.save(npy, np.concatenate([rng.normal(size=(8192, 3)),
                                 rng.random((8192, 3))], 1).astype(np.float32))
    questions = [
        ("<audio>\nWhat is making this sound?", {"audio": [wav]}),
        ("<point>\nWhat is this object? Answer in one word.",
         {"point": [npy]}),
        ("Which instrument is usually tuned to A440 first?", {})]
    path = os.path.join(root, "questions.json")
    with open(path, "w") as f:
        json.dump([{"id": f"q{i}", "conversations": [
            {"from": "human", "value": v}, {"from": "gpt", "value": None}],
            "modal_inputs": m} for i, (v, m) in enumerate(questions)], f)
    return path, len(questions)


# The two question-file runs: beam search under the benchmark protocol,
# and sampling with top-p in the CLI's default conversation mode (the
# benchmark protocol would force greedy decoding)
QA_RUNS = {"beam": ["--protocol", "benchmark", "--num-beams",
                    str(NUM_BEAMS)],
           "sampled": ["--temperature", str(SAMPLE_TEMPERATURE), "--top-p",
                       str(SAMPLE_TOP_P)]}
QA_KEYS = ["question_id", "prompt", "text", "answer_id", "model_id",
           "metadata"]


def phase_qa_loader(device, root, merged, base_dir, model):
    """The eval entry on the card: ``eval_model`` (what ``python -m
    modelcompose_tpu_torch.eval.model_multimodal_qa_loader`` runs) on
    phase 7's merged checkpoint (width 4,096, 2 layers), then
    ``run_questions`` on phase 6's 32-layer MCUB-4 model, each over the
    same three questions in both QA_RUNS; one answer line per question
    with the reference's keys, K1 and K2 launched, seconds per
    question."""
    import numpy as np
    from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as qa
    reset, read = _attention_counters()
    qfile, n_q = _question_file(root, np.random.default_rng(SEED))
    tokenizer = WordHashTokenizer()
    out, totals = {}, {"flash_attention_fwd": 0, "flash_decode": 0}
    load_s = []  # eval_model's load, timed apart from its questions
    loader = qa.load_pretrained_model

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        res = loader(*args, **kw)
        load_s.append(time.perf_counter() - t0)
        return res
    for target in ("checkpoint_2_layers", "mcub4_32_layers"):
        for run, flags in QA_RUNS.items():
            answers = os.path.join(root, f"answers-{target}-{run}.jsonl")
            args = qa.parse_args([
                "--model-path", merged, "--model-base", base_dir,
                "--question-file", qfile, "--answers-file", answers,
                "--max-new-tokens", str(QA_TOKENS)] + flags)
            reset()
            load_s.clear()
            t0 = time.perf_counter()
            with warnings.catch_warnings():  # random towers
                warnings.simplefilter("ignore")
                if target == "checkpoint_2_layers":
                    qa.load_pretrained_model = timed_load
                    try:
                        qa.eval_model(args, device=device,
                                      load_tokenizer_fn=lambda _: tokenizer)
                    finally:
                        qa.load_pretrained_model = loader
                else:
                    qa.run_questions(args, tokenizer, model,
                                     model.modal_processors(),
                                     "mcub4-damc-multimodal")
            seconds = time.perf_counter() - t0 - sum(load_s)
            launches = read()
            with open(answers) as f:
                lines = [json.loads(line) for line in f]
            key = f"{target}/{run}"
            out[key] = {"load_s": sum(load_s), "questions_s": seconds,
                        "s_per_question": seconds / n_q,
                        "launches": launches,
                        "texts": [line["text"] for line in lines]}
            log("qa_loader", run=key, load_s=f"{sum(load_s):.2f}",
                s_per_question=f"{seconds / n_q:.3f}",
                launches=json.dumps(launches),
                answers=json.dumps([line["text"] for line in lines]))
            if [line["question_id"] for line in lines] != \
                    [f"q{i}" for i in range(n_q)] \
                    or any(list(line) != QA_KEYS for line in lines):
                raise AssertionError(f"{key}: answer lines {lines}")
            if min(launches.values()) == 0:
                raise AssertionError(f"{key}: kernels launched {launches}")
            for k in totals:
                totals[k] += launches[k]
    return out, totals


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


# The train_entry phase: Vicuna-7B v1.5 at full width and depth (its
# config.json), and the point recipes' flags
# (scripts/model_composition/train/run_pretrain_point.sh,
# run_finetune_point_damc.sh) cut in steps.
VICUNA_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096,
                 rms_norm_eps=1e-5, rope_theta=10000.0)
ENTRY_SAMPLES = 48
ENTRY_FLAGS = ["--mm_point_encoder", "point_bert_v1.2.pt",
               "--mm_point_projector_type", "mlp2x_gelu", "--bf16", "True",
               "--gradient_checkpointing", "True", "--warmup_ratio", "0.03",
               "--logging_steps", "1", "--model_max_length", "2048",
               "--seed", str(SEED)]
STAGE1_FLAGS = ["--version", "plain", "--tune_mm_mlp_adapter", "True",
                "--per_device_train_batch_size", "16",
                "--learning_rate", "2e-3", "--max_steps", "3"]
STAGE2_FLAGS = ["--version", "v1", "--lora_strategy", "modal+language",
                "--lora_r", "128", "--lora_alpha", "256",
                "--mm_projector_lr", "2e-5", "--mm_language_lr", "1e-5",
                "--local_prefix_tokens", "5", "--local_suffix_tokens", "5",
                "--per_device_train_batch_size", "4",
                "--learning_rate", "2e-4", "--save_steps", "4"]
ENTRY_STEPS = {"stage1": 3, "stage2": 4, "stage2_resumed": 6}
# 13.5 GB of base, a 3.9 GB step checkpoint, 5.3 GB of fp32 adapter export
# (.bin, and .safetensors where the package imports)
ENTRY_DISK_GB = 24
WORDS = ("red blue small large round flat wooden metal chair table lamp "
         "vase plane car cup bottle guitar shelf sofa bed mug bowl airplane "
         "with four legs a handle two wings on top of the and it is").split()


def _gb(nbytes):
    return nbytes / 1e9


def _dir_bytes(path, pattern="*"):
    import glob
    return sum(os.path.getsize(p) for p in glob.glob(os.path.join(path,
                                                                  pattern))
               if os.path.isfile(p))


def _host_room(path):
    """(free disk GB at ``path``, available host RAM GB)."""
    import shutil
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) for line in f
                     if line.startswith("MemAvailable"))
    return _gb(shutil.disk_usage(path).free), avail * 1024 / 1e9


def _write_vicuna_base(base_dir, device):
    """A Vicuna-7B v1.5 directory from SEED: two fp16 shards with their
    index and the Llama config.json, as the released one has them; weights
    N(0, 0.02), norms 1.  Returns (seconds, bytes)."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    H, I, V = (VICUNA_7B[k] for k in ("hidden_size", "intermediate_size",
                                      "vocab_size"))
    shapes = {"model.embed_tokens.weight": (V, H),
              "model.norm.weight": (H,), "lm_head.weight": (V, H)}
    for i in range(VICUNA_7B["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name in ("q", "k", "v", "o"):
            shapes[f"{pre}self_attn.{name}_proj.weight"] = (H, H)
        shapes[f"{pre}mlp.gate_proj.weight"] = (I, H)
        shapes[f"{pre}mlp.up_proj.weight"] = (I, H)
        shapes[f"{pre}mlp.down_proj.weight"] = (H, I)
        shapes[f"{pre}input_layernorm.weight"] = (H,)
        shapes[f"{pre}post_attention_layernorm.weight"] = (H,)
    keys = list(shapes)
    half = len(keys) // 2
    shards = {"pytorch_model-00001-of-00002.bin": keys[:half],
              "pytorch_model-00002-of-00002.bin": keys[half:]}
    os.makedirs(base_dir)
    for name, ks in shards.items():
        state = {}
        for k in ks:
            if len(shapes[k]) == 1:
                t = torch.ones(shapes[k], dtype=torch.float16)
            else:
                t = (torch.randn(shapes[k], generator=gen, device=device)
                     * 0.02).half().cpu()
            state[k] = t
        torch.save(state, os.path.join(base_dir, name))
        del state
    with open(os.path.join(base_dir, "pytorch_model.bin.index.json"),
              "w") as f:
        json.dump({"weight_map": {k: n for n, ks in shards.items()
                                  for k in ks}}, f)
    with open(os.path.join(base_dir, "config.json"), "w") as f:
        json.dump(dict(VICUNA_7B, architectures=["LlamaForCausalLM"],
                       model_type="llama", torch_dtype="float16"), f)
    return time.perf_counter() - t0, _dir_bytes(base_dir)


def _point_dataset(root, rng):
    """ENTRY_SAMPLES clouds of 8,192 x 6 (xyz normal, rgb uniform) as .npy,
    with a stage-1 json of plain captions and a stage-2 json of v1
    question-answer conversations over the same clouds."""
    import numpy as np
    plain, v1 = [], []

    def words(n):
        return " ".join(rng.choice(WORDS, n))
    for i in range(ENTRY_SAMPLES):
        path = os.path.join(root, f"cloud{i:02d}.npy")
        np.save(path, np.concatenate([rng.normal(size=(8192, 3)),
                                      rng.random((8192, 3))], 1)
                .astype(np.float32))
        plain.append({"id": i, "conversations": [
            {"from": "human", "value": "<point>\n"},
            {"from": "gpt", "value": words(int(rng.integers(8, 24)))}],
            "modal_inputs": {"point": [path]}})
        v1.append({"id": i, "conversations": [
            {"from": "human", "value": "<point>\nWhat is this object? "
                                       "Describe it in detail."},
            {"from": "gpt", "value": words(int(rng.integers(20, 60)))}],
            "modal_inputs": {"point": [path]}})
    paths = {}
    for name, data in (("stage1", plain), ("stage2", v1)):
        paths[name] = os.path.join(root, f"point_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(data, f)
    return paths


def _kernel_counters():
    """(reset, read) of the launch counts of K1-K4."""
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention
    fns = {"flash_attention_fwd": flash_attention_forward,
           "flash_decode": flash_decode_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv}

    def reset():
        for fn in fns.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in fns.items()}
    return reset, read


def _trainable(model):
    """{path: leaf} of the leaves a train run updates."""
    from modelcompose_tpu_torch.tree import tree_leaves
    return {p: t for p, t in tree_leaves({"backbone": model.params,
                                          "projectors": model.projectors})
            if t.requires_grad}


class _EntryProbe:
    """Instruments one ``train()`` call of the train entry from outside:
    times ``build_model`` (the base load), captures the model and hands it
    to ``watch(model, cfg)``, whose result (the leaves to hold after the
    run) it keeps, records every step's launches (counter differences, the
    counts are never reset here) and seconds (synchronized), profiles one
    chosen step, times the step checkpoint's write and the restore, and
    holds the restored state to the checkpoint's files."""

    def __init__(self, entry, read, device, profile_step=None, watch=None):
        self.entry, self.read, self.device = entry, read, device
        self.profile_step, self.watch = profile_step, watch
        self.steps, self.model, self.watched = [], None, None
        self.times = {}
        self.restored_step = None
        self.profile = None

    def __enter__(self):
        import torch
        e = self.entry
        self.saved = {n: getattr(e, n) for n in (
            "build_model", "make_train_step", "save_step_checkpoint",
            "restore_step_checkpoint")}
        originals = dict(self.saved)

        def build_model(args, cfg, device=None):
            t0 = time.perf_counter()
            model = originals["build_model"](args, cfg, device)
            torch.cuda.synchronize()
            self.times["build_model_s"] = time.perf_counter() - t0
            self.model = model
            if self.watch is not None:
                self.watched = self.watch(model, cfg)
            return model

        def make_train_step(*a, **kw):
            step = originals["make_train_step"](*a, **kw)

            def probed(state, batch, layout):
                before = self.read()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(self.steps) == self.profile_step:
                    out = []
                    self.profile = _profile(
                        "train_entry_step",
                        lambda: out.append(step(state, batch, layout)),
                        "train_entry_profile.txt")
                    result = out[0]
                else:
                    result = step(state, batch, layout)
                torch.cuda.synchronize()
                after = self.read()
                self.steps.append({
                    "s": time.perf_counter() - t0,
                    "profiled": len(self.steps) == self.profile_step,
                    "bucket": tuple(batch["token_ids"].shape),
                    "launches": {k: after[k] - before[k] for k in after}})
                return result
            return probed

        def save_step_checkpoint(output_dir, step, state, tx):
            t0 = time.perf_counter()
            path = originals["save_step_checkpoint"](output_dir, step, state,
                                                     tx)
            self.times["checkpoint_write_s"] = time.perf_counter() - t0
            self.times["checkpoint_bytes"] = _dir_bytes(path)
            return path

        def restore_step_checkpoint(ckpt_dir, state, tx):
            from modelcompose_tpu_torch.train import checkpoint as ck
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = originals["restore_step_checkpoint"](ckpt_dir, state, tx)
            torch.cuda.synchronize()
            self.times["restore_s"] = time.perf_counter() - t0
            self.restored_step = state.step
            saved = torch.load(os.path.join(ckpt_dir, ck.PARAMS_FILE),
                               map_location=self.device, weights_only=True)
            opt = torch.load(os.path.join(ckpt_dir, ck.OPT_FILE),
                             map_location=self.device, weights_only=True)
            live = {ck.path_key(p): t for p, t in
                    ck.tree_leaves(state.params) if tx.trains(p)}
            moments = {m: {ck.path_key(p): t for p, t in
                           state.opt_state[m].items()} for m in ("mu", "nu")}
            bad = [k for k in live if not torch.equal(live[k].detach(),
                                                      saved[k])]
            bad += [f"{m}:{k}" for m in moments for k in moments[m]
                    if not torch.equal(moments[m][k], opt[m][k])]
            if bad or set(live) != set(saved):
                raise AssertionError(f"restored state differs from "
                                     f"{ckpt_dir}: {bad[:3]}")
            self.times["restore_checked_leaves"] = len(live)
            del saved, opt
            return state

        for name, fn in (("build_model", build_model),
                         ("make_train_step", make_train_step),
                         ("save_step_checkpoint", save_step_checkpoint),
                         ("restore_step_checkpoint",
                          restore_step_checkpoint)):
            setattr(e, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.entry, name, fn)


def phase_train_entry(device, gen, root):
    """The DAMC train entry at Vicuna-7B width and depth from a base on
    disk: stage 1 (projector pretrain, B=16, 3 steps), stage 2 on its
    export (modal+language LoRA r=128, 5+5 soft tokens, B=4, 4 steps and
    checkpoint-4), the same flags resumed to 6 steps, then the export
    loaded by ``load_pretrained_model`` and one point question decoded
    greedily by ``run_questions``; after the path, each kernel against its
    plain version at the inputs the path gave it."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.compose.convert import projector_to_reference
    from modelcompose_tpu_torch.compose.state_io import load_state
    from modelcompose_tpu_torch.train import train_multimodal as entry

    reset, read = _kernel_counters()
    out = {}
    disk, ram = _host_room(root)
    log("train_entry", free_disk_gb=f"{disk:.1f}",
        host_ram_avail_gb=f"{ram:.1f}")
    if disk < ENTRY_DISK_GB:
        raise RuntimeError(f"train_entry needs {ENTRY_DISK_GB} GB of disk in "
                           f"the checkout (the base, a step checkpoint and "
                           f"the exports); {disk:.1f} GB free")
    base_dir = os.path.join(root, "vicuna-7b-v1.5")
    write_s, base_bytes = _write_vicuna_base(base_dir, device)
    data = _point_dataset(root, np.random.default_rng(SEED))
    out["base"] = {"write_s": write_s, "gb": _gb(base_bytes)}
    log("train_entry", base_write_s=f"{write_s:.1f}",
        base_gb=f"{_gb(base_bytes):.2f}", samples=ENTRY_SAMPLES)
    n_layers = VICUNA_7B["num_hidden_layers"]
    tokenizer = WordHashTokenizer()
    dirs = {"stage1": os.path.join(root, "point-stage1"),
            "stage2": os.path.join(root, "point-damc-multimodal")}

    def run(stage, profile_step=None, watch=None):
        name = "stage1" if stage == "stage1" else "stage2"
        flags = ["--model_name_or_path", base_dir, "--data_path", data[name],
                 "--output_dir", dirs[name]] + ENTRY_FLAGS + (
            STAGE1_FLAGS if name == "stage1" else STAGE2_FLAGS + [
                "--pretrain_mm_mlp_adapter",
                os.path.join(dirs["stage1"], "mm_projector.bin")]) + [
            "--max_steps", str(ENTRY_STEPS[stage])]
        args = entry.build_arg_parser().parse_args(flags)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # train()'s own steady window starts after the profiled step
        skip = 1 if profile_step is None else profile_step + 1
        with _EntryProbe(entry, read, device, profile_step, watch) as probe, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random PointBERT tower
            t0 = time.perf_counter()
            res = entry.train(args, tokenizer=tokenizer, device=device,
                              time_skip=skip)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = probe.steps
        # the profiled step's time holds the profiler's: not timed
        step_s = [None if s["profiled"] else s["s"] for s in steps]
        timed_s = [s for s in step_s[1:] if s is not None]
        positions = res["positions"]
        waits = [t["loader_wait"] for t in res["loop_trace"]]
        row = {"wall_s": wall, "build_model_s": probe.times["build_model_s"],
               "setup_s": res["setup_seconds"], "step_s": step_s,
               "steady_step_s": float(np.median(timed_s)),
               "positions": positions,
               "positions_per_s": [p / s if s else None
                                   for p, s in zip(positions, step_s)],
               "buckets": [s["bucket"] for s in steps],
               "loader_wait_s": waits, "losses": res["losses"],
               "peak_gb": peak / 2**30,
               "export_s": res["export_seconds"],
               "export_bytes": _dir_bytes(dirs[name], "adapter_model.*")
               + _dir_bytes(dirs[name], "mm_projector.*"),
               "launches": [s["launches"] for s in steps],
               "start_step": res["start_step"]}
        row.update({k: v for k, v in probe.times.items()
                    if k != "build_model_s"})
        if probe.profile is not None:
            row["profile"] = probe.profile
        # train()'s own steady window (its whole loop: loader wait,
        # make_batch, the step) covers the steps after the first ``skip``
        window = steps[skip:]
        if res.get("steady_steps") != len(window) \
                or res["steady_bucket_tokens"] != sum(
                    int(np.prod(s["bucket"])) for s in window):
            raise AssertionError(
                f"{stage}: steady window of {res.get('steady_steps')} steps "
                f"and {res.get('steady_bucket_tokens')} bucket positions, "
                f"the probe saw {[s['bucket'] for s in window]}")
        row["loop_steady_s_per_step"] = (res["steady_seconds"]
                                         / res["steady_steps"])
        log("train_entry", stage=stage,
            build_model_s=f"{row['build_model_s']:.1f}",
            setup_s=f"{row['setup_s']:.1f}",
            step_s=json.dumps([s and round(s, 4) for s in step_s]),
            steady_step_s=f"{row['steady_step_s']:.4f}",
            loop_steady_s_per_step=f"{row['loop_steady_s_per_step']:.4f}",
            positions_per_s=json.dumps([p and round(p) for p in
                                        row["positions_per_s"]]),
            buckets=json.dumps(row["buckets"]),
            loader_wait_s=json.dumps([round(w, 4) for w in waits]),
            losses=json.dumps([round(x, 5) for x in res["losses"]]),
            peak_gb=f"{row['peak_gb']:.2f}", export_s=f"{row['export_s']:.1f}",
            export_gb=f"{_gb(row['export_bytes']):.3f}",
            **{k: (f"{v:.2f}" if isinstance(v, float) else v)
               for k, v in probe.times.items() if k != "build_model_s"})
        # every micro-batch ran the kernels: K1 twice a layer under
        # remat, K3 and K4 once
        for i, counts in enumerate(row["launches"]):
            if counts["flash_attention_fwd"] < 2 * n_layers \
                    or counts["flash_attention_bwd_dq"] != n_layers \
                    or counts["flash_attention_bwd_dkv"] != n_layers:
                raise AssertionError(f"{stage} step {i}: launches {counts}")
        if len(steps) != res["steps"] - res["start_step"] \
                or not np.isfinite(res["losses"]).all():
            raise AssertionError(f"{stage}: {len(steps)} steps, losses "
                                 f"{res['losses']}")
        out[stage] = row
        return probe, res

    # stage 1 trains the projector only, stage 2 the LoRA A and B of both
    # adapter rows, the projector and the soft tokens; the base, the
    # embedding and the tower stay bit-unchanged
    def watch_leaves(stage):
        def watch(m, cfg):
            layers, tower = m.params["layers"], m.encoders["point"].params
            frozen = {"attn.q.w": layers["attn"]["q"]["w"],
                      "mlp.down.w": layers["mlp"]["down"]["w"],
                      "embed_tokens": m.params["embed_tokens"],
                      "tower.blocks.qkv.w": tower["blocks"]["qkv"]["w"],
                      "tower.conv1.w": tower["encoder"]["conv1"]["w"]}
            trained = {"projector.w0": m.projectors["point"]["layers"][0]["w"],
                       "projector.b1": m.projectors["point"]["layers"][1]["b"]}
            lora = {f"{k}.{n}": layers[g][n][k] for g, n in
                    (("attn", "q"), ("mlp", "down"))
                    for k in ("lora_a", "lora_b")}
            if stage == "stage1":
                frozen.update(lora)
            else:
                trained.update(lora, prefix=m.params["prefix_tokens"]["point"],
                               suffix=m.params["suffix_tokens"]["point"])
            if stage == "stage2":  # its projector is stage 1's export
                ref = projector_to_reference(
                    cfg.projector_type("point"), m.projectors["point"],
                    "model.modal_projectors.point")
                want = load_state(os.path.join(dirs["stage1"],
                                               "mm_projector.bin"))
                if sorted(ref) != sorted(want) or not all(
                        np.array_equal(ref[k], want[k]) for k in ref):
                    raise AssertionError("stage 2's projector before its "
                                         "first step is not stage 1's export")
            return {"frozen": frozen, "trained": trained, "before": {
                n: t.detach().clone() for n, t in {**frozen,
                                                   **trained}.items()}}
        return watch

    with _KernelInputs() as inputs:
        reset()  # the path's launches: from here to the served answer
        for stage in ("stage1", "stage2"):
            # a profile of stage 2's second step
            probe, res = run(stage, watch=watch_leaves(stage),
                             profile_step=1 if stage == "stage2" else None)
            watch = probe.watched
            before = watch["before"]
            for n, t in watch["frozen"].items():
                if not torch.equal(t.detach(), before[n]):
                    raise AssertionError(f"{stage}: frozen {n} changed")
            for n, t in watch["trained"].items():
                t = t.detach()
                # each LoRA adapter row ('default', 'point') on its own
                parts = [(i, t[:, i], before[n][:, i])
                         for i in range(t.shape[1])] \
                    if n.startswith("lora") else [(None, t, before[n])]
                for i, now, was in parts:
                    if torch.equal(now, was):
                        raise AssertionError(f"{stage}: {n} (row {i}) did "
                                             "not change")
            trained = _trainable(probe.model)
            if stage == "stage1" and any(p[0] != "projectors"
                                         for p in trained):
                raise AssertionError(f"stage 1 trains {sorted(trained)[:3]}")
            log("train_entry", stage=stage,
                frozen_unchanged=sorted(watch["frozen"]),
                trained_changed=sorted(watch["trained"]),
                trainable_leaves=len(trained),
                trainable_params=sum(t.numel() for t in trained.values()))
            del probe, res, watch, before, trained

        probe, res = run("stage2_resumed")
        if probe.restored_step != ENTRY_STEPS["stage2"] \
                or res["start_step"] != ENTRY_STEPS["stage2"] \
                or not res["resumed_from"].endswith(
                    f"checkpoint-{ENTRY_STEPS['stage2']}"):
            raise AssertionError(f"resume: step {probe.restored_step}, "
                                 f"{res['resumed_from']}")
        trained = _trainable(probe.model)
        del probe
        out["serve"] = _serve_entry_export(device, root, dirs, base_dir,
                                           tokenizer, trained)
        launches = read()
    log("train_entry", launches=json.dumps(launches))
    if launches["flash_decode"] == 0:
        raise AssertionError(f"the served answer ran no K2: {launches}")
    out["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    out["kernel_checks"] = _entry_kernel_checks(device, gen, inputs)
    return out


def _serve_entry_export(device, root, dirs, base_dir, tokenizer, trained):
    """Phase 10's stage-2 export loaded by ``load_pretrained_model``, every
    leaf of ``trained`` (emptied here, so the trained state is gone before
    the answer) held bit-equal to the loaded one, then one point question
    answered greedily by ``run_questions``."""
    import torch
    from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as qa
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    from modelcompose_tpu_torch.tree import tree_leaves
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, served, procs, _ = load_pretrained_model(
            dirs["stage2"], base_dir, load_tokenizer_fn=lambda _: tokenizer,
            device=device)
    load_s = time.perf_counter() - t0
    loaded = dict(tree_leaves({"backbone": served.params,
                               "projectors": served.projectors}))
    bad = [p for p, t in trained.items()
           if not torch.equal(loaded[p], t.detach())]
    n_trained = len(trained)
    kinds = {p[-1] if p[0] == "backbone" and p[1] == "layers" else p[0]
             if p[0] == "projectors" else p[1] for p in trained}
    trained.clear()
    if bad or kinds != {"lora_a", "lora_b", "projectors", "prefix_tokens",
                        "suffix_tokens"}:
        raise AssertionError(f"loaded leaves differ from the trained ones: "
                             f"{bad[:3]} ({sorted(kinds)})")
    if any(t.requires_grad for t in loaded.values()):
        raise AssertionError("the served model carries trainable leaves")
    qfile = os.path.join(root, "point_question.json")
    with open(qfile, "w") as f:
        json.dump([{"id": "p0", "conversations": [
            {"from": "human", "value": "<point>\nWhat is this object?"},
            {"from": "gpt", "value": None}],
            "modal_inputs": {"point": [os.path.join(root, "cloud00.npy")]}}],
            f)
    answers = os.path.join(root, "point_answers.jsonl")
    qargs = qa.parse_args(["--model-path", dirs["stage2"], "--model-base",
                           base_dir, "--question-file", qfile,
                           "--answers-file", answers, "--max-new-tokens",
                           str(QA_TOKENS), "--protocol", "benchmark"])
    t0 = time.perf_counter()
    qa.run_questions(qargs, tok, served, procs, "point-damc-multimodal")
    q_s = time.perf_counter() - t0
    with open(answers) as f:
        lines = [json.loads(line) for line in f]
    del served, loaded
    log("train_entry", served_load_s=f"{load_s:.1f}",
        s_per_question=f"{q_s:.3f}", leaves_checked=n_trained,
        answer=json.dumps(lines[0]["text"]))
    if [line["question_id"] for line in lines] != ["p0"] \
            or list(lines[0]) != QA_KEYS or not lines[0]["text"]:
        raise AssertionError(f"answer lines {lines}")
    return {"load_s": load_s, "s_per_question": q_s,
            "answer": lines[0]["text"], "leaves_checked": n_trained}


def _entry_kernel_checks(device, gen, inputs):
    """Each kernel against its plain version at the inputs phase 10 ran it
    at (``inputs``, a ``_KernelInputs``): K1 with K3 and K4 on its output
    (``_k34_case``) at every attention shape, with the row lengths of the
    first micro-batch or prefill at that shape, and K2 (``_k2_case``) at
    every cache shape with its first decode step's kv_len; the cases'
    own tolerances.  Returns the largest error per kernel."""
    import torch
    errs = {"fwd": [], "dq": [], "dkv": [], "decode": []}
    for (B, L, H, D, S, Hkv), (q_seg, kv_seg) in inputs.attention.items():
        lengths = (kv_seg != 0).sum(1)
        prefix = (torch.arange(S, device=kv_seg.device)[None]
                  < lengths[:, None]).to(kv_seg.dtype)
        # _k34_case rebuilds each row as one valid prefix, query offset 0
        if L != S or not torch.equal(q_seg, kv_seg) \
                or not torch.equal(kv_seg, prefix):
            raise AssertionError(f"train_entry: attention B{B} L{L} S{S} "
                                 "is not one valid prefix a row")
        res = _k34_case(device, gen, B=B, L=L, S=S, H=H, Hkv=Hkv, D=D,
                        q_offset=0, lengths=lengths.tolist())
        for n in ("fwd", "dq", "dkv"):
            errs[n].append(res[n]["max_abs_err"])
    for (NL, B, S, Hkv, D, H, dtype), kv_len in inputs.decode.items():
        res = _k2_case(device, gen, B=B, NL=NL, S=S, H=H, Hkv=Hkv, D=D,
                       kv_len=kv_len.tolist(),
                       quantized=dtype == str(torch.int8), layer=NL - 1)
        errs["decode"].append(res["max_abs_err"])
    if not all(errs.values()):
        raise AssertionError(f"train_entry: no kernel inputs recorded for "
                             f"{[n for n, e in errs.items() if not e]}")
    shapes = [f"B{k[0]} L{k[1]}" for k in inputs.attention] + [
        f"{k[-1]} B{k[1]} S{k[2]}" for k in inputs.decode]
    out = {n: max(e) for n, e in errs.items()}
    log("train_entry", kernel_checks=json.dumps(shapes),
        max_abs_err=json.dumps({n: float(f"{e:.4g}") for n, e in
                                out.items()}))
    return out


def main() -> int:
    try:
        import torch
        import modelcompose_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from the repository root ({e})")
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out
    device = timed("device", phase_device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timed("build", phase_build)
    k1 = timed("k1", phase_k1, device, gen)
    k2 = timed("k2", phase_k2, device, gen)
    launches = timed("main", phase_main_path, device, gen)
    gc.collect()
    torch.cuda.empty_cache()  # each served model is gone before the next
    composed, mcub4_model, request = timed("composed", phase_composed,
                                           device, gen)
    variants = timed("decode_variants", phase_decode_variants, mcub4_model,
                     request)
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoints live in a gitignored directory of the checkout
    with tempfile.TemporaryDirectory(prefix="tmp_loader_", dir=".") as root:
        merged, base_dir = timed("loader", phase_loader, device, gen, root)
        gc.collect()
        torch.cuda.empty_cache()
        _, qa_launches = timed("qa_loader", phase_qa_loader, device, root,
                               merged, base_dir, mcub4_model)
    del mcub4_model, request
    gc.collect()
    torch.cuda.empty_cache()
    k34 = timed("k34", phase_k34, device, gen)
    train = timed("train", phase_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tmp_entry_", dir=".") as root:
        entry = timed("train_entry", phase_train_entry, device, gen, root)
    log("seconds", phases=json.dumps(seconds),
        total=f"{time.perf_counter() - t_start:.1f}")
    if {"jax", "modelcompose_tpu"} & set(sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    # Launches on the main paths: the two serving runs, the decode variants
    # and the question-file runs, every step of the training run (train
    # steps and the accumulation window), and the train entry's two stages
    # with the served answer of its export.
    trained = train["launches"] + [train["accum_launches"]]

    def train_launches(name):
        return sum(c.get(name, 0) for c in trained)

    def by_path(name):
        return {"main": launches[name], "composed": composed["launches"][name],
                "decode_variants": sum(v["launches"][name]
                                       for v in variants.values()),
                "qa_loader": qa_launches[name], "train": train_launches(name),
                "train_entry": entry["launches"][name]}

    def train_paths(name):
        return {"train": train_launches(name),
                "train_entry": entry["launches"][name]}

    def worst(row, key):  # the largest error, phase 10's shapes included
        return dict(row, max_abs_err=max(row["max_abs_err"],
                                         entry["kernel_checks"][key]))
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES,
             launches=sum(by_path("flash_attention_fwd").values()),
             launches_by_path=by_path("flash_attention_fwd"),
             **worst(dict(k1, max_abs_err=max(k1["max_abs_err"],
                                              k34["fwd"]["max_abs_err"])),
                     "fwd")),
        dict(name="flash_decode", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES,
             launches=sum(by_path("flash_decode").values()),
             launches_by_path=by_path("flash_decode"),
             **worst(k2, "decode")),
        dict(name="flash_attention_bwd_dq", route="cuda", source=K34_SOURCE,
             replaces=K3_REPLACES,
             launches=sum(train_paths("flash_attention_bwd_dq").values()),
             launches_by_path=train_paths("flash_attention_bwd_dq"),
             **worst(k34["dq"], "dq")),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=K34_SOURCE,
             replaces=K4_REPLACES,
             launches=sum(train_paths("flash_attention_bwd_dkv").values()),
             launches_by_path=train_paths("flash_attention_bwd_dkv"),
             **worst(k34["dkv"], "dkv")),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
