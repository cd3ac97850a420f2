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
   ``MultimodalLM.generate``: the first request of the shape runs the
   tower and the prefill eagerly and captures its decode graph
   (``core/decode_graph``), the second captures the tower's and the
   prefill's graphs (``models/towers``, ``core/prefill_graph``), the
   third, timed, replays every graph and captures nothing (counts per
   kind checked, K1 exactly once a layer in the replayed prefill, peak
   allocated and reserved memory, each kind's graph pool GB, the time to
   first token of the three calls: eager, capturing, replayed); the same
   request with the tower, the prefill and the decode launch by launch
   (no tower or prefill graph, ``device_loop=False``): greedy ids and the
   prefill's logits bit-equal, time to first token (towers, prefill) and
   decode tokens/s both ways; then prefill and teacher-forced decode on
   the plain path with the same weights and tokens, logits held to a
   bf16 tolerance;
6. composed: the MCUB-4 composition (``configs.mcub4_damc_7b``: CLIP,
   BEATs + Q-Former, LanguageBind video and PointBERT towers, 9 stacked
   adapter rows, online-merge-reset 0.25 each) at Vicuna-7B width with
   random weights, in the same production variant plus the adapter stacks
   compacted to the batch's columns: one four-modality request of 3,287
   positions (the 3,328 bucket) answered with 32 greedy tokens; the time
   of each tower through its graph and eagerly at B=1 and B=4 (outputs
   bit-equal) and of its projector, PointBERT's farthest-point sampling
   as one graph replay against its eager loop (indices equal), prefill,
   the request through the graphs and launch by launch as in phase 5 (ids
   and prefill logits bit-equal), peak memory, torch.profiler over one
   replay of the step
   (``chiprun_out/decode_step_profile.txt``), the kernel path's logits
   against the plain path's, and torch.profiler over the towers + prefill
   (``chiprun_out/composed_profile.txt``);
6b. decode variants on phase 6's model and request: sampled (temperature
   0.2), sampled with top-p 0.7 (every drawn token inside its step's
   nucleus; both sampled runs' ids equal to ``device_loop=False`` from the
   same seed), the ``concat`` fold (its ids against the unfolded decode's),
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
   the same draws;
11. serve (run after 7b, on phase 6's model and phase 7's merged
   checkpoint): the model worker with the continuous-batching slot engine
   (8 slots of 3,456 positions, int8 pool) answering 12 requests (audio,
   video, point, text and the MCUB-4 request; greedy and sampled; one
   cancelled by its client, one ending on a stop string) with chunked
   admission (512-position chunks), then with one-shot admission, each on
   a warm server (every request's shapes admitted twice first, so the
   run's admissions replay their tower, prefill and chunk-step graphs)
   and again with the towers and prefills launch by launch; per
   request the time to first token and tokens, the tick's median and p95,
   aggregate tokens/s, the in-flight slots' longest stall during each
   admission (MCUB-4's beside its own and its prefill's seconds, graphs
   against eager), peak memory, each kind's graph pool GB, K1/K2 launches
   (K2 once a layer a tick, K1 once a layer a prefill or chunk, exactly,
   replays counted); every stream ended, and every
   greedy answer whole and equal to a solo run of the same request (a
   one-shot slot's to ``generate(kv_quant=True)``, a chunked slot's to
   ``prefill_chunked(kv_quant=True)`` and greedy steps) or leaving it at a
   named near tie; K1 at the admission's chunk shapes (beside SDPA with
   ``causal_lower_right``, both also timed from a CUDA graph) and K2 on
   the pool at its fullest step's kv_len, against their plain versions;
   the pool decodes through its own decode graph, one replay a tick
   (each run's captures and replays printed);
   then the micro-batching worker packing 4 requests into one
   ``generate_stream``, and the chat CLI (``serve/cli.main``) on phase 7's
   checkpoint with two turns on stdin;
12. the last towers, the text encoder and the eval entries (run after 11):
   (a) ``towers``: EVA02-CLIP-L-14-336 (23 of 24 layers, 577 tokens),
   EVA01-CLIP-g-14 at 224 and 336 (257 and 577 tokens), ImageBind-huge
   audio (3 clips of 229 tokens from a 10 s waveform through the port's
   processor, whose host ms it also times) and the text CLIP encoder at
   ViT-L/14 text width (77 tokens), each alone at full size with random
   fp32 weights: median ms at B=1 and B=4 (text also B=8) through the
   tower's graph and eagerly (outputs bit-equal), peak memory,
   and the card's B=1 output against the same tower's on the CPU, within
   1e-5 of max |x| (beside it, as a control, the same ratio with TF32
   allowed); (b) ``eva_imagebind``: ``configs.eva_imagebind_damc_7b``
   at Vicuna-7B width and depth in phase 5's production variant, one 336
   px image + 10 s audio + 70 text tokens request (698 positions, the
   1,024 bucket) answered with 32 greedy tokens as phase 5 answers its
   requests (three calls, graphs against launch by launch): tower +
   projector ms at B=1 and B=4, prefill, decode, peak memory, launches,
   kernel- against plain-path logits; (c) ``entries``: ``model_qa`` (2 text questions), ``run_inference``
   (.wav + .npy), ``model_multimodal_loss`` (4 rows, batch 2) and
   ``retrieval`` (2 records x 4 captions) on phase 6's model, each with
   its seconds, result and launches, and one loss batch on the kernel path
   against the plain path within 2e-2.  (b) and (c) record the inputs
   their K1 and K2 launches got and hold each kernel to its plain version
   at those shapes, as phase 10 does;
13. legacy_eval (run after 12, on phase 6's model and phase 7's files): (a)
   four PNGs (RGB 640 x 480, RGBA 333 x 500, a 256-colour palette 200 x
   300, grey 320 x 240) written by ``write_png`` with the five row filters
   in turn, read back by ``data.image_io.load_image`` (no PIL) and held to
   the written pixels, with the host ms of reading and preprocessing each;
   (b) the four LLaVA-suite entries answering them greedily (16 tokens,
   ``loaded=``): ``model_vqa`` (two image rows and a text row),
   ``model_vqa_loader`` (one image, then two), ``model_vqa_science``
   (``--answer-prompter --single-pred-prompt``, an image and a text row)
   and ``model_vqa_mmbench`` (two TSV rows with base64 PNGs and four
   options, ``--all-rounds``), each answer line with the JAX entry's keys;
   then the same runs with K1 and K2 replaced by their plain versions,
   every answer equal to the kernel path's or leaving it at a named near
   tie (each entry's seconds and graph captures and replays by kind);
   (c) at Vicuna-7B width and 2 layers: a LLaVA-LoRA vision
   checkpoint converted by ``compose.convert_llava_checkpoint``, loaded by
   ``model_vqa_loader`` and asked a PNG question; ``compose.lifecycle
   merge-lora`` on phase 7's composition, its dense export held to numpy's
   fold, loaded by ``model_vqa`` and asked; ``merge_deltas_to_base`` over
   two peft checkpoints and ``compare`` between phase 7's vision and audio
   checkpoints, every written tensor held to numpy; K1 and K2 against their
   plain versions at every shape (b) and (c) ran them at;
14. distributed (``parallel/``, in two parts, each in an NCCL process
   group of this one process on a free local port, left afterwards): (a)
   after 13, phase 6's model sharded at tp 1 by the loader's
   tensor-parallel step, the MCUB-4 request answered with greedy ids equal
   to a no-group run's bit for bit (prefill s and decode tokens/s of both,
   both with ``device_loop=False``: collectives are not captured; K1 and
   K2 counted on the tp 1 path), then K1 and K2 at the tp 2 and 4
   ranks' shapes (16 and 8 heads, the 3,328 bucket and the int8 3,360
   cache) against their plain versions, timed by CUDA graph replay, with
   their bounds (the ``tp_shards`` of the K1 and K2 rows); (b) after 9,
   phase 9's stage-2 step rebuilt, two steps with no group, then the same
   two from the same state through the data-parallel path (ZeRO-1
   moments, gradients and loss summed over the data group): losses and
   every trainable leaf bit-equal, step seconds of both.

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
K1's ``serve_chunks`` and K2's ``serve_pool`` hold phase 11's, their
``tp_shards`` phase 14's; each kernel's ``launches_by_path`` splits its
launches by phase.  A time that
could not be taken is null.  K2's launches count each replay of a decode
graph as the launches its capture recorded, so a replayed step counts as
an eager one, and so do K1's inside a prefill or chunk-step graph.
Before them, a ``[decode_graph]`` line gives the graph replays of each
phase (every decoding phase must have some), the captures, phase 6's
graph-against-eager decode and its sampling times, and a
``[prefill_graph]`` line the captures and replays of every kind of graph
(decode, prefill, chunk step, tower) by phase (phases 5, 6, 11 and 12b
must replay prefill graphs), K1's launches by path, the time to first
token through the graphs and eager of phases 5, 6 and 12b, the prefill
logits' bit-equality, each kind's pool GB and the peak memory of phase 6
and of each serve run, and MCUB-4's admission stall graph against eager.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits nonzero and prints no
result.
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
# the phases whose decoding runs through captured decode graphs
DECODING_PHASES = ("main", "composed", "decode_variants", "qa_loader",
                   "serve", "eva_imagebind", "entries", "legacy_eval")
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
    # a profile that recorded no kernel measured nothing: not a time of 0
    return total_us / 1e3 / (rounds * n) if total_us > 0 else None


def graph_time_ms(fn, n: int = 20, replays: int = 5):
    """Device time of one ``fn()`` with the host's launch gaps taken out:
    ``n`` calls captured into one CUDA graph, replayed ``replays`` times
    between two events.  None, with the reason logged, when ``fn`` cannot
    be captured."""
    import torch
    from modelcompose_tpu_torch.ops import flash_attention, flash_decode
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        # K2's scratch is the capture record's, kept as long as the graph;
        # K1's launches go to a record nobody counts (timing launches)
        with flash_decode.capturing() as record, \
                flash_attention.capturing(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
            for _ in range(n):
                fn()
    except Exception as e:  # noqa: BLE001 — reported as not measured
        log("graph", not_captured=repr(e)[:200])
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del record
    return start.elapsed_time(end) / (n * replays)


def _graph_counts():
    """(captures, replays) of every decode graph so far."""
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    return DecodeGraph.captures, DecodeGraph.replays


def _graph_kinds():
    """{kind: graph class} of every captured step of the port."""
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.core.prefill_graph import (ChunkStepGraph,
                                                           PrefillGraph)
    from modelcompose_tpu_torch.models.towers import TowerGraph
    return {"decode": DecodeGraph, "prefill": PrefillGraph,
            "chunk_step": ChunkStepGraph, "tower": TowerGraph}


def _all_graph_counts():
    """{kind: [captures, replays]} of every kind of graph so far."""
    return {k: [c.captures, c.replays] for k, c in _graph_kinds().items()}


def _graph_delta(before):
    """{kind: [captures, replays]} since ``before`` (``_all_graph_counts``),
    kinds with neither left out."""
    now = _all_graph_counts()
    out = {k: [now[k][0] - before[k][0], now[k][1] - before[k][1]]
           for k in now}
    return {k: v for k, v in out.items() if any(v)}


def _graph_pools_by_kind_gb(*models):
    """GB the allocator holds in the private pools of each kind of graph
    the ``models`` keep: the decode graphs', the prefill graphs' (one pool
    a model: the one-shot graphs, those in its decode graphs and the chunk
    steps), the towers' (one a model), and ``other`` for the remaining
    private pools (PointBERT's sampling graphs, another model's graphs)."""
    import torch
    pools = {}
    for model in models:
        for graph in model.decode_graphs.values():
            pools[graph.graph.pool() if graph.graph else None] = "decode"
            for pre in graph.prefills.values():
                if pre.graph is not None:
                    pools[pre.graph.pool()] = "prefill"
        if model.prefill_graphs is not None:
            for pre in model.prefill_graphs.one_shot.values():
                if pre.graph is not None:
                    pools[pre.graph.pool()] = "prefill"
            for adm in model.prefill_graphs.admissions.values():
                for step in adm.steps.values():
                    if step.graph is not None:  # the one-shot graphs' pool
                        pools[step.graph.pool()] = "prefill"
        if model.tower_graphs is not None:
            for graph in model.tower_graphs._graphs.values():
                if graph.graph is not None:
                    pools[graph.graph.pool()] = "tower"
    out = {k: 0.0 for k in ("decode", "prefill", "tower", "other")}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool != (0, 0):
            out[pools.get(pool, "other")] += seg["total_size"] / 2**30
    return out


class _GraphCalls:
    """While active, counts the calls of every captured step by kind
    (eager, capturing and replayed calls alike): each prefill-graph or
    chunk-step call runs K1 once a layer, however it runs."""

    def __enter__(self):
        from modelcompose_tpu_torch.core.decode_graph import CapturedStep
        self.cls, self.run, self.calls = CapturedStep, CapturedStep.run, {}
        kinds = {c: k for k, c in _graph_kinds().items()}

        def counted(step):
            kind = kinds.get(type(step), type(step).__name__)
            self.calls[kind] = self.calls.get(kind, 0) + 1
            return self.run(step)
        CapturedStep.run = counted
        return self

    def __exit__(self, *exc):
        self.cls.run = self.run

    def k1_calls(self):
        """Backbone forwards through prefill and chunk-step graphs."""
        return self.calls.get("prefill", 0) + self.calls.get("chunk_step", 0)


class _EagerTTFT:
    """While active, ``model`` runs its towers and prefill launch by launch
    (the functions' ``graphs=None`` path): its tower and prefill graphs
    are set aside and put back after."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.kept = self.model.tower_graphs, self.model.prefill_graphs
        self.model.tower_graphs = self.model.prefill_graphs = None
        return self

    def __exit__(self, *exc):
        self.model.tower_graphs, self.model.prefill_graphs = self.kept


class _PrefillLogits:
    """While active, records a copy of the logits of every one-shot
    prefill ``core.generate.generate`` runs (through a graph or not)."""

    def __enter__(self):
        from modelcompose_tpu_torch.core import generate
        self.module, self.prefill, self.logits = generate, generate.prefill, []

        def recorded(*args, **kw):
            logits, cache = self.prefill(*args, **kw)
            self.logits.append(logits.clone())
            return logits, cache
        generate.prefill = recorded
        return self

    def __exit__(self, *exc):
        self.module.prefill = self.prefill


def _peak_gb():
    """(peak allocated, peak reserved) GB since the last reset: reserved
    holds the decode graphs' private pools besides the allocator's cache;
    allocated holds the retained graph caches."""
    import torch
    return (torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.max_memory_reserved() / 2**30)


def _graph_pools_gb():
    """GB the allocator holds in private pools: the live CUDA graphs' (the
    decode graphs' and PointBERT's sampling graphs')."""
    import torch
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**30


def _graph_vs_eager(phase, model, ids, inputs, answers, timings, logits,
                    **kw):
    """The request again with everything launch by launch: the towers and
    the prefill without their graphs (``_EagerTTFT``) and the decode with
    ``device_loop=False``.  Greedy ids and the prefill's logits bit-equal
    to the graphs' (``logits``, from ``_PrefillLogits``); time to first
    token (towers + projectors + packing, then prefill) and decode
    tokens/s both ways."""
    import torch
    eager_t = {}
    with _EagerTTFT(model), _PrefillLogits() as eager_logits:
        eager = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                               device_loop=False, timings=eager_t, **kw)
    steps = len(ids) * (NEW_TOKENS - 1)
    res = {"ids_equal": eager == answers,
           "logits_equal": torch.equal(eager_logits.logits[0], logits),
           "graph_decode_tok_per_s": steps / timings["decode_s"],
           "eager_decode_tok_per_s": steps / eager_t["decode_s"],
           "graph_encode_s": timings["encode_s"],
           "eager_encode_s": eager_t["encode_s"],
           "graph_prefill_s": timings["prefill_s"],
           "eager_prefill_s": eager_t["prefill_s"]}
    log(phase, graphs="graph vs eager", ids_equal=res["ids_equal"],
        prefill_logits_equal=res["logits_equal"],
        ttft_s=json.dumps({
            "graph": {"towers": round(timings["encode_s"], 4),
                      "prefill": round(timings["prefill_s"], 4)},
            "eager": {"towers": round(eager_t["encode_s"], 4),
                      "prefill": round(eager_t["prefill_s"], 4)}}),
        graph_decode_tok_per_s=f"{res['graph_decode_tok_per_s']:.2f}",
        eager_decode_tok_per_s=f"{res['eager_decode_tok_per_s']:.2f}")
    if eager != answers or not res["logits_equal"]:
        raise AssertionError(f"{phase}: graphs {answers} != eager {eager}, "
                             f"or prefill logits differ")
    return res


def _timed_request(phase, model, ids, inputs, record=None, **kw):
    """One request's shape answered three times: the first request runs
    the towers and the prefill eagerly and captures the decode graph, the
    second captures the towers and the prefill, the third, counted and
    timed, replays every graph and captures nothing.  Returns (answers,
    timings, launches, graph counts, peak GB, the third request's prefill
    logits); ``record`` (a ``_KernelInputs``) is active around the third
    request."""
    import torch
    reset, read = _attention_counters()
    calls = []
    for _ in range(2):
        before = _all_graph_counts()
        t = {}
        model.generate(ids, inputs, max_new_tokens=NEW_TOKENS, timings=t,
                       **kw)
        calls.append((_graph_delta(before), t))
    gc.collect()
    torch.cuda.empty_cache()  # reserved = allocated + graph pools + slack
    torch.cuda.reset_peak_memory_stats()
    reset()
    timings = {}
    before = _all_graph_counts()
    with _PrefillLogits() as prefill, record or _KernelInputs():
        answers = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                                 timings=timings, **kw)
    launches = read()
    # K1 ran once a layer in the one replayed prefill, counted by the replay
    if launches["flash_attention_fwd"] != model.cfg.num_hidden_layers:
        raise AssertionError(f"{phase}: K1 {launches} in one replayed "
                             f"prefill of {model.cfg.num_hidden_layers} "
                             f"layers")
    third = _graph_delta(before)
    peak, reserved = _peak_gb()
    graphs = {"first_request": calls[0][0], "second_request": calls[1][0],
              "third_request": third}
    n_towers = len(inputs)
    ttft = [{"towers": round(t["encode_s"], 4),
             "prefill": round(t["prefill_s"], 4)}
            for t in (calls[0][1], calls[1][1], timings)]
    log(phase, graphs=json.dumps(graphs), peak_mem_gb=f"{peak:.2f}",
        peak_reserved_gb=f"{reserved:.2f}",
        graph_pools_gb=f"{_graph_pools_gb():.3f}",
        pools_by_kind_gb=json.dumps({k: round(v, 3) for k, v in
                                     _graph_pools_by_kind_gb(model).items()}),
        ttft_s_eager_capture_replay=json.dumps(ttft),
        retained_graphs=len(model.decode_graphs))
    # the shape's decode graph is captured by the first request, its
    # prefill graph by the second (the towers' graphs there too, unless an
    # earlier call of the phase took them); the third captures nothing
    want = {"decode": [0, NEW_TOKENS - 1], "prefill": [0, 1],
            "tower": [0, n_towers]}
    if graphs["first_request"].get("decode", [0])[0] != 1 \
            or graphs["second_request"].get("prefill", [0])[0] != 1 \
            or third != want:
        raise AssertionError(f"{phase}: graphs {graphs}: want one decode "
                             f"capture, then one prefill capture, then "
                             f"{want}")
    timings["capture_call_s"] = calls[1][1]["prefill_s"]
    timings["eager_call_s"] = calls[0][1]["prefill_s"]
    return answers, timings, launches, graphs, (peak, reserved), \
        prefill.logits[0]


def _ms(t):
    return "not_measured" if t is None else f"{t:.4f}"


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
             library=False, timer=None):
    """K1 against its plain version at one shape, its time (``timer``, CUDA
    events over warm launches by default), the plain version's (events),
    SDPA's (``library``, by the same timer) and its bound."""
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
    timer = timer or cuda_time_ms
    ms = timer(lambda: flash_attention_forward(q, k, v, **kw))
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
               library_ms=_k1_library(q, k, v, kw, lengths, timer)
               if library else None)
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


def _k1_library(q, k, v, kw, lengths, timer=cuda_time_ms):
    """ms of one ``scaled_dot_product_attention`` call computing the same
    attention (timed here only; the port never calls it), and the backend
    PyTorch picked, read from the kernels it launched."""
    import torch.nn.functional as F
    args, extra = _sdpa_inputs(q, k, v, kw, lengths)
    call = lambda: F.scaled_dot_product_attention(*args, **extra)  # noqa
    ms = timer(call)
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


def _k2_case(device, gen, *, B, NL, S, H, Hkv, D, kv_len, quantized, layer,
             graph=False):
    import torch
    from modelcompose_tpu_torch.core.llama import quantize_kv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q = rnd(B, 1, H, D)
    k, v = rnd(NL, B, S, Hkv, D), rnd(NL, B, S, Hkv, D)
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return _k2_measure(q, k, v, kv, layer, graph)


def _check_k2(q, k, v, kv, layer):
    """K2 against its plain version and the chunked loop on the given
    inputs: (case name, max abs err, its relative error, relative error
    against the loop)."""
    import torch
    from modelcompose_tpu_torch.ops.attention import decode_attention
    from modelcompose_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_reference)
    quantized = isinstance(k, dict)
    NL, B, S, Hkv, D = (k["q"] if quantized else k).shape
    scale = D ** -0.5
    out = flash_decode_attention(q, k, v, kv, layer, sm_scale=scale)
    ref = flash_decode_reference(q, k, v, kv, layer, sm_scale=scale)
    loop = decode_attention(q, k, v, kv, layer_idx=layer, impl="reference")
    torch.cuda.synchronize()
    err, rel = _rel_err(out, ref)
    _, rel_loop = _rel_err(out, loop)
    name = (f"{'int8' if quantized else 'bf16'} B{B} NL{NL} S{S} "
            f"H{q.shape[2]}/{Hkv} D{D} kv_len{kv.tolist()}")
    if not (rel <= ATTN_TOL and rel_loop <= ATTN_TOL):
        raise AssertionError(f"K2 {name}: rel err {rel:.3g} vs plain, "
                             f"{rel_loop:.3g} vs the chunked loop (tol "
                             f"{ATTN_TOL})")
    return name, err, rel, rel_loop


def _k2_measure(q, k, v, kv, layer, graph=False):
    """K2 against its plain version and the chunked loop on the given
    inputs (a bf16 or int8 stacked cache), then its times and bound; with
    ``graph`` also ``graph_ms``, one launch on ``layer`` by CUDA graph
    replay."""
    from modelcompose_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_reference)
    quantized = isinstance(k, dict)
    NL, B, S, Hkv, D = (k["q"] if quantized else k).shape
    H = q.shape[2]
    kv_len = kv.tolist()
    scale = D ** -0.5
    name, err, rel, rel_loop = _check_k2(q, k, v, kv, layer)
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
    # a profile that recorded no kernel leaves the cold device time null
    share_cold = None if device_ms_cold is None else bound_ms / device_ms_cold
    log("K2", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        rel_err_loop=f"{rel_loop:.3g}", ms_warm_events=f"{ms:.4f}",
        plain_ms_warm_events=f"{plain_ms:.4f}",
        device_ms_cold=_ms(device_ms_cold),
        events_ms_cold=f"{events_ms_cold:.4f}",
        plain_device_ms_cold=_ms(plain_device_ms_cold),
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound_cold=_ms(share_cold))
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms,
               library_ms=None, device_ms_cold=device_ms_cold,
               events_ms_cold=events_ms_cold,
               plain_device_ms_cold=plain_device_ms_cold,
               share_of_bound_cold=share_cold)
    if graph:
        res["graph_ms"] = graph_time_ms(lambda: kernel(layer))
        log("K2", case=repr(name), graph_ms=_ms(res["graph_ms"]))
    return res


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
                             embeds.shape[1] + max(NEW_TOKENS,
                                                   tokens.shape[1]),
                             attn_impl, kv_quant=kv_quant)
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
    cfg, model = build_main_model(device, gen)
    ids, inputs = _requests(cfg, device, gen)
    # the first request of the shape captures its decode graph (and warms
    # every kernel up); the second, timed and counted, replays it
    answers, timings, launches, _, _, logits = _timed_request(
        "main", model, ids, inputs, kv_quant=True)
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
    vs_eager = _graph_vs_eager("main", model, ids, inputs, answers, timings,
                               logits, kv_quant=True)
    _compare_logits("main", model, ids, inputs, answers, LOGIT_TOL)
    return launches, dict(vs_eager, capture_call_s=timings["capture_call_s"],
                          eager_call_s=timings["eager_call_s"])


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


def _time_towers(phase, model, inputs, batches=(1,)):
    """Wall time of each tower and its projector (synchronized), the tower
    through its graph (``tower_graphs``: the median of replays, after the
    eager call and the capturing one) and eagerly, at each batch (the
    request's inputs tiled); the graph's output bit-equal to the eager
    one."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.models.projectors import apply_projector
    times = {}

    def tiled(raw, b):
        if isinstance(raw, dict):
            return {k: tiled(v, b) for k, v in raw.items()}
        if not isinstance(raw, torch.Tensor):  # a host array
            return np.repeat(raw, b, axis=0)
        return raw.repeat((b,) + (1,) * (raw.dim() - 1))
    for modal, raw in inputs.items():
        spec = model.cfg.projector_type(modal)
        row = {}
        for b in batches:
            x_in = raw if b == 1 else tiled(raw, b)
            with torch.no_grad():
                for _ in range(2):  # the eager call, then the capture
                    model.encode_tower(modal, x_in)
                graph_ms = _median_ms(lambda: model.encode_tower(modal,
                                                                 x_in), 3)
                x = model.encode_tower(modal, x_in)
                with _EagerTTFT(model):
                    eager_ms = _median_ms(lambda: model.encode_tower(
                        modal, x_in), 3)
                    eager = model.encode_tower(modal, x_in)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                y = apply_projector(spec, model.projectors[modal], x)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            if not (_on_card(x) and torch.isfinite(y).all()):
                raise AssertionError(f"{modal}: tower output off the card "
                                     f"or not finite")
            if not torch.equal(x, eager):
                raise AssertionError(f"{modal}: tower graph output differs "
                                     f"from the eager encode at B={b}")
            row[b] = {"graph_ms": round(graph_ms, 3),
                      "eager_ms": round(eager_ms, 3),
                      "projector_ms": round((t2 - t1) * 1e3, 3)}
        times[modal] = dict(row[1], tokens=int(x.shape[1]),
                            out=int(y.shape[1]), tower_ms=row[1]["graph_ms"],
                            by_batch=row)
    log(phase, towers=json.dumps(times))
    return times


def phase_composed(device, gen):
    """The MCUB-4 composition at Vicuna-7B width: one four-modality request
    answered with 32 greedy tokens in the production decode variant, then
    the kernel path's logits against the plain path's."""
    import torch
    from modelcompose_tpu_torch.configs import MCUB4_SPANS, mcub4_damc_7b
    from modelcompose_tpu_torch.tree import tree_leaves

    cfg = mcub4_damc_7b()
    model = build_served_model(cfg, device, gen, "composed")
    if any(leaf.device.type != "cuda" for enc in model.encoders.values()
           for _, leaf in tree_leaves(enc.params)):
        raise AssertionError("a tower's weights are off the card")
    ids, inputs = _mcub4_request(cfg, device, gen)
    towers = _time_towers("composed", model, inputs, TOWER_BATCHES)
    spans = {m: model.feature_span_len(m) for m in cfg.modalities()}
    if spans != MCUB4_SPANS:
        raise AssertionError(f"spans {spans} != {MCUB4_SPANS}")
    with torch.no_grad():
        embeds, plan = model.prepare_batch(ids, inputs)
    if (int(plan.lengths[0]), embeds.shape[1]) != (MCUB4_POSITIONS, 3328):
        raise AssertionError(f"packed {plan.lengths} in {embeds.shape[1]}")
    del embeds
    fps = _fps_check("composed", inputs["point"])
    kw = dict(kv_quant=True, compact_adapters=True)
    answers, timings, launches, graphs, (peak, reserved), logits = \
        _timed_request("composed", model, ids, inputs, **kw)
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
    vs_eager = _graph_vs_eager("composed", model, ids, inputs, answers,
                               timings, logits, **kw)
    vs_eager.update(capture_call_s=timings["capture_call_s"],
                    eager_call_s=timings["eager_call_s"])
    step_prof = _decode_step_profile(model)
    rel = _compare_logits("composed", model, ids, inputs, answers,
                          COMPOSED_LOGIT_TOL)
    prof = _profile("composed_prefill", lambda: model.generate(
        ids, inputs, max_new_tokens=1, **kw), "composed_profile.txt")
    return {"launches": launches, "towers": towers,
            "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "peak_mem_gb": peak, "peak_reserved_gb": reserved,
            "pools_by_kind_gb": _graph_pools_by_kind_gb(model),
            "graphs": graphs, "vs_eager": vs_eager, "fps": fps,
            "decode_step_profile": step_prof, "logit_rel_err": rel,
            "profile": prof}, model, (ids, inputs)


def _fps_check(phase, points):
    """PointBERT's farthest-point sampling of the request's cloud (512 of
    8,192) as one graph replay against the eager loop on the card: median
    wall ms of each (synchronized), indices equal."""
    import torch
    from modelcompose_tpu_torch.models import point_bert
    xyz, npoint = points[..., :3], 512

    def eager():
        out = torch.zeros((xyz.shape[0], npoint), dtype=torch.int64,
                          device=xyz.device)
        point_bert._fps_loop(xyz, 0, out)
        return out.to(torch.int32)
    c0 = point_bert.farthest_point_sample.captures
    graph_ms = _median_ms(lambda: point_bert.farthest_point_sample(
        xyz, npoint))
    eager_ms = _median_ms(eager)
    equal = torch.equal(point_bert.farthest_point_sample(xyz, npoint),
                        eager())
    res = {"graph_ms": graph_ms, "eager_ms": eager_ms, "equal": equal,
           "captures": point_bert.farthest_point_sample.captures - c0}
    log(phase, fps_graph_ms=f"{graph_ms:.3f}", fps_eager_ms=f"{eager_ms:.3f}",
        fps_indices_equal=equal, fps_captures=res["captures"])
    if not equal or res["captures"] > 1:
        raise AssertionError(f"{phase}: FPS graph {res}")
    return res


def _decode_step_profile(model):
    """torch.profiler over one replay of the model's last decode graph:
    the device ops of a captured step by time
    (``chiprun_out/decode_step_profile.txt``); where the profile sees no
    kernel inside the graph, one eager step over the same cache instead."""
    import torch
    from modelcompose_tpu_torch.core.generate import _decode_step
    graph = list(model.decode_graphs._graphs.values())[-1]
    res = _profile("decode_step_replay", graph.replay,
                   "decode_step_profile.txt")
    if not res["device_kernel_s"]:
        def eager():
            with torch.no_grad():
                _decode_step(graph.params, graph.cfg, graph.cache,
                             graph.tokens, graph.kv_lens, graph.table)
        res = _profile("decode_step_eager", eager, "decode_step_profile.txt")
    return res


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
    copies stay on the device: recording adds no host sync.  A capture
    records nothing (its launches do not run); a replayed graph's K1 and
    K2 launches are recorded from its capture records after its first
    replay here."""

    def __enter__(self):
        import torch
        from modelcompose_tpu_torch.core.decode_graph import CapturedStep
        from modelcompose_tpu_torch.ops import flash_attention, flash_decode
        self.modules = (flash_attention, flash_decode)
        attention_check, decode_check = self.checks = tuple(
            m._check_cuda_inputs for m in self.modules)
        self.attention, self.decode = {}, {}

        def record_attention(q_shape, k_shape, q_seg, kv_seg):
            key = tuple(q_shape) + tuple(k_shape[1:3])
            if key not in self.attention:
                self.attention[key] = (q_seg.clone(), kv_seg.clone())

        def attention(q, k, v, q_seg, kv_seg):
            if not torch.cuda.is_current_stream_capturing():
                record_attention(q.shape, k.shape, q_seg, kv_seg)
            return attention_check(q, k, v, q_seg, kv_seg)

        def decode(q, k_q, v_q, k_s, v_s, kv_len):
            key = tuple(k_q.shape) + (q.shape[2], str(k_q.dtype))
            if key not in self.decode \
                    and not torch.cuda.is_current_stream_capturing():
                self.decode[key] = kv_len.clone()
            return decode_check(q, k_q, v_q, k_s, v_s, kv_len)
        flash_attention._check_cuda_inputs = attention
        flash_decode._check_cuda_inputs = decode
        # a replayed graph runs its launches without a call: its first
        # replay here records them, after it ran (so the segment ids and
        # kv_len hold that replay's values)
        self.cls, self.replay, seen = CapturedStep, CapturedStep.replay, set()

        def replay(graph):
            self.replay(graph)
            if id(graph) not in seen:
                seen.add(id(graph))
                for args in graph.k1.launches:
                    record_attention(*args)
                for args in graph.k2.launches:
                    decode(*args)
        CapturedStep.replay = replay
        return self

    def __exit__(self, *exc):
        for module, check in zip(self.modules, self.checks):
            module._check_cuda_inputs = check
        self.cls.replay = self.replay

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
    out["a_sampled"], answers["a"] = _variant(
        "a sampled", model, ids, inputs, top_p=1.0, generator=gen(1),
        compact_adapters=True, **sampled)
    out["b_top_p"], answers["b"] = _variant(
        "b top_p", model, ids, inputs, top_p=SAMPLE_TOP_P, generator=gen(2),
        **sampled)
    # the draws stay outside the graph: the eager loop draws the same ids
    # from the same seed
    for key, seed, kw in (("a", 1, dict(top_p=1.0, compact_adapters=True)),
                          ("b", 2, dict(top_p=SAMPLE_TOP_P))):
        eager = model.generate(ids, inputs, generator=gen(seed),
                               device_loop=False, **kw, **sampled)
        log("decode_variants", variant=f"{key} eager", ids_equal=eager
            == answers[key])
        if eager != answers[key]:
            raise AssertionError(f"{key}: sampled ids through the graph "
                                 f"{answers[key]} != eager {eager}")
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


# The serve phase: phase 6's model behind the model worker.  The slot pool
# holds the 3,328 bucket and 128 new tokens a slot; an admission is
# prefilled in chunks of 512 positions (the MCUB-4 prompt: 6 chunks and a
# tail of 256).  K1's shapes on that admission (Lq, S): the first full
# chunk, the heaviest, and the tail.
SERVE_SLOTS = 8
SERVE_CACHE_LEN = 3456
SERVE_CHUNK = 512
SERVE_K1_CHUNKS = [(512, 512), (512, 3072), (256, 3328)]
SERVE_CANCEL_AFTER = 4  # the cancelled request's client leaves after these
# The stop-string request stops on its solo answer's token at this step
# (early: a chunked admission attends over its int8 prefix, so a slot may
# leave the solo answer at a later near tie).
SERVE_STOP_STEP = 1
SERVE_TIMEOUT_S = 300  # a run's streams must all end within this
# (name, wave, modality, sampled, new tokens).  Wave 1 fills 7 slots; the
# MCUB-4 request (vision needs PIL, which the card's machine lacks, so it
# goes to the engine itself) is admitted while they decode and fills the
# 8th; wave 3 queues for the slots they free.
SERVE_REQUESTS = [
    ("audio_greedy", 1, "audio", False, 40),
    ("video_greedy", 1, "video", False, 40),
    ("point_greedy", 1, "point", False, 36),
    ("text_stop", 1, None, False, 32),  # ends on a stop string
    ("text_greedy_1", 1, None, False, 48),
    ("text_sampled_1", 1, None, True, 40),
    ("audio_cancelled", 1, "audio", True, 32),
    ("mcub4", 2, "mcub4", False, 48),
    ("text_greedy_2", 3, None, False, 32),
    ("text_greedy_3", 3, None, False, 40),
    ("point_sampled", 3, "point", True, 36),
    ("video_sampled", 3, "video", True, 32),
]
SERVE_WAVES = [[n for n, w, *_ in SERVE_REQUESTS if w == wave]
               for wave in (1, 2, 3)]
SERVE_QUESTIONS = {
    "audio": "<audio>\nWhat is making this sound?",
    "video": "<video>\nWhat happens in this video?",
    "point": "<point>\nWhat is this object? Answer in one word.",
    None: ["Which instrument is usually tuned to A440 first?",
           "Name three primary colors.", "What is the capital of France?",
           "Describe a quiet morning in one sentence.",
           "How many legs does a spider have?"]}


def _chat(question):
    """The vicuna_v1 prompt of one question, as the web UI builds it."""
    from modelcompose_tpu_torch.data.conversation import conv_templates
    conv = conv_templates["vicuna_v1"].copy()
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def _serve_requests(rng):
    """SERVE_REQUESTS as worker request dicts (MCUB-4's aside), with the
    media as the wire carries them (host arrays: a 10.24 s clip, 8 frames
    of 224 px, 8,192 points)."""
    import numpy as np
    media = {"audio": (rng.normal(size=163840) * 0.1).astype(np.float32),
             "video": rng.normal(size=(8, 224, 224, 3)).astype(np.float32),
             "point": np.concatenate([rng.normal(size=(8192, 3)),
                                      rng.random((8192, 3))],
                                     1).astype(np.float32)}
    out, n_text = {}, 0
    for name, _, modal, sampled, budget in SERVE_REQUESTS:
        if modal is None:
            question = SERVE_QUESTIONS[None][n_text % 5]
            n_text += 1
        else:
            question = SERVE_QUESTIONS.get(modal)
        r = {"prompt": _chat(question), "max_new_tokens": budget,
             "temperature": SAMPLE_TEMPERATURE if sampled else 0.0,
             "top_p": SAMPLE_TOP_P if sampled else 1.0}
        if modal in media:
            r["modal_inputs"] = {modal: [media[modal]]}
        out[name] = r
    return out


class _SlotProbe:
    """Wraps, from outside and on the instance, a SlotDecoder's ``admit``
    (each admission's host window and the slots in flight then), ``sample``
    (the time each tick's ids reach the host: its sync point) and ``step``
    (steps taken, and the kv_len K2 reads at the fullest step)."""

    def __init__(self, dec):
        import torch
        self.admits, self.ticks, self.active, self.steps = [], [], [], 0
        self.fullest, self.kv_fullest = -1, None
        admit, sample, step = dec.admit, dec.sample, dec.step
        backbone, prefill = dec.backbone, dec.backbone.prefill
        self.backbone, self.prefill_s = backbone, None
        self.gc_pauses, self._gc_start = [], None  # (start, end) each

        def gc_probe(phase, info):  # Python's collector stops every thread
            if phase == "start":
                self._gc_start = time.perf_counter()
            elif self._gc_start is not None:
                self.gc_pauses.append((self._gc_start, time.perf_counter()))
        self.gc_probe = gc_probe
        gc.callbacks.append(gc_probe)

        def prefill_probe(*args, **kw):
            # the admission's prefill apart from its towers: synchronized
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(*args, **kw)
            torch.cuda.synchronize()
            self.prefill_s = time.perf_counter() - t0
            return out
        backbone.prefill = prefill_probe

        def admit_probe(slot, ids, modal_inputs, tick_cb=None):
            n, t0 = int(dec.active.sum()), time.perf_counter()
            L = admit(slot, ids, modal_inputs, tick_cb=tick_cb)
            self.admits.append({"L": L, "in_flight": n, "start": t0,
                                "end": time.perf_counter(),
                                "prefill_s": self.prefill_s})
            return L

        def sample_probe(*args):
            out = sample(*args)
            self.ticks.append(time.perf_counter())
            self.active.append(int(dec.active.sum()))
            return out

        def step_probe(tokens):
            n = int(dec.active.sum())
            if n > self.fullest:
                self.fullest, self.kv_fullest = n, dec.kv_lens + 1
            self.steps += 1
            return step(tokens)
        dec.admit, dec.sample, dec.step = admit_probe, sample_probe, step_probe

    def close(self):
        """Put the backbone's own prefill back, stop timing collections."""
        del self.backbone.prefill
        gc.callbacks.remove(self.gc_probe)

    def timeline(self, max_slots):
        """(tick gaps outside admissions in ms, with the median decode
        tokens/s of the ticks among them that stepped every slot: a rate
        of selected ticks, not of the run; per admission with slots in
        flight: its positions and the longest gap between two ticks
        around or inside it, the stall those slots saw)."""
        import numpy as np
        pairs = list(zip(self.ticks, self.ticks[1:]))

        def overlaps(t0, t1, a):
            return t1 >= a["start"] and t0 <= a["end"]
        free, full = [], []
        for (t0, t1), n in zip(pairs, self.active):
            if not any(overlaps(t0, t1, a) for a in self.admits):
                free.append((t1 - t0) * 1e3)
                if n == max_slots:
                    full.append(n / (t1 - t0))
        # an admission stalls the slots in flight only once they tick
        def stall(a):
            t0, t1 = max(((t0, t1) for t0, t1 in pairs
                          if overlaps(t0, t1, a)),
                         key=lambda p: p[1] - p[0])
            return {"positions": a["L"], "stall_s": t1 - t0,
                    "admit_s": a["end"] - a["start"],
                    "prefill_s": a["prefill_s"],
                    # the gap's parts outside this admission: from the
                    # tick before it, to the tick after it, and the other
                    # admissions inside the same gap
                    "before_s": a["start"] - t0, "after_s": t1 - a["end"],
                    "others": [b["L"] for b in self.admits if b is not a
                               and overlaps(t0, t1, b)],
                    # Python's garbage collections inside the gap
                    "gc_s": sum(min(e, t1) - max(b, t0)
                                for b, e in self.gc_pauses
                                if e > t0 and b < t1)}
        stalls = [stall(a) for a in self.admits if a["in_flight"]
                  and any(t0 < a["start"] for t0, _ in pairs)]
        tick = {"median_ms": float(np.median(free)) if free else None,
                "p95_ms": float(np.percentile(free, 95)) if free else None,
                "n": len(free), "all_slots_ticks": len(full),
                "all_slots_tick_median_tok_per_s": float(np.median(full))
                if full else None}
        return tick, stalls


def _consume(rec, stream, cancel_after=None):
    """Read one request's stream (wire chunks, or engine events when
    ``rec['events']``), stamping each token's arrival."""
    rec["times"] = []
    try:
        for item in stream:
            rec["times"].append(time.perf_counter())
            if rec.get("events"):
                rec.setdefault("tokens", []).append(item)
            else:
                rec["last"] = json.loads(item[:-1])
            if cancel_after and len(rec["times"]) >= cancel_after:
                stream.close()  # the client leaves: the row is cancelled
                break
    except Exception as e:  # noqa: BLE001 — reported with the request
        rec["error"] = repr(e)


def _engine_events(events, deadline_s=300):
    """An engine's events queue as a stream of token ids."""
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        kind, payload = events.get(timeout=deadline_s)
        if kind == "error":
            raise payload
        if kind == "done":
            return
        yield payload
    raise TimeoutError("engine stream incomplete")


def _wire_tokens(rec, prompt):
    """The ids of a wire stream's last text (WordHashTokenizer writes each
    as ``t<id>``)."""
    return [int(w[1:]) for w in rec["last"]["text"][len(prompt):].split()]


def _serve_run(part, worker, requests, waves, mcub4=None, stop_str=None):
    """``waves`` of requests through ``worker``, the second wave started
    once the first has its first tokens (MCUB-4, ``mcub4`` prepared,
    straight into the engine; the others through
    ``ModelWorker.generate_stream``); per request its time to first token,
    tokens and ids; aggregate tokens/s over the whole run, peak memory,
    K1/K2 launches; the ticks and stalls when the worker has a slot engine,
    else the packed decode's median step.  Every stream must end within
    SERVE_TIMEOUT_S."""
    import threading

    import numpy as np
    import torch
    reset, read = _attention_counters()
    slots = hasattr(worker.engine, "decoder")
    probe = _SlotProbe(worker.engine.decoder) if slots else None
    if mcub4 is not None:  # MCUB-4 goes to the engine with its inputs ready
        prepare = worker.engine.prepare
        worker.engine.prepare = lambda r: r["prepared"] \
            if "prepared" in r else prepare(r)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    captures0, replays0 = _graph_counts()
    kinds0 = _all_graph_counts()
    recs, threads = {}, {}
    calls = _GraphCalls().__enter__()
    t_start = time.perf_counter()

    def start(name):
        rec = recs[name] = {"submit": time.perf_counter()}
        if name == "mcub4":
            rec["events"] = True
            stream = _engine_events(worker.engine.submit(
                {"prepared": mcub4}))
        else:
            r = dict(requests[name])
            if name == "text_stop":
                r["stop"] = stop_str
            stream = worker.generate_stream(r)
        t = threads[name] = threading.Thread(
            target=_consume, args=(rec, stream), kwargs={
                "cancel_after": SERVE_CANCEL_AFTER
                if name == "audio_cancelled" else None}, daemon=True)
        t.start()
    for i, names in enumerate(waves):
        for name in names:
            start(name)
        deadline = time.perf_counter() + SERVE_TIMEOUT_S
        while i == 0 and len(waves) > 1 \
                and time.perf_counter() < deadline and not all(
                    recs[n].get("times") or "error" in recs[n]
                    for n in names):
            time.sleep(0.01)
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    for t in threads.values():
        t.join(max(0.0, deadline - time.perf_counter()))
    hung = [n for n, t in threads.items() if t.is_alive()]
    if hung:
        raise AssertionError(f"{part}: streams still open after "
                             f"{SERVE_TIMEOUT_S} s: {hung}")
    torch.cuda.synchronize()
    calls.__exit__()
    launches = read()
    peak, reserved = _peak_gb()
    captures, replays = _graph_counts()
    out = {"requests": {}, "launches": launches, "peak_mem_gb": peak,
           "peak_reserved_gb": reserved,
           "seconds": time.perf_counter() - t_start,
           "graph_captures": captures - captures0,
           "graph_replays": replays - replays0,
           "graphs_by_kind": _graph_delta(kinds0),
           "graph_calls": calls.calls}
    if not out["graph_replays"]:
        raise AssertionError(f"{part}: no decode graph replayed")
    for name, rec in recs.items():
        if "error" in rec or (rec.get("last") or {}).get("error_code"):
            raise AssertionError(f"{part}/{name}: {rec.get('error') or rec}")
        if not rec["times"]:
            raise AssertionError(f"{part}/{name}: no token")
        out["requests"][name] = {
            "ttft_s": rec["times"][0] - rec["submit"],
            "tokens": len(rec["times"]),
            "ids": rec.get("tokens") or _wire_tokens(
                rec, requests[name]["prompt"])}
    first = min(r["times"][0] for r in recs.values())
    last = max(r["times"][-1] for r in recs.values())
    n_tokens = sum(len(r["times"]) for r in recs.values())
    out["aggregate_tok_per_s"] = n_tokens / (last - first)
    if probe is not None:
        probe.close()
        out["tick"], out["stalls"] = probe.timeline(
            worker.engine.decoder.max_slots)
        out["gc"] = {"n": len(probe.gc_pauses),
                     "total_s": sum(e - b for b, e in probe.gc_pauses),
                     "max_s": max((e - b for b, e in probe.gc_pauses),
                                  default=0.0)}
        out["steps"], out["kv_fullest"] = probe.steps, probe.kv_fullest
    else:  # the packed decode's step, from its longest request's tokens
        longest = max(recs.values(), key=lambda r: len(r["times"]))["times"]
        out["step_median_ms"] = float(np.median(np.diff(longest))) * 1e3 \
            if len(longest) > 1 else None
    log("serve", part=part, seconds=f"{out['seconds']:.2f}",
        aggregate_tok_per_s=f"{out['aggregate_tok_per_s']:.2f}",
        tokens=n_tokens, peak_mem_gb=f"{peak:.2f}",
        peak_reserved_gb=f"{reserved:.2f}",
        graph_pools_gb=f"{_graph_pools_gb():.3f}",
        graph_captures=out["graph_captures"],
        graph_replays=out["graph_replays"],
        graphs_by_kind=json.dumps(out["graphs_by_kind"]),
        graph_calls=json.dumps(out["graph_calls"]),
        launches=json.dumps(launches), tick=json.dumps(out.get("tick")),
        gc=json.dumps(out.get("gc")),
        steps=out.get("steps"), step_median_ms=out.get("step_median_ms"))
    for name, r in out["requests"].items():
        log("serve", part=part, request=name,
            ttft_s=f"{r['ttft_s']:.3f}", tokens=r["tokens"])
    if probe is not None:
        log("serve", part=part, stalls=json.dumps(
            [{"positions": a["positions"],
              "stall_s": round(a["stall_s"], 4),
              "admit_s": round(a["admit_s"], 4)} for a in out["stalls"]]))
    return out


def _mcub4_stall(run):
    """The admission of MCUB-4's 3,287 positions (the one with every other
    slot in flight) in a serve run: its stall, the admission's own seconds
    and its prefill's (the rest is its towers, projectors and packing), the
    stall's parts before and after the admission and the other admissions
    inside it; None where not seen."""
    stalls = [a for a in run.get("stalls", [])
              if a["positions"] == MCUB4_POSITIONS]
    if not stalls:
        return None
    a = max(stalls, key=lambda a: a["stall_s"])
    out = {k: None if a[k] is None else round(a[k], 4)
           for k in ("stall_s", "admit_s", "prefill_s", "before_s",
                     "after_s", "gc_s")}
    return dict(out, others=a["others"])


def _warm_admissions(worker, prepared):
    """Each request of ``prepared`` ((ids, inputs) by name) admitted twice
    with a budget of one token before a timed run: a shape's first
    admission runs its towers and prefill eagerly, the second captures
    their graphs, so the run measures a warm server, whose admissions
    replay.  Returns the graph counts of the warm-up."""
    prepare = worker.engine.prepare
    worker.engine.prepare = lambda r: r["prepared"] \
        if "prepared" in r else prepare(r)
    before = _all_graph_counts()
    for _ in range(2):
        for ids, inputs in prepared.values():
            for _ in _engine_events(worker.engine.submit(
                    {"prepared": (ids, inputs, 1, 0.0, 1.0)})):
                pass
    return _graph_delta(before)


def _slot_vs_solo(part, name, got, solo, solo_logits, budget, whole=True):
    """A greedy slot's answer against the solo run of the same request:
    equal, or the first divergence named, where the solo run's top-2 logit
    gap at that step (``solo_logits(step)``, fp32 [V]) must be under
    LOGIT_TOL of max |logit|: the pool's GEMMs run at M=8 and the solo's
    at M=1, so a near tie may break the other way.  With ``whole`` the
    answer must not be cut short: as long as the solo answer when it
    equals it, its budget when it leaves it (the random model's greedy
    answers run to their budgets: no EOS is drawn)."""
    n = len(got)
    if got == solo[:n]:
        if whole and n != len(solo):
            raise AssertionError(f"{part}/{name}: {n} tokens, a cut copy "
                                 f"of the solo answer's {len(solo)}")
        return {"equal": True, "tokens": n}
    step = next(i for i, (a, b) in enumerate(zip(got, solo + [None]))
                if a != b)
    logits = solo_logits(step)
    top2 = logits.topk(2).values
    gap = ((top2[0] - top2[1]) / logits.abs().max()).item()
    log("serve", part=part, request=name, diverge_step=step,
        slot_token=got[step], solo_token=solo[step] if step < len(solo)
        else "eos", solo_top2_gap_rel=f"{gap:.4g}", tol=LOGIT_TOL)
    if gap > LOGIT_TOL:
        raise AssertionError(f"{part}/{name}: slot answer leaves the solo "
                             f"run at step {step}, top-2 gap {gap:.3g} of "
                             f"max |logit|")
    if whole and n != budget:
        raise AssertionError(f"{part}/{name}: {n} tokens of {budget} after "
                             f"leaving the solo answer at step {step}")
    return {"equal": False, "diverge_step": step, "top2_gap_rel": gap}


def _solo_chunked(model, ids, inputs, budget):
    """Greedy answer of one request computed as a chunked slot admission
    computes it, alone: ``prefill_chunked(kv_quant=True)`` in SERVE_CHUNK
    pieces into an int8 cache of SERVE_CACHE_LEN, then greedy decode steps
    over it; with each step's fp32 logits."""
    import torch
    from modelcompose_tpu_torch.core.generate import (_decode_step,
                                                      prefill_chunked)
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    with torch.inference_mode():
        embeds, plan = model.prepare_batch(ids, inputs)
        dev = embeds.device
        route_ids = (torch.as_tensor(plan.route_ids, device=dev)
                     if model.cfg.routing_active() else None)
        logits, cache = prefill_chunked(
            model.params, model.cfg, embeds, route_ids,
            as_table(model.routing_table, dev), plan.lengths,
            SERVE_CACHE_LEN, chunk=SERVE_CHUNK, kv_quant=True)
        kv_lens = torch.as_tensor(plan.lengths, dtype=torch.int32,
                                  device=dev)
        answer, steps = [], []
        for _ in range(budget):
            steps.append(logits[0].float())
            tok = logits[0].argmax()
            if int(tok) == model.cfg.eos_token_id:
                break
            answer.append(int(tok))
            logits, cache, kv_lens = _decode_step(
                model.params, model.cfg, cache, tok[None].to(torch.int32),
                kv_lens, model.decode_routing_table())
    return answer, steps


def _k1_chunk_case(device, gen, cfg, Lq, S):
    """K1 on one chunk of an int8-pool admission as the path runs it (the
    heads of ``cfg``): no segment ids, q_offset = S - Lq, k/v the
    dequantized prefix [0, S) of an int8 stacked cache
    (``core.llama._used_prefix``); against its plain version, with its
    time, the plain version's, the bound and SDPA with
    ``causal_lower_right`` (the library call that computes a chunk)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from torch.profiler import ProfilerActivity, profile

    from modelcompose_tpu_torch.core.llama import _used_prefix, quantize_kv
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_reference)
    H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    cache = [quantize_kv(rnd(1, 1, SERVE_CACHE_LEN, Hkv, D))
             for _ in range(2)]
    k, v = (_used_prefix(c, 0, S, torch.bfloat16) for c in cache)
    q = rnd(1, Lq, H, D)
    off = S - Lq
    ones = [torch.ones((1, n), dtype=torch.int32, device=device)
            for n in (Lq, S)]
    kw = dict(causal=True, q_segment_ids=ones[0], kv_segment_ids=ones[1],
              q_offset=off)
    out, lse = flash_attention_forward(q, k, v, causal=True, q_offset=off)
    name = f"chunk Lq{Lq} S{S} q_offset{off}"
    err, rel, lse_err = _check_k1(name, q, k, v, kw, out, lse)
    k1 = lambda: flash_attention_forward(  # noqa: E731
        q, k, v, causal=True, q_offset=off)
    ms = cuda_time_ms(k1)
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(
        q, k, v, causal=True, q_offset=off))
    args = [t.transpose(1, 2) for t in (q, k, v)]
    mask = causal_lower_right(Lq, S)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *args, attn_mask=mask)
    library_ms = cuda_time_ms(sdpa)
    # events time a launch of a small shape by the host's pace; the device
    # time of each call comes from replaying it from a CUDA graph (the
    # profiler drops some of K1's and SDPA's kernel records at these
    # shapes: its sum once read K1 at 1.02 of the bound)
    device_ms = graph_time_ms(k1)
    library_device_ms = graph_time_ms(sdpa)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sdpa()  # the aten ops under the call name SDPA's backend
    library_ops = sorted({e.key for e in prof.key_averages()
                          if "attention" in e.key})
    # q, k, v read once, O and the fp32 LSE written once (a chunk has no
    # segment ids)
    nbytes = 2 * D * (H * Lq + Hkv * S) + 2 * (v.numel() + q.numel()) \
        + 4 * H * Lq
    bound_ms, bound_by = bound(4 * D * H * _valid_pairs(kw, Lq, S), nbytes)
    share = bound_ms / device_ms if device_ms else None
    log("K1", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        lse_err=f"{lse_err:.3g}", ms=f"{ms:.4f}", device_ms=_ms(device_ms),
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, share_of_bound=share,
        library="sdpa causal_lower_right", library_ms=f"{library_ms:.4f}",
        library_device_ms=_ms(library_device_ms),
        library_ops=json.dumps(library_ops))
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=share, library_ms=library_ms,
                library_device_ms=library_device_ms,
                library_ops=library_ops, shape=name)


def _serve_kernel_checks(device, gen, shapes, decoder, kv_fullest):
    """K1 at the chunk shapes the chunked admissions ran (checked against
    ``shapes``, a ``_KernelInputs``) and K2 on the pool itself at the
    kv_len of its fullest step, each against its plain version."""
    import torch
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention
    cfg = decoder.cfg
    H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    seen = {(key[1], key[4]) for key in shapes.attention
            if key[0] == 1 and key[2:4] == (H, D)}
    missing = [c for c in SERVE_K1_CHUNKS if c not in seen]
    pool = (cfg.num_hidden_layers, SERVE_SLOTS, SERVE_CACHE_LEN, Hkv, D, H,
            str(torch.int8))
    if missing or pool not in shapes.decode:
        raise AssertionError(f"serve: K1 ran at {sorted(seen)}, missing "
                             f"{missing}; K2 at {sorted(shapes.decode)}")
    k1 = {f"Lq{Lq} S{S}": _k1_chunk_case(device, gen, cfg, Lq, S)
          for Lq, S in SERVE_K1_CHUNKS}
    q = torch.randn((SERVE_SLOTS, 1, H, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    kv = torch.tensor(kv_fullest, dtype=torch.int32, device=device)
    NL = cfg.num_hidden_layers
    with torch.inference_mode():  # the pool is made in inference mode
        k2 = _k2_measure(q, decoder.cache.k, decoder.cache.v, kv, NL - 1)
        # the profiler's cold time cross-checked by a CUDA graph of one
        # launch on each layer in turn
        graph_ms = graph_time_ms(lambda: [flash_decode_attention(
            q, decoder.cache.k, decoder.cache.v, kv, i, sm_scale=D ** -0.5)
            for i in range(NL)])
    k2["graph_ms_cold"] = graph_ms / NL if graph_ms is not None else None
    log("K2", case="serve pool", graph_ms_cold=_ms(k2["graph_ms_cold"]))
    k2["shape"] = f"int8 B{SERVE_SLOTS} S{SERVE_CACHE_LEN} kv_len {kv_fullest}"
    return k1, k2


def phase_serve(device, gen, model, request, root, merged, base_dir):
    """The serving stack on phase 6's MCUB-4 model: the continuous-batching
    worker (8 slots of 3,456 positions, int8 pool) with chunked admission,
    then with one-shot admission, each answering SERVE_REQUESTS (one
    four-modality MCUB-4 request through the engine, the rest through
    ``ModelWorker.generate_stream``'s wire chunks, no HTTP hop), every
    greedy answer held to its solo ``generate``; the kernels at the
    chunk and pool shapes; then the micro-batching worker packing 4
    requests into one ``generate_stream``, and ``serve/cli.main`` on
    phase 7's merged checkpoint with two turns on stdin."""
    import contextlib
    import io

    import numpy as np
    import torch
    from modelcompose_tpu_torch.serve import cli
    from modelcompose_tpu_torch.serve.model_worker import ModelWorker
    tokenizer = WordHashTokenizer()
    requests = _serve_requests(np.random.default_rng(SEED))

    def worker(**kw):
        return ModelWorker(
            "http://controller", "http://worker", "mcub4-damc-multimodal",
            base_dir, no_register=True, limit_concurrency=SERVE_SLOTS,
            loader=lambda *_: (tokenizer, model, model.modal_processors(),
                               2048), **kw)
    slot_kw = dict(continuous_batching=True, slot_cache_len=SERVE_CACHE_LEN,
                   slot_kv_quant=True)
    first = worker(prefill_chunk=SERVE_CHUNK, **slot_kw)
    # every greedy request's ids and decoded inputs, and its solo answers:
    # a one-shot admission prefills as ``generate(kv_quant=True)`` does; a
    # chunked one attends over its own dequantized int8 prefix
    greedy = {}
    for name, _, _, sampled, budget in SERVE_REQUESTS:
        if not sampled:
            ids, inputs = request if name == "mcub4" else \
                first._prepare_request(requests[name])[:2]
            greedy[name] = (list(ids) if name == "mcub4" else [ids], inputs,
                            budget)
    t0 = time.perf_counter()
    solos = {"one_shot": {name: model.generate(
        ids, inputs, max_new_tokens=budget, kv_quant=True)[0]
        for name, (ids, inputs, budget) in greedy.items()}}
    t1 = time.perf_counter()
    chunked = {name: _solo_chunked(model, ids, inputs, budget)
               for name, (ids, inputs, budget) in greedy.items()}
    solos["chunked"] = {n: a for n, (a, _) in chunked.items()}
    log("serve", solo_s=f"{t1 - t0:.1f}",
        solo_chunked_s=f"{time.perf_counter() - t1:.1f}",
        solo_lens=json.dumps({p: {n: len(a) for n, a in s.items()}
                              for p, s in solos.items()}))

    def solo_logits(part, name):
        if part == "chunked":
            return lambda step: chunked[name][1][step]
        ids, inputs, _ = greedy[name]
        tokens = (solos[part][name] + [0])  # the EOS step's input is unused

        def at(step):
            with torch.no_grad():
                return _teacher_forced(model, ids, inputs, torch.tensor(
                    [tokens[:step + 1]], device=model.device), "auto")[0, step]
        return at
    # a word's start: the wire text is "t<id> t<id> ..."
    stop_strs = {p: f" t{s['text_stop'][SERVE_STOP_STEP]}"
                 for p, s in solos.items()}
    mcub4 = (request[0][0], request[1], 48, 0.0, 1.0)
    parts, warm, pools = {}, {}, {}

    def eager_run(part, srv):
        """The same waves again with the towers and the admissions'
        prefill launch by launch (the decode pool stays a graph): the
        MCUB-4 admission's stall, the aggregate and the ticks, graph
        against eager."""
        with _EagerTTFT(model):
            parts[part + "_eager"] = _serve_run(
                part + "_eager", srv, requests, SERVE_WAVES, mcub4,
                stop_strs[part])
    # every request's shapes, warmed before each graph run: one request of
    # each modality (the text prompts share one bucket, as do the media
    # requests of one modality)
    warm_inputs = {modal: (request[0][0], request[1]) if modal == "mcub4"
                   else first._prepare_request(requests[name])[:2]
                   for name, _, modal, *_ in reversed(SERVE_REQUESTS)}
    warm["chunked"] = _warm_admissions(first, warm_inputs)
    with _KernelInputs() as shapes:
        parts["chunked"] = _serve_run("chunked", first, requests, SERVE_WAVES,
                                      mcub4, stop_strs["chunked"])
    pools["chunked"] = _graph_pools_by_kind_gb(model)
    eager_run("chunked", first)
    first.engine.stop()  # no thread touches the card while K1 is captured
    k1, k2 = _serve_kernel_checks(device, gen, shapes, first.engine.decoder,
                                  parts["chunked"]["kv_fullest"])
    del first
    second = worker(prefill_chunk=None, **slot_kw)
    warm["one_shot"] = _warm_admissions(second, warm_inputs)
    parts["one_shot"] = _serve_run("one_shot", second, requests, SERVE_WAVES,
                                   mcub4, stop_strs["one_shot"])
    pools["one_shot"] = _graph_pools_by_kind_gb(model)
    eager_run("one_shot", second)
    second.engine.stop()
    del second
    gc.collect()
    torch.cuda.empty_cache()
    stall = {part: {"graph": _mcub4_stall(parts[part]),
                    "eager": _mcub4_stall(parts[part + "_eager"])}
             for part in ("chunked", "one_shot")}
    log("serve", mcub4_stall_s=json.dumps(stall),
        warm_admission_graphs=json.dumps(warm),
        pools_by_kind_gb=json.dumps({p: {k: round(v, 3) for k, v in g.items()}
                                     for p, g in pools.items()}),
        ticks=json.dumps({p: r["tick"] for p, r in parts.items()
                          if "tick" in r}))
    checks = {}
    for part in ("chunked", "one_shot"):
        res = parts[part]
        reqs = res["requests"]
        if reqs["audio_cancelled"]["tokens"] >= requests[
                "audio_cancelled"]["max_new_tokens"]:
            raise AssertionError(f"{part}: the cancelled request ran on")
        n_layers = model.cfg.num_hidden_layers
        # K2 once a layer a tick; K1 once a layer in each admission's
        # prefill or chunk, every one through a graph (eager, capturing or
        # replayed: a replay counts what its capture recorded)
        pieces = parts[part]["graph_calls"]
        k1_want = n_layers * (pieces.get("prefill", 0)
                              + pieces.get("chunk_step", 0))
        if res["launches"]["flash_decode"] != n_layers * res["steps"] \
                or res["launches"]["flash_attention_fwd"] != k1_want \
                or k1_want < n_layers * len(SERVE_REQUESTS):
            raise AssertionError(f"{part}: launches {res['launches']} for "
                                 f"{res['steps']} steps and {pieces} "
                                 f"prefill graph calls")
        for name, (_, _, budget) in greedy.items():
            checks[f"{part}/{name}"] = _slot_vs_solo(
                part, name, reqs[name]["ids"], solos[part][name],
                solo_logits(part, name), budget, whole=name != "text_stop")
        # the stop string ends the request, unless the slot left the solo
        # answer (at a near tie, checked above) before reaching it
        stop = checks[f"{part}/text_stop"]
        stopped = len(reqs["text_stop"]["ids"]) <= SERVE_STOP_STEP
        log("serve", part=part, text_stop_stopped=stopped,
            tokens=reqs["text_stop"]["tokens"])
        if not stopped and stop.get("diverge_step", SERVE_STOP_STEP + 1) \
                > SERVE_STOP_STEP:
            raise AssertionError(f"{part}: the stop string "
                                 f"{stop_strs[part]!r} did not end the "
                                 f"request")
    # the micro-batching worker: 4 requests coalesced into one packed
    # generate_stream (a wide window so that they meet)
    third = worker(continuous_batching=False)
    third.engine.batch_wait_s = 1.0
    calls = []
    stream = model.generate_stream

    def counted(ids, inputs, **kw):
        calls.append(len(ids))
        return stream(ids, inputs, **kw)
    model.generate_stream = counted
    batch = ["point_greedy", "text_greedy_1", "text_sampled_1",
             "text_greedy_2"]
    try:
        with _KernelInputs() as packed:
            parts["batching"] = _serve_run("batching", third, requests,
                                           [batch])
    finally:
        del model.generate_stream
    if calls != [len(batch)]:
        raise AssertionError(f"batching: generate_stream calls {calls}")
    if packed.decode_rows_dtype() != [(len(batch), "torch.bfloat16")]:
        raise AssertionError(f"batching: K2 at {packed.decode_rows_dtype()}")
    del third
    # the terminal client on phase 7's merged checkpoint: two turns on
    # stdin, a point cloud, greedy
    reset, read = _attention_counters()
    reset()
    argv = ["--model-path", merged, "--model-base", base_dir, "--point-file",
            os.path.join(root, "cloud.npy"), "--temperature", "0",
            "--max-new-tokens", str(QA_TOKENS)]
    out, stdin = io.StringIO(), sys.stdin
    t0 = time.perf_counter()
    try:
        sys.stdin = io.StringIO("What is this object?\nWhat color is it?\n")
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cli.main(argv, load_tokenizer_fn=lambda _: tokenizer)
    finally:
        sys.stdin = stdin
    answers = [ln.split("ASSISTANT: ", 1)[1] for ln in
               out.getvalue().splitlines() if "ASSISTANT: " in ln]
    parts["cli"] = {"seconds": time.perf_counter() - t0, "answers": answers,
                    "launches": read()}
    log("serve", part="cli", seconds=f"{parts['cli']['seconds']:.2f}",
        answers=json.dumps(answers), launches=json.dumps(read()))
    if len(answers) != 2 or not all(answers) \
            or min(parts["cli"]["launches"].values()) == 0:
        raise AssertionError(f"cli: {out.getvalue()!r}")
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("flash_attention_fwd", "flash_decode")}
    log("serve", launches=json.dumps(launches), greedy_vs_solo=json.dumps(
        {k: v.get("diverge_step", "equal") for k, v in checks.items()}))
    return {"parts": parts, "launches": launches, "vs_solo": checks,
            "k1_chunks": k1, "k2_pool": k2, "stall": stall, "pools": pools,
            "warm_graphs": warm,
            "max_abs_err": {"fwd": max(c["max_abs_err"] for c in k1.values()),
                            "decode": k2["max_abs_err"]}}


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


def _entry_kernel_checks(device, gen, inputs, phase="train_entry"):
    """Each kernel against its plain version at the inputs the path
    ``phase`` ran it at (``inputs``, a ``_KernelInputs``): K1 with K3 and
    K4 on its output (``_k34_case``) at every attention shape, with the
    row lengths of the first micro-batch, prefill or loss batch at that
    shape, and K2 (``_k2_case``) at every cache shape with its first
    decode step's kv_len; the cases' own tolerances.  Returns the largest
    error per kernel."""
    import torch
    errs = {"fwd": [], "dq": [], "dkv": [], "decode": []}
    for (B, L, H, D, S, Hkv), (q_seg, kv_seg) in inputs.attention.items():
        lengths = (kv_seg != 0).sum(1)
        prefix = (torch.arange(S, device=kv_seg.device)[None]
                  < lengths[:, None]).to(kv_seg.dtype)
        # _k34_case rebuilds each row as one valid prefix, query offset 0
        if L != S or not torch.equal(q_seg, kv_seg) \
                or not torch.equal(kv_seg, prefix):
            raise AssertionError(f"{phase}: attention B{B} L{L} S{S} "
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
        raise AssertionError(f"{phase}: no kernel inputs recorded for "
                             f"{[n for n, e in errs.items() if not e]}")
    shapes = [f"B{k[0]} L{k[1]}" for k in inputs.attention] + [
        f"{k[-1]} B{k[1]} S{k[2]}" for k in inputs.decode]
    out = {n: max(e) for n, e in errs.items()}
    log(phase, kernel_checks=json.dumps(shapes),
        max_abs_err=json.dumps({n: float(f"{e:.4g}") for n, e in
                                out.items()}))
    return out


# Phase 12: the last two towers, the text encoder and the eval entries.
# (a) each tower alone at its released size, random fp32 weights (TF32 off),
# timed at these batches (the text encoder also at B=8) and held on the
# card to the same tower on the CPU at B=1; (b) eva_imagebind_damc_7b
# serving one image + audio + text request; (c) the four entries on phase
# 6's MCUB-4 model.
TOWER_BATCHES = (1, 4)
TEXT_BATCHES = (1, 4, 8)
# card against CPU, fp32: summation order only (1.1e-6 to 2.6e-6 measured
# on the H100); TF32 products would round at about 5e-4, which the
# control reading of each tower row shows
TOWER_TOL = 1e-5
ENTRY_LOSS_TOL = 2e-2  # kernel path's loss against the plain path's
WAVE_SECONDS = 10.0
EVA_PRESETS = ("EVA02-CLIP-L-14-336", "EVA01-CLIP-g-14",
               "EVA01-CLIP-g-14-336")


def _on_card(t) -> bool:
    return t.is_cuda


def _median_ms(fn, n: int = 5) -> float:
    """Median wall time of ``n`` synchronized calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def _cpu_copy(tree):
    from modelcompose_tpu_torch.tree import tree_map_with_path
    return tree_map_with_path(lambda _, t: t.detach().cpu(), tree)


def _tower_row(name, tower, make_inputs, batches, tokens, resident):
    """Time ``tower`` on the card at each batch (median ms of its graph's
    replays, ``ms``, and of the eager encode, ``eager_ms``, the two outputs
    bit-equal; peak memory of its weights, activations and graph pool: the
    peak above the ``resident`` bytes allocated before the tower was
    built), then hold its B=1 output to the
    same tower on the CPU (the weights copied there): max |card - CPU| /
    max |CPU|.  As a control of that check, the same ratio with TF32
    products allowed on the card is reported (``tf32_card_vs_cpu``), not
    held."""
    import torch
    from modelcompose_tpu_torch.models.towers import TowerGraphs
    encode = tower.encode
    row = {"tokens": tokens, "ms": {}, "eager_ms": {}, "peak_mem_gb": {}}
    for b in batches:
        inputs = make_inputs(b)
        graphs = TowerGraphs()  # this batch's graph, dropped after it

        def graph():
            return graphs.encode(tower, *inputs)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            graph()  # the eager call; _median_ms's warm-up captures
            row["ms"][b] = _median_ms(graph)
            row["eager_ms"][b] = _median_ms(lambda: encode(*inputs))
            if not torch.equal(graph(), encode(*inputs)):
                raise AssertionError(f"{name}: the tower graph's output "
                                     f"differs from the eager encode")
        row["peak_mem_gb"][b] = (torch.cuda.max_memory_allocated()
                                 - resident) / 2**30
        del graphs
    inputs = make_inputs(batches[0])
    with torch.no_grad():
        card = encode(*inputs)
        device_params = tower.params
        tower.params = _cpu_copy(device_params)
        try:
            t0 = time.perf_counter()
            cpu = encode(*[x.cpu() if isinstance(x, torch.Tensor) else x
                           for x in inputs])
            row["cpu_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            tower.params = device_params
    if not (_on_card(card) and cpu.device.type == "cpu"):
        raise AssertionError(f"{name}: ran on {card.device} / {cpu.device}")
    if not torch.isfinite(card).all():
        raise AssertionError(f"{name}: non-finite output")
    row["shape"] = list(card.shape)
    row["card_vs_cpu"] = ((card.cpu() - cpu).abs().max()
                          / cpu.abs().max()).item()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            card_tf32 = encode(*inputs)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    row["tf32_card_vs_cpu"] = ((card_tf32.cpu() - cpu).abs().max()
                               / cpu.abs().max()).item()
    log("towers", tower=name, tokens=tokens, shape=row["shape"],
        graph_ms=json.dumps({b: round(t, 3) for b, t in row["ms"].items()}),
        eager_ms=json.dumps({b: round(t, 3)
                             for b, t in row["eager_ms"].items()}),
        peak_mem_gb=json.dumps({b: round(g, 3) for b, g in
                                row["peak_mem_gb"].items()}),
        cpu_ms=f"{row['cpu_ms']:.1f}",
        card_vs_cpu=f"{row['card_vs_cpu']:.3g}", tol=TOWER_TOL,
        tf32_card_vs_cpu=f"{row['tf32_card_vs_cpu']:.3g}")
    if not row["card_vs_cpu"] <= TOWER_TOL:
        raise AssertionError(f"{name}: card differs from the CPU by "
                             f"{row['card_vs_cpu']:.3g} of max |x|")
    return row


def phase_towers(device):
    """(a): EVA02-CLIP-L-14-336, EVA01-CLIP-g-14 (224 and 336), ImageBind
    huge audio from a 10 s waveform through the port's processor, and the
    text CLIP encoder at ViT-L/14 text width, each alone at full size."""
    import dataclasses

    import numpy as np
    import torch
    from modelcompose_tpu_torch import ModelConfig
    from modelcompose_tpu_torch.models.audio_imagebind import (
        ImageBindAudioProcessor, ImageBindAudioTower)
    from modelcompose_tpu_torch.models.text_clip import ClipTextEncoder
    from modelcompose_tpu_torch.models.vision_eva import EvaVisionTower
    rows = {}

    def gen(seed):
        return torch.Generator(device=device).manual_seed(SEED + seed)

    def pixels(size):
        return lambda b: (torch.randn((b, size, size, 3), generator=gen(9),
                                      device=device),)
    mcfg = ModelConfig(mm_vision_encoder="EVA02_CLIP_L_336_psz14_s6B.pt")
    resident = torch.cuda.memory_allocated()  # phase 6's model
    log("towers", resident_gb=f"{resident / 2**30:.3f}")
    g14 = None
    for i, preset in enumerate(EVA_PRESETS):
        if preset == "EVA01-CLIP-g-14-336":
            # the same blocks as the 224 tower, 577 positions
            tower = EvaVisionTower(preset, mcfg, params={})
            tower.params = dict(g14.params, position_embedding=torch.randn(
                (tower.cfg.num_patches + 1, tower.cfg.hidden_size),
                generator=gen(i), device=device) * 0.02)
        else:
            tower = EvaVisionTower(preset, mcfg, generator=gen(i),
                                   device=device)
        cfg = tower.cfg
        rows[preset] = _tower_row(
            preset, tower, pixels(cfg.image_size), TOWER_BATCHES,
            cfg.num_patches + 1, resident)
        rows[preset].update(layers_run=cfg.select_layer % (cfg.depth + 1),
                            width=cfg.hidden_size,
                            params=sum(t.numel() for t in _leaves(
                                tower.params)))
        if preset == "EVA01-CLIP-g-14":
            g14 = tower
        del tower
    del g14
    gc.collect()
    torch.cuda.empty_cache()

    tower = ImageBindAudioTower("VideoLLaMA/imagebind_huge", generator=gen(3),
                                device=device)
    proc = ImageBindAudioProcessor(tower.cfg)
    rng = np.random.default_rng(SEED)
    waves = [(rng.normal(size=int(WAVE_SECONDS * 16000)) * 0.1).astype(
        np.float32) for _ in range(max(TOWER_BATCHES))]
    proc_ms = _median_ms(lambda: proc(waves[0]))
    mels = proc(waves)
    rows["imagebind_huge"] = _tower_row(
        "imagebind_huge", tower,
        lambda b: (torch.as_tensor(mels[:b], device=device),),
        TOWER_BATCHES, tower.cfg.num_patches + 1, resident)
    rows["imagebind_huge"].update(processor_ms=proc_ms,
                                  clips=tower.cfg.clips_per_audio)
    log("towers", tower="imagebind_huge", processor_ms=f"{proc_ms:.2f}",
        melspec=list(mels.shape))
    del tower

    text = ClipTextEncoder(generator=gen(4), device=device)
    tcfg = text.cfg
    T = tcfg.max_position_embeddings
    ids = torch.randint(1, tcfg.vocab_size - 1, (max(TEXT_BATCHES), T),
                        generator=gen(5), device=device)
    lengths = torch.randint(4, T + 1, (max(TEXT_BATCHES),), generator=gen(6),
                            device=device)
    ids[torch.arange(len(ids)), lengths - 1] = tcfg.vocab_size - 1  # EOT
    mask = (torch.arange(T, device=device)[None] < lengths[:, None]).long()
    rows["clip_text"] = _tower_row(
        "clip_text", text, lambda b: (ids[:b], mask[:b]), TEXT_BATCHES, T,
        resident)
    del text
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _leaves(tree):
    from modelcompose_tpu_torch.tree import tree_leaves
    return [t for _, t in tree_leaves(tree)]


def _eva_imagebind_request(cfg, device, gen):
    """A 336 px image, a 10 s waveform through ImageBind's processor and
    70 text tokens: ids on the host, pixels on the card, the melspec a host
    array (as the processor gives it)."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
    from modelcompose_tpu_torch.models.audio_imagebind import \
        ImageBindAudioProcessor
    rng = np.random.default_rng(SEED + 1)
    ids = [np.concatenate([[1], rng.integers(3, cfg.vocab_size, 35),
                           [MODAL_TOKEN_INDEXES["vision"],
                            MODAL_TOKEN_INDEXES["audio"]],
                           rng.integers(3, cfg.vocab_size, 34)])]
    wave = (rng.normal(size=int(WAVE_SECONDS * 16000)) * 0.1).astype(
        np.float32)
    return ids, {"vision": torch.randn((1, 336, 336, 3), generator=gen,
                                       device=device),
                 "audio": ImageBindAudioProcessor()(wave)}


def phase_eva_imagebind(device, gen):
    """(b): ``configs.eva_imagebind_damc_7b`` at Vicuna-7B width and depth,
    built as phase 6 builds MCUB-4 (its own backbone: the adapter rows
    differ), in the production variant, one image + audio + text request
    answered with 32 greedy tokens; then the kernel path's logits against
    the plain path's."""
    import torch
    from modelcompose_tpu_torch.configs import (EVA_IMAGEBIND_SPANS,
                                                eva_imagebind_damc_7b)
    cfg = eva_imagebind_damc_7b()
    resident = torch.cuda.memory_allocated()  # phase 6's model
    model = build_served_model(cfg, device, gen, "eva_imagebind")
    kinds = {m: type(e).__name__ for m, e in model.encoders.items()}
    if kinds != {"vision": "EvaVisionTower", "audio": "ImageBindAudioTower"}:
        raise AssertionError(f"towers {kinds}")
    if not all(_on_card(t) for enc in model.encoders.values()
               for t in _leaves(enc.params)):
        raise AssertionError("a tower's weights are off the card")
    ids, inputs = _eva_imagebind_request(cfg, device, gen)
    towers = _time_towers("eva_imagebind", model, inputs, TOWER_BATCHES)
    spans = {m: model.feature_span_len(m) for m in cfg.modalities()}
    if spans != EVA_IMAGEBIND_SPANS:
        raise AssertionError(f"spans {spans} != {EVA_IMAGEBIND_SPANS}")
    with torch.no_grad():
        embeds, plan = model.prepare_batch(ids, inputs)
    positions, bucket = int(plan.lengths[0]), int(embeds.shape[1])
    del embeds
    if bucket != 1024:
        raise AssertionError(f"packed {positions} in {bucket}")
    kw = dict(kv_quant=True, compact_adapters=True)
    # two warm-up requests capture the shape's graphs; the third replays
    kernel_inputs = _KernelInputs()
    answers, timings, launches, graphs, (peak, _), logits = _timed_request(
        "eva_imagebind", model, ids, inputs, record=kernel_inputs, **kw)
    own = peak - resident / 2**30
    decode_steps = NEW_TOKENS - 1
    log("eva_imagebind", positions=positions, bucket=bucket,
        resident_gb=f"{resident / 2**30:.2f}", own_peak_gb=f"{own:.2f}",
        prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_steps / timings['decode_s']:.2f}",
        peak_mem_gb=f"{peak:.2f}", answer_len=len(answers[0]),
        launches=json.dumps(launches))
    n_layers = cfg.num_hidden_layers
    if launches["flash_attention_fwd"] < n_layers \
            or launches["flash_decode"] < n_layers * decode_steps:
        raise AssertionError(f"launches {launches}")
    vs_eager = _graph_vs_eager("eva_imagebind", model, ids, inputs,
                               answers, timings, logits, **kw)
    vs_eager.update(capture_call_s=timings["capture_call_s"],
                    eager_call_s=timings["eager_call_s"])
    rel = _compare_logits("eva_imagebind", model, ids, inputs, answers,
                          LOGIT_TOL)
    pools = _graph_pools_by_kind_gb(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    checks = _entry_kernel_checks(device, gen, kernel_inputs, "eva_imagebind")
    return {"launches": launches, "towers": towers, "positions": positions,
            "bucket": bucket, "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "peak_mem_gb": peak, "own_peak_gb": own, "logit_rel_err": rel,
            "kernel_checks": checks, "vs_eager": vs_eager, "graphs": graphs,
            "pools_by_kind_gb": pools}


def _entry_files(root):
    """The entries' question files over phase 7b's clip.wav and
    cloud.npy: two text questions (model_qa), four gold rows (the loss)
    and two retrieval records of four captions."""
    wav, npy = os.path.join(root, "clip.wav"), os.path.join(root, "cloud.npy")
    paths = {}
    paths["qa"] = os.path.join(root, "entry_qa.jsonl")
    with open(paths["qa"], "w") as f:
        for i, q in enumerate(["Which instrument is usually tuned first?",
                               "Name three primary colors."]):
            f.write(json.dumps({"question_id": i, "text": q,
                                "category": "generic"}) + "\n")

    def row(i, text, answer, **media):
        return {"id": f"r{i}", "conversations": [
            {"from": "human", "value": text},
            {"from": "gpt", "value": answer}], "modal_inputs": media}
    paths["loss"] = os.path.join(root, "entry_loss.json")
    with open(paths["loss"], "w") as f:
        json.dump([row(0, "<audio>\n", "a dog barking in a yard",
                       audio=[wav]),
                   row(1, "<point>\n", "a small wooden chair", point=[npy]),
                   row(2, "<audio>\n<point>\n", "a chair that creaks",
                       audio=[wav], point=[npy]),
                   row(3, "Describe a violin.", "a string instrument")], f)
    paths["retrieval"] = os.path.join(root, "entry_retrieval.json")
    with open(paths["retrieval"], "w") as f:
        json.dump([
            {"id": 0, "conversations": [{"from": "human",
                                         "value": "<audio>\n"}],
             "modal_inputs": {"audio": [wav]}, "gold": 1,
             "candidates": ["rain on a roof", "a dog barking",
                            "a violin playing", "people talking"]},
            {"id": 1, "conversations": [{"from": "human",
                                         "value": "<point>\n"}],
             "modal_inputs": {"point": [npy]}, "gold": 0,
             "candidates": ["a chair", "a lamp", "a table", "a mug"]}], f)
    return wav, npy, paths


def phase_entries(device, gen, root, model):
    """(c): ``model_qa``, ``run_inference``, ``model_multimodal_loss`` and
    ``retrieval`` on phase 6's MCUB-4 model (``loaded=``, as phase 7b
    calls the QA loader), over phase 7b's .wav and .npy; the loss and the
    retrieval under the ``plain`` template (the default v1 mask drops every
    sample once these entries set the pad id to EOS, in the JAX entries as
    here); then one loss batch on the kernel path against the plain path,
    and each kernel against its plain version at every input shape the
    four entries ran it at (``_entry_kernel_checks``)."""
    import contextlib
    import io

    import torch
    from modelcompose_tpu_torch.data import conversation as conversation_lib
    from modelcompose_tpu_torch.data.dataset import (
        ChunkedMultimodalDataset, DataCollatorForSupervisedDataset)
    from modelcompose_tpu_torch.eval import (model_multimodal_loss,
                                             model_qa, retrieval,
                                             run_inference)
    if not _on_card(model.params["embed_tokens"]):
        raise AssertionError(f"the model is on {model.device}")
    tokenizer = WordHashTokenizer()
    loaded = (tokenizer, model, model.modal_processors(), 2048)
    wav, npy, files = _entry_files(root)
    name = os.path.join(root, "mcub4-damc-multimodal")
    reset, read = _attention_counters()
    out = {}
    template = conversation_lib.default_conversation
    # model_qa prompts in the module's default template, which phase 11's
    # chat CLI left set to its own conversation (turns and a <point>
    # included): start from what a fresh process has
    conversation_lib.default_conversation = \
        conversation_lib.conv_templates["default"]

    def run(entry, fn, argv):
        reset()
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            res = fn(argv)
        out[entry] = {"seconds": time.perf_counter() - t0,
                      "launches": read(), "result": res,
                      "stdout": stdout.getvalue().strip().splitlines()}
        return res

    answers = os.path.join(root, "entry_qa_answers.jsonl")
    with _KernelInputs() as kernel_inputs:
        run("model_qa", lambda a: model_qa.eval_model(
            model_qa.build_arg_parser().parse_args(a), loaded=loaded),
            ["--model-path", name, "--question-file", files["qa"],
             "--answers-file", answers, "--temperature", "0",
             "--max-new-tokens", str(QA_TOKENS)])
        run("run_inference", lambda a: run_inference.run(
            run_inference.build_arg_parser().parse_args(a), loaded=loaded),
            ["--model-path", name, "--audio-file", wav, "--point-file", npy,
             "--query", "What makes this sound, and what is this object?",
             "--conv-mode", "vicuna_v1", "--max-new-tokens", str(QA_TOKENS)])
        run("model_multimodal_loss",
            lambda a: model_multimodal_loss.eval_loss(
                model_multimodal_loss.build_arg_parser().parse_args(a),
                loaded=loaded),
            ["--model-path", name, "--question-file", files["loss"],
             "--batch-size", "2", "--conv-mode", "plain"])
        run("retrieval", lambda a: retrieval.eval_retrieval(
            retrieval.build_arg_parser().parse_args(a), loaded=loaded),
            ["--model-path", name, "--question-file", files["retrieval"],
             "--conv-mode", "plain"])
    with open(answers) as f:
        lines = [json.loads(line) for line in f]
    out["model_qa"]["result"] = [line["text"] for line in lines]
    if [line["question_id"] for line in lines] != [0, 1] or any(
            list(line) != ["question_id", "text", "answer_id", "model_id",
                           "metadata"] for line in lines):
        raise AssertionError(f"model_qa lines {lines}")
    for entry, res in out.items():
        log("entries", entry=entry, seconds=f"{res['seconds']:.3f}",
            launches=json.dumps(res["launches"]),
            result=json.dumps(res["result"]))
    n_layers = model.cfg.num_hidden_layers
    want_k1 = {"model_qa": 2, "run_inference": 1, "model_multimodal_loss": 2,
               "retrieval": 8}  # prefills or forwards of 32 layers
    for entry, calls in want_k1.items():
        if out[entry]["launches"]["flash_attention_fwd"] < calls * n_layers:
            raise AssertionError(f"{entry}: launches "
                                 f"{out[entry]['launches']}")
    for entry in ("model_qa", "run_inference"):
        if out[entry]["launches"]["flash_decode"] == 0:
            raise AssertionError(f"{entry}: K2 never launched")
    loss = out["model_multimodal_loss"]["result"]
    metrics = out["retrieval"]["result"]
    if not (loss > 0 and loss == loss) or not out["run_inference"]["result"]:
        raise AssertionError(f"loss {loss}, answer "
                             f"{out['run_inference']['result']!r}")
    if set(metrics) != {"R@1", "R@5", "R@10", "MedR"}:
        raise AssertionError(f"metrics {metrics}")

    # one loss batch (the audio and point rows) on both attention paths
    conversation_lib.default_conversation = \
        conversation_lib.conv_templates["plain"]
    procs = model.modal_processors()
    dataset = ChunkedMultimodalDataset(files["loss"], tokenizer, None, procs)
    batch = DataCollatorForSupervisedDataset(
        tokenizer, procs, {"vision": {"image_aspect_ratio": "pad"}})(
        [dataset[0], dataset[1]])
    conversation_lib.default_conversation = template
    with torch.no_grad():
        kernel, plain = (model.loss(batch["input_ids"], batch["labels"],
                                    batch["modal_inputs"], attn_impl=impl)
                         .item() for impl in ("auto", "reference"))
    rel = abs(kernel - plain) / abs(plain)
    log("entries", loss_kernel=f"{kernel:.6f}", loss_plain=f"{plain:.6f}",
        rel_err=f"{rel:.3g}", tol=ENTRY_LOSS_TOL)
    if not rel <= ENTRY_LOSS_TOL:
        raise AssertionError(f"kernel path's loss {kernel} differs from the "
                             f"plain path's {plain} by {rel:.3g}")
    launches = {k: sum(e["launches"][k] for e in out.values())
                for k in ("flash_attention_fwd", "flash_decode")}
    checks = _entry_kernel_checks(device, gen, kernel_inputs, "entries")
    return {"entries": out, "loss_kernel_vs_plain": rel,
            "launches": launches, "kernel_checks": checks}


# Phase 13: the LLaVA-suite VQA entries on image files, and the checkpoint
# lifecycle tools.  PNGs are written here with zlib + struct (the card's
# machine has no PIL): each row filtered in turn with the five PNG filters.
PNG_FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth


def write_png(path, pixels, *, palette=None, depth=8,
              filters=PNG_FILTERS):
    """Write uint8 ``pixels`` as a non-interlaced PNG: [H, W] grey (or
    palette indices with ``palette`` [N, 3]), [H, W, 2] grey + alpha,
    [H, W, 3] RGB or [H, W, 4] RGBA; grey and palette images may be packed
    at ``depth`` 1, 2 or 4 bits.  Row y is filtered with
    ``filters[y % len(filters)]``."""
    import struct
    import zlib

    import numpy as np
    pixels = np.asarray(pixels, np.uint8)
    height, width = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = pixels.reshape(height, width * channels)
    if depth < 8:
        per_byte = 8 // depth
        padded = np.zeros((height, -(-width // per_byte) * per_byte),
                          np.uint8)
        padded[:, :width] = rows
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = (padded.reshape(height, -1, per_byte) << shifts).sum(
            -1).astype(np.uint8)
    bpp = max(1, channels * depth // 8)
    cur = rows.astype(np.int16)
    up = np.vstack([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.hstack([np.zeros_like(cur[:, :bpp]), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    kinds = np.asarray([filters[y % len(filters)] for y in range(height)])
    body = np.empty((height, rows.shape[1] + 1), np.uint8)
    body[:, 0] = kinds
    for kind in set(kinds.tolist()):
        sel = kinds == kind
        pred = preds[kind][sel] if kind else 0
        body[sel, 1:] = (cur[sel] - pred) & 0xFF

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
    data += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return path


# (a) the images: what the four entries read, in the layouts the port's
# decoder takes (pixel shape, palette colours or 0), photo-like (gradients
# plus noise) so the filters carry real residuals.
VQA_IMAGES = {"rgb.png": ((480, 640, 3), 0), "rgba.png": ((500, 333, 4), 0),
              "palette.png": ((300, 200), 256), "grey.png": ((240, 320), 0)}
MMBENCH_KEYS = ["question_id", "round_id", "prompt", "text", "options",
                "option_char", "answer_id", "model_id", "metadata"]
PEFT_TARGETS = ("self_attn.q_proj", "self_attn.v_proj")  # peft's default
DENSE_ATOL = 1e-6  # fp32 sums of |W| ~ 0.1: error ~1e-8
LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
           "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
           "mlp.down_proj")


def _photo(rng, shape):
    import numpy as np
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = xx * 255 // max(w - 1, 1) + yy * 128 // max(h - 1, 1)
    channels = shape[2] if len(shape) == 3 else 1
    out = (base[:, :, None] * np.arange(1, channels + 1)
           + rng.integers(0, 24, (h, w, channels))) % 256
    return out.astype(np.uint8).reshape(shape)


def _vqa_images(root, rng, processor):
    """(a): each of VQA_IMAGES written by ``write_png``, read back by
    ``image_io.load_image`` and held to the written pixels exactly; the
    host ms of ``load_image`` + ``process_images`` (pad, then the model's
    CLIP processor: 336 px) per image, the median of 3."""
    import numpy as np
    from modelcompose_tpu_torch.data.image_io import load_image
    from modelcompose_tpu_torch.data.image_processing import process_images
    folder = os.path.join(root, "vqa_images")
    os.makedirs(folder)
    host_ms = {}
    for name, (shape, colours) in VQA_IMAGES.items():
        path = os.path.join(folder, name)
        palette = None
        if colours:
            palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
            pixels = (_photo(rng, shape).astype(np.int64) * colours
                      // 256).astype(np.uint8)
            want = palette[pixels]
        else:
            pixels = _photo(rng, shape)
            want = (np.repeat(pixels[:, :, None], 3, 2) if pixels.ndim == 2
                    else pixels[:, :, :3])
        write_png(path, pixels, palette=palette)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = load_image(path)
            batch = process_images([img], processor, image_aspect_ratio="pad")
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(img, want):
            raise AssertionError(f"{name}: load_image gives other pixels "
                                 f"than were written")
        side = processor.size
        if batch.shape != (1, side, side, 3) or not np.isfinite(batch).all():
            raise AssertionError(f"{name}: processed to {batch.shape}")
        host_ms[name] = sorted(times)[1]
    log("legacy_eval", images=json.dumps({n: list(s) for n, (s, _) in
                                          VQA_IMAGES.items()}),
        host_ms_per_image=json.dumps({n: round(t, 2)
                                      for n, t in host_ms.items()}))
    return folder, host_ms


def _vqa_files(root, folder):
    """(b): the four entries' question files over (a)'s PNGs."""
    import base64
    paths = {"model_vqa": os.path.join(root, "vqa.jsonl"),
             "model_vqa_loader": os.path.join(root, "vqa_loader.jsonl"),
             "model_vqa_science": os.path.join(root, "sqa.json"),
             "model_vqa_mmbench": os.path.join(root, "mmbench.tsv")}
    with open(paths["model_vqa"], "w") as f:
        for row in ({"question_id": 0, "image": "rgb.png",
                     "text": "Is there a red car in the image?"},
                    {"question_id": 1, "image": "palette.png",
                     "text": "<image>\nWhat is written on the sign?"},
                    {"question_id": 2, "text": "Is the sky blue at noon?"}):
            f.write(json.dumps(row) + "\n")
    with open(paths["model_vqa_loader"], "w") as f:
        for row in ({"question_id": "l0", "image": "rgba.png",
                     "text": "Describe the picture briefly."},
                    {"question_id": "l1", "image": ["grey.png", "rgb.png"],
                     "text": "Which of the two images is brighter?"}):
            f.write(json.dumps(row) + "\n")
    with open(paths["model_vqa_science"], "w") as f:
        json.dump([
            {"id": "s0", "image": "grey.png", "conversations": [
                {"from": "human", "value": "<image>\nWhich force moves the "
                 "ball?\nA. gravity\nB. magnetism"}]},
            {"id": "s1", "conversations": [
                {"from": "human", "value": "Which is a mammal?\nA. shark\n"
                 "B. whale"}]}], f)

    def b64(name):
        with open(os.path.join(folder, name), "rb") as fh:
            return base64.b64encode(fh.read()).decode()
    with open(paths["model_vqa_mmbench"], "w") as f:
        f.write("index\tquestion\thint\tA\tB\tC\tD\timage\tcategory\n")
        f.write(f"101\tWhat color dominates?\tLook at the top left.\tred\t"
                f"green\tblue\tgray\t{b64('rgb.png')}\tcolor\n")
        f.write(f"102\tHow many objects are there?\tnan\tone\ttwo\tthree\t"
                f"four\t{b64('palette.png')}\tcount\n")
    return paths


class _GenerateLog:
    """While active, runs every ``model.generate`` call with ``attn_impl``
    ('reference' replaces K1 and K2 by their plain versions) and records
    its prompt, media and answer."""

    def __init__(self, model, attn_impl="auto"):
        self.model, self.attn_impl = model, attn_impl

    def __enter__(self):
        self.calls = []
        generate = type(self.model).generate

        def logged(input_ids, modal_inputs, **kw):
            out = generate(self.model, input_ids, modal_inputs,
                           attn_impl=self.attn_impl, **kw)
            self.calls.append((input_ids, modal_inputs, out))
            return out
        self.model.generate = logged
        return self

    def __exit__(self, *exc):
        del self.model.generate


def _kernel_vs_plain(model, kernel_calls, plain_calls):
    """Each greedy answer of the kernel path against the plain path's on
    the same prompt: equal, or leaving it at a near tie: the teacher-forced
    logits of both paths at the first differing step within LOGIT_TOL of
    max |logit|, and the plain path's top-2 gap there under LOGIT_TOL."""
    import torch
    if len(kernel_calls) != len(plain_calls):
        raise AssertionError(f"{len(kernel_calls)} kernel-path calls, "
                             f"{len(plain_calls)} plain-path calls")
    eos = model.cfg.eos_token_id
    out = []
    for (ids, inputs, got), (_, _, want) in zip(kernel_calls, plain_calls):
        got, want = got[0], want[0]
        if got == want:
            out.append({"equal": True, "tokens": len(got)})
            continue
        step = next(i for i, (a, b) in enumerate(zip(got + [None],
                                                     want + [None]))
                    if a != b)
        tokens = torch.tensor([(got + [eos])[:step + 1]],
                              device=model.device)
        with torch.no_grad():
            k, p = (_teacher_forced(model, ids, inputs, tokens, impl,
                                    kv_quant=False)[0, step]
                    for impl in ("auto", "reference"))
        scale = p.abs().max()
        rel = ((k - p).abs().max() / scale).item()
        top2 = p.topk(2).values
        gap = ((top2[0] - top2[1]) / scale).item()
        log("legacy_eval", diverge_step=step, kernel_len=len(got),
            plain_len=len(want), logit_rel_err=f"{rel:.3g}",
            plain_top2_gap_rel=f"{gap:.4g}", tol=LOGIT_TOL)
        if rel > LOGIT_TOL or gap > LOGIT_TOL:
            raise AssertionError(f"kernel-path answer leaves the plain "
                                 f"path's at step {step}: logits {rel:.3g}"
                                 f", top-2 gap {gap:.3g} of max |logit|")
        out.append({"equal": False, "diverge_step": step, "rel": rel,
                    "top2_gap_rel": gap})
    return out


def _vqa_runs(root, folder, name):
    """(b)'s runs: entry -> (module, question file, flags)."""
    from modelcompose_tpu_torch.eval import (model_vqa, model_vqa_loader,
                                             model_vqa_mmbench,
                                             model_vqa_science)
    files = _vqa_files(root, folder)
    common = ["--model-path", name, "--temperature", "0",
              "--max-new-tokens", str(QA_TOKENS)]
    images = ["--image-folder", folder]
    return {
        "model_vqa": (model_vqa, files["model_vqa"], common + images),
        "model_vqa_loader": (model_vqa_loader, files["model_vqa_loader"],
                             common + images + ["--num-workers", "2"]),
        "model_vqa_science": (model_vqa_science, files["model_vqa_science"],
                              common + images + ["--answer-prompter",
                                                 "--single-pred-prompt"]),
        "model_vqa_mmbench": (model_vqa_mmbench, files["model_vqa_mmbench"],
                              common + ["--all-rounds",
                                        "--single-pred-prompt"])}


def _answer_lines(path, entry):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    keys = MMBENCH_KEYS if entry == "model_vqa_mmbench" else QA_KEYS
    if not lines or any(list(line) != keys for line in lines):
        raise AssertionError(f"{entry}: answer lines {lines[:2]}")
    if any(not line["text"] for line in lines):
        raise AssertionError(f"{entry}: an empty answer in {lines}")
    return lines


class _CaptureLoad:
    """While active, ``models.loader.load_pretrained_model`` (what the
    entries call) also keeps the model it returned and its load seconds."""

    def __enter__(self):
        from modelcompose_tpu_torch.models import loader
        self.module, self.load = loader, loader.load_pretrained_model
        self.models, self.seconds = [], []

        def load(*args, **kw):
            t0 = time.perf_counter()
            with warnings.catch_warnings():  # random towers
                warnings.simplefilter("ignore")
                out = self.load(*args, **kw)
            self.seconds.append(time.perf_counter() - t0)
            self.models.append(out[1])
            return out
        loader.load_pretrained_model = load
        return self

    def __exit__(self, *exc):
        self.module.load_pretrained_model = self.load


def _bf16(a):
    """``a`` (fp32) rounded to bf16, as the loader stores it."""
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _llava_checkpoint(root, gen, device):
    """(c) 1: a LLaVA-LoRA vision checkpoint at Vicuna-7B width and
    LOADER_LAYERS depth, as LLaVA saves one: peft's one adapter
    ``default`` (r=128) under ``base_model.model.``, the ``mlp2x_gelu``
    ``mm_projector``, bare soft tokens and one base weight the converter
    drops, bf16, with config.json.  Returns its directory and the DAMC-
    layout tensors the conversion must give back."""
    import torch
    from modelcompose_tpu_torch.compose.convert import params_to_adapter
    from modelcompose_tpu_torch.configs import damc_unimodal
    from modelcompose_tpu_torch.core.llama import init_params, torch_dtype
    from modelcompose_tpu_torch.models.projectors import init_projector
    cfg = damc_unimodal("vision", num_hidden_layers=LOADER_LAYERS,
                        lora_strategy="modal")
    with torch.no_grad():
        params = init_params(cfg, gen, device)
        _perturb(params, gen)
        proj = init_projector(cfg.projector_type("vision"), gen,
                              cfg.projector_input_size("vision"),
                              cfg.hidden_size, dtype=torch_dtype(cfg.dtype),
                              device=device)
        damc = {k: v for k, v in params_to_adapter(
            params, cfg, {"vision": proj}).items()
            if ".lora_A.default." not in k and ".lora_B.default." not in k}
    del params, proj
    state = {}
    for k, v in damc.items():
        k = (k.replace(".vision.weight", ".default.weight")
             .replace("modal_projectors.vision", "mm_projector")
             .replace("prefix_tokens.vision", "prefix_tokens")
             .replace("suffix_tokens.vision", "suffix_tokens"))
        state["base_model.model." + k] = torch.from_numpy(v).to(
            torch.bfloat16)
    state["base_model.model.model.norm.weight"] = torch.ones(
        cfg.hidden_size, dtype=torch.bfloat16)
    path = os.path.join(root, "llava-v1.5-7b-lora")
    os.makedirs(path)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    cfg.save(os.path.join(path, "config.json"))
    return path, damc


def _dense_reference(merged, base_dir):
    """(c) 4: the merge-lora export computed in numpy from the files: per
    layer and linear, bf16(W + sum_a c_a B_a @ A_a) with W, A and B as the
    loader holds them (bf16) and c the default route's row."""
    import numpy as np
    from modelcompose_tpu_torch.compose.state_io import load_adapter_dir
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.models.loader import load_hf_llama_dir
    with open(os.path.join(merged, "config.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    base = load_hf_llama_dir(base_dir)
    adapter = load_adapter_dir(merged)
    row = cfg.routing_table()[0]
    want = {}
    for i in range(cfg.num_hidden_layers):
        for lin in LINEARS:
            key = f"model.layers.{i}.{lin}"
            acc = base[f"{key}.weight"].astype(np.float32)
            for c, name in zip(row, cfg.adapter_names()):
                if c:
                    acc = acc + np.float32(c) * (
                        _bf16(adapter[f"{key}.lora_B.{name}.weight"])
                        @ _bf16(adapter[f"{key}.lora_A.{name}.weight"]))
            want[f"{key}.weight"] = _bf16(acc)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            key = f"model.layers.{i}.{norm}.weight"
            want[key] = base[key]
    for key in ("model.embed_tokens.weight", "model.norm.weight",
                "lm_head.weight"):
        want[key] = base[key]
    return want


def _peft_checkpoint(root, name, modal, rng, hidden):
    """(c) 5: a peft-era unimodal LoRA checkpoint at the base's width
    ``hidden``: r=128 A/B on PEFT_TARGETS of LOADER_LAYERS layers (bf16),
    an ``mm_projector`` and soft tokens, adapter_config.json and a config
    stamp."""
    import numpy as np
    import torch
    path = os.path.join(root, name)
    os.makedirs(path)
    state = {}
    for i in range(LOADER_LAYERS):
        for lin in PEFT_TARGETS:
            stem = f"base_model.model.model.layers.{i}.{lin}"
            state[f"{stem}.lora_A.weight"] = rng.normal(
                0, 0.01, (128, hidden)).astype(np.float32)
            state[f"{stem}.lora_B.weight"] = rng.normal(
                0, 0.01, (hidden, 128)).astype(np.float32)
    state = {k: _bf16(v) for k, v in state.items()}
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in state.items()},
               os.path.join(path, "adapter_model.bin"))
    width = {"vision": 1024, "audio": 768}[modal]
    extra = {"base_model.model.model.mm_projector.0.weight":
             rng.normal(0, 0.02, (hidden, width)).astype(np.float32),
             "base_model.model.model.mm_projector.0.bias":
             rng.normal(0, 0.02, (hidden,)).astype(np.float32),
             "base_model.model.prefix_tokens":
             rng.normal(0, 0.02, (1, 5, hidden)).astype(np.float32)}
    torch.save({k: torch.from_numpy(v) for k, v in extra.items()},
               os.path.join(path, "non_lora_trainables.bin"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"lora_alpha": 256, "r": 128}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({f"mm_{modal}_encoder": f"{modal}-tower",
                   f"mm_{modal}_hidden_size": width}, f)
    return path, state, extra


def _checkpoint_tools(device, gen, root, merged, base_dir, folder,
                      tokenizer, counters):
    """(c): the LLaVA conversion, merge-lora, merge_deltas_to_base and
    compare at Vicuna-7B width and LOADER_LAYERS depth, each written tensor
    held to numpy; the converted checkpoint and the dense export each
    loaded by an entry onto the card and asked one PNG question."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.compose import (compare, lifecycle,
                                                merge_deltas_to_base)
    from modelcompose_tpu_torch.compose.convert import params_to_adapter
    from modelcompose_tpu_torch.compose.convert_llava_checkpoint import \
        convert_checkpoint
    from modelcompose_tpu_torch.compose.state_io import load_state
    from modelcompose_tpu_torch.eval import model_vqa, model_vqa_loader
    from modelcompose_tpu_torch.models.loader import load_hf_llama_dir
    reset, read = counters
    out = {"bytes": {}, "seconds": {}, "launches": {}}
    question = os.path.join(root, "one_png.jsonl")
    with open(question, "w") as f:
        f.write(json.dumps({"question_id": "c0", "image": "rgb.png",
                            "text": "What is in the image?"}) + "\n")

    def ask(entry, mod, model_path, model_base, extra=()):
        """One PNG question through ``mod``'s own load (main()-style
        args): the loaded model; its answer, launches and seconds go into
        ``out`` under ``entry``."""
        answers = os.path.join(root, f"{entry}-answers.jsonl")
        args = mod.build_arg_parser().parse_args([
            "--model-path", model_path, "--model-base", model_base,
            "--question-file", question, "--image-folder", folder,
            "--answers-file", answers, "--temperature", "0",
            "--max-new-tokens", str(QA_TOKENS)] + list(extra))
        reset()
        t0 = time.perf_counter()
        with _CaptureLoad() as cap:
            mod.eval_model(args, load_tokenizer_fn=lambda _: tokenizer,
                           device=device)
        out["seconds"][f"{entry}_answer"] = (time.perf_counter() - t0
                                             - sum(cap.seconds))
        out["seconds"][f"{entry}_load"] = sum(cap.seconds)
        out["launches"][entry] = read()
        lines = _answer_lines(answers, mod.__name__.rsplit(".", 1)[1])
        model = cap.models[0]
        n_layers = model.cfg.num_hidden_layers
        if out["launches"][entry]["flash_attention_fwd"] < n_layers \
                or out["launches"][entry]["flash_decode"] == 0:
            raise AssertionError(f"{entry}: launches "
                                 f"{out['launches'][entry]}")
        log("legacy_eval", tool=entry, answer=lines[0]["text"],
            launches=json.dumps(out["launches"][entry]))
        return model

    # 1-3: LLaVA checkpoint -> converted -> loaded, asked
    t0 = time.perf_counter()
    llava, damc = _llava_checkpoint(root, gen, device)
    converted = os.path.join(root, "llava-vision-multimodal")
    stats = convert_checkpoint(llava, converted)
    out["seconds"]["convert"] = time.perf_counter() - t0
    out["bytes"]["llava"] = _dir_bytes(llava)
    out["bytes"]["converted"] = _dir_bytes(converted)
    got = {}
    for fname in ("adapter_model.bin", "non_lora_trainables.bin"):
        got.update({k[len("base_model.model."):]: v for k, v in load_state(
            os.path.join(converted, fname)).items()})
    bad = sorted(set(got) ^ set(damc)) + [
        k for k in damc if k in got and not np.array_equal(got[k], damc[k])]
    if bad or stats["adapter_keys"] + stats["non_lora_keys"] != len(damc):
        raise AssertionError(f"converted keys differ: {bad[:3]} {stats}")
    model = ask("converted", model_vqa_loader, converted,
                base_dir, ["--num-workers", "2"])
    loaded = params_to_adapter(model.params, model.cfg, model.projectors)
    bad = [k for k in damc if not np.array_equal(loaded[k], damc[k])]
    if bad:
        raise AssertionError(f"the converted checkpoint loads other "
                             f"leaves: {bad[:3]}")
    del model, loaded
    gc.collect()
    torch.cuda.empty_cache()

    # 4: merge-lora on phase 7's composition, the dense export asked
    dense = os.path.join(root, "mcub4-dense-multimodal")
    t0 = time.perf_counter()
    with warnings.catch_warnings():  # random towers
        warnings.simplefilter("ignore")
        lifecycle.main(["merge-lora", "--model-path", merged, "--model-base",
                        base_dir, "--save-model-path", dense])
    out["seconds"]["merge_lora"] = time.perf_counter() - t0
    out["bytes"]["dense"] = _dir_bytes(dense)
    lifecycle.main(["extract-projector", "--model-path",
                    os.path.join(merged, "adapter_model.bin"), "--output",
                    os.path.join(dense, "mm_projector.bin")])
    got = load_state(os.path.join(dense, "model.safetensors"))
    want = _dense_reference(merged, base_dir)
    if sorted(got) != sorted(want):
        raise AssertionError(f"dense keys {sorted(set(got) ^ set(want))[:3]}")
    # one bf16 rounding of an fp32 sum taken in another order: a value on
    # a rounding boundary may land one bf16 step (up to 2^-7 of it) away;
    # DENSE_ATOL covers the fp32 sums' own error where W + delta nearly
    # cancels
    excess = max(float((np.abs(got[k] - want[k]) - 2 ** -7 * np.abs(
        want[k]) - DENSE_ATOL).max()) for k in want)
    max_abs = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    log("legacy_eval", merge_lora_tensors=len(want),
        max_abs_err_vs_numpy=f"{max_abs:.3g}",
        tol=f"2^-7 |x| + {DENSE_ATOL}")
    if excess > 0:
        raise AssertionError(f"dense export off numpy's fold by {max_abs}")
    del got, want
    ask("dense", model_vqa, dense, dense)
    gc.collect()
    torch.cuda.empty_cache()

    # 5: merge_deltas_to_base over two peft checkpoints
    rng = np.random.default_rng(SEED + 13)
    base = load_hf_llama_dir(base_dir)
    vocab, hidden = base["model.embed_tokens.weight"].shape
    peft = {m: _peft_checkpoint(root, f"llava-{m}-lora", m, rng, hidden)
            for m in ("vision", "audio")}
    with open(os.path.join(base_dir, "config.json"), "w") as f:
        json.dump({"hidden_size": hidden, "vocab_size": vocab,
                   "num_hidden_layers": LOADER_LAYERS}, f)
    naive = os.path.join(root, "naive-merge")
    t0 = time.perf_counter()
    stats = merge_deltas_to_base.merge_deltas_to_base(
        base_dir, {m: p for m, (p, _, _) in peft.items()}, naive, "avg")
    out["seconds"]["merge_deltas_to_base"] = time.perf_counter() - t0
    out["bytes"]["naive_merge"] = _dir_bytes(naive)
    got = load_hf_llama_dir(naive)
    want = dict(base)
    for i in range(LOADER_LAYERS):
        for lin in PEFT_TARGETS:
            stem = f"base_model.model.model.layers.{i}.{lin}"
            deltas = [(st[f"{stem}.lora_B.weight"]
                       @ st[f"{stem}.lora_A.weight"]) * 2.0
                      for _, st, _ in peft.values()]
            key = f"model.layers.{i}.{lin}.weight"
            want[key] = base[key] + np.mean(deltas, axis=0)
    for modal, (_, _, extra) in peft.items():
        for k, v in extra.items():
            k = k[len("base_model.model."):].replace(
                "mm_projector", f"modal_projectors.{modal}")
            want[k] = v
    bad = sorted(set(got) ^ set(want)) + [
        k for k in want if k in got and not np.array_equal(got[k], want[k])]
    if bad or stats != {"merged_keys": LOADER_LAYERS * len(PEFT_TARGETS),
                        "overlay_keys": 5}:
        raise AssertionError(f"naive merge differs: {bad[:3]} {stats}")
    del got, base, want

    # 6: compare phase 7's vision and audio checkpoints
    t0 = time.perf_counter()
    metrics = compare.compare_checkpoints(os.path.join(root, "ckpt-vision"),
                                          os.path.join(root, "ckpt-audio"))
    out["seconds"]["compare"] = time.perf_counter() - t0
    if set(metrics) != {"L2", "Cosine", "SSD"} or not (
            metrics["L2"] > 0 and 0 <= metrics["Cosine"] <= 2
            and 0 <= metrics["SSD"] <= 1):
        raise AssertionError(f"compare: {metrics}")
    out["compare"] = metrics
    log("legacy_eval", tools_seconds=json.dumps(
        {k: round(v, 2) for k, v in out["seconds"].items()}),
        bytes_gb=json.dumps({k: round(_gb(v), 3)
                             for k, v in out["bytes"].items()}),
        compare=json.dumps(metrics))
    return out


def _k1_k2_checks(device, gen, inputs, phase):
    """K1 and K2 against their plain versions, untimed, at the inputs the
    path ``phase`` ran them at (``inputs``, a ``_KernelInputs``): random
    bf16 q/k/v with each K1 shape's recorded segment ids, random caches of
    each K2 shape with its recorded kv_len, read at the last layer.
    Returns the largest error per kernel."""
    import torch
    from modelcompose_tpu_torch.core.llama import quantize_kv
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    errs = {"fwd": [], "decode": []}
    for (B, L, H, D, S, Hkv), (q_seg, kv_seg) in inputs.attention.items():
        q, k, v = rnd(B, L, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                  q_offset=S - L)
        out, lse = flash_attention_forward(q, k, v, **kw)
        errs["fwd"].append(_check_k1(f"{phase} B{B} L{L} S{S}", q, k, v, kw,
                                     out, lse)[0])
    for (NL, B, S, Hkv, D, H, dtype), kv_len in inputs.decode.items():
        k, v = rnd(NL, B, S, Hkv, D), rnd(NL, B, S, Hkv, D)
        if dtype == str(torch.int8):
            k, v = quantize_kv(k), quantize_kv(v)
        errs["decode"].append(_check_k2(rnd(B, 1, H, D), k, v, kv_len,
                                        NL - 1)[1])
    if not all(errs.values()):
        raise AssertionError(f"{phase}: no kernel inputs recorded for "
                             f"{[n for n, e in errs.items() if not e]}")
    out = {n: max(e) for n, e in errs.items()}
    log(phase, kernel_checks=json.dumps(
        [f"B{k[0]} L{k[1]}" for k in inputs.attention]
        + [f"{k[-1]} B{k[1]} S{k[2]}" for k in inputs.decode]),
        max_abs_err=json.dumps({n: float(f"{e:.4g}") for n, e in
                                out.items()}))
    return out


def phase_legacy_eval(device, gen, root, merged, base_dir, model):
    """Phase 13: (a) PNGs written and read back without PIL; (b) the four
    LLaVA-suite entries (``model_vqa``, ``model_vqa_loader``,
    ``model_vqa_science`` with ``--answer-prompter --single-pred-prompt``,
    ``model_vqa_mmbench`` with ``--all-rounds``) answering them greedily on
    phase 6's MCUB-4 model (``loaded=``), each answer line with the JAX
    entry's keys, then the same runs on the plain path (K1 and K2 replaced
    by their plain versions) with every answer held to the kernel path's;
    (c) the checkpoint tools on phase 7's files; K1 and K2 held to their
    plain versions at every shape (b) and (c) ran them at."""
    import numpy as np
    from modelcompose_tpu_torch.data import conversation as conversation_lib
    if not _on_card(model.params["embed_tokens"]):
        raise AssertionError(f"the model is on {model.device}")
    tokenizer = WordHashTokenizer()
    loaded = (tokenizer, model, model.modal_processors(), 2048)
    template = conversation_lib.default_conversation
    reset, read = _attention_counters()
    folder, host_ms = _vqa_images(root, np.random.default_rng(SEED),
                                  loaded[2]["vision"])
    runs = _vqa_runs(root, folder, os.path.join(root, "mcub4-damc-multimodal"))
    entries = {}
    with _KernelInputs() as kernel_inputs:
        for entry, (mod, qfile, flags) in runs.items():
            res = entries[entry] = {}
            for path, impl in (("kernel", "auto"), ("plain", "reference")):
                answers = os.path.join(root, f"{entry}-{path}.jsonl")
                args = mod.build_arg_parser().parse_args(
                    flags + ["--question-file", qfile, "--answers-file",
                             answers])
                reset()
                before = _all_graph_counts()
                t0 = time.perf_counter()
                with _GenerateLog(model, impl) as calls:
                    mod.eval_model(args, loaded=loaded)
                res[f"{path}_s"] = time.perf_counter() - t0
                res[f"{path}_graphs"] = _graph_delta(before)
                res[f"{path}_calls"] = calls.calls
                res[f"{path}_launches"] = read()
                res[f"{path}_lines"] = _answer_lines(answers, entry)
            if res["plain_launches"] != {"flash_attention_fwd": 0,
                                         "flash_decode": 0}:
                raise AssertionError(f"{entry}: the plain path launched "
                                     f"{res['plain_launches']}")
            res["vs_plain"] = _kernel_vs_plain(model, res["kernel_calls"],
                                               res["plain_calls"])
            n = len(res["kernel_calls"])
            steps = sum(max(len(out[0]) - 1, 0)
                        for _, _, out in res["kernel_calls"])
            launches = res["kernel_launches"]
            n_layers = model.cfg.num_hidden_layers
            if launches["flash_attention_fwd"] < n * n_layers \
                    or launches["flash_decode"] < steps * n_layers:
                raise AssertionError(f"{entry}: {n} answers, launches "
                                     f"{launches}")
            log("legacy_eval", entry=entry, answers=n,
                kernel_s=f"{res['kernel_s']:.3f}",
                plain_s=f"{res['plain_s']:.3f}",
                graphs=json.dumps(res["kernel_graphs"]),
                launches=json.dumps(launches),
                equal_to_plain=sum(v["equal"] for v in res["vs_plain"]),
                texts=json.dumps([line["text"] for line in
                                  res["kernel_lines"]][:3]))
        tools = _checkpoint_tools(device, gen, root, merged, base_dir,
                                  folder, tokenizer, (reset, read))
    conversation_lib.default_conversation = template
    prefills = {f"B{k[0]} L{k[1]}": int((seg[0] != 0).sum(1).max())
                for k, seg in kernel_inputs.attention.items()}
    checks = _k1_k2_checks(device, gen, kernel_inputs, "legacy_eval")
    launches = {k: sum(e["kernel_launches"][k] for e in entries.values())
                + sum(v[k] for v in tools["launches"].values())
                for k in ("flash_attention_fwd", "flash_decode")}
    for res in entries.values():  # the recorded calls hold the pixels
        res.pop("kernel_calls"), res.pop("plain_calls")
    return {"images_host_ms": host_ms, "entries": entries, "tools": tools,
            "prefill_positions": prefills, "launches": launches,
            "kernel_checks": checks}


# ---------------------------------------------------------------------------
# Phase 14: the distribution layer at world 1 over NCCL
# ---------------------------------------------------------------------------

DIST_STEPS = 2  # train steps of each run of phase 14's train part
TP_SHARDS = (2, 4)  # the tensor-parallel degrees whose rank shapes K1/K2 run
DIST_TIMEOUT_S = 120  # the process group's timeout on every collective


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _NcclWorld1:
    """A process group of this one process over NCCL (a free local port),
    left on exit."""

    def __enter__(self):
        import datetime
        from modelcompose_tpu_torch.parallel import distributed
        distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                               backend="nccl", timeout=datetime.timedelta(
                                   seconds=DIST_TIMEOUT_S))
        return self

    def __exit__(self, *exc):
        from modelcompose_tpu_torch.parallel import distributed
        distributed.shutdown()
        return False


def _tp_shard_cases(device, gen):
    """K1 and K2 at a tensor-parallel rank's shapes on the MCUB-4 path:
    32 / tp heads at the 3,328 bucket and over the int8 3,360 cache, each
    against its plain version, timed by CUDA graph replay (SDPA beside
    K1), with its bound."""
    k1, k2 = [], []
    for tp_size in TP_SHARDS:
        heads = 32 // tp_size
        case = _k1_case(device, gen, library=True, timer=graph_time_ms,
                        **dict(MCUB4_K1, H=heads, Hkv=heads))
        k1.append(dict(case, tp=tp_size, heads=heads,
                       shape=f"B1 Lq=S=3328 (3287 valid) H={heads}"))
        case = _k2_case(device, gen, B=1, NL=32, S=3328 + NEW_TOKENS,
                        H=heads, Hkv=heads, D=128, kv_len=[MCUB4_POSITIONS],
                        quantized=True, layer=31, graph=True)
        # the row's time is the graph replay's; events keep their key
        case = dict(case, ms=case["graph_ms"], events_ms=case["ms"],
                    share_of_bound=None if case["graph_ms"] is None
                    else case["bound_ms"] / case["graph_ms"])
        k2.append(dict(case, tp=tp_size, heads=heads,
                       shape=f"B1 int8 S=3360 kv_len 3287 H={heads}"))
    return k1, k2


def phase_distributed_serve(device, gen, model, request):
    """Phase 14a: phase 6's MCUB-4 model sharded at tp 1 through the
    loader's tensor-parallel step (``apply_tensor_parallel``) in an NCCL
    process group of one: its greedy ids equal the no-group run's bit for
    bit, K1 and K2 counted on that path; then K1 and K2 at the tp 2 and 4
    ranks' shapes."""
    import torch
    from modelcompose_tpu_torch.parallel import tp
    from modelcompose_tpu_torch.parallel.mesh import apply_tensor_parallel
    reset, read = _attention_counters()
    ids, inputs = request
    kw = dict(kv_quant=True, compact_adapters=True)
    steps = NEW_TOKENS - 1
    plain_t = {}
    # collectives are not captured: both sides decode eagerly, so this
    # compares the collectives' host cost, eager against eager
    kw["device_loop"] = False
    with torch.no_grad():
        want = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                              timings=plain_t, **kw)
    params = model.params
    with _NcclWorld1():
        mesh = apply_tensor_parallel(model, 1)
        if model.tp_group is None or tp.model_size(model.tp_group) != 1:
            raise AssertionError("no model group of one after the TP step")
        model._compact_cache.clear()  # compaction reruns on the shard
        got_t = {}
        with torch.no_grad():
            model.generate(ids, inputs, max_new_tokens=2, **kw)  # warm-up
            reset()
            got = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                                 timings=got_t, **kw)
        launches = read()
    model.params, model.tp_group, model._serving = params, None, None
    model._compact_cache.clear()
    log("distributed", path="mcub4_tp1", mesh=json.dumps(mesh.shape),
        ids_equal=got == want, no_group_decode_tok_per_s=(
            f"{steps / plain_t['decode_s']:.2f}"),
        tp1_decode_tok_per_s=f"{steps / got_t['decode_s']:.2f}",
        no_group_prefill_s=f"{plain_t['prefill_s']:.4f}",
        tp1_prefill_s=f"{got_t['prefill_s']:.4f}",
        launches=json.dumps(launches))
    if got != want:
        raise AssertionError(f"greedy ids through the tp 1 group {got} != "
                             f"the no-group run's {want}")
    n_layers = model.cfg.num_hidden_layers
    if launches["flash_attention_fwd"] < n_layers \
            or launches["flash_decode"] < n_layers * steps:
        raise AssertionError(f"K1/K2 launches on the tp 1 path {launches}")
    k1, k2 = _tp_shard_cases(device, gen)
    return {"launches": launches, "k1_tp_shards": k1, "k2_tp_shards": k2,
            "decode_tok_per_s": {"no_group": steps / plain_t["decode_s"],
                                 "tp1": steps / got_t["decode_s"]},
            "prefill_s": {"no_group": plain_t["prefill_s"],
                          "tp1": got_t["prefill_s"]}}


def phase_distributed_train(device):
    """Phase 14b: phase 9's stage-2 train step at Vicuna-7B width, two
    steps with no process group, then the same two steps from the same
    state through the data-parallel path (``mesh_for_batch``, the
    valid-target count, gradients and loss all-reduced over the data
    group) in an NCCL group of one: losses and every trainable leaf
    bit-equal.  At one rank no leaf has a ZeRO-1 axis (``zero_axis`` needs
    a data width above 1), so the moment slicing and its all-gather do not
    run here, nor any tensor-parallel collective or leader broadcast: the
    CPU gloo tests cover those."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.parallel.mesh import mesh_for_batch
    from modelcompose_tpu_torch.train.train_multimodal import (
        build_arg_parser, build_model, build_model_config, make_batch)
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_optimizer, make_train_step,
        tree_leaves)
    counters = {"flash_attention_fwd": flash_attention_forward,
                "flash_attention_bwd_dq": flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv}
    args = build_arg_parser().parse_args([
        "--model_name_or_path", "vicuna-7b-v1.5", "--data_path", "-",
        "--output_dir", "-", "--random_init_backbone", "--seed", str(SEED),
        "--mm_vision_encoder", "clip-vit-large-patch14-336",
        "--mm_projector_type", "mlp2x_gelu", "--mm_vision_select_layer", "-2",
        "--lora_strategy", "modal+language", "--lora_r", "128",
        "--lora_alpha", "256", "--local_prefix_tokens", "5",
        "--local_suffix_tokens", "5", "--gradient_checkpointing", "True"])
    cfg = build_model_config(args)
    with warnings.catch_warnings():  # random tower weights are the point
        warnings.simplefilter("ignore")
        model = build_model(args, cfg, device)
    collated = _train_samples(cfg, np.random.default_rng(SEED))
    batch, layout = make_batch(model, collated)
    tc = TrainConfig(learning_rate=2e-4, mm_projector_lr=2e-5,
                     mm_language_lr=1e-5, warmup_ratio=0.0)
    tree = {"backbone": model.params, "projectors": model.projectors}

    def run(mesh):
        tx, _ = make_optimizer(cfg, tc, tree, mesh)
        state = init_train_state(cfg, tc, model.params, model.projectors,
                                 tx=tx)
        step = make_train_step(cfg, tc, tx)
        for fn in counters.values():
            fn.launches = 0
        losses, seconds = [], []
        for _ in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch, layout)
            losses.append(float(loss))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        trained = {p: t.detach().clone() for p, t in tree_leaves(tree)
                   if tx.trains(p)}
        return losses, seconds, trained, launches

    tx0, _ = make_optimizer(cfg, tc, tree)
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)
             if tx0.trains(p)}

    def restart():  # the same starting state for the next run
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                if p in start:
                    t.copy_(start[p])
    plain = run(None)
    restart()
    with _NcclWorld1():
        mesh = mesh_for_batch(len(collated["input_ids"]), allow_partial=True)
        dp = run(mesh)
    differ = [p for p in plain[2] if not torch.equal(plain[2][p], dp[2][p])]
    if dp[0] != plain[0] or differ:
        # is it the DP path, or does the no-group run itself vary?
        restart()
        again = run(None)
        log("distributed", no_group_rerun_losses=again[0],
            no_group_rerun_leaves_differing=sum(
                not torch.equal(plain[2][p], again[2][p]) for p in plain[2]))
    log("distributed", path="train_dp_world1", mesh=json.dumps(mesh.shape),
        no_group_losses=[f"{x:.6f}" for x in plain[0]],
        dp_losses=[f"{x:.6f}" for x in dp[0]],
        no_group_step_s=[f"{x:.4f}" for x in plain[1]],
        dp_step_s=[f"{x:.4f}" for x in dp[1]],
        trainable_leaves=len(plain[2]), leaves_differing=len(differ),
        launches=json.dumps(dp[3]))
    if dp[0] != plain[0] or differ:
        raise AssertionError(f"the world-1 DP run left the no-group run: "
                             f"losses {dp[0]} vs {plain[0]}, leaves "
                             f"{differ[:3]}")
    n_layers = cfg.num_hidden_layers
    if min(dp[3].values()) < n_layers * DIST_STEPS:
        raise AssertionError(f"K1/K3/K4 launches on the DP path {dp[3]}")
    return {"launches": dp[3], "losses": dp[0],
            "step_s": {"no_group": plain[1], "dp": dp[1]}}


def main() -> int:
    try:
        import torch
        import modelcompose_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from the repository root ({e})")
    t_start = time.perf_counter()
    seconds = {}

    replays = {}  # decode-graph replays per phase
    graphs = {}  # captures and replays of every kind of graph per phase

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        r0 = _graph_counts()[1]
        kinds = _all_graph_counts()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        replays[name] = _graph_counts()[1] - r0
        graphs[name] = _graph_delta(kinds)
        return out
    device = timed("device", phase_device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timed("build", phase_build)
    k1 = timed("k1", phase_k1, device, gen)
    k2 = timed("k2", phase_k2, device, gen)
    launches, main = timed("main", phase_main_path, device, gen)
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
        gc.collect()
        torch.cuda.empty_cache()
        serve = timed("serve", phase_serve, device, gen, mcub4_model,
                      request, root, merged, base_dir)
        # the admissions' caches and prefill graphs go with the serve phase
        mcub4_model.prefill_graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        towers = timed("towers", phase_towers, device)
        eva = timed("eva_imagebind", phase_eva_imagebind, device, gen)
        entries = timed("entries", phase_entries, device, gen, root,
                        mcub4_model)
        gc.collect()
        torch.cuda.empty_cache()
        legacy = timed("legacy_eval", phase_legacy_eval, device, gen, root,
                       merged, base_dir, mcub4_model)
    gc.collect()
    torch.cuda.empty_cache()
    dist_serve = timed("distributed_serve", phase_distributed_serve, device,
                       gen, mcub4_model, request)
    del mcub4_model, request
    gc.collect()
    torch.cuda.empty_cache()
    k34 = timed("k34", phase_k34, device, gen)
    train = timed("train", phase_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    dist_train = timed("distributed_train", phase_distributed_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tmp_entry_", dir=".") as root:
        entry = timed("train_entry", phase_train_entry, device, gen, root)
    log("phase12", towers_ms=json.dumps(
        {k: {b: round(t, 3) for b, t in r["ms"].items()}
         for k, r in towers.items()}),
        card_vs_cpu=json.dumps({k: float(f"{r['card_vs_cpu']:.3g}")
                                for k, r in towers.items()}),
        tf32_card_vs_cpu=json.dumps({
            k: float(f"{r['tf32_card_vs_cpu']:.3g}")
            for k, r in towers.items()}),
        eva_imagebind_prefill_s=f"{eva['prefill_s']:.4f}",
        eva_imagebind_decode_tok_per_s=f"{eva['decode_tok_per_s']:.2f}",
        entries_s=json.dumps({k: round(v["seconds"], 3) for k, v in
                              entries["entries"].items()}))
    log("phase13", entries_s=json.dumps(
        {k: {"kernel": round(v["kernel_s"], 3), "plain": round(v["plain_s"],
                                                               3)}
         for k, v in legacy["entries"].items()}),
        host_ms_per_image=json.dumps({k: round(v, 2) for k, v in
                                      legacy["images_host_ms"].items()}),
        launches=json.dumps(legacy["launches"]),
        prefill_positions=json.dumps(legacy["prefill_positions"]),
        equal_to_plain=json.dumps({k: [v["equal"] for v in e["vs_plain"]]
                                   for k, e in legacy["entries"].items()}),
        checkpoint_gb=json.dumps({k: round(_gb(v), 3) for k, v in
                                  legacy["tools"]["bytes"].items()}),
        checkpoint_s=json.dumps({k: round(v, 2) for k, v in
                                 legacy["tools"]["seconds"].items()}))
    log("phase14", dp_step_s=json.dumps({
        k: [round(x, 4) for x in v]
        for k, v in dist_train["step_s"].items()}),
        decode_tok_per_s=json.dumps({
            k: round(v, 2) for k, v in dist_serve["decode_tok_per_s"].items()}),
        prefill_s=json.dumps({k: round(v, 4) for k, v in
                              dist_serve["prefill_s"].items()}),
        tp_shard_ms=json.dumps({
            f"K{i + 1} tp{c['tp']}": None if c["ms"] is None
            else round(c["ms"], 4)
            for i, row in enumerate((dist_serve["k1_tp_shards"],
                                     dist_serve["k2_tp_shards"]))
            for c in row}))
    log("seconds", phases=json.dumps(seconds),
        total=f"{time.perf_counter() - t_start:.1f}")
    log("decode_graph", replays_by_phase=json.dumps(replays),
        captures=_graph_counts()[0],
        main=json.dumps({k: round(v, 2) if isinstance(v, float) else v
                         for k, v in composed["vs_eager"].items()}),
        fps=json.dumps(composed["fps"]))
    eager = [p for p in DECODING_PHASES if not replays.get(p)]
    if eager:  # every decoding phase decodes through captured graphs
        raise AssertionError(f"no decode graph replayed in {eager}")
    if {"jax", "modelcompose_tpu"} & set(sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    # Launches on the main paths: the two serving runs, the decode variants
    # and the question-file runs, the serving stack, the EVA + ImageBind
    # request and the four eval entries, the four LLaVA-suite entries and
    # the answers of the converted and the dense checkpoints, every step
    # of the training run
    # (train steps and the accumulation window), and the train entry's two
    # stages with the served answer of its export.
    trained = train["launches"] + [train["accum_launches"]]

    def train_launches(name):
        return sum(c.get(name, 0) for c in trained)

    def by_path(name):
        return {"main": launches[name], "composed": composed["launches"][name],
                "decode_variants": sum(v["launches"][name]
                                       for v in variants.values()),
                "qa_loader": qa_launches[name],
                "serve": serve["launches"][name],
                "eva_imagebind": eva["launches"][name],
                "entries": entries["launches"][name],
                "legacy_eval": legacy["launches"][name],
                "train": train_launches(name),
                "train_entry": entry["launches"][name],
                "distributed": dist_serve["launches"][name]
                + dist_train["launches"].get(name, 0)}

    def train_paths(name):
        return {"train": train_launches(name),
                "train_entry": entry["launches"][name],
                "distributed": dist_train["launches"][name]}

    tp_err = {"fwd": max(c["max_abs_err"]
                         for c in dist_serve["k1_tp_shards"]),
              "decode": max(c["max_abs_err"]
                            for c in dist_serve["k2_tp_shards"])}

    def worst(row, key):  # the largest error, phases 10-14's shapes included
        return dict(row, max_abs_err=max(
            row["max_abs_err"], entry["kernel_checks"][key],
            serve["max_abs_err"].get(key, 0.0),
            eva["kernel_checks"][key], entries["kernel_checks"][key],
            legacy["kernel_checks"].get(key, 0.0), tp_err.get(key, 0.0)))
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES,
             launches=sum(by_path("flash_attention_fwd").values()),
             launches_by_path=by_path("flash_attention_fwd"),
             serve_chunks=serve["k1_chunks"],
             tp_shards=dist_serve["k1_tp_shards"],
             **worst(dict(k1, max_abs_err=max(k1["max_abs_err"],
                                              k34["fwd"]["max_abs_err"])),
                     "fwd")),
        dict(name="flash_decode", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES,
             launches=sum(by_path("flash_decode").values()),
             launches_by_path=by_path("flash_decode"),
             serve_pool=serve["k2_pool"],
             tp_shards=dist_serve["k2_tp_shards"], **worst(k2, "decode")),
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
    log("prefill_graph", graphs_by_phase=json.dumps(graphs),
        totals=json.dumps(_all_graph_counts()),
        k1_launches_by_path=json.dumps(by_path("flash_attention_fwd")),
        ttft_s=json.dumps({p: {k: round(v, 4) for k, v in r.items()
                               if k.endswith(("encode_s", "prefill_s",
                                              "call_s"))}
                           for p, r in (("main", main),
                                        ("composed", composed["vs_eager"]),
                                        ("eva_imagebind", eva["vs_eager"]))}),
        logits_equal={p: r["logits_equal"] for p, r in (
            ("main", main), ("composed", composed["vs_eager"]),
            ("eva_imagebind", eva["vs_eager"]))},
        pools_by_kind_gb=json.dumps({p: {k: round(v, 3) for k, v in g.items()}
                                     for p, g in (
            ("composed", composed["pools_by_kind_gb"]),
            ("eva_imagebind", eva["pools_by_kind_gb"]),
            *serve["pools"].items())}),
        peak_gb=json.dumps({"composed": [round(composed["peak_mem_gb"], 2),
                                         round(composed["peak_reserved_gb"],
                                               2)],
                            **{p: [round(r["peak_mem_gb"], 2),
                                   round(r["peak_reserved_gb"], 2)]
                               for p, r in serve["parts"].items()
                               if "peak_mem_gb" in r}}),
        serve_mcub4_stall_s=json.dumps(serve["stall"]))
    missing = [p for p in ("main", "composed", "eva_imagebind", "serve")
               if not graphs[p].get("prefill", [0, 0])[1]
               and not graphs[p].get("chunk_step", [0, 0])[1]]
    if missing:  # every prefilling phase replays a prefill graph
        raise AssertionError(f"no prefill graph replayed in {missing}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
