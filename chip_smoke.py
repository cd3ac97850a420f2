#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``modelcompose_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
nonzero:

1. device: the card's name and power limit, TF32 off for the comparisons;
2. build: every hand-written kernel compiled by nvcc from ``csrc/``, one
   nvcc per source, all started together;
3. K1 (flash-attention forward) against its plain PyTorch version, at
   the vision path's 1,024 bucket and the composed path's 3,328 (bf16, and
   fp16: the reference's eval dtype), with its bound and the time of
   ``scaled_dot_product_attention`` on the same inputs (the yardstick,
   never called by the port); both types at a ragged length, GQA with a
   query offset, D=64 and a prefill chunk;
4. K2 (split-KV flash-decode) against its plain PyTorch version, over the
   vision path's int8 cache of 1,056 positions and the composed path's
   3,360 (a bf16 q, and an fp16 one), and at beam search's shape (a bf16
   and an fp16 cache of 3 rows of 3,360), timed cycling over the 32 layers
   of the stacked cache so that each launch finds its layer cold in L2, as
   decode does;
4b. K5 (the W8A16 product of the int8 weights) against its plain version
   (the convert and the fp32-output GEMM), with a bf16 and an fp32
   result, at every int8 product of the main paths: Vicuna-7B's q/k/v/o,
   gate/up, down and lm_head and their tp 2 and 4 shards, at 1, 2, 3, 4 and
   8 rows; timed by CUDA-graph replay cycling over 32 weight copies (each
   launch cold in L2, as in a decode step) at the Vicuna-7B shapes for
   every row count and at the shards for 1 and 8 rows, beside the plain
   version, ``torch._weight_int8pack_mm`` on an [N, K] copy (the
   yardstick, never called by the port; its error text where the card's
   torch has no CUDA version) and the bound; the products that share an
   input (q/k/v, gate/up and their tp shards) as one grouped launch at 1
   and 2 rows against each member's plain product, the Vicuna-7B groups
   timed beside their members launched one by one; the sum over one
   decode step's products at each row count (129 launches at 1-2 rows,
   grouped, beside the 225 one by one; 225 at 3-8);
4c. K6 (the W8A16 GEMM of the int8 products above 8 rows) against its
   plain version (the convert, the fp32-output GEMM and the scale pass),
   with a bf16 and an fp32 result, at every int8 product of the main paths
   and its tp 2 and 4 shards at 9, 256, 512, 2,048 and 3,328 rows, each
   one K6 launch and no K5 launch, with each shape's block printed; the
   seven products of a Vicuna-7B layer timed by CUDA-graph replay over 4
   weight copies at 512, 2,048 and 3,328 rows and the tp shards of a layer
   at 3,328, beside the plain route, ``torch.mm`` on bf16 copies of the
   weights made beforehand (the yardstick, never called by the port),
   ``torch._weight_int8pack_mm`` (or its error text) and the bound; the
   sums over a layer and a 32-layer prefill (224 launches);
4d. K7 (the gradient through x of the int8 products: the scaled cotangent
   rounded to bf16 times the int8 weight, transposed, in one tensor-core
   GEMM) against its plain version (the fp32 scaled cotangent, its bf16
   copy, a bf16 copy of the weight, cuBLAS into fp32 and the cast) for an
   fp32 cotangent, at every dL/dx of the int8-base train step: q/k/v/o,
   gate/up and down at 8,192 and 32,768 rows (B=4 and B=16 x 2,048) and
   the lm_head at a 256-position loss chunk of those batches (1,024 and
   4,096 rows), one K7 launch each, with each shape's grid printed; each
   timed by CUDA-graph replay over 4 weight copies beside the plain route,
   ``torch.mm`` on bf16 copies of the scaled cotangent and of the weight
   made beforehand (the yardstick, never called by the port) and the
   bound; the sums over a layer and a 32-layer step (232 launches at 8
   loss chunks);
4e. K8 (the residual add and RMSNorm), K9 (RoPE and the KV-cache write)
   and K10 (the SiLU product), the decode layer's fused passes, against
   their plain versions at the MCUB-4 decode shapes: 1 and 8 rows, hidden
   4,096, 32 heads of 128 (and the tp 2 / tp 4 ranks' 16 and 8, intermediate
   5,504 and 2,752), int8 and bf16 caches of 3,360 positions with a
   different position a row: K8's sum bit-equal and its normed output
   within one ulp (a weight of ones), K9's rotated q and whole caches and
   K10 bit-equal; each timed by CUDA-graph replay beside its plain version
   and its bound (the bytes at 3.35 TB/s); no one PyTorch call computes any
   of them (``library_ms`` null, but for K8 with no residual, the final
   norm: ``F.rms_norm``); the sum over a decode step (65 K8, 32 K9, 32
   K10); then K8 and K9 inside K5's streaming launch at 1 and 2 rows: the
   Vicuna-7B q/k/v group and its tp 2 / tp 4 shards with K8 in the
   prologue and K9 in the epilogue (int8 cache, and bf16 for the whole
   group), gate/up and its shards and the lm_head with K8 in the
   prologue, each bit-equal to K8, K5 and K9 launched in turn (s, the
   outputs, the whole caches) and within 2e-2 of its plain version, timed
   by CUDA-graph replay over 8 weight copies beside that chain (in one
   graph, and launch by launch), its plain version and its bound; the sum
   over a step's 64 fused launches; then K10 inside the down product's K5
   launch at 1 and 2 rows (K 11,008, 5,504 and 2,752; bf16, and fp16 at
   11,008), bit-equal to K10 and the streaming K5 in turn (h written out
   and not, the product in x's type and in fp32), timed the same way
   beside K10 -> K5 in one graph, and the sum over a step's 32 down
   launches;
5. the serving path at Vicuna-7B width: a vision DAMC composition (CLIP
   ViT-L/14-336, linear projector, routed LoRA r=128) with random weights,
   int8 base, the default adapter mix folded into W, int8 KV cache,
   answering two image+question requests greedily through
   ``MultimodalLM.generate``: the first request of the shape runs the
   tower and the prefill eagerly and captures its decode graph
   (``core/decode_graph``), the second captures the tower's and the
   prefill's graphs (``models/towers``, ``core/prefill_graph``), the
   third, timed, replays every graph and captures nothing (counts per
   kind checked, K1 exactly once a layer in the replayed prefill, K6
   exactly once an int8 product there (7 a layer: 224), K5
   exactly 4 a layer + 1 a replayed decode step of 1-2 rows (q/k/v and
   gate/up one launch each; 7 a layer + 1 at 3-8) and once in the
   prefill's lm_head, K8-K10 a replayed decode step as
   ``_fused_per_step`` counts them (at 1-2 rows K8 alone only for the
   final norm, each layer's norms in the prologue of the K5 launch that
   reads them, RoPE with the cache write in the q/k/v launch's epilogue
   and the SiLU product in the down product's prologue; at 3-8 rows K8 2
   a layer + 1, K9 and K10 once a layer), and none in the prefill, peak
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
   against the plain path's, the request through the graphs on each arm
   of three A/Bs once (their timing in turns is ``scripts/torch_path_ab.py
   --workload routes``): K5 against the plain int8 product with K2 in both
   (decode tokens/s, one replayed step's device time by kernel in
   ``chiprun_out/decode_step_profile_{k5,plain}.txt``, greedy ids equal or
   parting at a named near tie), three routes of the decode layer: K8-K10
   inside K5's launches, K8-K10 as launches of their own, and unfused (the
   layer's ops as PyTorch kernels, K5 writing fp32 and a cast), K2 and K5
   in all (decode tokens/s, one replayed step's device time and its
   kernels counted by profile split in
   ``chiprun_out/decode_step_profile_fused_ab_<route>.txt``, the K5 and
   K8-K10 launches of every arm checked exactly, greedy ids equal or
   parting at a named near tie), and K6 against the plain route above 8
   rows with K1 and K5 in both (the one-shot prefill through its graph; a
   512-row chunk step through its graph and the prefill graphs' pool GB;
   K6's launches exactly 224 a prefill, the prefill logits within 8e-2 and
   the greedy ids equal or parting at a named near tie), and
   torch.profiler over the towers + prefill
   (``chiprun_out/composed_profile.txt``);
6b. decode variants on phase 6's model and request: sampled (temperature
   0.2), sampled with top-p 0.7 (every drawn token inside its step's
   nucleus; both sampled runs' ids equal to ``device_loop=False`` from the
   same seed), the ``concat`` fold (its ids against the unfolded decode's),
   beam search and beam sampling (3 beams, 16 tokens, K2 over a bf16
   cache of 3 rows), each with its answer, launches, decode tokens/s and
   peak memory;
6c. fp16 (run after phase 14, once phase 6's model is gone): the MCUB-4
   composition of phase 6 with ``dtype="float16"`` (the reference's eval
   dtype) at Vicuna-7B width and its 32 layers, in the same production
   variant: the request through the tower, prefill and
   decode graphs as in phase 5 (every count exact), the launches of each
   kernel equal to phase 6's bf16 request's (K1 32, K2 992), the
   teacher-forced logits within 8e-2 of the plain path's (attention and
   the int8 products on their plain versions) and finite, the greedy ids
   equal to the plain path's or parting at a named near tie;
6d. tiny: attention's dtypes end to end on small models (2 layers of
   256, head_dim 128, text only): an fp32 model's request raises at K1's
   checks with no K1 or K2 launch (the kernels take bf16 and fp16; a CUDA
   tensor gets no plain version) and answers on the CPU; an fp16 model
   through the prefill and decode graphs with K1 once a layer and K2 once
   a layer a step, within 2e-2 of the same weights on the CPU; an fp16
   stage-2 train step eagerly and through its graph, K1 twice a layer
   (remat), K3 and K4 once, counted exactly, the first loss finite and the
   graph's losses the eager ones (fp16 Adam's first update overflows, as
   the JAX optimizer's does, so later losses are NaN on every route); its
   first loss, gradients and update held to the plain attention's;
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
   shapes too: the shape K3/K4 have been timed at since their port (bf16,
   and fp16), the train step's batch and its micro-batches, with SDPA's
   backward beside them (a boolean mask at B=2, ``is_causal`` at B=1);
   both types at a ragged length, GQA with a query offset and D=64;
9. the training path at Vicuna-7B width: the vision DAMC stage-2 recipe
   (bf16 base, modal+language LoRA r=128, 5+5 soft tokens, mlp2x_gelu
   projector, remat) built through the train entry, four
   ``make_train_step`` steps on two image+question+answer samples, one
   accumulation window of two micro-batches through
   ``make_grad_and_apply``, torch.profiler over one more step (device time
   by kernel, the K1/K3/K4 shares; the table goes to
   ``chiprun_out/train_profile.txt``), then the kernel path's loss and
   gradients against the plain path's on one micro-batch;
9b. train_int8: the same model and recipe on an int8 base, built by the
   train entry's ``build_model`` with the QLoRA recipe's flags
   (``--quantize_frozen_base True --loss_chunk 256 --adam_mu_dtype
   bfloat16``), at B=4 x 2,048 (four rows of about 1,400, 1,100, 1,900 and
   1,300 positions): 3 fused steps eagerly and 3 through a
   ``TrainStepGraph`` (eager, capture, replay) from one state, losses,
   LoRA leaves and Adam moments bit-equal; every step K6 14 times a layer
   + 2 a loss chunk (forward and remat recompute), K7 7 times a layer + 1
   a chunk (every int8 product's dL/dx), K1 twice a layer, K3 and K4
   once, no K5, from the counters and the capture's record; step s,
   positions/s, the device-idle share of one replayed step (torch.profiler,
   ``chiprun_out/train_int8_profile.txt``), peak memory; then K7 against
   the plain dx in turns (plain, K7, K7, plain; two eager steps each from
   the same state): losses within 1e-2 of the plain arm's, step s and peak
   memory;
10. train_entry: the DAMC train entry (``train()``, what ``python -m
   modelcompose_tpu_torch.train.train_multimodal`` runs) at Vicuna-7B v1.5
   width and 8 of its 32 layers: a random fp16 base written to disk in
   the released layout (two shards, index, config.json), a 48-sample
   point dataset (8,192 x 6 clouds), stage 1 as ``run_pretrain_point.sh``
   (B=16, 3 steps, projector only), stage 2 as
   ``run_finetune_point_damc.sh`` on its export (B=4, 4 steps,
   checkpoint-4), the same flags resumed to 6
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
   against eager), peak memory, each kind's graph pool GB, K1/K2/K6
   launches (K2 once a layer a tick, K1 once a layer and K6 once an int8
   product a prefill or chunk, exactly, replays counted); every stream
   ended, and every
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
   then the same runs with K1, K2, K5 and K6 replaced by their plain
   versions, every answer equal to the kernel path's or leaving it at a
   named near tie (each entry's seconds and graph captures and replays by
   kind; K6 exactly 7 launches for each K1 launch of a prefill layer);
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
   tensor-parallel step, the MCUB-4 request answered through the prefill
   and decode graphs under the group (their collectives captured), with
   greedy ids bit-equal to the same graphs' with no group and to the
   eager path's under the group; captures and replays under the group
   and K1 = 32 and K6 = 224 a prefill, K2 = 32 a decode step from the
   counters;
   decode tokens/s and prefill s of the three; one replayed decode step
   profiled under the group and with none (NCCL's kernels and copies in
   ``chiprun_out/distributed_decode_profile*.txt``); the slot pool behind
   the leader's serving backbone under the group and with none (MCUB-4
   admitted in 512-position chunks beside two short vision requests):
   answers bit-equal between the two and each held to its solo no-group
   run, the tick ms of both beside phase 11's; then K1 and K2 at the tp 2
   and 4 ranks' shapes (16 and 8 heads, the 3,328 bucket and the int8
   3,360 cache) against their plain versions, timed by CUDA graph replay,
   with their bounds (the ``tp_shards`` of the K1 and K2 rows); (b) after
   9, phase 9's stage-2 step rebuilt and run from one state three ways:
   through the train graphs with no group, through them in the
   data-parallel path (gradients and loss summed over the data group,
   captured), and eagerly in that path: 4 fused steps and 3 accumulation
   windows each, losses, every trainable leaf and the moments bit-equal,
   K1/K3/K4 = 64/32/32 a step, step seconds, host dispatch seconds and
   the device-idle share of a replayed step under the group and with
   none.

The line before the last is a JSON object with each kernel's launches on the
main paths, its largest error against the plain version, its time, the plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes over 3.35 TB/s and the operations over
989 TFLOP/s bf16, counting the valid causal pairs and the valid cache bytes
of this run's inputs; ``bound_by`` says which) and one library call's time
(``library_ms``, or null where no call computes the same function).  Each
row's own keys keep the shape and timing of earlier runs: K1 at the vision
bucket and K2 over the vision cache (CUDA events over warm launches), K3/K4
at B=2, L=2,048 with rows of 2,048 and 1,391, K5 at one row of q/k/v/o
(its ``shapes``, ``tp_shards`` and ``step`` hold the others and the sum
over a decode step, its ``decode_ab`` phase 6's A/B), K6 at 3,328 rows of
q/k/v/o (its ``shapes``, ``tp_shards`` and ``step`` the others and the
sums over a layer and a prefill, its ``prefill_ab`` phase 6's A/B,
``library_ms`` ``torch.mm`` on a bf16 copy of the weight), K7 at 8,192
rows of q/k/v/o's dL/dx (its ``shapes`` and ``step`` the others and the
sums over a layer and a 32-layer step, its ``train_ab`` phase 9b's A/B,
``library_ms`` ``torch.mm`` on bf16 copies of the scaled cotangent and of
the weight; its launches phase 9b's, the one path with an int8 base's
gradient), K8, K9 and K10 at one row of the MCUB-4 decode (their
``shapes`` the others and ``step`` the sum over a decode step, their
``decode_ab`` phase 6's third A/B), and K8 and K9 inside K5's launch,
named by their counters (``norm_matmul_group``: K8 in the prologue, at
one row of gate/up; ``norm_qkv_rope``: K8 and K9, at one row of q/k/v;
their ``shapes`` the others with the unfused chain's times, ``step`` the
sum over a step's 64 fused launches); K1's and K2's
``mcub4`` hold
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

import contextlib
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
K5_SOURCE = "modelcompose_tpu_torch/csrc/w8a16_gemv.cu"
# no Pallas kernel: XLA's fused int8 convert of the JAX dequant_matmul
K5_REPLACES = "modelcompose_tpu/ops/quant.py:33"
K6_SOURCE = "modelcompose_tpu_torch/csrc/w8a16_gemm.cu"
# no Pallas kernel either: the same fused convert at prefill sizes
K6_REPLACES = "modelcompose_tpu/ops/quant.py:33"
K7_SOURCE = "modelcompose_tpu_torch/csrc/w8a16_dx.cu"
# no Pallas kernel: the fused convert in the transposed dot of the same
# dequant_matmul's gradient
K7_REPLACES = "modelcompose_tpu/ops/quant.py:33"
K8_SOURCE = K9_SOURCE = K10_SOURCE = \
    "modelcompose_tpu_torch/csrc/decode_fused.cu"
# no Pallas kernels: the counterparts of the XLA fusions of the JAX decode
# step's elementwise work (RMSNorm with the residual add; RoPE with the
# int8 KV quantize and the scatter; the SiLU product)
K8_REPLACES = "modelcompose_tpu/ops/norms.py:9"
K9_REPLACES = "modelcompose_tpu/ops/rope.py:36"
K10_REPLACES = "modelcompose_tpu/core/llama.py:323"
# the decode layer's fused passes, by their launch counters' names: K8, K9
# and K10 as launches of their own, then K5's launches with K8 in their
# prologue and with K8 and K9 (each also counted as a K5 launch)
FUSED_KERNELS = ("add_rms_norm", "rope_kv_write", "silu_mul",
                 "norm_matmul_group", "norm_qkv_rope", "silu_matmul")
# the launch counters of the forward kernels, as the phases read them
FORWARD_KERNELS = ("flash_attention_fwd", "flash_decode", "w8a16_gemv",
                   "w8a16_gemm") + FUSED_KERNELS

# K5's fp32 result against its plain version, relative to max |plain|: int8
# and bf16 values are exact in fp32, so only the summation order differs
K5_F32_TOL = 1e-5
# bf16 tolerances, relative to max |reference| on the compared rows: bf16
# keeps 8 mantissa bits (~0.4% per rounding); the kernel and its plain
# version round P, the output and (K2) the accumulation order differently.
ATTN_TOL = 2e-2
LSE_TOL = 1e-3      # fp32 statistics from identical bf16 operands
# fp32 attention (K1-K4, K2) against its plain version with TF32 off: both
# in fp32, the kernels' products in 3xTF32 (about fp32 accuracy), so the
# summation order and the tensor cores' truncating adds alone differ
ATTN_F32_TOL = 1e-5
# The fp32 MCUB-4 request (phase 6e): kernel-path logits against the plain
# path's, relative to max |logit|.  fp32 rounding (about 1e-6 in the
# attention) through 32 random layers and the int8 KV cache
F32_LOGIT_TOL = 1e-3
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
# The tiny fp32 train step's gradients and first update through the
# kernels against the plain attention, relative to each leaf's max |plain|:
# fp32 on both routes, but two layers of backward by two formulas (K3/K4's
# Di = rowsum(O dO) and autograd's softmax backward) compound the 1e-5 of
# the attention itself
F32_GRAD_TOL = 1e-4

SEED = 0
NEW_TOKENS = 32
TRAIN_GRAPH_STEPS = 6  # phase 9's fused steps: eager, capture, 4 replays
TRAIN_WINDOWS = 3  # phase 9's accumulation windows: eager, capture, replay
# The decode variants: beam search's width and length, the sampling knobs
NUM_BEAMS = 3
BEAM_TOKENS = 16
SAMPLE_TEMPERATURE = 0.2
SAMPLE_TOP_P = 0.7
BEAM_SAMPLE_TEMPERATURE = 0.7
QA_TOKENS = 16  # --max-new-tokens of the question-file runs
# the phases whose decoding runs through captured decode graphs
DECODING_PHASES = ("main", "composed", "decode_variants", "qa_loader",
                   "serve", "eva_imagebind", "entries", "legacy_eval",
                   "distributed_serve")
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
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores (the fused passes' math)
# dense TF32 on the tensor cores: the fp32 attention kernels run each fp32
# product as three TF32 ones (3xTF32), so their bound counts 3x the flops
PEAK_TF32_FLOPS = 494.7e12
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


def graph_time_ms(fn, n: int = 20, replays: int = 5, records=()):
    """Device time of one ``fn()`` with the host's launch gaps taken out:
    ``n`` calls captured into one CUDA graph, replayed ``replays`` times
    between two events.  ``records`` are more capture-record context
    managers to enter (an earlier checkout's wrappers).  None, with the
    reason logged, when ``fn`` cannot be captured."""
    import contextlib
    import torch
    from modelcompose_tpu_torch.ops import flash_attention, flash_decode, quant
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        # K2's and K5's scratch is the capture records', kept as long as
        # the graph; K1's launches go to a record nobody counts (timing
        # launches)
        with flash_decode.capturing() as record, \
                quant.capturing() as k5_record, \
                flash_attention.capturing(), contextlib.ExitStack() as more:
            kept = [more.enter_context(r()) for r in records]
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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
    del record, k5_record, kept
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
    from modelcompose_tpu_torch.train.step_graph import GRAPH_KINDS
    return {"decode": DecodeGraph, "prefill": PrefillGraph,
            "chunk_step": ChunkStepGraph, "tower": TowerGraph, **GRAPH_KINDS}


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
    # K5 once an int8 product in each replayed decode step, q/k/v and
    # gate/up one launch each at 1-2 rows: 4 a layer and the lm_head (129
    # for a 32-layer int8 model), 7 a layer and the lm_head at 3-8 (225);
    # and the prefill's lm_head once (its B rows; the prefill's own
    # products are large).  An fp32 model runs none of K5-K10: its fp32
    # activations take the products' and the decode layer's plain versions
    # (ops/_route), as the JAX package computes them outside any kernel.
    from modelcompose_tpu_torch.ops.quant import K5_GROUP_ROWS
    half = int(model.cfg.dtype in ("bfloat16", "float16"))
    k5_step = _k5_per_step(model.params, len(ids))
    per_layer = 4 if len(ids) <= K5_GROUP_ROWS else 7
    if k5_step != per_layer * model.cfg.num_hidden_layers + 1 \
            or launches["w8a16_gemv"] != half * (
                k5_step * (NEW_TOKENS - 1) + 1):
        raise AssertionError(f"{phase}: K5 {launches} for {NEW_TOKENS - 1} "
                             f"replayed decode steps of {k5_step} products "
                             f"and one prefill lm_head ({model.cfg.dtype})")
    # K6 once an int8 product of every layer in the one replayed prefill
    # (B x its bucket rows: 224 for a 32-layer int8 model)
    if launches["w8a16_gemm"] != half * _k6_per_forward(model.params):
        raise AssertionError(f"{phase}: K6 {launches} in one replayed "
                             f"prefill, want {_k6_per_forward(model.params)}"
                             f" ({model.cfg.dtype})")
    # K8-K10 (alone or in K5's launches) in each replayed decode step, none
    # in the prefill
    fused = {k: half * v * (NEW_TOKENS - 1) for k, v in _fused_per_step(
        model.params, len(ids)).items()}
    if {k: launches[k] for k in FUSED_KERNELS} != fused:
        raise AssertionError(f"{phase}: K8-K10 {launches} for "
                             f"{NEW_TOKENS - 1} replayed decode steps, "
                             f"want {fused}")
    third = _graph_delta(before)
    peak, reserved = _peak_gb()
    graphs = {"first_request": calls[0][0], "second_request": calls[1][0],
              "third_request": third}
    n_towers = len(inputs)
    ttft = [{"towers": round(t["encode_s"], 4),
             "prefill": round(t["prefill_s"], 4)}
            for t in (calls[0][1], calls[1][1], timings)]
    log(phase, graphs=json.dumps(graphs), k5_per_decode_step=k5_step,
        k6_per_prefill=launches["w8a16_gemm"], dtype=model.cfg.dtype,
        peak_mem_gb=f"{peak:.2f}",
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


def _rounded(row):
    """A result row with its floats to 4 significant digits (the kernels
    line stays short)."""
    return {k: float(f"{v:.4g}") if isinstance(v, float) else v
            for k, v in row.items()}


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what sets it): ``flops`` at
    ``peak_flops`` (the tensor cores' bf16 rate by default) or ``nbytes``
    at the memory rate, whichever is longer."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(flops: float, nbytes: float, dtype):
    """``bound`` of an attention kernel at its operands' type: the bf16 /
    fp16 tensor-core rate, or at fp32 three TF32 products for each fp32
    one (the kernels' 3xTF32) at the TF32 rate."""
    import torch
    if dtype == torch.float32:
        return bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return bound(flops, nbytes)


def _assert_tf32_off():
    """The plain versions an attention kernel is held to run in full fp32:
    TF32 off for matmuls (phase 1 sets it; nothing may turn it back on)."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain versions must run with TF32 off")


def _attn_tols(dtype):
    """(relative output tolerance, LSE tolerance) of an attention kernel
    against its plain version at its operands' type."""
    import torch
    if dtype == torch.float32:
        return ATTN_F32_TOL, ATTN_F32_TOL
    return ATTN_TOL, LSE_TOL


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
    k6 = _build.load("w8a16_gemm")
    k7 = _build.load("w8a16_dx")
    log("build", dynamic_smem_bytes=json.dumps({
        **{f"w8a16_gemm rows {r}": k6.mc_w8a16_gemm_smem(r)
           for r in (64, 128, 256)},
        **{f"w8a16_dx rows {r}": k7.mc_w8a16_dx_smem(r)
           for r in (128, 256)},
        # dtype codes: 1 bf16, 2 fp32 (fp16 is sized as bf16)
        "flash_attention_fwd D128": k1.mc_flash_attention_fwd_smem(128, 1),
        "flash_attention_fwd D64": k1.mc_flash_attention_fwd_smem(64, 1),
        "flash_attention_fwd fp32 D128":
            k1.mc_flash_attention_fwd_smem(128, 2),
        "flash_decode D128 int8 G1": k2.mc_flash_decode_smem(128, 1, 1),
        "flash_decode D128 bf16 G1": k2.mc_flash_decode_smem(128, 0, 1),
        "flash_decode D128 fp32 G1": k2.mc_flash_decode_smem(128, 0, 2),
        "flash_attention_bwd dq D128":
            k34.mc_flash_attention_bwd_smem(0, 128, 1),
        "flash_attention_bwd dkv D128":
            k34.mc_flash_attention_bwd_smem(1, 128, 1),
        "flash_attention_bwd fp32 D128":
            k34.mc_flash_attention_bwd_smem(1, 128, 2)}))
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")


def _ptxas_report(text: str):
    """{instantiation: "registers, spills"} from nvcc's -Xptxas -v output:
    the kernel's name and template arguments, if any, as mangled
    (``ILi128ELi1EaE``: 128, 1, int8)."""
    import re

    def entry(ln):
        """The kernel's mangled name: an identifier ending in ``_kernel``
        whose length its decimal prefix gives (names may hold digits)."""
        for m in re.finditer(
                r"(?=(\d+)([a-z][a-z0-9_]*?_kernel)(I\w*?E)?E)", ln):
            digits, name = m.group(1), m.group(2)
            if any(digits[i:] == str(len(name)) for i in range(len(digits))):
                return name + (m.group(3) or "")
        return None
    report, current = {}, None
    for ln in text.splitlines():
        name = entry(ln) if "Compiling entry function" in ln else None
        if name:
            current = name
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
             library=False, timer=None, dtype="bfloat16"):
    """K1 against its plain version at one shape, on operands of
    ``dtype`` (bf16, fp16 or fp32), its time (``timer``, CUDA events over
    warm launches by default), the plain version's (events), SDPA's
    (``library``, by the same timer, on the same operands) and its
    bound."""
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(getattr(torch, dtype))
    q, k, v = rnd(B, Lq, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (torch.arange(S, device=device)[None]
              < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    name = f"{dtype} B{B} Lq{Lq} S{S} H{H}/{Hkv} D{D} q_offset{q_offset}"
    err, rel, lse_err = _check_k1(name, q, k, v, kw, out, lse)
    timer = timer or cuda_time_ms
    ms = timer(lambda: flash_attention_forward(q, k, v, **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, **kw))
    # What the outputs need, each moved once: q and k on valid rows (a
    # padding row reads no q, padding keys are masked for every row), all
    # of V (a padding row's output is the mean of V), out and the LSE
    # written, the segment ids read.
    n_q, n_k = int((q_seg != 0).sum()), int((kv_seg != 0).sum())
    es = q.element_size()
    nbytes = es * D * (H * n_q + Hkv * n_k) + es * (v.numel() + q.numel()) \
        + 4 * B * H * Lq + 4 * (B * Lq + B * S)
    bound_ms, bound_by = attention_bound(
        4 * D * H * _valid_pairs(kw, Lq, S), nbytes, q.dtype)
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
    _assert_tf32_off()
    valid = kw["q_segment_ids"] != 0
    err, rel = _rel_err(out, ref_out, valid)
    lse_err = (lse.transpose(1, 2)[valid] - ref_lse.transpose(1, 2)[valid]
               ).abs().max().item()
    tol, lse_rel_tol = _attn_tols(q.dtype)
    lse_tol = lse_rel_tol * max(
        ref_lse.transpose(1, 2)[valid].abs().max().item(), 1.0)
    if not (out.dtype == q.dtype and rel <= tol and lse_err <= lse_tol):
        raise AssertionError(f"K1 {name}: out {out.dtype} rel err {rel:.3g} "
                             f"(tol {tol}), lse err {lse_err:.3g} (tol "
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
    # the fp16 model's prefill (the reference's eval dtype), beside SDPA
    # on the same fp16 operands
    mcub4_fp16 = _k1_case(device, gen, library=True, dtype="float16",
                          **MCUB4_K1)
    # the fp32 model's prefill (phase 6e), by CUDA-graph replay, beside
    # SDPA on the same fp32 operands (its memory-efficient backend: cuDNN
    # and flash take no fp32)
    mcub4_fp32 = _k1_case(device, gen, library=True, dtype="float32",
                          timer=graph_time_ms, **MCUB4_K1)
    errs = [mcub4["max_abs_err"], vision["max_abs_err"],
            mcub4_fp16["max_abs_err"]]
    errs_fp32 = [mcub4_fp32["max_abs_err"]]
    for dtype in ("bfloat16", "float16", "float32"):
        for case in (dict(B=2, Lq=150, S=150, H=32, Hkv=32, D=128,
                          q_offset=0, lengths=[150, 97]),
                     dict(B=2, Lq=256, S=1024, H=32, Hkv=8, D=128,
                          q_offset=768, lengths=[1024, 900]),
                     dict(B=2, Lq=150, S=150, H=8, Hkv=4, D=64, q_offset=0,
                          lengths=[150, 61]),
                     dict(B=1, Lq=512, S=3072, H=32, Hkv=32, D=128,
                          q_offset=2560, lengths=[3072])):
            err = _k1_case(device, gen, dtype=dtype, **case)["max_abs_err"]
            (errs_fp32 if dtype == "float32" else errs).append(err)
    return dict(vision, max_abs_err=max(errs),
                shape="B2 Lq=S=1024 (1024, 637 valid)",
                mcub4=dict(mcub4, shape="B1 Lq=S=3328 (3287 valid)"),
                mcub4_fp16=dict(mcub4_fp16,
                                shape="fp16 B1 Lq=S=3328 (3287 valid)"),
                fp32=dict(mcub4_fp32, max_abs_err=max(errs_fp32),
                          shape="fp32 B1 Lq=S=3328 (3287 valid), "
                          "CUDA-graph replay"))


def _k2_case(device, gen, *, B, NL, S, H, Hkv, D, kv_len, quantized, layer,
             graph=False, dtype="bfloat16"):
    """K2 on a q of ``dtype`` (bf16, fp16 or fp32) over a cache of that
    type or int8 (``quantized``), measured by ``_k2_measure``."""
    import torch
    from modelcompose_tpu_torch.core.llama import quantize_kv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(getattr(torch, dtype))
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
    _assert_tf32_off()
    err, rel = _rel_err(out, ref)
    _, rel_loop = _rel_err(out, loop)
    cache = "int8" if quantized else str(k.dtype).split(".")[-1]
    name = (f"q {str(q.dtype).split('.')[-1]} {cache} B{B} NL{NL} S{S} "
            f"H{q.shape[2]}/{Hkv} D{D} kv_len{kv.tolist()}")
    tol = _attn_tols(q.dtype)[0]
    if not (out.dtype == q.dtype and rel <= tol and rel_loop <= tol):
        raise AssertionError(f"K2 {name}: {out.dtype}, rel err {rel:.3g} vs "
                             f"plain, {rel_loop:.3g} vs the chunked loop "
                             f"(tol {tol})")
    return name, err, rel, rel_loop


def _k2_library(q, k, v, kv, out, layer):
    """Over a cache of q's type (not int8: its per-vector scales have no
    library call), one ``scaled_dot_product_attention`` call computes K2's
    function: q [B, H, 1, D] against views of one layer's k and v sliced to
    the longest kv_len (a boolean mask where rows differ; ``enable_gqa``
    for a group), held to K2's output ``out``.  Its device time, cold as
    K2's (each call on another layer), timed here only."""
    import torch
    import torch.nn.functional as F
    NL, B, S, Hkv, D = k.shape
    H = q.shape[2]
    n = max(kv.tolist())
    lens = kv.tolist()
    mask = None if len(set(lens)) == 1 else (
        torch.arange(n, device=q.device)[None] < kv[:, None])[:, None, None]
    qv = q.transpose(1, 2)

    def call(i):
        return F.scaled_dot_product_attention(
            qv, k[i, :, :n].transpose(1, 2), v[i, :, :n].transpose(1, 2),
            attn_mask=mask, scale=D ** -0.5, enable_gqa=H != Hkv)
    got = call(layer).transpose(1, 2)
    _, rel = _rel_err(got, out)
    tol = _attn_tols(q.dtype)[0]
    if rel > tol:
        raise AssertionError(f"K2's library call: rel err {rel:.3g} from the "
                             f"kernel (tol {tol})")
    ms = device_time_cycle_ms(call, NL)
    log("K2", library="scaled_dot_product_attention",
        cache=str(k.dtype).split(".")[-1], B=B, kv_len=json.dumps(lens),
        kernels=json.dumps(_kernel_names(lambda: call(layer))),
        rel_err_from_kernel=f"{rel:.3g}", library_device_ms_cold=_ms(ms))
    return ms


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
    per_pos = 2 * Hkv * D * (1 if quantized else k.element_size()) \
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
               library_ms=None if quantized
               else _k2_library(q, k, v, kv, kernel(layer), layer),
               device_ms_cold=device_ms_cold,
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
    # the fp16 model's decode: an fp16 q over the int8 cache (the main
    # path's), and over an fp16 cache (beam search's)
    fp16 = _k2_case(device, gen, B=1, NL=32, S=3328 + NEW_TOKENS, H=32,
                    Hkv=32, D=128, kv_len=[MCUB4_POSITIONS], quantized=True,
                    layer=31, dtype="float16")
    fp16_beam = _k2_case(device, gen, B=NUM_BEAMS, NL=32,
                         S=3328 + NEW_TOKENS, H=32, Hkv=32, D=128,
                         kv_len=[MCUB4_POSITIONS] * NUM_BEAMS,
                         quantized=False, layer=31, dtype="float16")
    # the fp32 model's decode (phase 6e): an fp32 q over the int8 cache,
    # cold and by CUDA-graph replay, and over an fp32 cache (beam search's,
    # and phase 6d's tiny fp32 model's)
    fp32 = _k2_case(device, gen, B=1, NL=32, S=3328 + NEW_TOKENS, H=32,
                    Hkv=32, D=128, kv_len=[MCUB4_POSITIONS], quantized=True,
                    layer=31, dtype="float32", graph=True)
    fp32_beam = _k2_case(device, gen, B=NUM_BEAMS, NL=32,
                         S=3328 + NEW_TOKENS, H=32, Hkv=32, D=128,
                         kv_len=[MCUB4_POSITIONS] * NUM_BEAMS,
                         quantized=False, layer=31, dtype="float32")
    # a phase-10 answer's shape: B=1 over a bf16 cache (553 positions, what
    # the bound of its earlier timing implies), here for the library call
    answer = _k2_case(device, gen, B=1, NL=32, S=576 + NEW_TOKENS, H=32,
                      Hkv=32, D=128, kv_len=[553], quantized=False, layer=31)
    errs.append(answer["max_abs_err"])
    errs_fp32 = [fp32["max_abs_err"], fp32_beam["max_abs_err"]]
    for dtype in ("float16", "float32"):
        for quantized in (False, True):  # GQA, S not a multiple of 128
            err = _k2_case(device, gen, B=2, NL=4, S=1000, H=32, Hkv=8,
                           D=128, kv_len=[1000, 517], quantized=quantized,
                           layer=2, dtype=dtype)["max_abs_err"]
            (errs_fp32 if dtype == "float32" else errs).append(err)
    for quantized in (False, True):  # D=64, a one-position row
        errs_fp32.append(_k2_case(device, gen, B=2, NL=4, S=333, H=8, Hkv=8,
                                  D=64, kv_len=[1, 333], quantized=quantized,
                                  layer=3, dtype="float32")["max_abs_err"])
    errs += [c["max_abs_err"] for c in cases + [vision, beam, fp16,
                                                fp16_beam]]
    return dict(vision, max_abs_err=max(errs),
                shape="B2 int8 S=1056 kv_len 660/630",
                mcub4=dict(cases[0], shape="B1 int8 S=3360 kv_len 3287"),
                mcub4_last_step=dict(cases[1], shape="kv_len 3318"),
                beam=dict(beam, shape="B3 bf16 S=3360 kv_len 3287"),
                mcub4_fp16=dict(fp16, shape="fp16 q, B1 int8 S=3360 kv_len "
                                "3287"),
                beam_fp16=dict(fp16_beam, shape="B3 fp16 S=3360 kv_len "
                               "3287"),
                fp32=dict(fp32, max_abs_err=max(errs_fp32),
                          shape="fp32 q, B1 int8 S=3360 kv_len 3287"),
                beam_fp32=dict(fp32_beam, shape="B3 fp32 S=3360 kv_len "
                               "3287"),
                answer=dict(answer, shape="B1 bf16 S=608 kv_len 553"))


# K5's shapes on the main paths, (K, N): Vicuna-7B's int8 products, and the
# tp 2 and 4 ranks' shards of them (column splits divide N: q/k/v,
# gate/up, the lm_head; row splits divide K: o, down); each at the decode
# rows of the paths: 1 (a request), 2 (the vision pair), 3 (beams), 4 (a
# micro-batching pack) and 8 (the slot pool).
K5_SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
             "down": (11008, 4096), "lm_head": (4096, 32000)}
K5_TP_SHAPES = {f"tp{tp} {name}": (K // tp, N) if name in ("qkvo_row",
                                                           "down")
                else (K, N // tp)
                for tp in (2, 4)
                for name, (K, N) in (("qkvo", (4096, 4096)),
                                     ("qkvo_row", (4096, 4096)),
                                     ("gate_up", (4096, 11008)),
                                     ("down", (11008, 4096)),
                                     ("lm_head", (4096, 32000)))}
# The products that share an input, (K, (N, ...)), one K5 launch at 1-2
# rows: q/k/v and gate/up, and their tp 2 and 4 ranks' column shards.
K5_GROUPS = {"qkv": (4096, (4096,) * 3), "gate_up": (4096, (11008,) * 2),
             **{f"tp{tp} qkv": (4096, (4096 // tp,) * 3) for tp in (2, 4)},
             **{f"tp{tp} gate_up": (4096, (11008 // tp,) * 2)
                for tp in (2, 4)}}
K5_ROWS = (1, 2, 3, 4, 8)
K5_CHECKED_ROWS = range(1, 9)  # every row count K5 takes, checked untimed
K5_TP_ROWS = (1, 8)  # the tp shards are timed at a request's and the pool's
K5_LAYERS = 32  # weight copies cycled through, so each launch is cold in L2


def _k5_per_step(params, rows):
    """K5 launches in one decode step of ``rows`` rows (at most 8) of
    ``params``: one a layer for each int8 linear, one for an int8 lm_head;
    at 1-2 rows a layer's int8 q/k/v are one launch, and so are its
    gate/up (``routed_lora_matmul_group``)."""
    from modelcompose_tpu_torch.ops.quant import K5_GROUP_ROWS, is_quantized
    layers = params["layers"]
    per_layer = sum(is_quantized(p["w"]) for grp in ("attn", "mlp")
                    for p in layers[grp].values())
    if rows <= K5_GROUP_ROWS:
        for grp, names in (("attn", ("q", "k", "v")), ("mlp", ("gate", "up"))):
            if all(is_quantized(layers[grp][n]["w"]) for n in names):
                per_layer -= len(names) - 1
    return per_layer * layers["input_layernorm"].shape[0] \
        + int(is_quantized(params["lm_head"]))


def _fused_per_step(params, rows, routed=False, in_k5=True):
    """K8-K10 launches in one decode step of ``rows`` rows of ``params``
    (bf16 or fp16 activations, head_dim 128), by counter: at 1-2 rows each
    norm that a grouped int8 K5 launch reads runs in its prologue
    (``norm_matmul_group``) and, with no adapter branch (``routed`` False:
    the dense fold), RoPE and the cache write in the q/k/v launch's
    epilogue (``norm_qkv_rope``); K8 alone then only for the final norm
    (65, 32, 32 for Vicuna-7B at 3-8 rows, or with ``in_k5`` False; 1, 0,
    0 with 32 + 32 + 32 fused launches at 1-2).  The SiLU product runs in
    the prologue of the int8 down product's K5 launch (``silu_matmul``)
    where K5 streams that product (``decode_fused._silu_streams``: 1-2
    rows of Vicuna-7B's down product), else K10 once a layer."""
    from modelcompose_tpu_torch.ops.decode_fused import _silu_streams
    from modelcompose_tpu_torch.ops.quant import K5_GROUP_ROWS, is_quantized
    layers = params["layers"]
    n = layers["input_layernorm"].shape[0]

    def grouped(grp, names):
        return in_k5 and rows <= K5_GROUP_ROWS and all(
            is_quantized(layers[grp][k]["w"]) for k in names)
    qkv, gate_up = grouped("attn", ("q", "k", "v")), grouped("mlp", ("gate",
                                                                     "up"))
    rope = qkv and not routed
    w = layers["mlp"]["down"]["w"]
    down = in_k5 and is_quantized(w) and _silu_streams(rows,
                                                       *w["q"].shape[-2:])
    return {"add_rms_norm": 1 + n * ((not qkv) + (not gate_up)),
            "rope_kv_write": 0 if rope else n,
            "silu_mul": 0 if down else n,
            "norm_matmul_group": n * ((qkv and not rope) + gate_up),
            "norm_qkv_rope": n if rope else 0,
            "silu_matmul": n if down else 0}


def _k6_per_forward(params):
    """K6 launches in one prefill or chunk forward of ``params`` (more than
    8 rows): one for each int8 linear of every layer (224 for the 32-layer
    int8 Vicuna-7B); the last position's lm_head is K5's (B rows)."""
    from modelcompose_tpu_torch.ops.quant import is_quantized
    layers = params["layers"]
    return sum(is_quantized(p["w"]) for grp in ("attn", "mlp")
               for p in layers[grp].values()) \
        * layers["input_layernorm"].shape[0]


def _k5_case(gen, weights, M, K, N, timed=True):
    """K5 against its plain version on ``weights[0]`` at M rows (a bf16 and
    an fp32 result); with ``timed``, the fp32-result product (what the
    decode path asks for) timed by CUDA-graph replay cycling over the
    weight copies, the plain version the same way, the library call
    ``torch._weight_int8pack_mm`` (bf16 scales and result, an [N, K]
    copy made outside the timing) or its error text, and the bound."""
    import itertools
    import torch
    from modelcompose_tpu_torch.ops.quant import (dequant_matmul,
                                                  dequant_matmul_reference)
    x = torch.randn((M, 1, K), generator=gen, device=weights[0]["q"].device
                    ).to(torch.bfloat16)
    errs, rels = [], []
    for out, tol in ((None, ATTN_TOL), (torch.float32, K5_F32_TOL)):
        got = dequant_matmul(x, weights[0], out_dtype=out)
        want = dequant_matmul_reference(x, weights[0], out_dtype=out)
        err, rel = _rel_err(got, want)
        if not (got.dtype == want.dtype and rel <= tol):
            raise AssertionError(f"K5 M{M} K{K} N{N} {got.dtype}: rel err "
                                 f"{rel:.3g} (tol {tol})")
        errs.append(err)
        rels.append(rel)
    res = {"M": M, "K": K, "N": N, "max_abs_err": max(errs),
           "rel_err_bf16": rels[0], "rel_err_f32": rels[1]}
    if not timed:
        return res
    n = len(weights)

    def cycled(fn):
        layers = itertools.cycle(range(n))
        return graph_time_ms(lambda: fn(weights[next(layers)]), n=n)
    ms = cycled(lambda w: dequant_matmul(x, w, out_dtype=torch.float32))
    plain_ms = cycled(lambda w: dequant_matmul_reference(
        x, w, out_dtype=torch.float32))
    x2 = x.reshape(M, K)
    try:
        packed = [(w["q"].t().contiguous(),
                   w["scale"].reshape(N).to(torch.bfloat16)) for w in weights]
        torch._weight_int8pack_mm(x2, *packed[0])
        torch.cuda.synchronize()
        layers = itertools.cycle(range(n))
        library_ms = graph_time_ms(lambda: torch._weight_int8pack_mm(
            x2, *packed[next(layers)]), n=n)
        library_error = None
    except (RuntimeError, NotImplementedError) as e:
        library_ms, library_error = None, repr(e)[:200]
    packed = None
    nbytes = K * N + 4 * N + 2 * M * K + 4 * M * N
    bound_ms, bound_by = bound(2 * M * K * N, nbytes)
    res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               library_error=library_error, bound_ms=bound_ms,
               bound_by=bound_by,
               share_of_bound=None if ms is None else bound_ms / ms)
    return res


def _k5_group_case(gen, members, M, K, Ns, timed=True):
    """One grouped K5 launch (the weights of ``members``, each a list of
    weight copies, sharing x at M rows) against each member's plain
    product (bf16 and fp32 results; one launch counted); with ``timed``,
    the fp32-result grouped launch, the members launched one by one and
    their plain products, each by CUDA-graph replay cycling over the
    copies, and the bound of the group's bytes."""
    import itertools
    import torch
    from modelcompose_tpu_torch.ops.quant import (dequant_matmul,
                                                  dequant_matmul_group,
                                                  dequant_matmul_reference)
    x = torch.randn((M, 1, K), generator=gen,
                    device=members[0][0]["q"].device).to(torch.bfloat16)
    errs, rels = [], []
    for out, tol in ((None, ATTN_TOL), (torch.float32, K5_F32_TOL)):
        n = dequant_matmul.launches
        got = dequant_matmul_group(x, [c[0] for c in members], out_dtype=out)
        if dequant_matmul.launches != n + 1:
            raise AssertionError(f"K5 group M{M} K{K} N{Ns}: "
                                 f"{dequant_matmul.launches - n} launches")
        for y, copies in zip(got, members):
            want = dequant_matmul_reference(x, copies[0], out_dtype=out)
            err, rel = _rel_err(y, want)
            if not (y.dtype == want.dtype and rel <= tol):
                raise AssertionError(f"K5 group M{M} K{K} N{Ns} {y.dtype}: "
                                     f"rel err {rel:.3g} (tol {tol})")
            errs.append(err)
            rels.append(rel)
    res = {"M": M, "K": K, "N": list(Ns), "max_abs_err": max(errs),
           "rel_err": max(rels)}
    if not timed:
        return res
    n = len(members[0])
    f32 = torch.float32

    def cycled(fn):
        layers = itertools.cycle(range(n))
        return graph_time_ms(lambda: fn(next(layers)), n=n)
    res["ms"] = cycled(lambda i: dequant_matmul_group(
        x, [c[i] for c in members], out_dtype=f32))
    res["one_by_one_ms"] = cycled(lambda i: [dequant_matmul(
        x, c[i], out_dtype=f32) for c in members])
    res["plain_ms"] = cycled(lambda i: [dequant_matmul_reference(
        x, c[i], out_dtype=f32) for c in members])
    nbytes = sum(K * N + 4 * N + 4 * M * N for N in Ns) + 2 * M * K
    res["bound_ms"], res["bound_by"] = bound(2 * M * K * sum(Ns), nbytes)
    return res


def phase_k5(device, gen):
    """K5 against its plain version at every main-path shape and tp shard
    at every row count 1-8 (bf16 and fp32 results), with each shape's grid
    (rows a block, splits, 64-column tiles) printed; timed at the
    Vicuna-7B shapes at 1, 2, 3, 4 and 8 rows and at the tp shards at 1 and
    8; the sum over one decode step's products at each timed row count
    beside its bound."""
    import torch
    from modelcompose_tpu_torch.ops import quant
    cases, tp_cases, errs = [], [], []
    for table, rows, out in ((K5_SHAPES, K5_ROWS, cases),
                             (K5_TP_SHAPES, K5_TP_ROWS, tp_cases)):
        for name, (K, N) in table.items():
            weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                           device=device, dtype=torch.int8),
                        "scale": torch.rand((1, N), generator=gen,
                                            device=device) * 1e-3 + 1e-4}
                       for _ in range(K5_LAYERS)]
            log("K5", shape=name, K=K, N=N, grid=json.dumps(
                {M: dict(zip(("tile", "rows", "splits", "tiles"),
                             quant._k5_plan(M, K, N)))
                 for M in K5_CHECKED_ROWS}))
            for M in K5_CHECKED_ROWS:
                res = dict(_k5_case(gen, weights, M, K, N,
                                    timed=M in rows), shape=name)
                errs.append(res["max_abs_err"])
                if "ms" in res:
                    out.append(res)
                    log("K5", shape=name, M=M, K=K, N=N,
                        max_abs_err=f"{res['max_abs_err']:.4g}",
                        rel_err_bf16=f"{res['rel_err_bf16']:.3g}",
                        rel_err_f32=f"{res['rel_err_f32']:.3g}",
                        graph_ms=_ms(res["ms"]),
                        plain_graph_ms=_ms(res["plain_ms"]),
                        library_graph_ms=_ms(res["library_ms"]),
                        bound_ms=f"{res['bound_ms']:.4f}",
                        share_of_bound=_ms(res["share_of_bound"]),
                        library_error=res["library_error"])
            del weights
            torch.cuda.empty_cache()
    # the products of one input, one launch at 1-2 rows: checked at every
    # shard, the Vicuna-7B q/k/v and gate/up timed
    groups = []
    for name, (K, Ns) in K5_GROUPS.items():
        members = [[{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                        device=device, dtype=torch.int8),
                     "scale": torch.rand((1, N), generator=gen,
                                         device=device) * 1e-3 + 1e-4}
                    for _ in range(K5_LAYERS)] for N in Ns]
        for M in range(1, quant.K5_GROUP_ROWS + 1):
            res = dict(_k5_group_case(gen, members, M, K, Ns,
                                      timed=name in ("qkv", "gate_up")),
                       shape=name, grid=dict(zip(
                           ("tile", "rows", "splits", "tiles"),
                           quant._k5_group_plan(M, K, Ns))))
            errs.append(res["max_abs_err"])
            groups.append(res)
            log("K5", group=name, M=M, K=K, N=json.dumps(list(Ns)),
                grid=json.dumps(res["grid"]),
                max_abs_err=f"{res['max_abs_err']:.4g}",
                rel_err=f"{res['rel_err']:.3g}",
                **({k: _ms(res[k]) for k in ("ms", "one_by_one_ms",
                                             "plain_ms", "bound_ms")}
                   if "ms" in res else {}))
        del members
        torch.cuda.empty_cache()
    # one decode step of the 32-layer model at M rows: 32 x (4 qkvo, 2
    # gate/up, 1 down) + the lm_head, one launch a product (225); at 1-2
    # rows q/k/v and gate/up one launch each: 32 x 4 + 1 (129)
    per_step = {"qkvo": 4 * 32, "gate_up": 2 * 32, "down": 32, "lm_head": 1}
    grouped_step = {"group qkv": 32, "qkvo": 32, "group gate_up": 32,
                    "down": 32, "lm_head": 1}
    step = {}
    for M in K5_ROWS:
        rows = {c["shape"]: c for c in cases if c["M"] == M}
        rows.update({"group " + g["shape"]: g for g in groups
                     if g["M"] == M and "ms" in g})
        if not all(rows[s]["ms"] is not None for s in per_step):
            continue
        step[M] = {k: sum(n * rows[s][k] for s, n in per_step.items())
                   for k in ("ms", "plain_ms", "bound_ms")}
        step[M]["launches"] = 225
        if M <= quant.K5_GROUP_ROWS and all(
                rows[s]["ms"] is not None for s in grouped_step):
            step[M]["one_by_one_ms"] = step[M]["ms"]
            step[M]["ms"] = sum(n * rows[s]["ms"]
                                for s, n in grouped_step.items())
            step[M]["launches"] = 129
    log("K5", checked=len(errs), step_sum_ms=json.dumps(
        {m: {k: round(v, 4) for k, v in s.items()} for m, s in step.items()}))
    first = cases[0]  # q/k/v/o at one row: the row's own keys
    return dict({k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                       "library_error", "bound_ms",
                                       "bound_by", "share_of_bound")},
                max_abs_err=max(errs), shape="M1 K4096 N4096 fp32 out, "
                "cold (32 weights cycled), CUDA graph replay",
                shapes=cases, tp_shards=tp_cases, groups=groups,
                checked=len(errs), step=step)


# K6 at the main path's shapes above 8 rows: every Vicuna-7B product and
# tp shard checked at K6_CHECKED_ROWS (a 9-row product, a tail chunk, a
# chunk, the vision pair's 2,048, MCUB-4's bucket); the seven products of a
# layer timed at a chunk, the vision pair and MCUB-4, the tp 2 / 4 shards
# of a layer at MCUB-4's bucket.
K6_SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
             "down": (11008, 4096), "lm_head": (4096, 32000)}
K6_CHECKED_ROWS = (9, 256, 512, 2048, 3328)
K6_ROWS = (512, 2048, 3328)
K6_TP_ROWS = (3328,)
K6_COPIES = 4  # weight copies cycled through: more bytes than L2 holds
# a layer's products: q/k/v/o, gate/up, down (the step sums)
K6_LAYER = {"qkvo": 4, "gate_up": 2, "down": 1}


def _k6_case(gen, weights, M, K, N, timed=True):
    """K6 against its plain version on ``weights[0]`` at M rows (a bf16 and
    an fp32 result, each one K6 launch and no K5 launch); with ``timed``,
    the fp32-result product (what routed LoRA asks for) timed by CUDA-graph
    replay cycling over the weight copies, beside the plain route (the
    convert, the fp32-output GEMM and the scale pass: what ran before),
    ``torch.mm`` on bf16 copies of the weights made beforehand
    (``library_ms``: the GEMM without the copy, never called by the port),
    ``torch._weight_int8pack_mm`` (bf16 scales, an [N, K] copy; or its
    error text; a kernel for a few rows, tens of ms a call at these sizes,
    so timed by CUDA events over 2 calls) and the bound."""
    import itertools
    import torch
    from modelcompose_tpu_torch.ops.quant import (_k6_active, _k6_plan,
                                                  dequant_matmul,
                                                  dequant_matmul_reference,
                                                  w8a16_gemm)
    x = torch.randn((M, K), generator=gen, device=weights[0]["q"].device
                    ).to(torch.bfloat16)
    errs, rels = [], []
    for out, tol in ((None, ATTN_TOL), (torch.float32, K5_F32_TOL)):
        n5, n6 = dequant_matmul.launches, w8a16_gemm.launches
        got = dequant_matmul(x, weights[0], out_dtype=out)
        if (dequant_matmul.launches - n5, w8a16_gemm.launches - n6) != (0, 1):
            raise AssertionError(f"K6 M{M} K{K} N{N}: not one K6 launch")
        want = dequant_matmul_reference(x, weights[0], out_dtype=out)
        err, rel = _rel_err(got, want)
        if not (got.dtype == want.dtype and rel <= tol):
            raise AssertionError(f"K6 M{M} K{K} N{N} {got.dtype}: rel err "
                                 f"{rel:.3g} (tol {tol})")
        errs.append(err)
        rels.append(rel)
    plan = _k6_plan(M, K, N, _k6_active(x.device))
    res = {"M": M, "K": K, "N": N, "rows": plan.rows, "split": plan.split,
           "max_abs_err": max(errs), "rel_err_bf16": rels[0],
           "rel_err_f32": rels[1]}
    if not timed:
        return res
    n = len(weights)

    def cycled(fn, ws):
        layers = itertools.cycle(range(n))
        return graph_time_ms(lambda: fn(ws[next(layers)]), n=n)
    f32 = torch.float32
    res["ms"] = cycled(lambda w: dequant_matmul(x, w, out_dtype=f32),
                       weights)
    res["plain_ms"] = cycled(lambda w: dequant_matmul_reference(
        x, w, out_dtype=f32), weights)
    dense = [w["q"].to(torch.bfloat16) for w in weights]
    res["library_ms"] = cycled(lambda w: torch.mm(x, w, out_dtype=f32),
                               dense)
    dense = None
    try:
        packed = (weights[0]["q"].t().contiguous(),
                  weights[0]["scale"].reshape(N).to(torch.bfloat16))
        res["int8pack_ms"] = cuda_time_ms(
            lambda: torch._weight_int8pack_mm(x, *packed), 2)
        res["int8pack_error"] = None
    except (RuntimeError, NotImplementedError) as e:
        res["int8pack_ms"], res["int8pack_error"] = None, repr(e)[:200]
    packed = None
    nbytes = K * N + 4 * N + 2 * M * K + 4 * M * N
    res["bound_ms"], res["bound_by"] = bound(2 * M * K * N, nbytes)
    res["share_of_bound"] = None if res["ms"] is None \
        else res["bound_ms"] / res["ms"]
    return res


def _k6_schedule_row(M, K, N, active):
    """K6's schedule at one shape on the card's clusters: the block's rows,
    the split, the clusters launched (of ``active`` for that block and
    split), the whole-tile units and the split units (``split`` a split
    tile)."""
    from modelcompose_tpu_torch.ops.quant import _k6_plan
    plan = _k6_plan(M, K, N, active)
    tiles = plan.m_tiles * plan.n_tiles
    return {"rows": plan.rows, "split": plan.split,
            "clusters": plan.clusters,
            "active": active[plan.rows, plan.split], "whole": plan.whole,
            "split_units": (tiles - plan.whole) * plan.split}


def phase_k6(device, gen):
    """K6 against its plain version at every main-path shape and tp shard at
    K6_CHECKED_ROWS (bf16 and fp32 results), with the card's active
    clusters and each shape's schedule printed (``_k6_schedule_row``); the
    seven products of a layer timed at K6_ROWS and the tp
    shards' at K6_TP_ROWS, each beside its plain route, ``torch.mm`` on a
    bf16 copy, ``torch._weight_int8pack_mm`` and its bound; the sums over
    a layer and over a 32-layer prefill at each timed row count."""
    import torch
    from modelcompose_tpu_torch.ops import quant
    active = quant._k6_active(torch.device(device))
    log("K6", active_clusters=json.dumps(
        {f"{rows}x{split}": n for (rows, split), n in sorted(active.items())}))
    cases, tp_cases, errs = [], [], []
    tp_shapes = {k: v for k, v in K5_TP_SHAPES.items()
                 if not k.endswith("lm_head")}
    for table, rows, out in ((K6_SHAPES, K6_ROWS, cases),
                             (K5_TP_SHAPES, K6_TP_ROWS, tp_cases)):
        for name, (K, N) in table.items():
            timed_rows = rows if name in K6_LAYER or name in tp_shapes \
                else ()
            weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                           device=device, dtype=torch.int8),
                        "scale": torch.rand((1, N), generator=gen,
                                            device=device) * 1e-3 + 1e-4}
                       for _ in range(K6_COPIES if timed_rows else 1)]
            log("K6", shape=name, K=K, N=N, schedule=json.dumps(
                {M: _k6_schedule_row(M, K, N, active)
                 for M in K6_CHECKED_ROWS}))
            for M in K6_CHECKED_ROWS:
                res = dict(_k6_case(gen, weights, M, K, N,
                                    timed=M in timed_rows), shape=name)
                errs.append(res["max_abs_err"])
                if "ms" in res:
                    out.append(res)
                    log("K6", shape=name, M=M, K=K, N=N, rows=res["rows"],
                        split=res["split"],
                        max_abs_err=f"{res['max_abs_err']:.4g}",
                        rel_err_bf16=f"{res['rel_err_bf16']:.3g}",
                        rel_err_f32=f"{res['rel_err_f32']:.3g}",
                        graph_ms=_ms(res["ms"]),
                        plain_graph_ms=_ms(res["plain_ms"]),
                        library_graph_ms=_ms(res["library_ms"]),
                        int8pack_ms=_ms(res["int8pack_ms"]),
                        bound_ms=f"{res['bound_ms']:.4f}",
                        share_of_bound=_ms(res["share_of_bound"]),
                        int8pack_error=res["int8pack_error"])
            del weights
            torch.cuda.empty_cache()
    # a layer's seven products and a 32-layer prefill's 224 at each row count
    step = {}
    for M in K6_ROWS:
        rows = {c["shape"]: c for c in cases if c["M"] == M}
        if not all(rows[s][k] is not None for s in K6_LAYER
                   for k in ("ms", "plain_ms", "library_ms")):
            continue
        layer = {k: sum(n * rows[s][k] for s, n in K6_LAYER.items())
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        step[M] = {"layer": layer, "prefill_32_layers": {
            k: 32 * v for k, v in layer.items()}, "launches": 224}
    log("K6", checked=len(errs), step_sum_ms=json.dumps(
        {m: {k: round(v, 4) for k, v in s["layer"].items()}
         for m, s in step.items()}))
    first = next(c for c in cases
                 if c["shape"] == "qkvo" and c["M"] == max(K6_ROWS))
    return dict({k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                       "int8pack_ms", "int8pack_error",
                                       "bound_ms", "bound_by",
                                       "share_of_bound")},
                max_abs_err=max(errs), shape="M3328 K4096 N4096 fp32 out "
                "(q/k/v/o at MCUB-4's bucket), 4 weights cycled, CUDA graph "
                "replay", shapes=cases, tp_shards=tp_cases,
                checked=len(errs), step=step)


# K7's products: dx [M, K] = (g [M, N] * scale) @ q [K, N]^T for the
# forward's q [K, N] of q/k/v/o, gate/up and down, at the DAMC recipes'
# B=4 x 2,048 and the QLoRA recipe's B=16 x 2,048 rows; the lm_head's at a
# 256-position loss chunk of those batches (1,024 and 4,096 rows)
K7_SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
             "down": (11008, 4096)}
K7_ROWS = (8192, 32768)
K7_LM_HEAD = (4096, 32000)
K7_LM_HEAD_ROWS = (1024, 4096)
K7_CHUNKS = 8  # loss chunks of 256 in a 2,048 bucket
K7_COPIES = 4  # weight copies cycled through: more bytes than L2 holds


def _k7_case(gen, weights, M, K, N, timed=True):
    """K7 against its plain version on ``weights[0]`` for an fp32
    cotangent g [M, N] (the routed products' and the logits'), bf16 dx,
    one K7 launch, and its first pass alone bit-equal to the plain
    scaled cotangent (``_scale_cotangent``); with ``timed``, K7 timed by
    CUDA-graph replay cycling over the weight copies, each pass alone the
    same way (pass 1 over the copies' scales, pass 2 on one gs), beside
    the plain route (the fp32 scaled cotangent, its bf16 copy, the bf16
    copy of q, cuBLAS into fp32 and the cast: what ran before), ``torch.mm``
    on bf16 copies of the scaled cotangent and of q^T made beforehand
    (``library_ms``: the GEMM alone, never called by the port), and the
    bounds of K7 and of each pass."""
    import itertools
    import torch
    from modelcompose_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    g = torch.randn((M, N), generator=gen, device=weights[0]["q"].device)
    n7 = quant.w8a16_dx.launches
    got = quant.w8a16_dx(g, weights[0], bf16)
    if quant.w8a16_dx.launches - n7 != 1:
        raise AssertionError(f"K7 M{M} K{K} N{N}: not one K7 launch")
    want = quant._dequant_matmul_dx(g, weights[0]["q"],
                                    weights[0]["scale"], bf16)
    err, rel = _rel_err(got, want)
    if not (got.dtype == want.dtype and rel <= ATTN_TOL):
        raise AssertionError(f"K7 M{M} K{K} N{N}: rel err {rel:.3g} (tol "
                             f"{ATTN_TOL})")
    gs = quant._k7_scale(g, weights[0]["scale"], bf16)
    if not torch.equal(gs, quant._scale_cotangent(g, weights[0]["scale"],
                                                  bf16)):
        raise AssertionError(f"K7 M{M} K{K} N{N}: pass 1 differs from "
                             "_scale_cotangent")
    res = {"M": M, "K": K, "N": N, "rows": quant._k7_plan(M, K, N)[0],
           "max_abs_err": err, "rel_err": rel,
           "bit_equal_to_plain": bool(torch.equal(got, want)),
           "pass1_bit_equal": True}
    if not timed:
        return res
    n = len(weights)

    def cycled(fn, ws):
        layers = itertools.cycle(range(n))
        return graph_time_ms(lambda: fn(ws[next(layers)]), n=n)
    res["ms"] = cycled(lambda w: quant.w8a16_dx(g, w, bf16), weights)
    res["pass1_ms"] = cycled(lambda w: quant._k7_scale(g, w["scale"], bf16),
                             weights)
    res["pass2_ms"] = cycled(lambda w: quant._k7_product(gs, w["q"]),
                             weights)
    res["passes_sum_ms"] = None if None in (res["pass1_ms"],
                                            res["pass2_ms"]) \
        else res["pass1_ms"] + res["pass2_ms"]
    res["plain_ms"] = cycled(lambda w: quant._dequant_matmul_dx(
        g, w["q"], w["scale"], bf16), weights)
    pairs = [((g * w["scale"].reshape(-1)).to(bf16),
              w["q"].to(bf16).t().contiguous()) for w in weights]
    res["library_ms"] = cycled(lambda pair: torch.mm(*pair), pairs)
    pairs = None
    nbytes = 4 * M * N + K * N + 4 * N + 2 * M * K
    res["bound_ms"], res["bound_by"] = bound(2 * M * K * N, nbytes)
    res["pass1_bound_ms"] = bound(0, 6 * M * N + 4 * N)[0]
    res["pass2_bound_ms"] = bound(2 * M * K * N, 2 * M * N + K * N
                                  + 2 * M * K)[0]
    res["share_of_bound"] = None if res["ms"] is None \
        else res["bound_ms"] / res["ms"]
    return res


def phase_k7(device, gen):
    """K7 against its plain version at every dL/dx shape of the int8-base
    train step (q/k/v/o, gate/up, down at K7_ROWS; the lm_head at
    K7_LM_HEAD_ROWS), its first pass bit-equal to the plain scaled
    cotangent, each timed whole and pass by pass with its plain route,
    ``torch.mm`` on bf16 copies made beforehand and its bound, with the
    product's block; the sums over a layer's seven products and a
    32-layer step's 224 + K7_CHUNKS lm_head chunks at B=4 and B=16."""
    import torch
    from modelcompose_tpu_torch.ops import quant
    cases, errs = [], []
    table = [(name, K, N, M) for M in K7_ROWS
             for name, (K, N) in K7_SHAPES.items()]
    table += [("lm_head", *K7_LM_HEAD, M) for M in K7_LM_HEAD_ROWS]
    weights = {}
    for name, K, N, M in table:
        if name not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[name] = [
                {"q": torch.randint(-127, 128, (K, N), generator=gen,
                                    device=device, dtype=torch.int8),
                 "scale": torch.rand((1, N), generator=gen, device=device)
                 * 1e-3 + 1e-4} for _ in range(K7_COPIES)]
        res = dict(_k7_case(gen, weights[name], M, K, N), shape=name)
        errs.append(res["max_abs_err"])
        cases.append(res)
        log("K7", shape=name, M=M, K=K, N=N,
            grid=json.dumps(dict(zip(("rows", "m_tiles", "k_tiles", "group"),
                                     quant._k7_plan(M, K, N)))),
            max_abs_err=f"{res['max_abs_err']:.4g}",
            rel_err=f"{res['rel_err']:.3g}",
            bit_equal_to_plain=res["bit_equal_to_plain"],
            pass1_bit_equal=res["pass1_bit_equal"],
            graph_ms=_ms(res["ms"]), pass1_graph_ms=_ms(res["pass1_ms"]),
            pass2_graph_ms=_ms(res["pass2_ms"]),
            passes_sum_ms=_ms(res["passes_sum_ms"]),
            plain_graph_ms=_ms(res["plain_ms"]),
            library_graph_ms=_ms(res["library_ms"]),
            bound_ms=f"{res['bound_ms']:.4f}",
            pass1_bound_ms=f"{res['pass1_bound_ms']:.4f}",
            pass2_bound_ms=f"{res['pass2_bound_ms']:.4f}",
            share_of_bound=_ms(res["share_of_bound"]))
    weights.clear()
    torch.cuda.empty_cache()
    # a layer's seven dx products and a 32-layer step's at B=4 and B=16
    step = {}
    keys = ("ms", "pass1_ms", "pass2_ms", "plain_ms", "library_ms",
            "bound_ms")
    for M, M_head in zip(K7_ROWS, K7_LM_HEAD_ROWS):
        rows = {c["shape"]: c for c in cases
                if c["M"] == (M_head if c["shape"] == "lm_head" else M)}
        if not all(rows[s][k] is not None for s in rows for k in keys):
            continue
        layer = {k: sum(n * rows[s][k] for s, n in K6_LAYER.items())
                 for k in keys}
        step[M] = {"layer": layer, "step_32_layers": {
            k: 32 * layer[k] + K7_CHUNKS * rows["lm_head"][k] for k in keys},
            "launches": 7 * 32 + K7_CHUNKS}
    log("K7", checked=len(errs), step_sum_ms=json.dumps(
        {m: {k: round(v, 4) for k, v in s["step_32_layers"].items()}
         for m, s in step.items()}))
    first = next(c for c in cases
                 if c["shape"] == "qkvo" and c["M"] == K7_ROWS[0])
    return dict({k: first[k] for k in ("ms", "pass1_ms", "pass2_ms",
                                       "passes_sum_ms", "rows", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by",
                                       "share_of_bound")},
                max_abs_err=max(errs), shape="M8192 K4096 N4096 fp32 g, "
                "bf16 dx (q/k/v/o's dL/dx at B=4 x 2,048), 4 weights "
                "cycled, CUDA graph replay", shapes=cases, step=step)


# The decode layer's fused passes at the MCUB-4 decode shapes: a request's
# one row and the slot pool's eight, hidden 4,096, 32 heads of 128 (and the
# tp 2 / tp 4 ranks' 16 and 8, intermediate 5,504 and 2,752), caches of
# 3,360 positions (the composed request's length) with a position a row.
FUSED_ROWS = (1, 8)
FUSED_HIDDEN = 4096
FUSED_HEADS = {"mcub4": 32, "tp2": 16, "tp4": 8}
FUSED_INTER = {"mcub4": 11008, "tp2": 5504, "tp4": 2752}
FUSED_HEAD_DIM = 128
FUSED_CACHE_LEN = 3360
FUSED_LAYERS = 2  # K9 writes one slot a row: the cache's depth is not read


def _ulps(got, want):
    """The largest distance in units in the last place between two half
    tensors (their 16-bit patterns on a monotone line)."""
    import torch

    def line(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(got) - line(want)).abs().max().item()


def _fused_timed(res, fn, plain, nbytes, flops):
    """``res`` with the kernel's and the plain version's time (CUDA-graph
    replay of 20 calls) and the bound: the bytes at 3.35 TB/s or the fp32
    operations at 67 TFLOP/s (``bound_by``).  No one PyTorch call computes
    any of the three functions, so ``library_ms`` is null."""
    res.update(ms=graph_time_ms(fn), plain_ms=graph_time_ms(plain),
               library_ms=None)
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes, PEAK_FP32_FLOPS)
    res["share_of_bound"] = None if res["ms"] is None \
        else res["bound_ms"] / res["ms"]
    return res


# K8 and K9 inside K5's streaming launch at 1-2 rows: (member N..., the
# RoPE epilogue's head_dim or None) of the groups whose input is a norm's
# output, with K = 4,096 (the hidden width): Vicuna-7B's q/k/v (K8 + K9)
# and gate/up (K8) and the tp 2 / tp 4 ranks' column shards, and the
# lm_head (the final norm, one member: what folding it would cost).
FUSED_K5 = {"qkv": ((4096,) * 3, 128), "tp2 qkv": ((2048,) * 3, 128),
            "tp4 qkv": ((1024,) * 3, 128), "gate_up": ((11008,) * 2, None),
            "tp2 gate_up": ((5504,) * 2, None),
            "tp4 gate_up": ((2752,) * 2, None), "lm_head": ((32000,), None)}
FUSED_K5_ROWS = (1, 2)
FUSED_K5_COPIES = 8  # weight copies cycled: each launch finds them cold


def _fused_k5_case(device, gen, name, M, int8=True):
    """One fused launch (``norm_qkv_rope`` for a group with a head_dim,
    else ``norm_matmul_group``; x, the residual and a random norm weight;
    the q/k/v's outputs in bf16, gate/up's in bf16, the lm_head's fp32)
    against K8, K5 and K9 launched in turn on the same inputs: s, every
    output and the whole caches bit-equal; against its plain version
    within ATTN_TOL of max |plain| (K8's normed values may differ from the
    plain rms_norm's by one ulp, and the products sum in another order;
    int8 cache values within one step).  Timed by CUDA-graph replay over
    ``FUSED_K5_COPIES`` weight copies: the fused launch, the unfused chain
    in one graph and each of its launches alone, and the plain version;
    the bound from the bytes the fused launch must move."""
    import itertools
    import torch
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.core.llama import KVCache
    from modelcompose_tpu_torch.ops import decode_fused as df
    from modelcompose_tpu_torch.ops import quant
    from modelcompose_tpu_torch.ops.rope import rope_tables
    bf = torch.bfloat16
    Ns, D = FUSED_K5[name]
    K = FUSED_HIDDEN
    out = torch.float32 if name == "lm_head" else bf

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(bf)
    x, y = rnd(M, 1, K, scale=3.0), rnd(M, 1, K, scale=3.0)
    w = rnd(K, scale=0.1) + 1
    copies = [[{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                   device=device, dtype=torch.int8),
                "scale": torch.rand((1, N), generator=gen, device=device)
                * 1e-3 + 1e-4} for N in Ns] for _ in range(FUSED_K5_COPIES)]
    caches = rope = None
    if D:
        Hkv = Ns[1] // D
        cfg = ModelConfig(hidden_size=Ns[0], num_attention_heads=Ns[0] // D,
                          num_key_value_heads=Hkv,
                          num_hidden_layers=FUSED_LAYERS, dtype="bfloat16")
        caches = [KVCache.zeros(cfg, M, FUSED_CACHE_LEN, quantized=int8,
                                device=device) for _ in range(3)]
        pos = torch.randperm(FUSED_CACHE_LEN, generator=gen,
                             device=device)[:M].to(torch.int32)
        cos, sin = rope_tables(pos[:, None], D)
        rope = [df.RopeWrite(cos, sin, c.k, c.v, 1, pos) for c in caches]

    def fused(ws):
        if D:
            return df.norm_qkv_rope(x, y, w, 1e-5, ws, rope[0])
        s, _, outs = df.norm_matmul_group(x, y, w, 1e-5, ws, out)
        return [s] + outs

    def products(h, ws):
        return [quant.dequant_matmul(h, ws[0], out_dtype=out)] \
            if len(ws) == 1 else quant.dequant_matmul_group(h, ws,
                                                            out_dtype=out)

    def chain(ws):
        s, h = df.add_rms_norm(x, y, w, 1e-5)
        outs = products(h, ws)
        if D:
            return s, df.rotate_and_write(outs, rope[1], df.rope_kv_write)
        return [s] + outs

    def plain(ws):
        s, _, outs = df.norm_matmul_group_reference(
            x, y, w, 1e-5, ws, out, rope[2] if D else None)
        return [s] + outs
    before = (df.norm_matmul_group.launches, df.norm_qkv_rope.launches)
    got = fused(copies[0])
    counted = (df.norm_matmul_group.launches - before[0],
               df.norm_qkv_rope.launches - before[1])
    if counted != ((0, 1) if D else (1, 0)):
        raise AssertionError(f"fused K5 {name} M{M}: launches {counted}")
    want = chain(copies[0])
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    if D:
        equal = equal and all(torch.equal(a, b) for a, b in zip(
            caches[0].tensors(), caches[1].tensors()))
    if not equal:
        raise AssertionError(f"fused K5 {name} M{M} int8 {int8}: differs "
                             f"from K8, K5 and K9 in turn")
    ref = plain(copies[0])
    err = rel = 0.0
    for a, b in zip(got, ref):
        e, r = _rel_err(a, b)
        err, rel = max(err, e), max(rel, r)
    if D and int8:
        steps = max((a.int() - b.int()).abs().max().item() for a, b in zip(
            (caches[0].k["q"], caches[0].v["q"]),
            (caches[2].k["q"], caches[2].v["q"])))
        if steps > 1:
            raise AssertionError(f"fused K5 {name} M{M}: int8 cache {steps} "
                                 f"steps from the plain version")
    if rel > ATTN_TOL:
        raise AssertionError(f"fused K5 {name} M{M}: rel err {rel:.3g} "
                             f"against the plain version")
    res = {"shape": name, "M": M, "K": K, "N": list(Ns),
           "form": "K8+K9 in K5" if D else "K8 in K5",
           "cache": ("int8" if int8 else "bf16") if D else None,
           "max_abs_err": err, "rel_err": rel, "chain_bit_equal": True}
    layers = itertools.cycle(range(FUSED_K5_COPIES))

    def cycled(fn):
        return graph_time_ms(lambda: fn(copies[next(layers)]),
                             n=FUSED_K5_COPIES)
    s0, h0 = df.add_rms_norm(x, y, w, 1e-5)
    res.update(ms=cycled(fused), chain_ms=cycled(chain),
               k8_ms=graph_time_ms(lambda: df.add_rms_norm(x, y, w, 1e-5)),
               k5_ms=cycled(lambda ws: products(h0, ws)),
               plain_ms=cycled(plain), library_ms=None)
    if D:
        qkv = products(h0, copies[0])
        res["k9_ms"] = graph_time_ms(lambda: df.rotate_and_write(
            qkv, rope[1], df.rope_kv_write))
    parts = [res[k] for k in ("k8_ms", "k5_ms", "k9_ms") if k in res]
    res["parts_sum_ms"] = None if None in parts else sum(parts)
    out_bytes = out.itemsize * M * sum(Ns)
    if D:
        Hkv = Ns[1] // D
        vec = M * Hkv * D
        out_bytes = 2 * M * Ns[0] + 2 * 4 * M * D + 4 * M + (
            2 * (vec + 4 * M * Hkv) if int8 else 2 * 2 * vec)
    nbytes = sum(K * N + 4 * N for N in Ns) + 2 * (3 * M * K + K) \
        + out_bytes
    res["bound_ms"], res["bound_by"] = bound(2 * M * K * sum(Ns), nbytes)
    res["share_of_bound"] = None if res["ms"] is None \
        else res["bound_ms"] / res["ms"]
    del copies, caches
    return res


def _silu_k5_case(device, gen, name, M, dtype="bfloat16"):
    """The down product with K10 in its K5 prologue (``silu_matmul``; gate
    and up of ``dtype`` [M, 1, I], I the ``FUSED_INTER`` width of ``name``,
    the weight [I, 4,096]) against K10 and then the streaming K5 on the
    same grid: h (written out) and the product bit-equal, in x's type and
    in fp32; against its plain version within ATTN_TOL.  Where K5 takes
    the product on the tensor cores (two rows of the tp 4 shard) the fused
    launch must refuse it, uncounted, and the case returns None.  Timed by
    CUDA-graph replay over ``FUSED_K5_COPIES`` weight copies: the fused
    launch, K10 -> K5 as the route without the fusion runs them
    (``dequant_matmul``'s own plan) in one graph and each alone, and the
    plain version; the bound from the bytes the fused launch moves."""
    import itertools
    import torch
    from modelcompose_tpu_torch.ops import decode_fused as df
    from modelcompose_tpu_torch.ops import quant
    dt = getattr(torch, dtype)
    K, N = FUSED_INTER[name], FUSED_HIDDEN
    gate = (torch.randn((M, 1, K), generator=gen, device=device) * 4).to(dt)
    up = torch.randn((M, 1, K), generator=gen, device=device).to(dt)
    copies = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                  device=device, dtype=torch.int8),
               "scale": torch.rand((1, N), generator=gen, device=device)
               * 1e-3 + 1e-4} for _ in range(FUSED_K5_COPIES)]
    if not df._silu_streams(M, K, N):
        before = (quant.dequant_matmul.launches, df.silu_matmul.launches)
        try:
            df.silu_matmul(gate, up, copies[0])
        except ValueError as e:
            if (quant.dequant_matmul.launches,
                    df.silu_matmul.launches) != before \
                    or df.silu_fuses(gate, copies[0]):
                raise AssertionError(f"K10 in K5 {name} M{M}: counted or "
                                     f"routed where it refuses") from e
            log("K10 in K5", shape=name, M=M, dtype=dtype,
                route="K10 then K5 on the tensor cores", refused=str(e))
            return None
        raise AssertionError(f"K10 in K5 {name} M{M}: the fused launch took "
                             f"a shape K5 runs on the tensor cores")
    for out in (dt, torch.float32):
        before = (df.silu_matmul.launches, df.silu_mul.launches)
        h, y = df.silu_matmul(gate, up, copies[0], out, keep_h=True)
        counted = (df.silu_matmul.launches - before[0],
                   df.silu_mul.launches - before[1])
        if counted != (1, 0):
            raise AssertionError(f"K10 in K5 {name} M{M}: launches {counted}")
        h_ref = df.silu_mul(gate, up)
        (y_ref,) = quant._k5(h_ref.view(M, K), [copies[0]], out)
        y_nokeep = df.silu_matmul(gate, up, copies[0], out)[1]
        if not (torch.equal(h, h_ref) and torch.equal(y.view(M, N), y_ref)
                and torch.equal(y_nokeep, y)):
            raise AssertionError(f"K10 in K5 {name} M{M} {dtype} out {out}: "
                                 f"differs from K10 and K5 in turn")
        h_plain, y_plain = df.silu_matmul_reference(gate, up, copies[0], out)
        err, rel = _rel_err(y, y_plain)
        if rel > (ATTN_TOL if out is dt else K5_F32_TOL) \
                or not torch.equal(h, h_plain):
            raise AssertionError(f"K10 in K5 {name} M{M} {dtype}: rel err "
                                 f"{rel:.3g} against the plain version")
    res = {"shape": name, "M": M, "K": K, "N": N, "dtype": dtype,
           "form": "K10 in K5", "max_abs_err": err, "rel_err": rel,
           "chain_bit_equal": True}
    layers = itertools.cycle(range(FUSED_K5_COPIES))

    def cycled(fn):
        return graph_time_ms(lambda: fn(copies[next(layers)]),
                             n=FUSED_K5_COPIES)

    def chain(ws):
        return quant.dequant_matmul(df.silu_mul(gate, up), ws, out_dtype=dt)
    h0 = df.silu_mul(gate, up)
    res.update(ms=cycled(lambda ws: df.silu_matmul(gate, up, ws)),
               chain_ms=cycled(chain),
               k10_ms=graph_time_ms(lambda: df.silu_mul(gate, up)),
               k5_ms=cycled(lambda ws: quant.dequant_matmul(h0, ws,
                                                            out_dtype=dt)),
               plain_ms=cycled(lambda ws: df.silu_matmul_reference(
                   gate, up, ws)), library_ms=None)
    parts = [res["k10_ms"], res["k5_ms"]]
    res["parts_sum_ms"] = None if None in parts else sum(parts)
    nbytes = K * N + 4 * N + 2 * 2 * M * K + 2 * M * N
    res["bound_ms"], res["bound_by"] = bound(2 * M * K * N, nbytes)
    res["share_of_bound"] = None if res["ms"] is None \
        else res["bound_ms"] / res["ms"]
    del copies
    return res


def phase_fused(device, gen):
    """K8, K9 and K10 against their plain versions at the MCUB-4 decode
    shapes (1 and 8 rows; the tp 2 and 4 ranks' heads and intermediate
    widths): K8's sum bit-equal and its normed output within one ulp (a
    weight of ones) or 2e-2 (a random weight), K9's rotated q and whole
    int8 or bf16 caches bit-equal, K10 bit-equal; each timed by CUDA-graph
    replay beside its plain version and its bound from the bytes it moves
    (and K8 without a residual beside ``F.rms_norm``); the sum over one
    decode step of the 32-layer model (65 K8, 32 K9, 32 K10); then K8 and
    K9 inside K5's streaming launch at 1 and 2 rows (``_fused_k5_case`` for
    every ``FUSED_K5`` group) and the sum over a step's 64 fused
    launches."""
    import torch
    from modelcompose_tpu_torch.core.llama import KVCache
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.ops import decode_fused as df
    from modelcompose_tpu_torch.ops.rope import rope_tables
    bf = torch.bfloat16
    H, D, S = FUSED_HIDDEN, FUSED_HEAD_DIM, FUSED_CACHE_LEN
    rows = {"K8": [], "K9": [], "K10": []}
    errs = {"K8": 0.0, "K9": 0.0, "K10": 0.0}
    for M in FUSED_ROWS:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=device)
                    * scale).to(bf)
        x, y = rnd(M, 1, H, scale=3.0), rnd(M, 1, H, scale=3.0)
        for w, residual in ((torch.ones(H, device=device, dtype=bf), True),
                            (rnd(H, scale=0.1) + 1, True),
                            (rnd(H, scale=0.1) + 1, False)):
            yy = y if residual else None
            s, out = df.add_rms_norm(x, yy, w, 1e-5)
            want_s, want = df.add_rms_norm_reference(x, yy, w, 1e-5)
            ulps, (err, rel) = _ulps(out, want), _rel_err(out, want)
            ones = bool((w == 1).all())
            if not torch.equal(s, want_s) or (ones and ulps > 1) \
                    or rel > ATTN_TOL:
                raise AssertionError(f"K8 M{M} residual {residual}: sum "
                                     f"equal {torch.equal(s, want_s)}, "
                                     f"{ulps} ulps, rel {rel:.3g}")
            errs["K8"] = max(errs["K8"], err)
            if ones:
                continue
            res = {"M": M, "H": H, "residual": residual, "ulps": ulps}
            n_in = (2 if residual else 1) * M * H
            nbytes = 2 * (n_in + H + (2 if residual else 1) * M * H)
            rows["K8"].append(_fused_timed(
                res, lambda: df.add_rms_norm(x, yy, w, 1e-5),
                lambda: df.add_rms_norm_reference(x, yy, w, 1e-5), nbytes,
                5 * M * H))
            if not residual:  # the final norm: one PyTorch call computes it
                res["library_ms"] = graph_time_ms(
                    lambda: torch.nn.functional.rms_norm(x, (H,), w, 1e-5))
        for name, heads in FUSED_HEADS.items():
            for int8 in (True, False) if name == "mcub4" else (True,):
                q, k, v = (rnd(M, 1, h, D) for h in (heads, heads, heads))
                pos = torch.randperm(S, generator=gen, device=device)[:M] \
                    .to(torch.int32)
                cos, sin = rope_tables(pos[:, None], D)
                cfg = ModelConfig(hidden_size=heads * D,
                                  num_attention_heads=heads,
                                  num_key_value_heads=heads,
                                  num_hidden_layers=FUSED_LAYERS,
                                  dtype="bfloat16")
                kc, pc = (KVCache.zeros(cfg, M, S, quantized=int8,
                                        device=device) for _ in range(2))
                got = df.rope_kv_write(q, k, v, cos, sin, kc.k, kc.v, 1, pos)
                want = df.rope_kv_write_reference(q, k, v, cos, sin, pc.k,
                                                  pc.v, 1, pos)
                if not torch.equal(got, want) or not all(
                        torch.equal(a, b) for a, b in zip(kc.tensors(),
                                                          pc.tensors())):
                    raise AssertionError(f"K9 M{M} {name} int8 {int8}: "
                                         f"differs from its plain version")
                res = {"M": M, "shape": name, "heads": heads, "D": D,
                       "cache": "int8" if int8 else "bf16", "S": S}
                vec = M * heads * D
                cache_bytes = 2 * (vec + 4 * M * heads) if int8 \
                    else 2 * 2 * vec
                nbytes = 2 * 4 * vec + 2 * 4 * M * D + 4 * M + cache_bytes
                rows["K9"].append(_fused_timed(
                    res, lambda: df.rope_kv_write(q, k, v, cos, sin, kc.k,
                                                  kc.v, 1, pos),
                    lambda: df.rope_kv_write_reference(q, k, v, cos, sin,
                                                       pc.k, pc.v, 1, pos),
                    nbytes, 6 * vec + (10 * vec if int8 else 0)))
                del kc, pc
        for name, inter in FUSED_INTER.items():
            gate, up = rnd(M, 1, inter, scale=4.0), rnd(M, 1, inter)
            got = df.silu_mul(gate, up)
            if not torch.equal(got, df.silu_mul_reference(gate, up)):
                raise AssertionError(f"K10 M{M} {name}: differs from its "
                                     f"plain version")
            rows["K10"].append(_fused_timed(
                {"M": M, "shape": name, "I": inter},
                lambda: df.silu_mul(gate, up),
                lambda: df.silu_mul_reference(gate, up), 3 * 2 * M * inter,
                6 * M * inter))
        torch.cuda.empty_cache()
    rows["K8 in K5"], rows["K8+K9 in K5"], rows["K10 in K5"] = [], [], []
    for M in FUSED_K5_ROWS:
        for name, (_, D) in FUSED_K5.items():
            for int8 in (True, False) if name == "qkv" else (True,):
                c = _fused_k5_case(device, gen, name, M, int8)
                rows[c["form"]].append(c)
        for name in FUSED_INTER:  # the down product and its row shards
            for dtype in ("bfloat16", "float16") if name == "mcub4" \
                    else ("bfloat16",):
                c = _silu_k5_case(device, gen, name, M, dtype)
                if c is not None:
                    rows["K10 in K5"].append(c)
        torch.cuda.empty_cache()
    for key, cases in rows.items():
        for c in cases:
            log(key, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in c.items()})
    # one decode step of the 32-layer model at each row count: 64 K8 with
    # a residual and 1 without, 32 K9 into the int8 cache, 32 K10
    step = {}
    for M in FUSED_ROWS:
        k8 = {c["residual"]: c for c in rows["K8"] if c["M"] == M}
        k9 = next(c for c in rows["K9"] if c["M"] == M
                  and c["shape"] == "mcub4" and c["cache"] == "int8")
        k10 = next(c for c in rows["K10"] if c["M"] == M
                   and c["shape"] == "mcub4")
        parts = ((k8[True], 64), (k8[False], 1), (k9, 32), (k10, 32))
        if all(c[k] is not None for c, _ in parts for k in ("ms",
                                                            "plain_ms")):
            step[M] = {k: sum(n * c[k] for c, n in parts)
                       for k in ("ms", "plain_ms", "bound_ms")}
            step[M]["launches"] = 129
    # the 64 norm -> product launch groups of a 32-layer step at 1-2 rows:
    # 32 q/k/v (int8 cache) and 32 gate/up, fused against K8, K5 and K9
    # launched in turn (one graph: ``chain_ms``; each alone: the parts)
    in_k5 = {}
    for M in FUSED_K5_ROWS:
        qkv = next(c for c in rows["K8+K9 in K5"] if c["M"] == M
                   and c["shape"] == "qkv" and c["cache"] == "int8")
        gu = next(c for c in rows["K8 in K5"] if c["M"] == M
                  and c["shape"] == "gate_up")
        in_k5[M] = {k: None if qkv[k] is None or gu[k] is None
                    else 32 * (qkv[k] + gu[k]) for k in (
                        "ms", "chain_ms", "parts_sum_ms", "plain_ms",
                        "bound_ms")}
        in_k5[M]["launches"] = 64
    # the 32 down products of a step at 1-2 rows, with K10 in their
    # prologue against K10 -> K5 (one graph; each alone: the parts)
    silu_in_k5 = {}
    for M in FUSED_K5_ROWS:
        down = next(c for c in rows["K10 in K5"] if c["M"] == M
                    and c["shape"] == "mcub4" and c["dtype"] == "bfloat16")
        silu_in_k5[M] = {k: None if down[k] is None else 32 * down[k]
                         for k in ("ms", "chain_ms", "parts_sum_ms",
                                   "plain_ms", "bound_ms")}
        silu_in_k5[M]["launches"] = 32
    log("fused", step_sum_ms=json.dumps(
        {m: {k: round(v, 4) for k, v in s.items()} for m, s in step.items()}),
        in_k5_step_sum_ms=json.dumps(
            {m: {k: v if v is None else round(v, 4) for k, v in s.items()}
             for m, s in in_k5.items()}),
        silu_in_k5_step_sum_ms=json.dumps(
            {m: {k: v if v is None else round(v, 4) for k, v in s.items()}
             for m, s in silu_in_k5.items()}))
    out = {}
    k8_alone = next(c for c in rows["K8"] if not c["residual"])
    for key, note in (("K8", "F.rms_norm on the no-residual case (the "
                             "final norm; it rounds in another order); "
                             "none with the residual"),
                      ("K9", "none"), ("K10", "none"),
                      ("K8 in K5", "none"), ("K8+K9 in K5", "none"),
                      ("K10 in K5", "none")):
        first = rows[key][0]  # one row of the Vicuna-7B shape
        out[key] = dict({k: first[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "share_of_bound")}, library_call=note,
            shapes=[_rounded(c) for c in rows[key]],
            step=silu_in_k5 if key == "K10 in K5"
            else in_k5 if "K5" in key else step)
        out[key]["max_abs_err"] = errs[key] if key in errs \
            else max(c["max_abs_err"] for c in rows[key])
    out["K8"]["library_ms"] = k8_alone["library_ms"]
    return out


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
    k5_ab = _k5_decode_ab(model, ids, inputs, kw)
    fused_ab = _fused_decode_ab(model, ids, inputs, kw)
    k6_ab = _k6_prefill_ab(model, ids, inputs, kw)
    prof = _profile("composed_prefill", lambda: model.generate(
        ids, inputs, max_new_tokens=1, **kw), "composed_profile.txt")
    return {"launches": launches, "towers": towers,
            "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "peak_mem_gb": peak, "peak_reserved_gb": reserved,
            "pools_by_kind_gb": _graph_pools_by_kind_gb(model),
            "graphs": graphs, "vs_eager": vs_eager, "fps": fps,
            "decode_step_profile": step_prof, "logit_rel_err": rel,
            "k5_ab": k5_ab, "fused_ab": fused_ab, "k6_ab": k6_ab,
            "profile": prof}, model, \
        (ids, inputs)


def phase_fp16(device, gen, bf16_launches):
    """The MCUB-4 composition at Vicuna-7B width and depth in fp16 (the
    reference's eval dtype), in the production decode variant (int8 base
    and KV cache, the dense fold) as phase 6 serves it in bf16: one
    request through the tower, prefill and decode graphs
    (``_timed_request``: every kernel's count exact), its counts equal to
    the bf16 request's, its greedy answer held to the plain path on the
    card at fp16 (``attn_impl="reference"``: teacher-forced logits within
    COMPOSED_LOGIT_TOL of max |logit|, finite on both routes, and the ids
    equal or parting only at a near tie)."""
    import torch
    from modelcompose_tpu_torch.configs import mcub4_damc_7b

    cfg = mcub4_damc_7b(dtype="float16")
    model = build_served_model(cfg, device, gen, "fp16")
    ids, inputs = _mcub4_request(cfg, device, gen)
    kw = dict(kv_quant=True, compact_adapters=True)
    answers, timings, launches, graphs, (peak, reserved), logits = \
        _timed_request("fp16", model, ids, inputs, **kw)
    n_layers = cfg.num_hidden_layers
    decode_steps = NEW_TOKENS - 1
    if launches["flash_attention_fwd"] != n_layers \
            or launches["flash_decode"] != n_layers * decode_steps \
            or launches != bf16_launches:
        raise AssertionError(f"fp16: launches {launches}, want K1 "
                             f"{n_layers}, K2 {n_layers * decode_steps} and "
                             f"the bf16 request's {bf16_launches}")
    if logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        raise AssertionError("fp16: prefill logits not finite fp32")
    rel = _compare_logits("fp16", model, ids, inputs, answers,
                          COMPOSED_LOGIT_TOL)
    plain = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                           attn_impl="reference", **kw)
    vs_plain = _kernel_vs_plain(model, [(ids, inputs, answers)],
                                [(ids, inputs, plain)], kv_quant=True,
                                phase="fp16")
    log("fp16", prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_steps / timings['decode_s']:.2f}",
        peak_mem_gb=f"{peak:.2f}", answer_len=len(answers[0]),
        launches=json.dumps(launches), equal_to_bf16_counts=True,
        max_abs_logit=f"{logits.abs().max().item():.4g}",
        vs_plain=json.dumps(vs_plain), logit_rel_err=f"{rel:.3g}")
    del model
    return {"launches": launches, "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "logit_rel_err": rel, "vs_plain": vs_plain}


def phase_fp32(device, gen):
    """Phase 6e: the MCUB-4 composition at Vicuna-7B width and depth in
    fp32 (a float32 model), in the production decode variant (int8 base
    and KV cache, the dense fold) as phase 6c serves it in fp16: one
    request through the tower, prefill and decode graphs
    (``_timed_request``: K1 once a layer in the replayed prefill, K2 once
    a layer a step, counted exactly; K5-K10 none, their fp32 activations
    take the plain products), its greedy answer held to the plain path on
    the card at fp32 (``attn_impl="reference"``: teacher-forced logits
    within F32_LOGIT_TOL of max |logit|, finite on both routes, and the ids
    equal or parting only at a near tie under F32_LOGIT_TOL)."""
    import torch
    from modelcompose_tpu_torch.configs import mcub4_damc_7b

    cfg = mcub4_damc_7b(dtype="float32")
    model = build_served_model(cfg, device, gen, "fp32")
    ids, inputs = _mcub4_request(cfg, device, gen)
    kw = dict(kv_quant=True, compact_adapters=True)
    answers, timings, launches, graphs, (peak, reserved), logits = \
        _timed_request("fp32", model, ids, inputs, **kw)
    n_layers = cfg.num_hidden_layers
    decode_steps = NEW_TOKENS - 1
    want = {"flash_attention_fwd": n_layers,
            "flash_decode": n_layers * decode_steps}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"fp32: launches {launches}, want {want}")
    if logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        raise AssertionError("fp32: prefill logits not finite fp32")
    rel = _compare_logits("fp32", model, ids, inputs, answers,
                          F32_LOGIT_TOL)
    plain = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                           attn_impl="reference", **kw)
    vs_plain = _kernel_vs_plain(model, [(ids, inputs, answers)],
                                [(ids, inputs, plain)], kv_quant=True,
                                phase="fp32", tol=F32_LOGIT_TOL)
    log("fp32", prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_steps / timings['decode_s']:.2f}",
        peak_mem_gb=f"{peak:.2f}", peak_reserved_gb=f"{reserved:.2f}",
        answer_len=len(answers[0]), launches=json.dumps(launches),
        max_abs_logit=f"{logits.abs().max().item():.4g}",
        vs_plain=json.dumps(vs_plain), logit_rel_err=f"{rel:.3g}",
        logit_tol=F32_LOGIT_TOL)
    del model
    return {"launches": launches, "prefill_s": timings["prefill_s"],
            "decode_tok_per_s": decode_steps / timings["decode_s"],
            "peak_mem_gb": peak, "logit_rel_err": rel, "vs_plain": vs_plain,
            "graphs": graphs}


# The tiny models of phase 6d: 2 layers of 256, head_dim 128 (a width the
# kernels take), text only, a float base, the int8 KV cache.
TINY_CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2, vocab_size=1024,
                max_position_embeddings=512)
TINY_TOKENS = 12


def _tiny_models(device, dtype):
    """A tiny ``dtype`` model made on the CPU from a seed, on the CPU and
    copied to the card, and two text requests (40 and 23 tokens)."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.core.llama import init_params
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.tree import tree_map_with_path
    cfg = ModelConfig(dtype=dtype, lora_r=4, lora_alpha=8, **TINY_CFG)
    cpu_gen = torch.Generator().manual_seed(SEED + 6)
    params = init_params(cfg, cpu_gen, "cpu")
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"].normal_(0.0, 0.05, generator=cpu_gen)
    cpu = MultimodalLM(cfg, params, {}, {})
    card = MultimodalLM(cfg, tree_map_with_path(
        lambda _, t: t.to(device), params), {}, {})
    rng = np.random.default_rng(SEED + 6)
    ids = [np.concatenate([[1], rng.integers(3, cfg.vocab_size, n)])
           for n in (40, 23)]
    return cfg, cpu, card, ids


def _tiny_case(device, dtype):
    """The tiny ``dtype`` model (``_tiny_models``): its two requests
    answered three times on the card (the decode graph captured, then the
    prefill graph, then every graph replayed, the third counted), against
    the same weights on the CPU: teacher-forced fp32 logits within the
    type's tolerance of max |logit| (fp16: ATTN_TOL; fp32: ATTN_F32_TOL)
    and the greedy ids equal or parting where the CPU's top-2 gap is under
    it.  The fp16 model decodes over the int8 KV cache, the fp32 one over
    an fp32 cache: at 1e-5 an int8 rounding that one side takes at a
    half-quantum and the other not (a 1e-7 difference before it) would be
    the whole difference.  Returns the third request's K1 and K2 launches
    and the comparison."""
    import torch
    kv_quant = dtype != "float32"
    cfg, cpu, card, ids = _tiny_models(device, dtype)
    reset, read = _attention_counters()
    before = _all_graph_counts()
    for _ in range(3):
        reset()
        answers = card.generate(ids, {}, max_new_tokens=TINY_TOKENS,
                                kv_quant=kv_quant)
    launches = read()
    graphs = _graph_delta(before)
    want = cpu.generate(ids, {}, max_new_tokens=TINY_TOKENS,
                        kv_quant=kv_quant)
    eos = cfg.eos_token_id
    tokens = torch.tensor([a + [eos] * (TINY_TOKENS - len(a))
                           for a in answers])
    with torch.no_grad():
        got = _teacher_forced(card, ids, {}, tokens.to(device), "auto",
                              kv_quant=kv_quant)
        ref = _teacher_forced(cpu, ids, {}, tokens, "auto",
                              kv_quant=kv_quant)
    got = got.cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    tol = ATTN_F32_TOL if dtype == "float32" else ATTN_TOL
    res = {"dtype": dtype, "kv_quant": kv_quant,
           "launches": {k: launches[k] for k in (
               "flash_attention_fwd", "flash_decode")},
           "logit_rel_err": rel, "logit_tol": tol,
           "ids_equal": answers == want, "graphs": graphs}
    if not (torch.isfinite(got).all() and rel <= tol):
        raise AssertionError(f"tiny {dtype}: card logits {rel:.3g} of max "
                             f"|logit| from the CPU's (tol {tol})")
    for row, (a, b) in enumerate(zip(answers, want)):
        if a == b:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a + [None], b + [None]))
                    if x != y)
        top2 = ref[row, step].topk(2).values
        gap = ((top2[0] - top2[1]) / ref[row, step].abs().max()).item()
        res.setdefault("near_ties", []).append(
            {"row": row, "step": step, "cpu_top2_gap_rel": gap})
        if gap > tol:
            raise AssertionError(f"tiny {dtype}: row {row} leaves the CPU's "
                                 f"answer at step {step}, top-2 gap {gap:.3g}")
    n = cfg.num_hidden_layers
    steps = TINY_TOKENS - 1  # decode steps a request: every row to the end
    want_launches = {"flash_attention_fwd": n, "flash_decode": n * steps}
    if res["launches"] != want_launches:
        raise AssertionError(f"tiny {dtype}: launches {res['launches']}, "
                             f"want {want_launches}")
    if not graphs.get("decode", [0, 0])[1] or not graphs.get("prefill",
                                                              [0, 0])[1]:
        raise AssertionError(f"tiny {dtype}: graphs {graphs}: no prefill or "
                             f"decode replay")
    log("tiny", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                   for k, v in res.items()})
    return res


def _tiny_train(device, dtype):
    """A tiny ``dtype`` (fp16 or fp32) stage-2 DAMC step (2 layers of 256,
    head_dim 64, a test CLIP tower, remat, nonzero LoRA B, two image
    samples) eagerly and through its train graph (one eager call, the
    capture, replays) from the same weights: every step K1 twice a layer
    (remat) and K3 and K4 once, counted exactly; the first step's loss
    finite (fp32: every step's), and every step's loss through the graph
    equal to the eager step's (fp16: NaN where the eager one is: see
    below).  Then by values, from the same weights, against the plain
    attention (``attn_impl="reference"``, ``_tiny_train_values``)."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.constants import (IGNORE_INDEX,
                                                  MODAL_TOKEN_INDEXES)
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.train.train_multimodal import make_batch
    from modelcompose_tpu_torch.tree import tree_leaves
    cfg = ModelConfig(hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=512,
                      max_position_embeddings=256, lora_r=4, lora_alpha=8,
                      lora_strategy="modal+language", dtype=dtype,
                      remat=True, mm_vision_encoder="test:32x2",
                      mm_hidden_size=32, mm_projector_type="mlp2x_gelu",
                      local_prefix_tokens=1, local_suffix_tokens=1)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    model = MultimodalLM.random_init(cfg, gen, device)
    for grp in ("attn", "mlp"):
        for p in model.params["layers"][grp].values():
            p["lora_b"].normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(SEED + 13)
    img = MODAL_TOKEN_INDEXES["vision"]
    ids = [np.concatenate([[1, img], rng.integers(3, 512, n)])
           for n in (40, 23)]
    labels = [np.concatenate([[IGNORE_INDEX] * 12, i[12:]]) for i in ids]
    batch, layout = make_batch(model, {
        "input_ids": ids, "labels": labels,
        "modal_inputs": {"vision": rng.random((2, 28, 28, 3)).astype(
            np.float32)}}, buckets=(64,))
    tc = trainer.TrainConfig(learning_rate=2e-3, warmup_ratio=0.0,
                             total_steps=20)
    tree = {"backbone": model.params, "projectors": model.projectors}
    tx, _ = trainer.make_optimizer(cfg, tc, tree)
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)}
    n = cfg.num_hidden_layers
    fns = (flash_attention_forward, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
    runs, counts = [], []
    for graphs in (False, True):
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        step = trainer.make_train_step(cfg, tc, tx, graphs=graphs)
        losses = []
        for i in range(4):
            before = [f.launches for f in fns]
            state, loss = step(state, batch, layout)
            losses.append(float(loss))
            counted = [f.launches - b for f, b in zip(fns, before)]
            counts.append(counted)
            if counted != [2 * n, n, n]:
                raise AssertionError(f"tiny {dtype} train step {i} (graphs "
                                     f"{graphs}): K1/K3/K4 {counted}, want "
                                     f"{[2 * n, n, n]}")
        runs.append(losses)
        if graphs:
            (graph,) = step.graphs.values()
            if graph.graph is None:
                raise AssertionError(f"tiny {dtype} train step: not "
                                     "captured")
    eager, replayed = np.array(runs[0]), np.array(runs[1])
    finite = np.isfinite(eager).all() if dtype == "float32" \
        else np.isfinite(eager[0])
    if not (finite and np.array_equal(eager, replayed, equal_nan=True)):
        raise AssertionError(f"tiny {dtype} train step: eager losses "
                             f"{runs[0]}, graph losses {runs[1]}")
    # fp16: Adam's second moment (1e-3 g^2) underflows in fp16 and its eps
    # (1e-8) rounds to 0, as in the JAX optimizer (tests/test_torch_train.py
    # holds both packages to it): the first update sends most trained
    # elements to +-inf (0 / 0 to NaN), so the losses after it are NaN on
    # every route alike (the reference trains in bf16)
    log("tiny", train=f"{dtype} stage-2 step, eager and through its graph",
        losses=json.dumps(runs[1]), finite_losses=int(
            np.isfinite(replayed).sum()), k1_k3_k4_per_step=[2 * n, n, n],
        steps=len(counts))
    values = _tiny_train_values(cfg, tc, tx, tree, start, model, batch,
                                layout)
    log("tiny", train=f"{dtype} first step against the plain attention",
        **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
           for k, v in values.items()})
    return {"flash_attention_fwd": sum(c[0] for c in counts),
            "flash_attention_bwd_dq": sum(c[1] for c in counts),
            "flash_attention_bwd_dkv": sum(c[2] for c in counts)}


def _tiny_train_values(cfg, tc, tx, tree, start, model, batch, layout):
    """The tiny step's first gradients and first update through K1, K3 and
    K4 against the plain attention, from the weights ``start``
    (``_tiny_train``).  The first loss within the type's tolerance (fp16
    ATTN_TOL, fp32 ATTN_F32_TOL) and each trainable leaf's gradient as
    phase 9 holds them (cosine, norm ratio), at fp32 also within
    F32_GRAD_TOL of the leaf's max |plain|.  The parameters after the
    first update: fp16: non-finite at the same elements but for under 1%
    of them, and within ATTN_TOL of max |plain| where the plain route's
    second moment is a normal fp16 number (elsewhere Adam divides by a
    subnormal of a bit or two, and the update is as uncertain as that);
    fp32: finite, and the update within F32_GRAD_TOL of max |plain update|
    where the plain gradient is at least 1e-3 of its leaf's max (elsewhere
    a gradient near Adam's eps makes the update as uncertain as the
    gradient's last digits)."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves

    def restart():
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        return trainer.init_train_state(cfg, tc, model.params,
                                        model.projectors, tx=tx)
    res, grads, updated = {}, {}, {}
    for impl in ("auto", "reference"):
        grad_fn = trainer.make_grad_and_apply(cfg, tc, tx, attn_impl=impl,
                                              graphs=False)[0]
        loss, g = grad_fn(restart().params, batch, layout)
        grads[impl] = (float(loss), {p: t.float() for p, t in g.items()})
        state = restart()
        trainer.make_train_step(cfg, tc, tx, attn_impl=impl,
                                graphs=False)(state, batch, layout)
        nu = state.opt_state["nu"]
        updated[impl] = {p: (t.detach().float().clone(), nu[p].float())
                         for p, t in tree_leaves(state.params)
                         if tx.trains(p)}
    fp32 = cfg.dtype == "float32"
    tol = ATTN_F32_TOL if fp32 else ATTN_TOL
    (loss_k, g_k), (loss_p, g_p) = grads["auto"], grads["reference"]
    res["loss_rel"] = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and res["loss_rel"] <= tol):
        raise AssertionError(f"tiny {cfg.dtype} train: kernel-path loss "
                             f"{loss_k} vs plain {loss_p} (tol {tol})")
    worst, worst_rel = None, 0.0
    for p in g_p:
        if not (g_p[p].any() or g_k[p].any()):
            continue  # a leaf this batch does not reach: zero on both
        cmp = _compare_grads(f"tiny_{cfg.dtype}_" + "/".join(map(str, p)),
                             g_k[p].reshape(-1), g_p[p].reshape(-1))
        if worst is None or cmp["cosine"] < worst["cosine"]:
            worst = dict(cmp, leaf="/".join(map(str, p)))
        if fp32:
            worst_rel = max(worst_rel, _rel_err(g_k[p], g_p[p])[1])
    res["grad_leaves"], res["worst_grad"] = len(g_p), worst
    if fp32:
        res["grad_rel"] = worst_rel
        if worst_rel > F32_GRAD_TOL:
            raise AssertionError(f"tiny fp32 train: a gradient {worst_rel:.3g}"
                                 f" of its max |plain| off (tol "
                                 f"{F32_GRAD_TOL})")
        return _tiny_fp32_update(res, updated, start, g_p)
    bad = differ = total = normal = 0
    normal_rel = 0.0
    for p, (want, nu) in updated["reference"].items():
        got = updated["auto"][p][0]
        fin = torch.isfinite(want)
        same = (got == want) | (got.isnan() & want.isnan())
        differ += int(((torch.isfinite(got) != fin) | (~fin & ~same)).sum())
        bad += int((~fin).sum())
        total += want.numel()
        held = nu.reshape(want.shape) >= torch.finfo(torch.float16).tiny
        normal += int(held.sum())
        if held.any():
            normal_rel = max(normal_rel, _rel_err(got[held], want[held])[1])
    res.update(update_nonfinite=bad, update_differ=differ,
               update_elements=total, update_normal_moment=normal,
               update_normal_rel=normal_rel)
    if differ > total // 100 or not normal or normal_rel > ATTN_TOL:
        raise AssertionError(f"tiny fp16 train: the first update differs "
                             f"from the plain route's: {res}")
    return res


def _tiny_fp32_update(res, updated, start, grads):
    """The tiny fp32 step's first update through the kernels against the
    plain attention's (``_tiny_train_values``): every parameter finite on
    both routes, and the update (new - start) within F32_GRAD_TOL of the
    leaf's max |plain update| where the plain gradient is at least 1e-3 of
    the leaf's max |gradient|."""
    import torch
    held = total = 0
    rel = 0.0
    for p, (want, _) in updated["reference"].items():
        got = updated["auto"][p][0]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"tiny fp32 train: {p} not finite after "
                                 "the first update")
        g = grads[p].reshape(want.shape).abs()
        mask = g >= 1e-3 * g.max()
        if not mask.any():
            continue
        d_got, d_want = got - start[p].float(), want - start[p].float()
        held += int(mask.sum())
        total += want.numel()
        err = (d_got - d_want)[mask].abs().max().item()
        rel = max(rel, err / max(d_want.abs().max().item(), 1e-30))
    res.update(update_elements=total, update_held=held, update_rel=rel)
    if not held or rel > F32_GRAD_TOL:
        raise AssertionError(f"tiny fp32 train: the first update differs "
                             f"from the plain route's: {res}")
    return res


def phase_tiny(device):
    """Phase 6d: attention's dtypes on the card end to end.  A tiny fp32
    and a tiny fp16 model each run K1 once a layer and K2 once a layer a
    step through the graphs, within 1e-5 (fp32) and 2e-2 (fp16) of the
    same weights on the CPU (``_tiny_case``); a tiny fp32 and a tiny fp16
    train step each run K1, K3 and K4 through their graph, counted
    exactly, held to the plain attention by values (``_tiny_train``).
    Launches are kept by type: ``launches`` and ``train_launches`` the
    fp16 ones, ``fp32_launches`` (both models' and steps') the fp32
    ones."""
    cases = {dtype: _tiny_case(device, dtype)
             for dtype in ("float32", "float16")}
    trains = {dtype: _tiny_train(device, dtype)
              for dtype in ("float32", "float16")}
    launches = {}
    for dtype in cases:
        counts = dict(cases[dtype]["launches"])
        for k, v in trains[dtype].items():
            counts[k] = counts.get(k, 0) + v
        launches[dtype] = counts
    return {"cases": cases, "train_launches": trains["float16"],
            "launches": launches["float16"],
            "fp32_launches": launches["float32"]}


class _DequantArm:
    """One arm of phase 6's A/Bs: the model's decode and prefill graphs
    dropped on entry and on exit, since a captured step keeps the int8
    product it was captured with, and the int8 products of the kernels not
    in ``kernels`` ("k5", "k6") on their plain version (the convert, the
    fp32-output GEMM and the scale pass): without "k6" K6's launcher
    computes the plain product, and without "k5" so does every product
    (``quant.K5_MAX_ROWS`` 0 sends 1-8 rows there too).  K1 and K2 stay."""

    def __init__(self, model, kernels):
        self.model, self.kernels = model, kernels

    def _drop_graphs(self):
        self.model.decode_graphs.clear()
        self.model.prefill_graphs.clear()

    def __enter__(self):
        from modelcompose_tpu_torch.ops import quant
        self.quant = quant
        self.rows, self.k6 = quant.K5_MAX_ROWS, quant._k6
        self._drop_graphs()
        if "k5" not in self.kernels:
            quant.K5_MAX_ROWS = 0
        if "k6" not in self.kernels or "k5" not in self.kernels:
            quant._k6 = lambda x2, weights, out_dtype: [
                quant.dequant_matmul_reference(x2, weights[0], out_dtype)]
        return self

    def __exit__(self, *exc):
        self.quant.K5_MAX_ROWS, self.quant._k6 = self.rows, self.k6
        self._drop_graphs()


def _near_tie(name, model, ids, inputs, got, want, plain_kernels, arm=None):
    """Where two greedy answers part: the step, the kernel path's and the
    plain arm's (``arm``, or ``_DequantArm(model, plain_kernels)``)
    teacher-forced logits there (within LOGIT_TOL of max |logit|) and the
    plain arm's top-2 gap (under LOGIT_TOL), or raises."""
    import torch
    step = next(i for i, (a, b) in enumerate(zip(got + [None], want + [None]))
                if a != b)
    tokens = torch.tensor([(got + [model.cfg.eos_token_id])[:step + 1]],
                          device=model.device)
    with torch.no_grad():
        k = _teacher_forced(model, ids, inputs, tokens, "auto")[0, step]
        with arm or _DequantArm(model, plain_kernels):
            p = _teacher_forced(model, ids, inputs, tokens, "auto")[0, step]
    scale = p.abs().max()
    top2 = p.topk(2).values
    res = {"diverge_step": step,
           "logit_rel_err": ((k - p).abs().max() / scale).item(),
           "plain_top2_gap_rel": ((top2[0] - top2[1]) / scale).item()}
    if res["logit_rel_err"] > LOGIT_TOL \
            or res["plain_top2_gap_rel"] > LOGIT_TOL:
        raise AssertionError(f"{name}: the kernel path's answer leaves the "
                             f"plain arm's at step {step}, not at a near "
                             f"tie: {res}")
    return res


def _k5_decode_ab(model, ids, inputs, kw, turns=("plain", "k5")):
    """Phase 6's request through the graphs with K5 and with the plain int8
    product, K2 in both, in ``turns`` (the smoke runs each arm once;
    ``K5_AB_TURNS`` times them in turns): each turn's decode tokens/s (the
    second of two calls, whose decode replays the graph the first
    captured), one replayed step's device time by kernel and the decode
    graph's pool GB (each arm's first turn), and the greedy ids of the two
    arms equal or parting at a named near tie (teacher-forced logits of
    both within LOGIT_TOL of max |logit| there, the plain arm's top-2 gap
    under LOGIT_TOL)."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul
    tok_s, answers, profiles, launches, pools = {}, {}, {}, {}, {}
    for arm in turns:
        with _DequantArm(model, () if arm == "plain" else ("k5", "k6")):
            n5 = dequant_matmul.launches
            for _ in range(2):
                timings = {}
                out = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                                     timings=timings, **kw)
            launches[arm] = dequant_matmul.launches - n5
            tok_s.setdefault(arm, []).append(
                (NEW_TOKENS - 1) / timings["decode_s"])
            answers.setdefault(arm, out[0])
            if out[0] != answers[arm]:
                raise AssertionError(f"k5_ab: the {arm} arm answered "
                                     f"{out[0]}, then {answers[arm]}")
            if arm not in profiles:
                graph = list(model.decode_graphs._graphs.values())[-1]
                profiles[arm] = _profile(f"decode_step_{arm}", graph.replay,
                                         f"decode_step_profile_{arm}.txt")
                pools[arm] = _graph_pools_by_kind_gb(model)["decode"]
        if (launches[arm] == 0) != (arm == "plain"):
            raise AssertionError(f"k5_ab: {launches[arm]} K5 launches in "
                                 f"the {arm} arm")
    res = {"decode_tok_per_s": tok_s, "k5_launches": launches,
           "step_device_ms": {a: p["device_kernel_s"] * 1e3
                              for a, p in profiles.items()},
           "decode_pool_gb": pools,
           "step_shares": {a: p["shares"] for a, p in profiles.items()},
           "step_kernels": {a: {s: sum(n for k, n in p["device_counts"].items()
                                       if _split_of(k) == s)
                                for s in ("K2", "K5", "gemm", "copy")}
                            for a, p in profiles.items()},
           "ids_equal": answers["k5"] == answers["plain"]}
    if not res["ids_equal"]:
        res.update(_near_tie("k5_ab", model, ids, inputs, answers["k5"],
                             answers["plain"], ()))
    log("composed", k5_ab="K5 vs plain int8 product, K2 in both",
        decode_tok_per_s=json.dumps({a: [round(v, 2) for v in t]
                                     for a, t in tok_s.items()}),
        step_device_ms=json.dumps({a: round(v, 4) for a, v in
                                   res["step_device_ms"].items()}),
        step_kernels=json.dumps(res["step_kernels"]),
        decode_pool_gb=json.dumps({a: round(v, 4) for a, v in
                                   pools.items()}),
        k5_launches=json.dumps(launches), ids_equal=res["ids_equal"],
        diverge=json.dumps({k: res[k] for k in (
            "diverge_step", "logit_rel_err", "plain_top2_gap_rel")
            if k in res}), tol=LOGIT_TOL)
    return res


class _FusedArm(_DequantArm):
    """An arm of phase 6's third A/B, the graphs dropped on entry and exit
    as ``_DequantArm`` drops them, K2, K5 and K6 kept: ``route``
    "unfused", the decode layer as the route before K8-K10 ran it
    (``llama.fused_decode`` off: RMSNorm, RoPE, the KV quantize and
    writes, the SiLU product and the residual adds as PyTorch ops, K5
    writing fp32 and a cast after it); "separate", K8-K10 each a launch of
    its own (``decode_fused.norm_fuses`` and ``silu_fuses`` off); "in_k5",
    the main path (K8 in the prologue of the K5 launch that reads it, K9 in
    the q/k/v launch's epilogue, K10 in the prologue of the down product's
    launch)."""

    def __init__(self, model, route="unfused"):
        super().__init__(model, ("k5", "k6"))
        self.route = route

    def __enter__(self):
        from modelcompose_tpu_torch.core import llama
        from modelcompose_tpu_torch.ops import decode_fused
        self.llama, self.df = llama, decode_fused
        self.fused, self.norm = llama.fused_decode, decode_fused.norm_fuses
        self.silu = decode_fused.silu_fuses
        if self.route == "unfused":
            llama.fused_decode = lambda x, attn_impl: False
        if self.route == "separate":
            decode_fused.norm_fuses = lambda x, weights: False
        if self.route == "separate":
            decode_fused.silu_fuses = lambda gate, w: False
        return super().__enter__()

    def __exit__(self, *exc):
        self.llama.fused_decode, self.df.norm_fuses = self.fused, self.norm
        self.df.silu_fuses = self.silu
        super().__exit__(*exc)


# phase 6's A/Bs timed in turns (``scripts/torch_path_ab.py --workload
# routes``); the smoke runs each arm once
K5_AB_TURNS = ("plain", "k5", "k5", "plain")
FUSED_AB_TURNS = ("unfused", "separate", "in_k5", "in_k5", "separate",
                  "unfused")
K6_AB_TURNS = ("plain", "k6", "k6", "plain")


def _fused_decode_ab(model, ids, inputs, kw,
                     turns=("unfused", "separate", "in_k5")):
    """Phase 6's request through the graphs on the three routes of the
    decode layer (``_FusedArm``: unfused, K8-K10 as launches of their own,
    K8-K10 inside K5's launches), K2 and K5 in all, in ``turns`` (the
    smoke runs each arm once; ``FUSED_AB_TURNS`` times them in turns):
    each turn's decode tokens/s
    (the second of two calls: its decode replays the graph the first
    captured), one replayed step's device time and its kernels by profile
    split (each arm's first turn), the K5 and K8-K10 launches of every
    turn checked exactly (``_k5_per_step``, ``_fused_per_step``: K8-K10
    none on the unfused route, their separate launches on the separate
    one), and the greedy ids of the arms equal or parting at a named near
    tie."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul
    tok_s, answers, profiles, launches = {}, {}, {}, {}
    fns = dict(_fused_fns(), w8a16_gemv=dequant_matmul)
    steps = 2 * (NEW_TOKENS - 1)
    rows = len(ids)
    k5 = {"w8a16_gemv": 2 * (_k5_per_step(model.params, rows)
                             * (NEW_TOKENS - 1) + 1)}
    want = {"in_k5": dict(k5, **{k: v * steps for k, v in _fused_per_step(
                model.params, rows).items()}),
            "separate": dict(k5, **{k: v * steps for k, v in _fused_per_step(
                model.params, rows, in_k5=False).items()}),
            "unfused": dict(k5, **dict.fromkeys(FUSED_KERNELS, 0))}
    for arm in turns:
        with _FusedArm(model, arm):
            before = {k: f.launches for k, f in fns.items()}
            for _ in range(2):
                timings = {}
                out = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                                     timings=timings, **kw)
            counted = {k: f.launches - before[k] for k, f in fns.items()}
            tok_s.setdefault(arm, []).append(
                (NEW_TOKENS - 1) / timings["decode_s"])
            answers.setdefault(arm, out[0])
            if out[0] != answers[arm]:
                raise AssertionError(f"fused_ab: the {arm} arm answered "
                                     f"{out[0]}, then {answers[arm]}")
            if arm not in profiles:
                launches[arm] = counted
                graph = list(model.decode_graphs._graphs.values())[-1]
                profiles[arm] = _profile(
                    f"decode_step_fused_ab_{arm}", graph.replay,
                    f"decode_step_profile_fused_ab_{arm}.txt")
        if counted != want[arm]:
            raise AssertionError(f"fused_ab: launches {counted} in the {arm} "
                                 f"arm of {steps} decode steps, want "
                                 f"{want[arm]}")

    def by_split(p):
        counts = {name: 0 for name in PROFILE_SPLITS}
        counts["other"] = 0
        for k, n in p["device_counts"].items():
            counts[_split_of(k) or "other"] += n
        counts["total"] = sum(p["device_counts"].values())
        return counts
    res = {"decode_tok_per_s": tok_s, "fused_launches": launches,
           "step_device_ms": {a: p["device_kernel_s"] * 1e3
                              for a, p in profiles.items()},
           "step_shares": {a: p["shares"] for a, p in profiles.items()},
           "step_kernels": {a: by_split(p) for a, p in profiles.items()},
           "ids_equal": len({tuple(a) for a in answers.values()}) == 1}
    for arm in ("separate", "in_k5"):
        if answers[arm] != answers["unfused"]:
            res[arm] = _near_tie("fused_ab", model, ids, inputs,
                                 answers[arm], answers["unfused"], (),
                                 arm=_FusedArm(model))
    log("composed", fused_ab="K8-K10 inside K5, K8-K10 "
        "separate and the unfused decode layer, K2/K5 in all",
        decode_tok_per_s=json.dumps(
            {a: [round(v, 2) for v in t] for a, t in tok_s.items()}),
        step_device_ms=json.dumps({a: round(v, 4) for a, v in
                                   res["step_device_ms"].items()}),
        step_kernels=json.dumps(res["step_kernels"]),
        fused_launches=json.dumps(launches), ids_equal=res["ids_equal"],
        diverge=json.dumps({a: {k: res[a][k] for k in (
            "diverge_step", "logit_rel_err", "plain_top2_gap_rel")
            if k in res[a]} for a in ("separate", "in_k5")
            if a in res}),
        tol=LOGIT_TOL)
    return res


def _chunk_step_ms(model, ids, inputs):
    """One chunked admission of the request as the slot engine runs it
    (``prefill_chunked`` through the model's chunk-step graphs, int8 cache
    of SERVE_CACHE_LEN, SERVE_CHUNK pieces) three times: eager, capturing,
    replayed; the replayed call's ms of each full chunk, synchronized
    between pieces (the engine's ticks run there)."""
    import torch
    from modelcompose_tpu_torch.core.generate import prefill_chunked
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    with torch.inference_mode():
        embeds, plan = model.prepare_batch(ids, inputs)
        dev = embeds.device
        route_ids = (torch.as_tensor(plan.route_ids, device=dev)
                     if model.cfg.routing_active() else None)
        table = as_table(model.routing_table, dev)
        for _ in range(3):
            marks = []

            def tick():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            prefill_chunked(model.params, model.cfg, embeds, route_ids,
                            table, plan.lengths, SERVE_CACHE_LEN,
                            chunk=SERVE_CHUNK, kv_quant=True, tick_cb=tick,
                            graphs=model.prefill_graphs)
    full = embeds.shape[1] // SERVE_CHUNK
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])][:full]


def _k6_prefill_ab(model, ids, inputs, kw, turns=("plain", "k6")):
    """Phase 6's request through the graphs with K6 and with the plain
    route for the int8 products above 8 rows (K1 and K5 in both), in
    ``turns`` (the smoke runs each arm once; ``K6_AB_TURNS`` times them in
    turns): each turn's one-shot prefill through its graph
    (the third of three one-token requests: eager, capturing, replayed);
    in each arm's first turn the prefill graphs' pool GB and a 512-row
    chunk step through its graph (``_chunk_step_ms``: the median of the
    replayed admission's full chunks); K6's launches; the replayed
    prefills' logits within LOGIT_TOL of max |logit| and the greedy ids
    (the prefill's token) equal or parting at a named near tie."""
    import statistics
    from modelcompose_tpu_torch.ops.quant import w8a16_gemm
    prefill_s, chunk_ms, logits, answers = {}, {}, {}, {}
    launches, pools = {}, {}
    for arm in turns:
        with _DequantArm(model, ("k5", "k6") if arm == "k6" else ("k5",)):
            n6 = w8a16_gemm.launches
            for _ in range(3):
                timings = {}
                with _PrefillLogits() as pl:
                    out = model.generate(ids, inputs, max_new_tokens=1,
                                         timings=timings, **kw)
            prefill_s.setdefault(arm, []).append(timings["prefill_s"])
            if arm not in launches:
                launches[arm] = w8a16_gemm.launches - n6
                logits[arm], answers[arm] = pl.logits[0], out[0]
                pools[arm] = _graph_pools_by_kind_gb(model)["prefill"]
                chunk_ms[arm] = statistics.median(
                    _chunk_step_ms(model, ids, inputs))
    k6_want = 3 * _k6_per_forward(model.params)
    if (launches["k6"], launches["plain"]) != (k6_want, 0):
        raise AssertionError(f"k6_ab: K6 launches {launches}, want "
                             f"{k6_want} in the K6 arm's three requests")
    scale = logits["plain"].abs().max()
    rel = ((logits["k6"] - logits["plain"]).abs().max() / scale).item()
    res = {"prefill_s": prefill_s, "chunk_step_ms": chunk_ms,
           "prefill_pool_gb": pools, "k6_launches": launches,
           "prefill_logit_rel_err": rel,
           "ids_equal": answers["k6"] == answers["plain"]}
    if rel > LOGIT_TOL:
        raise AssertionError(f"k6_ab: the prefill's logits with K6 and with "
                             f"the plain route {rel:.3g} apart")
    if not res["ids_equal"]:
        res.update(_near_tie("k6_ab", model, ids, inputs, answers["k6"],
                             answers["plain"], ("k5",)))
    log("composed", k6_ab="K6 vs the plain route above 8 rows, K1/K5 in both",
        prefill_s=json.dumps({a: [round(v, 4) for v in t]
                              for a, t in prefill_s.items()}),
        chunk_step_ms=json.dumps({a: round(v, 3)
                                  for a, v in chunk_ms.items()}),
        prefill_pool_gb=json.dumps({a: round(v, 3) for a, v in
                                    pools.items()}),
        k6_launches=json.dumps(launches), prefill_logit_rel_err=f"{rel:.3g}",
        ids_equal=res["ids_equal"], diverge=json.dumps({k: res[k] for k in (
            "diverge_step", "logit_rel_err", "plain_top2_gap_rel")
            if k in res}), tol=LOGIT_TOL)
    return res


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


def _fused_fns():
    """{name: wrapper} of K8-K10 (their launch counters)."""
    from modelcompose_tpu_torch.ops import decode_fused
    return {name: getattr(decode_fused, name) for name in FUSED_KERNELS}


def _attention_counters():
    """(reset, read) of the launch counts of K1, K2, K5, K6 and K8-K10 (the
    forward path's kernels)."""
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention
    from modelcompose_tpu_torch.ops.quant import dequant_matmul, w8a16_gemm
    fns = dict(zip(FORWARD_KERNELS, (flash_attention_forward,
                                     flash_decode_attention, dequant_matmul,
                                     w8a16_gemm)))
    fns.update(_fused_fns())

    def reset():
        for fn in fns.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in fns.items()}
    return reset, read


class _KernelInputs:
    """Records, while active, the inputs the kernels are launched at,
    through the wrappers' input checks (the launch counts stay the
    wrappers' own): for every distinct K1/K3/K4 shape ``(B, Lq, H, D, S,
    Hkv)`` its first call's (q, kv) segment ids, and for every distinct K2
    cache ``(NL, B, S, Hkv, D, H, dtype)`` its first call's kv_len.  The
    copies stay on the device: recording adds no host sync.  A capture
    records nothing (its launches do not run); a replayed graph's K1-K4
    launches are recorded from its capture records after its first replay
    here."""

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
                for args in (graph.k1.launches + graph.k1.bwd_dq
                             + graph.k1.bwd_dkv):
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
    out, totals = {}, dict.fromkeys(FORWARD_KERNELS, 0)
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
            if min(launches["flash_attention_fwd"],
                   launches["flash_decode"]) == 0:
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
        # K2 once a layer a tick; K1 once a layer and K6 once an int8
        # product in each admission's prefill or chunk (every chunk of the
        # 512-position pieces and its bucket's tail has more than 8 rows),
        # every one through a graph (eager, capturing or replayed: a replay
        # counts what its capture recorded)
        pieces = parts[part]["graph_calls"]
        k1_want = n_layers * (pieces.get("prefill", 0)
                              + pieces.get("chunk_step", 0))
        k6_want = _k6_per_forward(model.params) * k1_want // n_layers
        if res["launches"]["flash_decode"] != n_layers * res["steps"] \
                or res["launches"]["flash_attention_fwd"] != k1_want \
                or res["launches"]["w8a16_gemm"] != k6_want \
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
            or min(parts["cli"]["launches"]["flash_attention_fwd"],
                   parts["cli"]["launches"]["flash_decode"]) == 0:
        raise AssertionError(f"cli: {out.getvalue()!r}")
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in FORWARD_KERNELS}
    log("serve", launches=json.dumps(launches), greedy_vs_solo=json.dumps(
        {k: v.get("diverge_step", "equal") for k, v in checks.items()}))
    return {"parts": parts, "launches": launches, "vs_solo": checks,
            "k1_chunks": k1, "k2_pool": k2, "stall": stall, "pools": pools,
            "warm_graphs": warm,
            "max_abs_err": {"fwd": max(c["max_abs_err"] for c in k1.values()),
                            "decode": k2["max_abs_err"]}}


def _k34_case(device, gen, *, B, L, S, H, Hkv, D, q_offset, lengths,
              library=False, dtype="bfloat16", timer=None):
    """K1 forward against its plain version at the case's shape, then K3
    and K4 on K1's output and LSE, with a cotangent zero on padding rows,
    against their plain versions on valid rows, on operands of ``dtype``
    (bf16, fp16 or fp32); K3 and K4 timed by ``timer`` (CUDA events over
    warm launches by default).  With ``library``, also the backward of
    ``scaled_dot_product_attention`` through autograd, which computes K3's
    and K4's outputs together."""
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        _di, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
        flash_attention_forward)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(getattr(torch, dtype))
    q, k, v = rnd(B, L, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (torch.arange(S, device=device)[None]
              < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    q_seg = kv_seg[:, q_offset:q_offset + L].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    name = f"{dtype} B{B} L{L} S{S} H{H}/{Hkv} D{D} q_offset{q_offset}"
    k1_err, k1_rel, k1_lse_err = _check_k1(name, q, k, v, kw, out, lse)
    do = (rnd(B, L, H, D) * (q_seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    args = (q, k, v, do, lse, di)
    dq = flash_attention_bwd_dq(*args, **kw)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    ref_dq = flash_attention_bwd_dq_reference(*args, **kw)
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_tf32_off()
    q_valid, kv_valid = q_seg != 0, kv_seg != 0
    errs = {n: _rel_err(g, w, rows) for n, g, w, rows in (
        ("dq", dq, ref_dq, q_valid), ("dk", dk, ref_dk, kv_valid),
        ("dv", dv, ref_dv, kv_valid))}
    tol = _attn_tols(q.dtype)[0]
    bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
    if bad or not dq.dtype == dk.dtype == dv.dtype == q.dtype:
        raise AssertionError(f"K3/K4 {name}: {dq.dtype} rel err {bad} (tol "
                             f"{tol})")
    timer = timer or cuda_time_ms
    res = {
        "fwd": dict(max_abs_err=k1_err),
        "dq": dict(max_abs_err=errs["dq"][0], ms=timer(
            lambda: flash_attention_bwd_dq(*args, **kw)),
            plain_ms=cuda_time_ms(
                lambda: flash_attention_bwd_dq_reference(*args, **kw))),
        "dkv": dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                    ms=timer(
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
    es = q.element_size()
    io = es * D * (2 * H * n_q + 2 * Hkv * n_k) + 8 * H * n_q
    for n, flops, nbytes in (("dq", 6, io + es * q.numel()),
                             ("dkv", 8, io + es * (k.numel() + v.numel()))):
        bms, by = attention_bound(flops * D * H * pairs, nbytes, q.dtype)
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
    # the fp16 model's train step at the same shape, beside SDPA's
    # backward on the same fp16 operands
    main_fp16 = _k34_case(device, gen, B=2, lengths=[2048, 1391],
                          library=True, dtype="float16", **shape)
    # the fp32 train step's (phase 10b's shape), by CUDA-graph replay,
    # beside SDPA's backward on the same fp32 operands
    main_fp32 = _k34_case(device, gen, B=2, lengths=[2048, 1391],
                          library=True, dtype="float32",
                          timer=graph_time_ms, **shape)
    errs = {n: [r[n]["max_abs_err"] for r in (main, train, micro, main_fp16)]
            for n in main}
    errs_fp32 = {n: [main_fp32[n]["max_abs_err"]] for n in main}
    for dtype in ("bfloat16", "float16", "float32"):
        for case in (dict(B=1, lengths=TRAIN_ROWS[1:], **shape),
                     dict(B=2, L=150, S=150, H=32, Hkv=32, D=128, q_offset=0,
                          lengths=[150, 97]),
                     dict(B=2, L=256, S=1024, H=32, Hkv=8, D=128,
                          q_offset=768, lengths=[1024, 900]),
                     dict(B=2, L=150, S=150, H=8, Hkv=4, D=64, q_offset=0,
                          lengths=[150, 61])):
            res = _k34_case(device, gen, dtype=dtype, **case)
            for n in errs:
                (errs_fp32 if dtype == "float32" else errs)[n].append(
                    res[n]["max_abs_err"])
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")
    out = {"fwd": dict(max_abs_err=max(errs["fwd"])),
           "fwd_fp32": dict(max_abs_err=max(errs_fp32["fwd"]))}
    for n in ("dq", "dkv"):
        out[n] = dict(
            main[n], max_abs_err=max(errs[n]),
            shape="B2 L=2048 (2048, 1391 valid)",
            train_batch=dict({k: train[n][k] for k in timed},
                             shape="B2 L=2048 (1400, 1100 valid)"),
            micro_batch=dict({k: micro[n][k] for k in timed},
                             shape="B1 L=2048 (1400 valid)",
                             **{k: v for k, v in micro[n].items()
                                if k.startswith("library_bwd_causal")}),
            fp16=dict(main_fp16[n], shape="fp16 B2 L=2048 (2048, 1391 "
                      "valid)"))
        out[f"{n}_fp32"] = dict(main_fp32[n], max_abs_err=max(errs_fp32[n]),
                                shape="fp32 B2 L=2048 (2048, 1391 valid), "
                                "CUDA-graph replay")
    return out


# Text spans (before the image, question, answer) of phase 9's two samples
# (about 1,400 and 1,100 packed positions) and of phase 9b's four (those
# two, about 1,900 and 1,300: real lengths in the 2,048 bucket)
TRAIN_SPANS = ((100, 400, 313), (50, 250, 213))
INT8_TRAIN_SPANS = TRAIN_SPANS + ((150, 800, 363), (80, 500, 143))


def _train_samples(cfg, rng, spans=TRAIN_SPANS):
    """Image+question+answer samples of ``spans`` text tokens (the image is
    576 patches + 5 + 5 soft tokens), labels on the answer span only;
    random ids and pixels from ``rng``."""
    import numpy as np
    from modelcompose_tpu_torch.core.packing import (IGNORE_INDEX,
                                                     MODAL_TOKEN_INDEXES)
    img = MODAL_TOKEN_INDEXES["vision"]
    ids, labels = [], []
    for before, question, answer in spans:
        text = [rng.integers(3, cfg.vocab_size, n) for n in
                (before, question, answer)]
        ids.append(np.concatenate([[1], text[0], [img], text[1], text[2]]))
        labels.append(np.concatenate([
            np.full(2 + before + question, IGNORE_INDEX), text[2]]))
    pixels = rng.normal(size=(len(spans), 336, 336, 3)).astype(np.float32)
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


class _TrainSnapshot:
    """The trainable leaves, Adam moments and counts of a train state
    (device copies), to start runs from and to compare runs by."""

    def __init__(self, state, tx):
        import torch
        from modelcompose_tpu_torch.tree import tree_leaves
        with torch.no_grad():
            self.leaves = {p: t.detach().clone()
                           for p, t in tree_leaves(state.params)
                           if tx.trains(p)}
            self.moments = {m: {p: t.clone()
                                for p, t in state.opt_state[m].items()}
                            for m in ("mu", "nu")}
        self.count, self.step = state.opt_state["count"], state.step

    def restore(self, state):
        """Copy this snapshot into ``state`` in place (its tensors keep
        their addresses, as a step checkpoint's restore does)."""
        import torch
        from modelcompose_tpu_torch.tree import tree_leaves
        flat = dict(tree_leaves(state.params))
        with torch.no_grad():
            for p, t in self.leaves.items():
                flat[p].copy_(t)
            for m, ts in self.moments.items():
                for p, t in ts.items():
                    state.opt_state[m][p].copy_(t)
        state.opt_state = dict(state.opt_state, count=self.count)
        state.step = self.step

    def differing(self, other):
        """Names of the leaves and moments that differ from ``other``'s."""
        import torch
        out = [p for p in self.leaves
               if not torch.equal(self.leaves[p], other.leaves[p])]
        return out + [(m,) + p for m in self.moments for p in self.moments[m]
                      if not torch.equal(self.moments[m][p],
                                         other.moments[m][p])]

    def max_rel_diff(self, other):
        """The largest difference of a leaf or moment from ``other``'s,
        over its max |value|."""
        pairs = [(self.leaves[p], other.leaves[p]) for p in self.leaves] + [
            (self.moments[m][p], other.moments[m][p])
            for m in self.moments for p in self.moments[m]]
        return max(((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30)).item()
                   for a, b in pairs)


def _train_pool_gb(graphs):
    """GB the allocator holds in the private pool of the train ``graphs``
    (one pool an optimizer: ``Optimizer.graph_pool``)."""
    import torch
    pools = {g.graph.pool() for g in graphs if g.graph is not None}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) in pools) / 2**30


def _idle_share(profile, wall_s):
    """1 - kernel time / wall time: the share of a step the card idles."""
    return 1.0 - profile["device_kernel_s"] / wall_s


def phase_train(device):
    """The DAMC stage-2 train step at Vicuna-7B width and depth (B=2 x
    2,048: rows of 1,400 and 1,100 positions), from one saved trainable
    state: ``TRAIN_GRAPH_STEPS`` fused steps eagerly, the first step once
    more (is the card's eager step bit-reproducible?), the same steps
    through a
    ``TrainStepGraph`` (one eager call, one capture, replays), and
    ``TRAIN_WINDOWS`` accumulation windows of two micro-batches eagerly and
    through the grad and apply graphs: losses, trainable leaves and moments
    bit-equal; K1 = 64, K3 = K4 = 32 a replayed step; step s and
    positions/s both ways, the device-idle share of one eager step and one
    replay (torch.profiler), peak memory and the train pool; then
    kernel-path against plain-path gradients."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.train.step_graph import (GradGraph,
                                                         TrainStepGraph)
    from modelcompose_tpu_torch.train.train_multimodal import (
        build_arg_parser, build_model, build_model_config, make_batch)
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_grad_and_apply, make_optimizer,
        make_train_step, tree_leaves)

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
    micro_positions = sum(int((b["segment_ids"] != 0).sum())
                          for b, _ in micro)
    torch.cuda.synchronize()
    log("train", setup_s=f"{time.perf_counter() - t0:.1f}",
        bucket=tuple(batch["token_ids"].shape), positions=positions,
        lengths=[int(x) for x in (batch["segment_ids"] != 0).sum(1)],
        trainable_params=sum(p.numel() for _, p in tree_leaves(params)
                             if p.requires_grad),
        gpu_mem_gb=f"{torch.cuda.memory_allocated() / 2**30:.1f}")
    start = _TrainSnapshot(state, tx)
    n_layers = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * n_layers,  # remat: twice
                "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers}
    launches = []  # every step and window the phase drives

    def steps(step, n, first=None):
        """``n`` steps from ``start``: (losses, seconds, launches, the
        state after, the host's seconds to dispatch each step); the state
        after the first step goes to the list ``first`` where given."""
        start.restore(state)
        losses, seconds, counts, dispatch = [], [], [], []
        for i in range(n):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss = step(state, batch, layout)
            dispatch.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts.append(read())
            losses.append(loss)
            if i == 0 and first is not None:
                first.append(_TrainSnapshot(state, tx))
        launches.extend(counts)
        for i, c in enumerate(counts):
            if c != per_step:
                raise AssertionError(f"step {i}: kernel launches {c}, want "
                                     f"{per_step} (K1 twice a layer under "
                                     f"remat, K3 and K4 once)")
        return ([float(x) for x in losses], seconds, counts,
                _TrainSnapshot(state, tx), dispatch)

    # (1) the fused step eagerly, and its first step once more from the
    # same state: is the eager step bit-reproducible on this card?
    eager_step = make_train_step(cfg, tc, tx, graphs=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first = []
    eager = steps(eager_step, TRAIN_GRAPH_STEPS, first)
    eager_peak = _peak_gb()
    again = steps(eager_step, 1)
    reproducible = again[0][0] == eager[0][0] \
        and not again[3].differing(first[0])
    eager_vs_eager = 0.0 if reproducible else again[3].max_rel_diff(
        first[0])
    log("train", eager_twice_losses=[f"{x:.6f}" for x in (eager[0][0],
                                                          again[0][0])],
        eager_bit_reproducible=reproducible,
        eager_vs_eager_max_rel=f"{eager_vs_eager:.3g}")
    del again, first

    # (2) the fused step through its graph
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph_step = make_train_step(cfg, tc, tx)  # graphs: the default here
    captures = TrainStepGraph.captures
    graph = steps(graph_step, TRAIN_GRAPH_STEPS)
    graph_peak = _peak_gb()
    (step_graph,) = graph_step.graphs.values()
    if TrainStepGraph.captures != captures + 1 or step_graph.graph is None \
            or step_graph.calls != TRAIN_GRAPH_STEPS:
        raise AssertionError(f"fused step: {TrainStepGraph.captures - captures}"
                             f" captures over {step_graph.calls} calls")
    differ = graph[3].differing(eager[3])
    equal = graph[0] == eager[0] and not differ
    graph_vs_eager = 0.0 if equal else graph[3].max_rel_diff(eager[3])
    eager_s = float(np.median(eager[1][1:]))
    replay_s = float(np.median(graph[1][2:]))
    dispatch_s = {"eager": float(np.median(eager[4][1:])),
                  "replay": float(np.median(graph[4][2:]))}
    log("train", fused="graph vs eager", eager_losses=[
        f"{x:.6f}" for x in eager[0]], graph_losses=[
        f"{x:.6f}" for x in graph[0]], bit_equal=equal,
        leaves_differing=len(differ),
        graph_vs_eager_max_rel=f"{graph_vs_eager:.3g}",
        eager_step_s=json.dumps([round(x, 4) for x in eager[1]]),
        graph_step_s=json.dumps([round(x, 4) for x in graph[1]]),
        eager_median_s=f"{eager_s:.4f}", replay_median_s=f"{replay_s:.4f}",
        eager_positions_per_s=f"{positions / eager_s:.1f}",
        replay_positions_per_s=f"{positions / replay_s:.1f}",
        host_dispatch_s=json.dumps({k: round(v, 4)
                                    for k, v in dispatch_s.items()}),
        replay_launches=json.dumps(graph[2][-1]),
        peak_gb_eager=json.dumps([round(x, 2) for x in eager_peak]),
        peak_gb_graph=json.dumps([round(x, 2) for x in graph_peak]))
    # bit-equal where the eager step is reproducible, else within its own
    # run-to-run difference
    if (reproducible and not equal) or graph_vs_eager > eager_vs_eager:
        raise AssertionError(f"fused step graph vs eager: losses "
                             f"{graph[0]} vs {eager[0]}, {len(differ)} "
                             f"leaves differ ({differ[:3]})")
    if not all(np.isfinite(graph[0])) or not graph[0][-1] < graph[0][0]:
        raise AssertionError(f"losses {graph[0]}: not finite or did not "
                             f"decrease")
    for n in frozen:
        if not torch.equal(frozen[n], before[n]):
            raise AssertionError(f"frozen {n} changed")
    for n in trained:
        if torch.equal(trained[n], before[n]):
            raise AssertionError(f"trainable {n} did not change")
    del before, eager

    # (3) accumulation windows of two micro-batches
    def windows(graphs):
        start.restore(state)
        grad_fn, apply_fn, _, grad_accum_fn = make_grad_and_apply(
            cfg, tc, tx, graphs=graphs)
        losses, seconds, counts = [], [], []
        for _ in range(TRAIN_WINDOWS):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss0, acc = grad_fn(state.params, *micro[0])
            loss1, acc = grad_accum_fn(state.params, acc, *micro[1])
            apply_fn(state, acc, scale=0.5)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts.append(read())
            losses += [loss0, loss1]
        del acc
        launches.extend(counts)
        want = {k: 2 * v for k, v in per_step.items()}
        if any(c != want for c in counts):
            raise AssertionError(f"window launches {counts}, want {want}")
        return ([float(x) for x in losses], seconds, counts,
                _TrainSnapshot(state, tx), grad_fn.graphs)

    accum_eager = windows(False)
    grad_captures = GradGraph.captures
    accum_graph = windows(True)
    accum_differ = accum_graph[3].differing(accum_eager[3])
    accum_equal = accum_graph[0] == accum_eager[0] and not accum_differ
    accum_max_rel = 0.0 if accum_equal else accum_graph[3].max_rel_diff(
        accum_eager[3])
    log("train", accumulation="graph vs eager", windows=TRAIN_WINDOWS,
        eager_micro_losses=[f"{x:.6f}" for x in accum_eager[0]],
        graph_micro_losses=[f"{x:.6f}" for x in accum_graph[0]],
        bit_equal=accum_equal, leaves_differing=len(accum_differ),
        graph_vs_eager_max_rel=f"{accum_max_rel:.3g}",
        eager_window_s=json.dumps([round(x, 4) for x in accum_eager[1]]),
        graph_window_s=json.dumps([round(x, 4) for x in accum_graph[1]]),
        replay_positions_per_s=f"{micro_positions / accum_graph[1][-1]:.1f}",
        captures=GradGraph.captures - grad_captures,
        graphs=len(accum_graph[4]))
    if not all(np.isfinite(accum_graph[0])):
        raise AssertionError(f"window losses {accum_graph[0]}")
    if (reproducible and not accum_equal) or accum_max_rel > eager_vs_eager:
        raise AssertionError(f"window graph vs eager: {accum_graph[0]} vs "
                             f"{accum_eager[0]}, {len(accum_differ)} leaves "
                             f"differ ({accum_differ[:3]})")
    if GradGraph.captures - grad_captures != 2 or len(accum_graph[4]) != 3 \
            or any(g.graph is None for g in accum_graph[4].values()):
        raise AssertionError("the window's write, add and apply graphs: one "
                             "capture each")
    pool_gb = _train_pool_gb([step_graph] + accum_graph[4].values())
    graph_losses = graph[0]
    del accum_eager, accum_graph, graph

    # (4) where the time goes: one eager step and one replay profiled; the
    # idle share over the profiled wall and over the unprofiled median
    profiled = []
    for name, step_fn, out_file in (
            ("train_step_eager", eager_step, "train_profile.txt"),
            ("train_step_replay", graph_step, "train_replay_profile.txt")):
        reset()
        profiled.append(_profile(name, lambda: step_fn(state, batch, layout),
                                 out_file, cpu=False))
        launches.append(read())
        if launches[-1] != per_step:
            raise AssertionError(f"{name} launches {launches[-1]}, want "
                                 f"{per_step}")
    prof_eager, prof_replay = profiled
    idle = {"eager": _idle_share(prof_eager, prof_eager["wall_s"]),
            "replay": _idle_share(prof_replay, prof_replay["wall_s"]),
            "eager_unprofiled": _idle_share(prof_eager, eager_s),
            "replay_unprofiled": _idle_share(prof_replay, replay_s)}
    log("train", device_idle_share=json.dumps(
        {k: round(v, 4) for k, v in idle.items()}),
        train_pool_gb=f"{pool_gb:.3f}")

    # (5) the kernel path against the plain path on one micro-batch, eager,
    # same weights
    grad_fn = make_grad_and_apply(cfg, tc, tx, graphs=False)[0]
    reset()
    loss_k, grads_k = grad_fn(state.params, *micro[0])
    k_launches = read()
    plain_fn = make_grad_and_apply(cfg, tc, tx, attn_impl="reference",
                                   graphs=False)[0]
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
    return {"launches": launches, "losses": graph_losses,
            "eager_step_s": eager_s, "replay_step_s": replay_s,
            "positions_per_s": {"eager": positions / eager_s,
                                "replay": positions / replay_s},
            "host_dispatch_s": dispatch_s,
            "bit_reproducible": reproducible, "graph_bit_equal": equal,
            "accum_bit_equal": accum_equal, "idle_share": idle,
            "peak_gb": {"eager": eager_peak, "graph": graph_peak},
            "pool_gb": pool_gb, "parity": parity,
            "graphs": len(graph_step.graphs) + 3}


# Phase 9b: the QLoRA recipe's flags (scripts/legacy/finetune_qlora.sh) on
# phase 9's DAMC stage-2 model; its steps and the A/B's turns
QLORA_FLAGS = ["--quantize_frozen_base", "True", "--loss_chunk", "256",
               "--adam_mu_dtype", "bfloat16"]
INT8_TRAIN_STEPS = 3  # eager steps; graph steps: eager, capture, replay
INT8_AB_TURNS = ("plain", "k7", "k7", "plain")
INT8_AB_STEPS = 2  # eager steps a turn, from the same state
# K7 against the plain dx on the same steps: the two differ in dx's
# summation order alone (K7 sums each dx in one block in k order, cuBLAS
# in its own), so two Adam steps on the random 7B move the second loss by
# rounding only: 8.3e-6 of it in two smokes (NVIDIA H100 80GB HBM3,
# 700 W); relative, 12 times that
INT8_AB_LOSS_TOL = 1e-4


class _PlainDx:
    """The A/B's plain arm: while entered, ``quant.w8a16_dx`` computes the
    plain route (``_dequant_matmul_dx``) on the card instead of launching
    K7; nothing else changes."""

    def __enter__(self):
        from modelcompose_tpu_torch.ops import quant
        self.k7 = quant._k7
        quant._k7 = quant._dequant_matmul_dx
        return self

    def __exit__(self, *exc):
        from modelcompose_tpu_torch.ops import quant
        quant._k7 = self.k7


def phase_train_int8(device):
    """Phase 9b: the int8-base (QLoRA) train step at Vicuna-7B width and
    depth: phase 9's DAMC stage-2 vision model (modal+language LoRA r=128,
    mlp2x_gelu, CLIP ViT-L/14-336, remat) built by the train entry's
    ``build_model`` with the QLoRA recipe's ``--quantize_frozen_base True
    --loss_chunk 256 --adam_mu_dtype bfloat16``, at the DAMC recipes'
    per-device B=4 x 2,048 (rows of real lengths; the QLoRA recipe's B=16
    is cut for time).  From one saved trainable state: INT8_TRAIN_STEPS
    fused steps eagerly and through a ``TrainStepGraph`` (eager call,
    capture, replay), losses, LoRA leaves and Adam moments bit-equal;
    every step K6 14 a layer + 2 a loss chunk, K7 7 a layer + 1 a chunk,
    K1 2 a layer, K3 and K4 1, no K5, from the counters; step s,
    positions/s, the device-idle share of one replayed step
    (torch.profiler), peak memory; then the A/B of K7 against the plain dx
    in turns (INT8_AB_TURNS, INT8_AB_STEPS eager steps each from the same
    state): losses within INT8_AB_LOSS_TOL, step s and peak memory."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.ops import quant
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.train.step_graph import TrainStepGraph
    from modelcompose_tpu_torch.train.train_multimodal import (
        build_arg_parser, build_model, build_model_config, make_batch)
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_optimizer, make_train_step)
    counters = {"flash_attention_fwd": flash_attention_forward,
                "flash_attention_bwd_dq": flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
                "w8a16_gemv": quant.dequant_matmul,
                "w8a16_gemm": quant.w8a16_gemm, "w8a16_dx": quant.w8a16_dx}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}
    args = build_arg_parser().parse_args([
        "--model_name_or_path", "vicuna-7b-v1.5", "--data_path", "-",
        "--output_dir", "-", "--random_init_backbone", "--seed", str(SEED),
        "--mm_vision_encoder", "clip-vit-large-patch14-336",
        "--mm_projector_type", "mlp2x_gelu", "--mm_vision_select_layer", "-2",
        "--lora_strategy", "modal+language", "--lora_r", "128",
        "--lora_alpha", "256", "--local_prefix_tokens", "5",
        "--local_suffix_tokens", "5", "--gradient_checkpointing", "True",
        *QLORA_FLAGS])
    t0 = time.perf_counter()
    cfg = build_model_config(args)
    with warnings.catch_warnings():  # random tower weights are the point
        warnings.simplefilter("ignore")
        model = build_model(args, cfg, device)
    layers = model.params["layers"]
    if not all(quant.is_quantized(p["w"]) for grp in ("attn", "mlp")
               for p in layers[grp].values()) \
            or not quant.is_quantized(model.params["lm_head"]):
        raise AssertionError("--quantize_frozen_base left a bf16 base weight")
    rng = np.random.default_rng(SEED + 9)
    batch, layout = make_batch(model, _train_samples(cfg, rng,
                                                     INT8_TRAIN_SPANS))
    tc = TrainConfig(learning_rate=2e-4, mm_projector_lr=2e-5,
                     mm_language_lr=1e-5, warmup_ratio=0.0,
                     loss_chunk=args.loss_chunk,
                     adam_mu_dtype=args.adam_mu_dtype)
    tx, _ = make_optimizer(cfg, tc, {"backbone": model.params,
                                     "projectors": model.projectors})
    state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
    B, L = batch["token_ids"].shape
    positions = int((batch["segment_ids"] != 0).sum())
    n, chunks = cfg.num_hidden_layers, L // tc.loss_chunk
    per_step = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n, "w8a16_gemv": 0,
                "w8a16_gemm": 14 * n + 2 * chunks,
                "w8a16_dx": 7 * n + chunks}
    torch.cuda.synchronize()
    log("train_int8", setup_s=f"{time.perf_counter() - t0:.1f}",
        bucket=(B, L), positions=positions,
        lengths=[int(x) for x in (batch["segment_ids"] != 0).sum(1)],
        loss_chunks=chunks, mu_dtype=str(
            next(iter(state.opt_state["mu"].values())).dtype),
        gpu_mem_gb=f"{torch.cuda.memory_allocated() / 2**30:.1f}",
        per_step=json.dumps(per_step))
    start = _TrainSnapshot(state, tx)
    launches = []

    def steps(step, k, want=per_step):
        """``k`` steps from ``start``, each one's launches recorded and
        held to ``want``: (losses, seconds, the state after, peak GB)."""
        start.restore(state)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, seconds = [], []
        for i in range(k):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss = step(state, batch, layout)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(float(loss))
            launches.append(read())
            if launches[-1] != want:
                raise AssertionError(f"int8-base step {i}: launches "
                                     f"{launches[-1]}, want {want}")
        return losses, seconds, _TrainSnapshot(state, tx), _peak_gb()

    # (1) eagerly, then through the step's graph (eager call, capture,
    # replay), from the same state
    eager_step = make_train_step(cfg, tc, tx, graphs=False)
    eager = steps(eager_step, INT8_TRAIN_STEPS)
    graph_step = make_train_step(cfg, tc, tx)  # graphs: the default here
    captures = TrainStepGraph.captures
    graph = steps(graph_step, INT8_TRAIN_STEPS)
    (step_graph,) = graph_step.graphs.values()
    if TrainStepGraph.captures != captures + 1 or step_graph.graph is None:
        raise AssertionError("int8-base step: not one capture")
    if (len(step_graph.k5.gemm), len(step_graph.k5.dx),
            len(step_graph.k5.launches)) != (per_step["w8a16_gemm"],
                                             per_step["w8a16_dx"], 0):
        raise AssertionError(f"int8-base capture recorded "
                             f"{len(step_graph.k5.gemm)} K6 and "
                             f"{len(step_graph.k5.dx)} K7 launches")
    differ = graph[2].differing(eager[2])
    equal = graph[0] == eager[0] and not differ
    log("train_int8", eager_losses=[f"{x:.6f}" for x in eager[0]],
        graph_losses=[f"{x:.6f}" for x in graph[0]], bit_equal=equal,
        leaves_differing=len(differ),
        eager_step_s=json.dumps([round(x, 4) for x in eager[1]]),
        graph_step_s=json.dumps([round(x, 4) for x in graph[1]]),
        peak_gb_eager=json.dumps([round(x, 2) for x in eager[3]]),
        peak_gb_graph=json.dumps([round(x, 2) for x in graph[3]]),
        replay_launches=json.dumps(launches[-1]))
    if not equal:
        raise AssertionError(f"int8-base step graph vs eager: losses "
                             f"{graph[0]} vs {eager[0]}, {len(differ)} "
                             f"leaves or moments differ ({differ[:3]})")
    if not all(np.isfinite(eager[0])) or not eager[0][-1] < eager[0][0]:
        raise AssertionError(f"int8-base losses {eager[0]}: not finite or "
                             f"did not decrease")
    eager_s, replay_s = eager[1][-1], graph[1][-1]

    # (2) where the time goes: one more replay profiled
    reset()
    prof = _profile("train_int8_replay", lambda: graph_step(state, batch,
                                                            layout),
                    "train_int8_profile.txt", cpu=False)
    launches.append(read())
    if launches[-1] != per_step:
        raise AssertionError(f"profiled int8-base replay launches "
                             f"{launches[-1]}, want {per_step}")
    idle = {"replay": _idle_share(prof, prof["wall_s"]),
            "replay_unprofiled": _idle_share(prof, replay_s)}
    del graph_step, step_graph  # the graph and its pool go before the A/B

    # (3) K7 against the plain dx, in turns, eager steps from one state
    ab = {"plain": [], "k7": []}
    for arm in INT8_AB_TURNS:
        with (_PlainDx() if arm == "plain" else contextlib.nullcontext()):
            losses, seconds, _, peak = steps(
                eager_step, INT8_AB_STEPS,
                dict(per_step, w8a16_dx=0) if arm == "plain" else per_step)
        ab[arm].append({"losses": losses, "step_s": seconds[-1],
                        "peak_gb": peak})
    base = ab["plain"][0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for r in ab["plain"] + ab["k7"]
                   for a, b in zip(r["losses"], base))
    log("train_int8", ab="K7 vs plain dx, in turns " + "/".join(
        INT8_AB_TURNS), step_s=json.dumps(
            {k: [round(r["step_s"], 4) for r in v] for k, v in ab.items()}),
        losses=json.dumps({k: [[round(x, 6) for x in r["losses"]]
                               for r in v] for k, v in ab.items()}),
        loss_max_rel=f"{loss_rel:.3g}", tol=INT8_AB_LOSS_TOL,
        peak_gb=json.dumps({k: [round(r["peak_gb"][0], 2) for r in v]
                            for k, v in ab.items()}))
    if not loss_rel <= INT8_AB_LOSS_TOL:
        raise AssertionError(f"K7 arm's losses off the plain dx arm's by "
                             f"{loss_rel:.3g}")
    med = {k: float(np.median([r["step_s"] for r in v]))
           for k, v in ab.items()}
    log("train_int8", eager_step_s=f"{eager_s:.4f}",
        replay_step_s=f"{replay_s:.4f}",
        replay_positions_per_s=f"{positions / replay_s:.1f}",
        device_idle_share=json.dumps({k: round(v, 4)
                                      for k, v in idle.items()}),
        ab_median_step_s=json.dumps({k: round(v, 4) for k, v in med.items()}))
    return {"launches": launches, "losses": eager[0],
            "eager_step_s": eager_s, "replay_step_s": replay_s,
            "positions": positions, "positions_per_s": {
                "eager": positions / eager_s, "replay": positions / replay_s},
            "idle_share": idle, "graph_bit_equal": equal,
            "peak_gb": {"eager": eager[3], "graph": graph[3]},
            "ab": {"median_step_s": med, "loss_max_rel": loss_rel,
                   "peak_gb": {k: max(r["peak_gb"][0] for r in v)
                               for k, v in ab.items()}},
            "per_step": per_step}


# Kernel-name fragments of each profile split: the hand-written kernels,
# and the library GEMMs (cuBLAS nvjet / xmma, magma) and convolutions.
# Kernel names to profile splits: a name goes to the first split whose
# fragment it holds (K6's w8a16_gemm_kernel is K6's, not a library GEMM;
# K7's two passes, w8a16_dx_scale_kernel and w8a16_dx_kernel, are both
# K7's).  tests/test_torch_k7.py holds every kernel of csrc/ to its split.
PROFILE_SPLITS = {"K1": ("fa_fwd_kernel", "fa_fwd_f32_kernel"),
                  "K2": ("fd_split_kernel",),
                  "K3": ("fa_bwd_dq_kernel", "fa_bwd_dq_f32_kernel"),
                  "K4": ("fa_bwd_dkv_kernel", "fa_bwd_dkv_f32_kernel"),
                  "K5": ("dequant_gemv",), "K6": ("w8a16_gemm",),
                  "K7": ("w8a16_dx",), "K8": ("add_rms_norm",),
                  "K9": ("rope_kv_write",), "K10": ("silu_mul",),
                  "gemm": ("gemm", "nvjet"), "conv": ("conv",),
                  "copy": ("copy_kernel",)}


def _split_of(kernel: str):
    """The PROFILE_SPLITS name of a kernel, or None."""
    k = kernel.lower()
    return next((name for name, frags in PROFILE_SPLITS.items()
                 if any(f in k for f in frags)), None)


def _profile(name, fn, out_file, cpu=True):
    """torch.profiler over one call of ``fn``: device time by kernel and
    the shares of PROFILE_SPLITS, the table written to chiprun_out/.
    ``cpu=False`` records the card's activity alone (no host op events:
    less of the profiler's own host time in the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = {e.key: e.device_time_total for e in events
           if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    total = sum(dev.values())
    share = {name: round(sum(t for k, t in dev.items()
                             if _split_of(k) == name) / total, 4)
             for name in PROFILE_SPLITS} if total else {}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_file), "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    log("profile", run=name, wall_s=f"{wall:.4f}",
        device_kernel_s=f"{total / 1e6:.4f}", shares=json.dumps(share))
    counts = {e.key: e.count for e in events
              if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    return {"wall_s": wall, "device_kernel_s": total / 1e6, "shares": share,
            "device_us": dev, "device_counts": counts}


# The train_entry phase: Vicuna-7B v1.5 at full width (its config.json)
# with its depth cut from 32 layers to 8 (writing, loading and exporting
# the 32-layer base took most of the phase's 150 s, a quarter of the
# smoke; the int8-base train phase 9b needs the room: on an H100 the
# smoke took 524-549 s with 8 layers here, 600 s with 12 (68 s here),
# against a working budget of 627 s, inside the smoke's limit of 1,200 s,
# and a spread of ~30 s between runs), and the
# point recipes' flags
# (scripts/model_composition/train/run_pretrain_point.sh,
# run_finetune_point_damc.sh) cut in steps.
VICUNA_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=8, num_attention_heads=32,
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
ENTRY_STEPS = {"stage1": 3, "stage2": 6, "stage2_resumed": 6}
ENTRY_CHECKPOINT = 4  # stage 2's step checkpoint (--save_steps), resumed
# at 32 layers: 13.5 GB of base, a 3.9 GB step checkpoint, 5.3 GB of fp32
# adapter export (.bin, and .safetensors where the package imports)
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
    """A Vicuna-7B v1.5 directory (``VICUNA_7B``'s layers) from SEED: two
    fp16 shards with their index and the Llama config.json, as the
    released one has them; weights
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
    """(reset, read) of the launch counts of K1-K6 and K8-K10."""
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention
    from modelcompose_tpu_torch.ops.quant import dequant_matmul, w8a16_gemm
    fns = {"flash_attention_fwd": flash_attention_forward,
           "flash_decode": flash_decode_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "w8a16_gemv": dequant_matmul, "w8a16_gemm": w8a16_gemm,
           **_fused_fns()}

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
    """The DAMC train entry at Vicuna-7B width (``VICUNA_7B``: 8 of its
    32 layers) from a base on disk, its steps through the train graphs (the default on the card):
    stage 1 (projector pretrain, B=16, 3 steps), stage 2 on its export
    (modal+language LoRA r=128, 5+5 soft tokens, B=4, 6 steps, checkpoint-4
    on the way), the same flags resumed from checkpoint-4 to 6 steps (its
    losses bit-equal to the uninterrupted run's), then the export loaded
    by ``load_pretrained_model`` and one point question decoded greedily by
    ``run_questions``; after the path, each kernel against its plain
    version at the inputs the path gave it."""
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
        kinds = _all_graph_counts()
        with _EntryProbe(entry, read, device, profile_step, watch) as probe, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random PointBERT tower
            t0 = time.perf_counter()
            res = entry.train(args, tokenizer=tokenizer, device=device,
                              time_skip=skip)
            wall = time.perf_counter() - t0
        graphs = _graph_delta(kinds)
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
               "start_step": res["start_step"], "graphs": graphs,
               "loop_trace_median_s": {
                   k: float(np.median([t[k] for t in res["loop_trace"]]))
                   for k in ("loader_wait", "make_batch", "dispatch")}}
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
            graphs=json.dumps(graphs), loop_trace_median_s=json.dumps(
                {k: round(v, 4)
                 for k, v in row["loop_trace_median_s"].items()}),
            export_gb=f"{_gb(row['export_bytes']):.3f}",
            **{k: (f"{v:.2f}" if isinstance(v, float) else v)
               for k, v in probe.times.items() if k != "build_model_s"})
        # every micro-batch ran the kernels, eager, capturing or replayed:
        # K1 twice a layer under remat, K3 and K4 once
        for i, counts in enumerate(row["launches"]):
            if counts["flash_attention_fwd"] != 2 * n_layers \
                    or counts["flash_attention_bwd_dq"] != n_layers \
                    or counts["flash_attention_bwd_dkv"] != n_layers:
                raise AssertionError(f"{stage} step {i}: launches {counts}")
        # a shape's first step runs eagerly, its second captures, the rest
        # replay
        per_shape = [row["buckets"].count(b) for b in set(row["buckets"])]
        want = [sum(n >= 2 for n in per_shape),
                sum(max(n - 2, 0) for n in per_shape)]
        if graphs.get("train_step", [0, 0]) != want:
            raise AssertionError(f"{stage}: train graphs {graphs}, want "
                                 f"[captures, replays] {want} for steps "
                                 f"of buckets {row['buckets']}")
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
            # a profile of stage 2's third step (its first replay)
            probe, res = run(stage, watch=watch_leaves(stage),
                             profile_step=2 if stage == "stage2" else None)
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
        if probe.restored_step != ENTRY_CHECKPOINT \
                or res["start_step"] != ENTRY_CHECKPOINT \
                or not res["resumed_from"].endswith(
                    f"checkpoint-{ENTRY_CHECKPOINT}"):
            raise AssertionError(f"resume: step {probe.restored_step}, "
                                 f"{res['resumed_from']}")
        # the resumed steps are the uninterrupted run's, bit for bit
        uninterrupted = out["stage2"]["losses"][ENTRY_CHECKPOINT:]
        log("train_entry", resumed_losses=res["losses"],
            uninterrupted_losses=uninterrupted,
            resumed_equal=res["losses"] == uninterrupted)
        if res["losses"] != uninterrupted:
            raise AssertionError(f"resumed losses {res['losses']} != the "
                                 f"uninterrupted run's {uninterrupted}")
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


# Phase 10b: the train entry with --bf16 False on phase 10's stage-2
# recipe (its base, its clouds) at B=2 in the 2,048 bucket: answers of
# these many words pack each sample to about 1,400 and 1,100 positions,
# phase 9's rows (so K3 and K4 see phase 8's train shapes), four steps
# (eager, capture, two replays), with no step checkpoint
ENTRY_F32_WORDS = (800, 500)
ENTRY_F32_SAMPLES = 8
ENTRY_F32_STEPS = 4
# its losses against the same steps on the plain attention, relative: the
# first step's loss comes before any update and is held as the forward is
# (ATTN_F32_TOL); after Adam's first update (the recipe's warmup of 3% of
# 4 steps is none) a gradient near eps moves its element by up to the
# learning rate on either route
F32_LOSS_TOL_UPDATED = 1e-4


def _long_point_dataset(root):
    """ENTRY_F32_SAMPLES v1 question-answer conversations over phase 10's
    first clouds, their answers ENTRY_F32_WORDS words long in turn."""
    import numpy as np
    rng = np.random.default_rng(SEED + 10)
    data = []
    for i in range(ENTRY_F32_SAMPLES):
        words = " ".join(rng.choice(WORDS, ENTRY_F32_WORDS[i % 2]))
        data.append({"id": i, "conversations": [
            {"from": "human", "value": "<point>\nWhat is this object? "
                                       "Describe it in detail."},
            {"from": "gpt", "value": words}],
            "modal_inputs": {"point": [os.path.join(root,
                                                    f"cloud{i:02d}.npy")]}})
    path = os.path.join(root, "point_stage2_long.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def phase_train_entry_fp32(device, root):
    """Phase 10b: ``train()`` with ``--bf16 False`` (a float32 model) on
    phase 10's stage-2 flags and base (8 layers at Vicuna-7B width, remat)
    at B=2 in the 2,048 bucket, through the train graphs: every step K1
    twice a layer and K3 and K4 once, counted exactly, the fp32 kernels;
    then the same run on the plain attention (``make_train_step`` with
    ``attn_impl="reference"``, no K1/K3/K4 launch): the first loss within
    ATTN_F32_TOL of its (no update yet), the rest within
    F32_LOSS_TOL_UPDATED; peak GB and step seconds of both."""
    import functools
    import numpy as np
    import torch
    from modelcompose_tpu_torch.train import train_multimodal as entry
    reset, read = _kernel_counters()
    base_dir = os.path.join(root, "vicuna-7b-v1.5")
    data = _long_point_dataset(root)
    n_layers = VICUNA_7B["num_hidden_layers"]
    flags = ["--model_name_or_path", base_dir, "--data_path", data] \
        + ENTRY_FLAGS + STAGE2_FLAGS + [
            "--bf16", "False", "--per_device_train_batch_size", "2",
            "--save_steps", "100000", "--max_steps", str(ENTRY_F32_STEPS)]
    out, launches = {}, {}
    make_step = entry.make_train_step
    reset()
    for impl in ("auto", "reference"):
        args = entry.build_arg_parser().parse_args(flags + [
            "--output_dir", os.path.join(root, f"point-fp32-{impl}")])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kinds = _all_graph_counts()
        if impl == "reference":
            entry.make_train_step = functools.partial(make_step,
                                                      attn_impl=impl)
        try:
            with _EntryProbe(entry, read, device) as probe, \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the random PointBERT
                t0 = time.perf_counter()
                res = entry.train(args, tokenizer=WordHashTokenizer(),
                                  device=device)
                wall = time.perf_counter() - t0
        finally:
            entry.make_train_step = make_step
        graphs = _graph_delta(kinds)
        dtypes = {str(t.dtype) for t in _trainable(probe.model).values()}
        row = {"wall_s": wall, "build_model_s": probe.times["build_model_s"],
               "step_s": [st["s"] for st in probe.steps],
               "buckets": [st["bucket"] for st in probe.steps],
               "positions": res["positions"], "losses": res["losses"],
               "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
               "graphs": graphs, "trainable_dtypes": sorted(dtypes),
               "launches": [st["launches"] for st in probe.steps]}
        del probe
        want = [2 * n_layers, n_layers, n_layers] if impl == "auto" \
            else [0, 0, 0]
        for i, counts in enumerate(row["launches"]):
            got = [counts[k] for k in ("flash_attention_fwd",
                                       "flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv")]
            if got != want:
                raise AssertionError(f"train_entry_fp32 {impl} step {i}: "
                                     f"K1/K3/K4 {got}, want {want}")
        if row["buckets"] != [(2, 2048)] * ENTRY_F32_STEPS \
                or graphs.get("train_step") != [1, ENTRY_F32_STEPS - 2] \
                or dtypes != {"torch.float32"} \
                or not np.isfinite(row["losses"]).all():
            raise AssertionError(f"train_entry_fp32 {impl}: buckets "
                                 f"{row['buckets']}, graphs {graphs}, "
                                 f"trained {dtypes}, losses {row['losses']}")
        log("train_entry_fp32", attn_impl=impl,
            build_model_s=f"{row['build_model_s']:.1f}",
            step_s=json.dumps([round(x, 4) for x in row["step_s"]]),
            positions=json.dumps(row["positions"]),
            losses=json.dumps(row["losses"]),
            peak_gb=f"{row['peak_gb']:.2f}", graphs=json.dumps(graphs),
            wall_s=f"{wall:.1f}")
        out[impl] = row
    got, ref = (np.array(out[k]["losses"]) for k in ("auto", "reference"))
    rel = np.abs(got - ref) / np.abs(ref)
    tols = np.array([ATTN_F32_TOL] + [F32_LOSS_TOL_UPDATED]
                    * (ENTRY_F32_STEPS - 1))
    log("train_entry_fp32", loss_rel=json.dumps([float(f"{x:.3g}")
                                                 for x in rel]),
        loss_tol=json.dumps(tols.tolist()))
    if not (rel <= tols).all():
        raise AssertionError(f"train_entry_fp32: kernel-path losses {got} "
                             f"vs plain {ref}: {rel} (tol {tols})")
    counted = read()
    out["launches"] = {k: counted[k] for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    out["loss_rel"] = rel.tolist()
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
                for k in FORWARD_KERNELS}
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
    ('reference' replaces K1, K2 and K5 by their plain versions) and
    records its prompt, media and answer."""

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


def _kernel_vs_plain(model, kernel_calls, plain_calls, kv_quant=False,
                     phase="legacy_eval", tol=LOGIT_TOL):
    """Each greedy answer of the kernel path against the plain path's.  On
    the same prompt: equal, or leaving it at a near tie: the
    teacher-forced logits of both paths at the first differing step within
    ``tol`` (LOGIT_TOL) of max |logit|, and the plain path's top-2 gap
    there under ``tol``.  A call whose prompt differs between the paths
    follows an answer that left the plain path's (ScienceQA's answer
    prompter puts the first answer into the second prompt), so it has no
    plain answer to compare with: the kernel path's answer is held to the
    plain path teacher-forced on the kernel path's prompt
    (``_follow_up_vs_plain``).
    A prompt that differs before any answer did raises."""
    import numpy as np
    import torch
    if len(kernel_calls) != len(plain_calls):
        raise AssertionError(f"{len(kernel_calls)} kernel-path calls, "
                             f"{len(plain_calls)} plain-path calls")
    eos = model.cfg.eos_token_id
    out = []
    diverged = False
    for (ids, inputs, got), (plain_ids, _, want) in zip(kernel_calls,
                                                        plain_calls):
        got, want = got[0], want[0]
        if len(ids) != len(plain_ids) or not all(
                np.array_equal(a, b) for a, b in zip(ids, plain_ids)):
            if not diverged:
                raise AssertionError("the paths' prompts differ before any "
                                     "answer left the plain path's")
            out.append(_follow_up_vs_plain(model, ids, inputs, got))
            continue
        if got == want:
            out.append({"equal": True, "tokens": len(got)})
            continue
        diverged = True
        step = next(i for i, (a, b) in enumerate(zip(got + [None],
                                                     want + [None]))
                    if a != b)
        tokens = torch.tensor([(got + [eos])[:step + 1]],
                              device=model.device)
        with torch.no_grad():
            k, p = (_teacher_forced(model, ids, inputs, tokens, impl,
                                    kv_quant=kv_quant)[0, step]
                    for impl in ("auto", "reference"))
        scale = p.abs().max()
        rel = ((k - p).abs().max() / scale).item()
        top2 = p.topk(2).values
        gap = ((top2[0] - top2[1]) / scale).item()
        log(phase, diverge_step=step, kernel_len=len(got),
            plain_len=len(want), logit_rel_err=f"{rel:.3g}",
            plain_top2_gap_rel=f"{gap:.4g}", tol=tol)
        if rel > tol or gap > tol:
            raise AssertionError(f"kernel-path answer leaves the plain "
                                 f"path's at step {step}: logits {rel:.3g}"
                                 f", top-2 gap {gap:.3g} of max |logit|")
        out.append({"equal": False, "diverge_step": step, "rel": rel,
                    "top2_gap_rel": gap})
    return out


def _follow_up_vs_plain(model, ids, inputs, got):
    """The kernel path's answer ``got`` to a prompt the plain path did not
    see, teacher-forced through both paths on that prompt: at every step
    the logits within LOGIT_TOL of max |logit|, and the kernel path's
    token the plain path's greedy pick or within LOGIT_TOL of it."""
    import torch
    if not got:
        return {"equal": False, "follow_up": True, "tokens": 0}
    tokens = torch.tensor([got], device=model.device)
    with torch.no_grad():
        k, p = (_teacher_forced(model, ids, inputs, tokens, impl,
                                kv_quant=False)[0]
                for impl in ("auto", "reference"))
    scale = p.abs().amax(-1)
    rel = ((k - p).abs().amax(-1) / scale).max().item()
    picked = p.gather(-1, tokens[0, :, None].long())[:, 0]
    gap = ((p.amax(-1) - picked) / scale).max().item()
    log("legacy_eval", follow_up_tokens=len(got), logit_rel_err=f"{rel:.3g}",
        plain_gap_to_kernel_token_rel=f"{gap:.4g}", tol=LOGIT_TOL)
    if rel > LOGIT_TOL or gap > LOGIT_TOL:
        raise AssertionError(f"kernel-path answer to a follow-up prompt off "
                             f"the plain path's: logits {rel:.3g}, its token "
                             f"{gap:.3g} of max |logit| under the plain "
                             f"pick")
    return {"equal": False, "follow_up": True, "tokens": len(got),
            "rel": rel, "gap_to_plain_pick_rel": gap}


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
            if res["plain_launches"] != dict.fromkeys(FORWARD_KERNELS, 0):
                raise AssertionError(f"{entry}: the plain path launched "
                                     f"{res['plain_launches']}")
            res["vs_plain"] = _kernel_vs_plain(model, res["kernel_calls"],
                                               res["plain_calls"])
            n = len(res["kernel_calls"])
            steps = sum(max(len(out[0]) - 1, 0)
                        for _, _, out in res["kernel_calls"])
            launches = res["kernel_launches"]
            n_layers = model.cfg.num_hidden_layers
            # every K1 launch is a layer of a prefill, whose int8
            # products are K6's (a bucket of 512 rows or more)
            k6_layer = _k6_per_forward(model.params) // n_layers
            if launches["flash_attention_fwd"] < n * n_layers \
                    or launches["flash_decode"] < steps * n_layers \
                    or launches["w8a16_gemm"] \
                    != k6_layer * launches["flash_attention_fwd"]:
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
                for k in FORWARD_KERNELS}
    for res in entries.values():  # the recorded calls hold the pixels
        res.pop("kernel_calls"), res.pop("plain_calls")
    return {"images_host_ms": host_ms, "entries": entries, "tools": tools,
            "prefill_positions": prefills, "launches": launches,
            "kernel_checks": checks}


# ---------------------------------------------------------------------------
# Phase 14: the distribution layer at world 1 over NCCL
# ---------------------------------------------------------------------------

DIST_STEPS = 4  # fused steps of each run of 14b: eager, capture, 2 replays
DIST_WINDOWS = 3  # accumulation windows of each run of 14b: the same
DIST_SLOT_TOKENS = 12  # each request's greedy budget in 14a's slot runs
TP_SHARDS = (2, 4)  # the tensor-parallel degrees whose rank shapes K1/K2 run
DIST_TIMEOUT_S = 120  # the process group's timeout on every collective
SERVE_GRAPH_KINDS = ("decode", "prefill", "chunk_step")


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


def _dist_generate(model, request, device_loop):
    """MCUB-4's greedy request (int8 cache, compacted adapters) of
    NEW_TOKENS: on the graph path twice untimed (the decode graph of the
    request's cache length captures at its first step, its prefill graph
    at its second call), eagerly once with two tokens, then once timed.
    Returns the timed request's ids, timings, K1/K2 launches and graph
    counts, and the warm-up's graph counts."""
    import torch
    reset, read = _attention_counters()
    ids, inputs = request
    kw = dict(kv_quant=True, compact_adapters=True, device_loop=device_loop)
    before = _all_graph_counts()
    with torch.no_grad():
        for _ in range(2 if device_loop else 1):
            model.generate(ids, inputs, max_new_tokens=NEW_TOKENS
                           if device_loop else 2, **kw)
        warm = _graph_delta(before)
        before = _all_graph_counts()
        timings = {}
        reset()
        out = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                             timings=timings, **kw)
        launches = read()
    return {"ids": out, "timings": timings, "launches": launches,
            "graphs": _graph_delta(before), "warm": warm}


def _dist_slots(model, requests):
    """The slot pool (SERVE_SLOTS slots of SERVE_CACHE_LEN positions, int8,
    admissions chunked by SERVE_CHUNK) through the model's serving
    backbone, answering ``requests`` (name -> (ids, inputs)) greedily,
    DIST_SLOT_TOKENS tokens each: every request but the last admitted,
    two ticks, then the last (MCUB-4) admitted with a tick between its
    chunks, then ticks until every answer is done.  A tick is the
    engine's: the slots' ids drawn on the card (greedy) and fetched, then
    one decode step of the pool.  Returns (answers by name, tick seconds,
    K1/K2 launches, graph counts)."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.serve.slot_engine import SlotDecoder
    reset, read = _attention_counters()
    before = _all_graph_counts()
    reset()
    dec = SlotDecoder(model, SERVE_SLOTS, SERVE_CACHE_LEN, kv_quant=True,
                      prefill_chunk=SERVE_CHUNK, device=model.device)
    gen = torch.Generator(device=model.device)  # greedy rows draw nothing
    temps = np.zeros(SERVE_SLOTS, np.float32)
    top_ps = np.ones(SERVE_SLOTS, np.float32)
    names = list(requests)
    answers = {n: [] for n in names}
    eos = model.cfg.eos_token_id
    ticks = []

    def tick():
        t0 = time.perf_counter()
        tokens = dec.sample(gen, temps, top_ps)
        for slot in np.flatnonzero(dec.active):
            got = answers[names[slot]]
            if int(tokens[slot]) != eos:
                got.append(int(tokens[slot]))
            if int(tokens[slot]) == eos or len(got) == DIST_SLOT_TOKENS:
                dec.release(slot)
        dec.step(tokens)
        ticks.append(time.perf_counter() - t0)
    for slot, name in enumerate(names[:-1]):
        dec.admit(slot, *requests[name])
    for _ in range(2):
        tick()
    dec.admit(len(names) - 1, *requests[names[-1]], tick_cb=tick)
    while dec.active.any():
        tick()
    torch.cuda.synchronize()
    return answers, ticks, read(), _graph_delta(before)


def _replay_profile(name, graph, out_file):
    """torch.profiler over one replay of a captured decode ``graph``: its
    device activity by name (kernels and copies; the event waits that
    join a collective's stream are not traced), with the NCCL and copy
    rows picked out."""
    res = _profile(name, graph.replay, out_file, cpu=False)
    picked = {k: {"count": res["device_counts"][k],
                  "us": round(res["device_us"][k], 2)}
              for k in res["device_us"]
              if "nccl" in k.lower() or "memcpy" in k.lower()}
    return {"kernels": sum(res["device_counts"].values()),
            "device_us": round(sum(res["device_us"].values()), 1),
            "nccl_and_copies": picked}


def phase_distributed_serve(device, gen, model, request, serve_tick_ms):
    """Phase 14a: phase 6's MCUB-4 model sharded at tp 1 through the
    loader's tensor-parallel step (``apply_tensor_parallel``) in an NCCL
    process group of one.  Its greedy request through the prefill and
    decode graphs under the group (their NCCL collectives captured: the
    logits' all-gather copies through NCCL's stream, the all-reduces of
    one rank record nothing), against the same graphs with no group and
    the eager path under the group: ids bit-equal, captures and replays
    under the group counted, K1 = 32 a prefill and K2 = 32 a decode step
    from the counters, tok/s and prefill s of all three; one replayed
    decode step profiled under the group and with none.  Then the slot
    pool behind the leader's serving backbone, under the group and with
    none: the MCUB-4 request admitted in 512-position chunks beside two
    short vision requests, the answers bit-equal between the two and each
    held to its solo no-group run, the tick ms of both beside phase 11's.
    Then K1 and K2 at the tp 2 and 4 ranks' shapes."""
    import numpy as np
    from modelcompose_tpu_torch.parallel import tp
    from modelcompose_tpu_torch.parallel.mesh import apply_tensor_parallel
    n_layers = model.cfg.num_hidden_layers
    steps = NEW_TOKENS - 1
    per_request = {"flash_attention_fwd": n_layers,
                   "flash_decode": n_layers * steps,
                   "w8a16_gemv": _k5_per_step(model.params, 1) * steps + 1,
                   "w8a16_gemm": _k6_per_forward(model.params),
                   **{k: v * steps for k, v in
                      _fused_per_step(model.params, 1).items()}}
    vision_ids, vision_inputs = _requests(model.cfg, device, gen)
    slot_requests = {
        f"vision{i}": (vision_ids[i], {"vision": vision_inputs["vision"][
            i:i + 1]}) for i in range(2)}
    slot_requests["mcub4"] = (request[0][0], request[1])
    runs = {"no_group_graph": _dist_generate(model, request, True)}
    no_group_graph = [g for g in model.decode_graphs.values()][-1]
    profiles = {"no_group": _replay_profile(
        "decode_replay_no_group", no_group_graph,
        "distributed_decode_profile_no_group.txt")}
    slots = {"no_group": _dist_slots(model, slot_requests)}
    params = model.params
    with _NcclWorld1():
        mesh = apply_tensor_parallel(model, 1)
        group = model.tp_group
        if group is None or tp.model_size(group) != 1:
            raise AssertionError("no model group of one after the TP step")
        model._compact_cache.clear()  # compaction reruns on the shard
        runs["tp1_graph"] = _dist_generate(model, request, True)
        grouped = [g for g in model.decode_graphs.values()
                   if g.group is group]
        if not grouped:
            raise AssertionError("no decode graph of the tp 1 group")
        profiles["tp1"] = _replay_profile(
            "decode_replay_tp1", grouped[-1],
            "distributed_decode_profile.txt")
        with _EagerTTFT(model):
            runs["tp1_eager"] = _dist_generate(model, request, False)
        slots["tp1"] = _dist_slots(model, slot_requests)
        made = [g.group is group for g in model.decode_graphs.values()]
    model.params, model.tp_group, model._serving = params, None, None
    model._compact_cache.clear()
    model.decode_graphs.clear()  # the group's graphs go with the group
    model.prefill_graphs.clear()
    rates = {k: steps / r["timings"]["decode_s"] for k, r in runs.items()}
    prefill_s = {k: r["timings"]["prefill_s"] for k, r in runs.items()}
    log("distributed", path="mcub4_tp1", mesh=json.dumps(mesh.shape),
        ids_equal={k: r["ids"] == runs["no_group_graph"]["ids"]
                   for k, r in runs.items()},
        decode_tok_per_s=json.dumps({k: round(v, 2)
                                     for k, v in rates.items()}),
        prefill_s=json.dumps({k: round(v, 4) for k, v in prefill_s.items()}),
        launches=json.dumps({k: r["launches"] for k, r in runs.items()}),
        graphs=json.dumps({k: r["graphs"] for k, r in runs.items()}),
        warm_graphs=json.dumps({k: r["warm"] for k, r in runs.items()}),
        decode_graphs_under_group=f"{sum(made)} of {len(made)}")
    for name, r in runs.items():
        if r["ids"] != runs["no_group_graph"]["ids"]:
            raise AssertionError(f"greedy ids of {name} {r['ids']} != the "
                                 f"no-group graph run's "
                                 f"{runs['no_group_graph']['ids']}")
        if r["launches"] != per_request:
            raise AssertionError(f"{name}: launches {r['launches']}, "
                                 f"want {per_request}")
    for name in ("no_group_graph", "tp1_graph"):
        r = runs[name]
        if r["graphs"].get("decode") != [0, steps] \
                or r["graphs"].get("prefill") != [0, 1]:
            raise AssertionError(f"{name}: graph counts {r['graphs']}, want "
                                 f"{steps} decode replays and a prefill one")
    warm = runs["tp1_graph"]["warm"]
    if warm.get("decode", [0])[0] < 1 or warm.get("prefill", [0])[0] < 1:
        raise AssertionError(f"no capture under the group: {warm}")
    if runs["tp1_eager"]["graphs"]:
        raise AssertionError(f"the eager A/B replayed graphs: "
                             f"{runs['tp1_eager']['graphs']}")
    log("distributed", decode_replay_profile=json.dumps(profiles))
    # the slot pool: under the group equal to no group, each held to solo
    answers = {k: v[0] for k, v in slots.items()}
    tick_ms = {k: float(np.median(v[1])) * 1e3 for k, v in slots.items()}
    vs_solo = {}
    for name, (ids, inputs) in slot_requests.items():
        solo, logits = _solo_chunked(model, [ids], inputs, DIST_SLOT_TOKENS)
        vs_solo[name] = _slot_vs_solo("distributed_slots", name,
                                      answers["no_group"][name], solo,
                                      lambda i: logits[i], DIST_SLOT_TOKENS)
    log("distributed", path="slots_tp1", answers_equal=(
        answers["tp1"] == answers["no_group"]),
        tick_median_ms=json.dumps({**{k: round(v, 3)
                                      for k, v in tick_ms.items()},
                                   "phase11_no_group": serve_tick_ms}),
        ticks={k: len(v[1]) for k, v in slots.items()},
        launches=json.dumps({k: v[2] for k, v in slots.items()}),
        graphs=json.dumps({k: v[3] for k, v in slots.items()}),
        vs_solo=json.dumps({k: v.get("diverge_step", "equal")
                            for k, v in vs_solo.items()}))
    if answers["tp1"] != answers["no_group"]:
        raise AssertionError(f"slot answers under the tp 1 group "
                             f"{answers['tp1']} != no group's "
                             f"{answers['no_group']}")
    for k, v in slots.items():  # the pool decodes through its graph
        if not v[3].get("decode", [0, 0])[1]:
            raise AssertionError(f"slots {k}: no decode replay {v[3]}")
    k1, k2 = _tp_shard_cases(device, gen)
    launches = {"tp1_graph": runs["tp1_graph"]["launches"],
                "tp1_eager": runs["tp1_eager"]["launches"],
                "tp1_slots": slots["tp1"][2],
                "tp_no_group_ab": _sum_counts(runs["no_group_graph"]["launches"],
                                           slots["no_group"][2])}
    return {"launches": launches, "k1_tp_shards": k1, "k2_tp_shards": k2,
            "decode_tok_per_s": rates, "prefill_s": prefill_s,
            "slot_tick_ms": tick_ms, "profiles": profiles}


def _sum_counts(*counts):
    """The sum of launch-count dicts, key by key."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_distributed_train(device):
    """Phase 14b: phase 9's stage-2 train step at Vicuna-7B width and
    depth (B=2 x 2,048, remat) from one starting state, three ways:
    through the train graphs with no process group, through them in the
    data-parallel path (``mesh_for_batch``: the valid-target count, each
    gradient and the loss all-reduced over the data group, captured in
    the graphs) in an NCCL group of one, and eagerly in that group (the
    A/B).  Each run takes DIST_STEPS fused steps (eager, capture,
    replays) and DIST_WINDOWS accumulation windows of two B=1
    micro-batches (the grad, grad-accum and apply graphs): losses, every
    trainable leaf and the moments bit-equal across the three, K1 = 64
    and K3 = K4 = 32 a step from the counters, step s and the host's
    dispatch s of each, and the device-idle share of one replayed step
    under the group and with none (torch.profiler, as phase 9 reads it).
    At one rank no leaf has a ZeRO-1 axis (``zero_axis`` needs a data
    width above 1), so the moment slicing and its all-gather do not run
    here, nor any tensor-parallel collective or leader broadcast: the
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
        TrainConfig, init_train_state, make_grad_and_apply, make_optimizer,
        make_train_step, tree_leaves)
    counters = {"flash_attention_fwd": flash_attention_forward,
                "flash_attention_bwd_dq": flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}
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
    micro = [make_batch(model, {
        "input_ids": collated["input_ids"][i:i + 1],
        "labels": collated["labels"][i:i + 1],
        "modal_inputs": {"vision": collated["modal_inputs"]["vision"][
            i:i + 1]}}) for i in range(2)]
    tc = TrainConfig(learning_rate=2e-4, mm_projector_lr=2e-5,
                     mm_language_lr=1e-5, warmup_ratio=0.0)
    tree = {"backbone": model.params, "projectors": model.projectors}
    n_layers = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * n_layers,  # remat: twice
                "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers}
    per_window = {k: 2 * v for k, v in per_step.items()}

    def timed(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        dispatch = time.perf_counter() - t0
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dispatch, read()

    def run(mesh, graphs):
        """DIST_STEPS fused steps and DIST_WINDOWS windows from the start
        state: losses, step and window seconds, dispatch seconds, launches,
        graph counts, the state after, and a replayed step's profile."""
        tx, _ = make_optimizer(cfg, tc, tree, mesh)
        state = init_train_state(cfg, tc, model.params, model.projectors,
                                 tx=tx)
        step = make_train_step(cfg, tc, tx, graphs=graphs)
        grad_fn, apply_fn, _, grad_accum_fn = make_grad_and_apply(
            cfg, tc, tx, graphs=graphs)
        before = _all_graph_counts()
        out = {"losses": [], "step_s": [], "window_s": [], "dispatch_s": [],
               "launches": []}
        for _ in range(DIST_STEPS):
            (state, loss), secs, dispatch, counts = timed(
                lambda: step(state, batch, layout))
            out["losses"].append(loss)
            out["step_s"].append(secs)
            out["dispatch_s"].append(dispatch)
            out["launches"].append(counts)

        def window():
            loss0, acc = grad_fn(state.params, *micro[0])
            loss1, acc = grad_accum_fn(state.params, acc, *micro[1])
            apply_fn(state, acc, scale=0.5)
            return [loss0, loss1]
        for _ in range(DIST_WINDOWS):
            losses, secs, _, counts = timed(window)
            out["losses"] += losses
            out["window_s"].append(secs)
            out["launches"].append(counts)
        out["graphs"] = _graph_delta(before)
        out["losses"] = [float(x) for x in out["losses"]]
        out["state"] = _TrainSnapshot(state, tx)
        if graphs is None:  # one more replay, profiled (after the snapshot)
            out["profile"] = _profile(
                f"train_step_replay_{'dp' if mesh else 'no_group'}",
                lambda: step(state, batch, layout),
                "distributed_train_profile.txt" if mesh
                else "distributed_train_profile_no_group.txt", cpu=False)
        return out

    tx0, _ = make_optimizer(cfg, tc, tree)
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)
             if tx0.trains(p)}

    def restart():  # the same starting state for the next run
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                if p in start:
                    t.copy_(start[p])
        gc.collect()
        torch.cuda.empty_cache()
    runs = {"no_group_graph": run(None, None)}
    with _NcclWorld1():
        mesh = mesh_for_batch(len(collated["input_ids"]), allow_partial=True)
        restart()
        runs["dp_graph"] = run(mesh, None)
        restart()
        runs["dp_eager"] = run(mesh, False)
    ref = runs["no_group_graph"]
    differ = {k: r["state"].differing(ref["state"]) for k, r in runs.items()}
    step_s = {k: float(np.median(r["step_s"][2:] if k.endswith("graph")
                                 else r["step_s"][1:]))
              for k, r in runs.items()}
    dispatch_s = {k: float(np.median(r["dispatch_s"][2:]
                                     if k.endswith("graph")
                                     else r["dispatch_s"][1:]))
                  for k, r in runs.items()}
    idle = {}
    for k in ("no_group_graph", "dp_graph"):
        prof = runs[k]["profile"]
        idle[k] = _idle_share(prof, prof["wall_s"])
        idle[k + "_unprofiled"] = _idle_share(prof, step_s[k])
    log("distributed", path="train_dp_world1", mesh=json.dumps(mesh.shape),
        losses=json.dumps({k: [f"{x:.6f}" for x in r["losses"]]
                           for k, r in runs.items()}),
        step_s=json.dumps({k: [round(x, 4) for x in r["step_s"]]
                           for k, r in runs.items()}),
        window_s=json.dumps({k: [round(x, 4) for x in r["window_s"]]
                             for k, r in runs.items()}),
        step_median_s=json.dumps({k: round(v, 4) for k, v in step_s.items()}),
        host_dispatch_s=json.dumps({k: round(v, 4)
                                    for k, v in dispatch_s.items()}),
        device_idle_share=json.dumps({k: round(v, 4)
                                      for k, v in idle.items()}),
        graphs=json.dumps({k: r["graphs"] for k, r in runs.items()}),
        trainable_leaves=len(ref["state"].leaves),
        differing=json.dumps({k: len(v) for k, v in differ.items()}))
    for k, r in runs.items():
        if r["losses"] != ref["losses"] or differ[k]:
            raise AssertionError(f"{k} left the no-group graph run: losses "
                                 f"{r['losses']} vs {ref['losses']}, "
                                 f"{differ[k][:3]} differ")
        want = [per_step] * DIST_STEPS + [per_window] * DIST_WINDOWS
        if r["launches"] != want:
            raise AssertionError(f"{k}: K1/K3/K4 launches {r['launches']}")
    for k in ("no_group_graph", "dp_graph"):
        g = runs[k]["graphs"]
        if g.get("train_step", [0])[0] != 1 or g.get("grad", [0])[0] != 2 \
                or g.get("apply", [0])[0] != 1 \
                or g["train_step"][1] != DIST_STEPS - 2:
            raise AssertionError(f"{k}: graph counts {g}")
    if runs["dp_eager"]["graphs"]:
        raise AssertionError(f"the eager A/B replayed graphs: "
                             f"{runs['dp_eager']['graphs']}")
    launches = {"dp_" + k.replace("dp_", ""): _sum_counts(*r["launches"])
                for k, r in runs.items()}
    return {"launches": launches, "losses": ref["losses"], "step_s": step_s,
            "dispatch_s": dispatch_s, "idle_share": idle}


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
    k5 = timed("k5", phase_k5, device, gen)
    k6 = timed("k6", phase_k6, device, gen)
    # phase 4d draws its data from a generator of its own, so the later
    # phases draw the same random weights and inputs as without it
    k7 = timed("k7", phase_k7, device,
               torch.Generator(device=device).manual_seed(SEED + 7))
    # so does phase 4e
    fused = timed("fused", phase_fused, device,
                  torch.Generator(device=device).manual_seed(SEED + 8))
    gc.collect()
    torch.cuda.empty_cache()
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
                       gen, mcub4_model, request,
                       (serve["parts"]["chunked"].get("tick") or {}).get(
                           "median_ms"))
    del mcub4_model, request
    gc.collect()
    torch.cuda.empty_cache()
    # phase 6c runs once phase 6's model is gone (two 7B models at once
    # would crowd the card), on a generator of its own, as 4d and 4e do
    fp16 = timed("fp16", phase_fp16, device,
                 torch.Generator(device=device).manual_seed(SEED + 16),
                 composed["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    # phase 6e: the same request in fp32, likewise on its own generator
    fp32 = timed("fp32", phase_fp32, device,
                 torch.Generator(device=device).manual_seed(SEED + 32))
    gc.collect()
    torch.cuda.empty_cache()
    tiny = timed("tiny", phase_tiny, device)
    gc.collect()
    torch.cuda.empty_cache()
    k34 = timed("k34", phase_k34, device, gen)
    train = timed("train", phase_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = timed("train_int8", phase_train_int8, device)
    gc.collect()
    torch.cuda.empty_cache()
    dist_train = timed("distributed_train", phase_distributed_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tmp_entry_", dir=".") as root:
        entry = timed("train_entry", phase_train_entry, device, gen, root)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 10b on phase 10's base and clouds
        entry_fp32 = timed("train_entry_fp32", phase_train_entry_fp32,
                           device, root)
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
        k: round(v, 4) for k, v in dist_train["step_s"].items()}),
        dp_host_dispatch_s=json.dumps({
            k: round(v, 4) for k, v in dist_train["dispatch_s"].items()}),
        dp_device_idle_share=json.dumps({
            k: round(v, 4) for k, v in dist_train["idle_share"].items()}),
        decode_tok_per_s=json.dumps({
            k: round(v, 2) for k, v in dist_serve["decode_tok_per_s"].items()}),
        prefill_s=json.dumps({k: round(v, 4) for k, v in
                              dist_serve["prefill_s"].items()}),
        slot_tick_median_ms=json.dumps({
            k: round(v, 3) for k, v in dist_serve["slot_tick_ms"].items()}),
        tp_shard_ms=json.dumps({
            f"K{i + 1} tp{c['tp']}": None if c["ms"] is None
            else round(c["ms"], 4)
            for i, row in enumerate((dist_serve["k1_tp_shards"],
                                     dist_serve["k2_tp_shards"]))
            for c in row}))
    train_kinds = ("train_step", "grad", "apply")
    log("train_graph", captures_replays_by_phase=json.dumps(
        {p: {k: v for k, v in g.items() if k in train_kinds}
         for p, g in graphs.items()
         if any(k in train_kinds for k in g)}),
        phase9_graphs=train["graphs"], pool_gb=f"{train['pool_gb']:.3f}",
        step_s={"eager": round(train["eager_step_s"], 4),
                "replay": round(train["replay_step_s"], 4)},
        positions_per_s=json.dumps({k: round(v, 1) for k, v in
                                    train["positions_per_s"].items()}),
        host_dispatch_s=json.dumps({k: round(v, 4) for k, v in
                                    train["host_dispatch_s"].items()}),
        device_idle_share=json.dumps({k: round(v, 4) for k, v in
                                      train["idle_share"].items()}),
        peak_gb=json.dumps({k: [round(x, 2) for x in v]
                            for k, v in train["peak_gb"].items()}),
        eager_bit_reproducible=train["bit_reproducible"],
        graph_bit_equal=train["graph_bit_equal"],
        accum_bit_equal=train["accum_bit_equal"],
        int8_step_s={"eager": round(int8["eager_step_s"], 4),
                     "replay": round(int8["replay_step_s"], 4)},
        int8_positions_per_s=json.dumps({
            k: round(v, 1) for k, v in int8["positions_per_s"].items()}),
        int8_device_idle_share=json.dumps({
            k: round(v, 4) for k, v in int8["idle_share"].items()}),
        int8_peak_gb=json.dumps({k: [round(x, 2) for x in v]
                                 for k, v in int8["peak_gb"].items()}),
        int8_graph_bit_equal=int8["graph_bit_equal"],
        int8_k7_vs_plain_dx_step_s=json.dumps({
            k: round(v, 4) for k, v in int8["ab"]["median_step_s"].items()}),
        entry_step_s=json.dumps({k: [x and round(x, 4)
                                     for x in entry[k]["step_s"]]
                                 for k in ENTRY_STEPS}),
        entry_loop_trace_median_s=json.dumps(
            {k: {n: round(v, 4) for n, v in
                 entry[k]["loop_trace_median_s"].items()}
             for k in ENTRY_STEPS}))
    unreplayed = [p for p in ("train", "train_int8", "train_entry",
                              "train_entry_fp32", "distributed_train")
                  if not any(graphs[p].get(k, [0, 0])[1]
                             for k in train_kinds)]
    if unreplayed:  # every training phase replays a train graph
        raise AssertionError(f"no train graph replayed in {unreplayed}")
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
    trained = train["launches"]

    def train_launches(name, runs=trained):
        return sum(c.get(name, 0) for c in runs)

    def by_path(name):
        return {"main": launches[name], "composed": composed["launches"][name],
                "decode_variants": sum(v["launches"][name]
                                       for v in variants.values()),
                "fp16": fp16["launches"][name],
                "tiny": tiny["launches"].get(name, 0),
                "qa_loader": qa_launches[name],
                "serve": serve["launches"][name],
                "eva_imagebind": eva["launches"][name],
                "entries": entries["launches"][name],
                "legacy_eval": legacy["launches"][name],
                "train": train_launches(name),
                "train_int8": train_launches(name, int8["launches"]),
                "train_entry": entry["launches"][name],
                **{p: c.get(name, 0) for p, c in (
                    *dist_serve["launches"].items(),
                    *dist_train["launches"].items())}}

    def fp32_paths(name):  # the fp32 instantiations' launches
        return {"fp32": fp32["launches"].get(name, 0),
                "tiny": tiny["fp32_launches"].get(name, 0),
                "train_entry_fp32": entry_fp32["launches"].get(name, 0)}

    def train_paths(name):
        return {"train": train_launches(name),
                "train_int8": train_launches(name, int8["launches"]),
                "train_entry": entry["launches"][name],
                "tiny": tiny["train_launches"][name],
                **{p: c[name] for p, c in dist_train["launches"].items()}}

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
        # the fp32 instantiations (a float32 model, --bf16 False training),
        # each timed by CUDA-graph replay at its main path's shape (K2 cold)
        dict(name="flash_attention_fwd fp32", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES,
             launches=sum(fp32_paths("flash_attention_fwd").values()),
             launches_by_path=fp32_paths("flash_attention_fwd"),
             **dict(k1["fp32"], max_abs_err=max(
                 k1["fp32"]["max_abs_err"], k34["fwd_fp32"]["max_abs_err"]))),
        dict(name="flash_decode fp32", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES,
             launches=sum(fp32_paths("flash_decode").values()),
             launches_by_path=fp32_paths("flash_decode"),
             **dict(k2["fp32"], ms=k2["fp32"]["device_ms_cold"]
                    or k2["fp32"]["events_ms_cold"],
                    share_of_bound=k2["fp32"]["share_of_bound_cold"],
                    timing="cold: every launch on another layer")),
        dict(name="flash_attention_bwd_dq fp32", route="cuda",
             source=K34_SOURCE, replaces=K3_REPLACES,
             launches=sum(fp32_paths("flash_attention_bwd_dq").values()),
             launches_by_path=fp32_paths("flash_attention_bwd_dq"),
             **k34["dq_fp32"]),
        dict(name="flash_attention_bwd_dkv fp32", route="cuda",
             source=K34_SOURCE, replaces=K4_REPLACES,
             launches=sum(fp32_paths("flash_attention_bwd_dkv").values()),
             launches_by_path=fp32_paths("flash_attention_bwd_dkv"),
             **k34["dkv_fp32"]),
        dict(name="w8a16_gemv", route="cuda", source=K5_SOURCE,
             replaces=K5_REPLACES,
             launches=sum(by_path("w8a16_gemv").values()),
             launches_by_path=by_path("w8a16_gemv"),
             decode_ab={k: composed["k5_ab"][k] for k in (
                 "decode_tok_per_s", "step_device_ms", "decode_pool_gb",
                 "ids_equal")},
             **dict(k5, shapes=[_rounded(c) for c in k5["shapes"]],
                    tp_shards=[_rounded(c) for c in k5["tp_shards"]],
                    groups=[_rounded(c) for c in k5["groups"]])),
        dict(name="w8a16_gemm", route="cuda", source=K6_SOURCE,
             replaces=K6_REPLACES,
             launches=sum(by_path("w8a16_gemm").values()),
             launches_by_path=by_path("w8a16_gemm"),
             prefill_ab={k: composed["k6_ab"][k] for k in (
                 "prefill_s", "chunk_step_ms", "prefill_pool_gb",
                 "prefill_logit_rel_err", "ids_equal")},
             **dict(k6, shapes=[_rounded(c) for c in k6["shapes"]],
                    tp_shards=[_rounded(c) for c in k6["tp_shards"]])),
        # the int8-base train step is the one path with an int8 product's
        # gradient: the other train phases train on a bf16 base
        *[dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=sum(by_path(name).values()),
               launches_by_path=by_path(name),
               decode_ab={k: composed["fused_ab"][k] for k in (
                   "decode_tok_per_s", "step_device_ms", "step_kernels",
                   "ids_equal")}, **fused[key])
          for key, name, source, replaces in (
              ("K8", "add_rms_norm", K8_SOURCE, K8_REPLACES),
              ("K9", "rope_kv_write", K9_SOURCE, K9_REPLACES),
              ("K10", "silu_mul", K10_SOURCE, K10_REPLACES),
              # K8 and K9 inside K5's streaming launch
              ("K8 in K5", "norm_matmul_group", K5_SOURCE, K8_REPLACES),
              ("K8+K9 in K5", "norm_qkv_rope", K5_SOURCE,
               f"{K8_REPLACES} + {K9_REPLACES}"),
              ("K10 in K5", "silu_matmul", K5_SOURCE, K10_REPLACES))],
        dict(name="w8a16_dx", route="cuda", source=K7_SOURCE,
             replaces=K7_REPLACES,
             launches=train_launches("w8a16_dx", int8["launches"]),
             launches_by_path={"train_int8": train_launches(
                 "w8a16_dx", int8["launches"])},
             train_ab={"median_step_s": int8["ab"]["median_step_s"],
                       "loss_max_rel": int8["ab"]["loss_max_rel"],
                       "peak_gb": int8["ab"]["peak_gb"]},
             **dict(k7, shapes=[_rounded(c) for c in k7["shapes"]])),
    ]
    if not all(k["launches"] for k in kernels):
        raise AssertionError("a kernel of the main paths never launched: "
                             + str([k["name"] for k in kernels
                                    if not k["launches"]]))
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
    missing = [p for p in ("main", "composed", "eva_imagebind", "serve",
                           "distributed_serve")
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
