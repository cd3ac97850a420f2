#!/usr/bin/env python3
"""Multi-process CPU dryrun of the PyTorch port's distribution layer.

    python scripts/torch_dryrun_multirank.py             # 4 gloo processes
    python scripts/torch_dryrun_multirank.py --world 2

starts ``--world`` processes on this host, joined by gloo through a
``file://`` rendezvous in a fresh temporary directory, and in each runs:

- a DP x TP train step at (2, world / 2) (world 4: 2 x 2) on a tiny random
  model: the loss and every trainable gradient (a split leaf's shard
  against its slice) held to a one-process step on the same global batch
  within 1e-5, the ranks holding different numbers of valid targets; the
  parameters after the ZeRO-1 update held the same way;
- the same step through the train graph objects (``GradGraph`` and
  ``ApplyGraph``; on the CPU a graph runs its step eagerly through its
  own buffers): loss, gradients and parameters equal to the eager step's
  bit for bit;
- a TP decode at tp = world: greedy ids through the decode and prefill
  graphs (``device_loop=True``) and eagerly, both equal to the unsharded
  model's;
- the audit: every ``torch.distributed`` call of the step and of one TP
  decode step recorded, with its bytes, on the graph path and on the
  eager one: the same calls in the same order.

It prints one JSON line of the results and exits nonzero if a rank failed,
a check failed, or a rank outlived ``--timeout``.  Every process it starts
is ended before it returns.  ``--case`` runs one of the other cases
(``tp``, ``worker``, ``train``) on the files a ``--spec`` JSON names; the
CPU tests (``tests/test_torch_parallel_*.py``) drive them that way.

``--case capture --device cuda`` runs on the cards of one host, one
process a card joined by NCCL (``--world`` cards; the kernels are built
first, once): on a tiny bf16 model whose head_dim the kernels take, the
greedy decode at tp = world through the captured decode and prefill
graphs against the eager path under the same group (ids, and one decode
step's logits), and the DP x TP train step at (2, world / 2) through a
captured ``TrainStepGraph`` against the eager step (losses, trainable
leaves), each with the graphs' captures and replays counted and the
collectives of the capturing call audited against the eager step's.
On the CPU (the default ``--device``) the same case runs over gloo, where
a graph runs its step eagerly.  The script imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from modelcompose_tpu_torch.parallel import distributed, tp  # noqa: E402

TOL = 1e-5


class WordTokenizer:
    """A Llama-like test tokenizer: BOS first, ``</s>`` as EOS, every other
    word to 3 + crc32(word) % 200 (fixed ids in every process)."""
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    model_max_length = 2048

    def __call__(self, text, return_tensors=None, padding=None,
                 max_length=None, truncation=None):
        import re
        ids = [self.bos_token_id]
        for part in re.split(r"(</s>)", text):
            if part == "</s>":
                ids.append(self.eos_token_id)
            elif part:
                ids.extend(3 + zlib.crc32(w.encode()) % 200
                           for w in part.split())
        if truncation and max_length:
            ids = ids[:max_length]

        class Out:
            pass
        out = Out()
        out.input_ids = torch.tensor([ids]) if return_tensors == "pt" \
            else ids
        return out

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in np.asarray(ids).tolist())


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The collective recorder (the audit)
# ---------------------------------------------------------------------------

_RECORDED = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter", "reduce_scatter_tensor", "broadcast",
             "all_to_all", "broadcast_object_list")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


@contextlib.contextmanager
def record_collectives(log: list):
    """Every ``torch.distributed`` collective called inside, as
    ``(name, bytes)``: the bytes of the tensor it produces (an all-gather:
    every rank's part)."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in _RECORDED}

    def wrap(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            first = args[0] if args else None
            log.append((name, _nbytes(first)))
            return out
        return call
    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# ---------------------------------------------------------------------------
# The dryrun: DP x TP train step, TP decode, audit
# ---------------------------------------------------------------------------

def audit_config():
    """Frozen base weights dwarf every legitimate collective: a layer's
    [H, H] slice is 64 KB against <= 48 KB of activations or trainable
    gradients (the JAX audit's dimensions; a linear projector, so no
    trainable leaf is weight-shaped)."""
    from modelcompose_tpu_torch.config import tiny_test_config
    return tiny_test_config(
        mm_vision_encoder="test:32x2", mm_hidden_size=32,
        mm_projector_type="linear", local_prefix_tokens=1,
        local_suffix_tokens=1, hidden_size=128, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=4, dtype="float32")


def _samples(model, n):
    """``n`` image + text samples whose label counts differ (3, 1, 4, 2,
    ...; so do the data ranks' sums): ids, labels, pixels."""
    from modelcompose_tpu_torch.constants import MODAL_TOKEN_INDEXES
    img = MODAL_TOKEN_INDEXES["vision"]
    rng = np.random.default_rng(5)
    ids, labels = [], []
    for i in range(n):
        k = (3, 1, 4, 2, 5, 1, 2, 6)[i % 8]
        text = rng.integers(3, 200, 2 + k)
        ids.append(np.concatenate([[1, img], text]))
        labels.append(np.concatenate([[-100, -100, -100, -100],
                                      text[2:]]))
    pixels = rng.normal(size=(n, 28, 28, 3)).astype(np.float32)
    return ids, labels, pixels


def _batch(model, ids, labels, pixels):
    from modelcompose_tpu_torch.train.train_multimodal import make_batch
    return make_batch(model, {"input_ids": ids, "labels": labels,
                              "modal_inputs": {"vision": pixels}},
                      buckets=(16,))


def _train_tools(cfg, model, mesh=None, graphs=None):
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_grad_and_apply, make_optimizer)
    tc = TrainConfig(learning_rate=1e-3, total_steps=4, warmup_ratio=0.0,
                     adam_eps=1e-2, max_grad_norm=1.0)
    tree = {"backbone": model.params, "projectors": model.projectors}
    tx, _ = make_optimizer(cfg, tc, tree, mesh)
    state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
    grad_fn, apply_fn, _, _ = make_grad_and_apply(cfg, tc, tx, graphs=graphs)
    return state, tx, grad_fn, apply_fn


def _fresh_model(cfg):
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.tree import tree_leaves
    model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # nonzero LoRA B: every adapter term is live
        for path, leaf in tree_leaves(model.params):
            if path[-1] == "lora_b":
                leaf.normal_(0, 0.05, generator=gen)
    return model


def case_dpxtp(spec):
    """DP x TP train step and TP decode against one process, with the
    audit.  Every rank checks its own tensors; the result is per rank."""
    from modelcompose_tpu_torch.parallel.mesh import (
        apply_tensor_parallel, leaf_specs, make_mesh, shard_params,
        split_axis)
    from modelcompose_tpu_torch.tree import tree_leaves
    world = distributed.world_size()
    data = 2 if world % 2 == 0 else 1
    model_w = world // data
    cfg = audit_config()
    B = 2 * data
    # one process: the global batch, no group
    ref = _fresh_model(cfg)
    ids, labels, pixels = _samples(ref, B)
    state, tx, grad_fn, apply_fn = _train_tools(cfg, ref)
    batch, layout = _batch(ref, ids, labels, pixels)
    ref_loss, ref_grads = grad_fn(state.params, batch, layout)
    ref_grads = {k: v.clone() for k, v in ref_grads.items()}
    apply_fn(state, ref_grads)
    ref_after = {k: v.detach().clone() for k, v in tree_leaves(state.params)
                 if k in ref_grads}
    # the mesh: this rank's shard and its data slice of the batch, the
    # step eagerly and through the graph objects, each on a fresh model
    mesh = make_mesh(data, model_w)
    local = distributed.local_batch_slice(B, mesh.data_rank, data)
    runs = {}
    for graphs in (False, True):
        model = _fresh_model(cfg)
        model.params = shard_params(model.params, mesh.model_rank, model_w)
        batch, layout = _batch(model, ids[local], labels[local],
                               pixels[local])
        state, tx, grad_fn, apply_fn = _train_tools(cfg, model, mesh,
                                                    graphs)
        audit = []
        with record_collectives(audit):
            loss, grads = grad_fn(state.params, batch, layout)
            grads = {k: v.clone() for k, v in grads.items()}
            apply_fn(state, grads)
        runs[graphs] = (loss, grads, state, audit, grad_fn.graphs)
    loss, grads, state, train_audit, _ = runs[False]
    g_loss, g_grads, g_state, graph_train_audit, made = runs[True]
    g_after = dict(tree_leaves(g_state.params))
    train_graph_equal = bool(
        torch.equal(g_loss, loss)
        and all(torch.equal(g_grads[p], grads[p]) for p in grads)
        and all(torch.equal(g_after[p], t)
                for p, t in tree_leaves(state.params))
        and len(made) == 2)  # a GradGraph and an ApplyGraph
    specs = {("backbone",) + k: v
             for k, v in leaf_specs(model.params).items()}

    def own(path, full):
        axis = split_axis(specs.get(path, ()))
        if axis is None or model_w == 1:
            return full
        n = full.shape[axis] // model_w
        return full.narrow(axis, mesh.model_rank * n, n)
    grad_err = max(_rel(g, own(p, ref_grads[p])) for p, g in grads.items())
    after = dict(tree_leaves(state.params))
    param_err = max(_rel(after[p].detach(), own(p, ref_after[p]))
                    for p in grads)
    moment_bytes = sum(t.numel() * t.element_size()
                       for m in ("mu", "nu")
                       for t in state.opt_state[m].values())
    # TP decode: greedy ids of the sharded model against the unsharded,
    # through the decode and prefill graphs and eagerly
    dec_ref = _fresh_model(cfg)
    prompt = [np.array([1, 5, 9, 13, 17]), np.array([1, 6, 10])]
    want = dec_ref.generate(prompt, {}, max_new_tokens=6)
    dec = _fresh_model(cfg)
    served = dec.serving  # made before the model is sharded
    apply_tensor_parallel(dec, world)
    serving_rebuilt = (dec.serving is not served
                       and dec.serving.group is dec.tp_group
                       and dec.serving.mirrored == (world > 1))
    got = dec.generate(prompt, {}, max_new_tokens=6)
    got_eager = dec.generate(prompt, {}, max_new_tokens=6,
                             device_loop=False)
    decode_graphs = len(dec.decode_graphs)
    decode_audit, graph_decode_audit = [], []
    with torch.no_grad(), tp.scope(dec.tp_group):
        with record_collectives(decode_audit):
            eager_logits = _one_decode_step(dec, cfg)
        with record_collectives(graph_decode_audit):
            graph_logits = _one_decode_step(dec, cfg, graph=True)
    decode_graph_equal = bool(torch.equal(graph_logits, eager_logits))
    frozen = [t.numel() * t.element_size() for p, t in tree_leaves(
        dec_ref.params) if p[-1] == "w" or p[0] in ("embed_tokens",
                                                     "lm_head")]
    return {"loss": float(loss), "ref_loss": float(ref_loss),
            "loss_err": abs(float(loss) - float(ref_loss))
            / abs(float(ref_loss)),
            "grad_err": grad_err, "param_err": param_err,
            "moment_bytes": moment_bytes, "ids": got, "ref_ids": want,
            "eager_ids": got_eager, "decode_graphs": decode_graphs,
            "train_graph_equal": train_graph_equal,
            "decode_graph_equal": decode_graph_equal,
            "train_audit": train_audit, "graph_train_audit": graph_train_audit,
            "decode_audit": decode_audit,
            "graph_decode_audit": graph_decode_audit,
            "min_frozen_bytes": min(frozen),
            "serving_rebuilt": serving_rebuilt,
            "layers": cfg.num_hidden_layers, "data": data, "model": model_w,
            "valid_targets": int((batch["labels"][:, 1:] != -100).sum()),
            "local_batch": [int(t.shape[0]) for t in [batch["labels"]]],
            "bucket": int(batch["labels"].shape[1])}


def _one_decode_step(model, cfg, graph=False):
    """One decode step of B=2 over a zero 32-position cache (the audit's
    decode shape): ``_decode_step``, or a ``DecodeGraph``'s call with
    ``graph``.  Returns the logits."""
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.core.generate import _decode_step
    from modelcompose_tpu_torch.core.llama import KVCache, local_kv_heads
    tokens = torch.tensor([3, 5], device=model.device)
    kv_lens = torch.tensor([4, 6], dtype=torch.int32, device=model.device)
    table = model.decode_routing_table()
    if graph:
        return DecodeGraph(model.params, cfg, 2, 32, routing_table=table)(
            tokens, kv_lens).clone()
    cache = KVCache.zeros(cfg, 2, 32, device=model.device,
                          kv_heads=local_kv_heads(model.params, cfg))
    return _decode_step(model.params, cfg, cache, tokens, kv_lens,
                        table)[0]


def dryrun_checks(results) -> list:
    """The dryrun's assertions over every rank's ``case_dpxtp`` result:
    the failures as strings."""
    bad = []
    for r, res in enumerate(results):
        for key in ("loss_err", "grad_err", "param_err"):
            if not res[key] <= TOL:
                bad.append(f"rank {r}: {key} {res[key]:.3g} > {TOL}")
        if not res["serving_rebuilt"]:
            bad.append(f"rank {r}: the serving backbone made before the "
                       "TP step was kept after it")
        for key in ("ids", "eager_ids"):
            if res[key] != res["ref_ids"]:
                bad.append(f"rank {r}: TP greedy {key} {res[key]} != "
                           f"{res['ref_ids']}")
        if res["decode_graphs"] < 1:
            bad.append(f"rank {r}: the TP decode made no decode graph")
        for name in ("train_graph_equal", "decode_graph_equal"):
            if not res[name]:
                bad.append(f"rank {r}: {name} is false")
        for name in ("train", "decode"):
            if res[f"graph_{name}_audit"] != res[f"{name}_audit"]:
                bad.append(f"rank {r}: the {name} graph's collectives "
                           f"{res[f'graph_{name}_audit'][:4]} differ from "
                           f"the eager step's {res[f'{name}_audit'][:4]}")
        for name in ("train_audit", "decode_audit"):
            log = res[name]
            if not log:
                bad.append(f"rank {r}: no collectives in {name}")
            per_layer = res["min_frozen_bytes"] // res["layers"]
            big = [c for c in log if c[1] >= per_layer]
            if big:
                bad.append(f"rank {r}: {name} moves weight-sized tensors "
                           f"{big[:3]}")
    return bad


# ---------------------------------------------------------------------------
# Cases driven by the tests
# ---------------------------------------------------------------------------

def _tokenizer_fn(_):
    return WordTokenizer()


def _requests():
    from modelcompose_tpu_torch.constants import MODAL_TOKEN_INDEXES
    img = MODAL_TOKEN_INDEXES["vision"]
    pixels = np.random.default_rng(3).normal(
        size=(1, 28, 28, 3)).astype(np.float32)
    prompts = [np.array([1, img, 7, 8, 9]), np.array([1, 11, 12, 13, 14])]
    return prompts, {"vision": pixels}


def _schedule(dec, chunk):
    """admit slot 0 (image, one-shot), 2 ticks; admit slot 1 (text)
    chunked with a tick between chunks; 2 ticks; release slot 0, readmit
    it (text, chunked), 3 ticks.  Greedy ids from the host logits; each
    tick's (tokens, kv_lens)."""
    record = []

    def tick():
        logits = dec.host_logits()
        tokens = np.where(dec.active, logits.argmax(-1), 0).astype(np.int32)
        record.append([tokens.tolist(), np.asarray(dec.kv_lens).tolist()])
        dec.step(tokens)
    prompts, inputs = _requests()
    dec.admit(0, prompts[0], inputs)
    for _ in range(2):
        tick()
    dec.prefill_chunk = chunk
    dec.admit(1, np.array([1, 11, 12, 13, 14, 15, 16]), {}, tick_cb=tick)
    for _ in range(2):
        tick()
    dec.release(0)
    dec.admit(0, np.array([1, 40, 41, 42]), {}, tick_cb=tick)
    for _ in range(3):
        tick()
    return record


def case_tp(spec):
    """Loads ``spec['ckpt']`` on ``spec['base']`` at tp = world (every
    variant of ``spec['variants']``): greedy ids of two requests through
    the decode and prefill graphs (``device_loop=True``; on the CPU a
    graph runs its step eagerly through its own buffers) and, as
    ``<variant>_eager``, launch by launch; with ``spec['slot']`` the
    chunked prefill's logits (eagerly, and through the chunk-step graphs
    as ``chunked_logits_graph``) and the slot decoder's schedule (rank 0
    leads, the others follow; the slot pool's decode graph); with
    ``spec['worker']`` the model worker's wire chunks (continuous
    batching, then the micro-batching engine).  Without a process group:
    the tp 1 run."""
    from modelcompose_tpu_torch.core.generate import prefill_chunked
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    world = distributed.world_size()
    lead = distributed.is_primary()
    out = {}
    prompts, inputs = _requests()
    for name, kw in spec["variants"].items():
        _, model, _, _ = load_pretrained_model(
            spec["ckpt"], spec["base"], load_tokenizer_fn=lambda _: None,
            tp=world, device="cpu", **kw)
        out[name] = model.generate(prompts, inputs, max_new_tokens=6)
        out[name + "_eager"] = model.generate(prompts, inputs,
                                              max_new_tokens=6,
                                              device_loop=False)
    if spec.get("slot"):
        from modelcompose_tpu_torch.serve.slot_engine import SlotDecoder
        with torch.no_grad(), tp.scope(model.tp_group):
            embeds, plan = model.prepare_batch(prompts[:1], inputs,
                                               bucket_len=16)
            for key, graphs in (("chunked_logits", None),
                                ("chunked_logits_graph",
                                 model.prefill_graphs)):
                logits, _ = prefill_chunked(
                    model.params, model.cfg, embeds,
                    torch.as_tensor(plan.route_ids), model.routing_table,
                    plan.lengths, 64, chunk=4, graphs=graphs)
                out[key] = logits.tolist()
        if lead:
            dec = SlotDecoder(model, max_slots=3, cache_len=64,
                              device="cpu")
            out["schedule"] = _schedule(dec, chunk=3)
            model.serving.stop() if model.serving.mirrored else None
        else:
            model.serving.follow()
    if spec.get("worker"):
        out["worker"] = _worker_chunks(spec, world, lead)
    return out


def _worker_chunks(spec, world, lead):
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    from modelcompose_tpu_torch.serve import model_worker
    loader = functools.partial(load_pretrained_model, tp=world,
                               device="cpu")
    chunks = {}
    for engine in ("continuous", "micro"):
        if not lead:
            model_worker.follow(loader, spec["ckpt"], spec["base"])
            continue
        worker = model_worker.ModelWorker(
            None, None, spec["ckpt"], spec["base"], no_register=True,
            loader=functools.partial(loader,
                                     load_tokenizer_fn=_tokenizer_fn),
            continuous_batching=engine == "continuous",
            slot_cache_len=64, prefill_chunk=4, device="cpu")
        got = []
        for prompt in ("USER: <image>\nwhat is it ASSISTANT:",
                       "USER: hello there ASSISTANT:"):
            payload = {"prompt": prompt, "temperature": 0.0,
                       "max_new_tokens": 5}
            if "<image>" in prompt:
                payload["modal_inputs"] = {"vision": [_png_b64()]}
            got.append([c.decode() for c in
                        worker.generate_stream(payload)])
        worker.close()
        chunks[engine] = got
    return chunks


def _png_b64():
    """A 28 x 28 RGB PNG, base64 (the worker's image wire format)."""
    import base64
    import struct
    rgb = (np.random.default_rng(9).random((28, 28, 3)) * 255).astype(
        np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in rgb)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 28, 28, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def case_train(spec):
    """``train()`` on each ``spec['runs'][i]['argv']`` in turn (Adam eps
    ``spec['adam_eps']``): per run the losses, the packed positions, this
    rank's moment bytes and the files it saved.  A run with ``graphs``
    true takes the train graph objects where the steps' default
    (``graphs=None``) would run eagerly, as on the card: on the CPU a
    graph runs its step eagerly through its own buffers."""
    from unittest import mock

    from modelcompose_tpu_torch.train import step_graph, trainer
    from modelcompose_tpu_torch.train import train_multimodal as entry
    from modelcompose_tpu_torch.train.trainer import TrainConfig
    out = []
    for run in spec["runs"]:
        states, saved = [], []
        init_state = entry.init_train_state
        real_save = torch.save

        def keep_state(*a, **kw):
            states.append(init_state(*a, **kw))
            return states[-1]

        def save(obj, f, *a, **kw):
            saved.append(os.path.basename(str(f)))
            return real_save(obj, f, *a, **kw)
        args = entry.build_arg_parser().parse_args(run["argv"])
        made = []
        real_use = step_graph.use_graphs

        def use_graphs(graphs, device, tx):
            if run.get("graphs") and graphs is None:
                graphs = True
            made.append(real_use(graphs, device, tx))
            return made[-1]
        with mock.patch.object(trainer, "use_graphs", use_graphs), \
                mock.patch.object(entry, "TrainConfig", functools.partial(
                TrainConfig, adam_eps=spec.get("adam_eps", 1e-2))), \
                mock.patch.object(entry, "init_train_state", keep_state), \
                mock.patch.object(torch, "save", save):
            result = entry.train(args, tokenizer=WordTokenizer(),
                                 device="cpu")
        moments = sum(t.numel() * t.element_size() for s in states[-1:]
                      for m in ("mu", "nu")
                      for t in s.opt_state[m].values())
        out.append({"losses": result["losses"], "steps": result["steps"],
                    "positions": result.get("positions", []),
                    "start_step": result.get("start_step"),
                    "idle": bool(result.get("idle")),
                    "moment_bytes": moments, "saved": sorted(set(saved)),
                    "graphed": sum(made), "rank": distributed.rank()})
    return out


def capture_config():
    """A tiny bf16 DAMC backbone the kernels take (head_dim 64) that splits
    2 and 4 ways (4 heads, 4 KV heads, 512 MLP columns, 256 ids)."""
    from modelcompose_tpu_torch.config import tiny_test_config
    return tiny_test_config(
        mm_vision_encoder="test:32x2", mm_hidden_size=32,
        mm_projector_type="linear", local_prefix_tokens=1,
        local_suffix_tokens=1, hidden_size=256, intermediate_size=512,
        num_attention_heads=4, num_key_value_heads=4, dtype="bfloat16")


def _graph_counts():
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.core.prefill_graph import PrefillGraph
    from modelcompose_tpu_torch.train.step_graph import TrainStepGraph
    return {k: [c.captures, c.replays] for k, c in (
        ("decode", DecodeGraph), ("prefill", PrefillGraph),
        ("train_step", TrainStepGraph))}


def _max_diff(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def case_capture(spec):
    """The captured graphs under a process group against the eager path
    under it, on this rank's device (see the module docstring).  Every
    rank reports its own."""
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.parallel.mesh import (
        apply_tensor_parallel, make_mesh, shard_params)
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves
    device = torch.device("cuda", torch.cuda.current_device()) \
        if spec.get("device") == "cuda" else torch.device("cpu")
    world = distributed.world_size()
    cfg = capture_config()

    def fresh():
        gen = torch.Generator(device=device).manual_seed(0)
        model = MultimodalLM.random_init(cfg, gen, device)
        with torch.no_grad():  # nonzero LoRA B: every adapter term is live
            for path, leaf in tree_leaves(model.params):
                if path[-1] == "lora_b":
                    leaf.normal_(0, 0.05, generator=gen)
        return model
    out = {"device": str(device), "world": world,
           "card": torch.cuda.get_device_name(device)
           if device.type == "cuda" else None}
    # tp = world: greedy ids through the graphs (three requests: the
    # decode graph captures at the first's first step, the prefill graph
    # at the second's prefill, the third replays both) and eagerly
    dec = fresh()
    apply_tensor_parallel(dec, world)
    prompt = [np.array([1, 5, 9, 13, 17, 21, 25]), np.array([1, 6, 10])]
    before = _graph_counts()
    graph_ids = [dec.generate(prompt, {}, max_new_tokens=8)
                 for _ in range(3)]
    made = {k: [a - b for a, b in zip(v, before[k])]
            for k, v in _graph_counts().items()}
    kept = dec.prefill_graphs
    dec.prefill_graphs = None  # the eager A/B prefills launch by launch
    eager_ids = dec.generate(prompt, {}, max_new_tokens=8,
                             device_loop=False)
    dec.prefill_graphs = kept
    out.update(graph_ids=graph_ids, eager_ids=eager_ids, serve_graphs=made)
    # one decode step: the eager step, the graph's capturing call (its
    # warm-up is an eager step under the group) and a replay, each over a
    # zero cache with the same token at the same position; a capturing
    # call on the card calls each collective twice (the warm-up, then the
    # capture, which runs nothing), once on the CPU
    passes = 2 if device.type == "cuda" else 1
    audits = {"eager": [], "capture": []}
    with torch.no_grad(), tp.scope(dec.tp_group):
        with record_collectives(audits["eager"]):
            eager_logits = _one_decode_step(dec, cfg)
        from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
        graph = DecodeGraph(dec.params, cfg, 2, 32,
                            routing_table=dec.decode_routing_table())
        tokens = torch.tensor([3, 5], device=device)
        kv_lens = torch.tensor([4, 6], dtype=torch.int32, device=device)
        with record_collectives(audits["capture"]):
            first = graph(tokens, kv_lens).clone()
        replay = graph(tokens, kv_lens).clone()
    out.update(decode_capture_vs_eager=_max_diff(first, eager_logits),
               decode_replay_vs_eager=_max_diff(replay, eager_logits),
               decode_captured=graph.graph is not None
               or device.type != "cuda",
               decode_audit_equal=passes * audits["eager"]
               == audits["capture"],
               decode_audit=audits["eager"])
    # DP x TP: four fused steps eagerly and through a TrainStepGraph
    # (eager, capture, two replays) from the same weights
    data = 2 if world % 2 == 0 and world > 2 else 1
    model_w = world // data
    mesh = make_mesh(data, model_w)
    rng = np.random.default_rng(5)
    B = 2 * data
    ids = [np.concatenate([[1], rng.integers(3, 200, 6 + 3 * i)])
           for i in range(B)]
    labels = [np.concatenate([[-100] * 3, i[3:]]) for i in ids]
    local = distributed.local_batch_slice(B, mesh.data_rank, data)
    runs = {}
    for graphs in (False, True):
        model = fresh()
        model.params = shard_params(model.params, mesh.model_rank, model_w)
        from modelcompose_tpu_torch.train.train_multimodal import make_batch
        batch, layout = make_batch(model, {
            "input_ids": ids[local], "labels": labels[local],
            "modal_inputs": {}}, buckets=(16,))
        tc = trainer.TrainConfig(learning_rate=1e-3, total_steps=8,
                                 warmup_ratio=0.0, max_grad_norm=1.0)
        tree = {"backbone": model.params, "projectors": model.projectors}
        tx, _ = trainer.make_optimizer(cfg, tc, tree, mesh)
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        step = trainer.make_train_step(cfg, tc, tx, graphs=graphs)
        before = _graph_counts()["train_step"]
        losses, audit = [], []
        for i in range(4):
            with record_collectives(audit if i == 1 else []):
                state, loss = step(state, batch, layout)
            losses.append(loss)
        now = _graph_counts()["train_step"]
        runs[graphs] = (torch.stack(losses), dict(tree_leaves(tree)),
                        [b - a for a, b in zip(before, now)], audit)
    (l_e, p_e, _, a_e), (l_g, p_g, counts, a_g) = runs[False], runs[True]
    trained = [p for p, t in p_e.items() if t.requires_grad]
    out.update(
        mesh=[data, model_w], train_losses_eager=l_e.tolist(),
        train_losses_graph=l_g.tolist(),
        train_losses_equal=bool(torch.equal(l_e, l_g)),
        train_leaves_max_diff=max(_max_diff(p_g[p], p_e[p])
                                  for p in trained),
        train_leaves_equal=all(torch.equal(p_g[p], p_e[p])
                               for p in trained),
        train_graph=counts, train_audit_equal=passes * a_e == a_g,
        train_audit_calls=len(a_e))
    return out


def capture_checks(results) -> list:
    """The capture case's assertions over every rank's result: the
    failures as strings."""
    bad = []
    for r, res in enumerate(results):
        if any(ids != res["eager_ids"] for ids in res["graph_ids"]):
            bad.append(f"rank {r}: greedy ids through the graphs "
                       f"{res['graph_ids']} != eager {res['eager_ids']}")
        card = res["device"].startswith("cuda")  # the CPU captures nothing
        if card and (res["serve_graphs"]["decode"][0] < 1
                     or res["serve_graphs"]["prefill"][0] < 1):
            bad.append(f"rank {r}: no capture {res['serve_graphs']}")
        for key in ("decode_captured", "decode_audit_equal",
                    "train_losses_equal", "train_leaves_equal",
                    "train_audit_equal"):
            if not res[key]:
                bad.append(f"rank {r}: {key} is false")
        for key in ("decode_capture_vs_eager", "decode_replay_vs_eager"):
            if res[key] != 0.0:
                bad.append(f"rank {r}: {key} {res[key]}")
        if card and res["train_graph"] != [1, 2]:
            bad.append(f"rank {r}: train graph captures and replays "
                       f"{res['train_graph']}, want [1, 2]")
    return bad


CASES = {"dpxtp": case_dpxtp, "tp": case_tp, "train": case_train,
         "capture": case_capture}


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------

def _child(args) -> None:
    torch.set_num_threads(1)
    distributed.initialize(args.init, args.world, args.rank,
                           backend="nccl" if args.device == "cuda"
                           else "gloo",
                           timeout=datetime.timedelta(seconds=args.timeout))
    try:
        spec = {}
        if args.spec:
            with open(args.spec) as f:
                spec = json.load(f)
        spec["device"] = args.device
        result = CASES[args.case](spec)
        with open(os.path.join(args.out, f"{args.case}-rank{args.rank}.json"),
                  "w") as f:
            json.dump(result, f)
    finally:
        distributed.shutdown()


def launch(case: str, world: int, out: str, spec=None, timeout: float = 120,
           cwd=None, device: str = "cpu") -> list:
    """Run ``case`` in ``world`` processes, over gloo on the CPU or NCCL on
    the cards (``device``); returns the ranks' results.  Raises
    RuntimeError (with the failing ranks' output) when a rank fails or
    outlives ``timeout``; every process is ended first."""
    os.makedirs(out, exist_ok=True)
    rendezvous = tempfile.mkdtemp(prefix="rendezvous_", dir=out)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(out, f"{case}-rank{rank}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, os.path.abspath(__file__), "--case", case,
               "--world", str(world), "--rank", str(rank), "--device", device,
               "--out",
               os.path.abspath(out), "--timeout", str(timeout), "--init",
               "file://" + os.path.join(os.path.abspath(rendezvous),
                                        "store")]
        if spec:
            cmd += ["--spec", os.path.abspath(spec)]
        procs.append(subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=cwd))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = ""
        for r in failed:
            with open(os.path.join(out, f"{case}-rank{r}.log")) as f:
                text += f"--- rank {r} ---\n{f.read()[-4000:]}\n"
        raise RuntimeError(f"{case}: ranks {failed} failed or timed out\n"
                           + text)
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"{case}-rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--case", default="dpxtp", choices=sorted(CASES))
    p.add_argument("--spec", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=120)
    p.add_argument("--rank", type=int, default=None)  # a child process
    p.add_argument("--init", default=None)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args(argv)
    if args.rank is not None:
        _child(args)
        return 0
    if args.device == "cuda":  # every kernel built once, before the ranks
        from modelcompose_tpu_torch import _build
        for name in sorted(_build.SIGNATURES):
            _build.load(name)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        results = launch(args.case, args.world, args.out or tmp, args.spec,
                         args.timeout, device=args.device)
    checks = {"dpxtp": dryrun_checks, "capture": capture_checks}
    bad = checks[args.case](results) if args.case in checks else []
    if args.device == "cuda":  # the cards' name and power limit
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    print(json.dumps({"ok": not bad, "case": args.case, "world": args.world,
                      "failures": bad, "ranks": [
                          {k: v for k, v in r.items()
                           if not k.endswith("audit")} for r in results]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
