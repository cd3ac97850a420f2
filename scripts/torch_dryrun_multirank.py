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
- a TP decode at tp = world: greedy ids equal to the unsharded model's;
- the audit: every ``torch.distributed`` call of the step and of one TP
  decode step recorded, with its bytes.

It prints one JSON line of the results and exits nonzero if a rank failed,
a check failed, or a rank outlived ``--timeout``.  Every process it starts
is ended before it returns.  ``--case`` runs one of the other cases
(``tp``, ``worker``, ``train``) on the files a ``--spec`` JSON names; the
CPU tests (``tests/test_torch_parallel_*.py``) drive them that way.  The
script imports no JAX.
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


def _train_tools(cfg, model, mesh=None):
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_grad_and_apply, make_optimizer)
    tc = TrainConfig(learning_rate=1e-3, total_steps=4, warmup_ratio=0.0,
                     adam_eps=1e-2, max_grad_norm=1.0)
    tree = {"backbone": model.params, "projectors": model.projectors}
    tx, _ = make_optimizer(cfg, tc, tree, mesh)
    state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
    grad_fn, apply_fn, _, _ = make_grad_and_apply(cfg, tc, tx)
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
    # the mesh: this rank's shard and its data slice of the batch
    mesh = make_mesh(data, model_w)
    model = _fresh_model(cfg)
    model.params = shard_params(model.params, mesh.model_rank, model_w)
    specs = {("backbone",) + k: v
             for k, v in leaf_specs(model.params).items()}
    local = distributed.local_batch_slice(B, mesh.data_rank, data)
    batch, layout = _batch(model, ids[local], labels[local], pixels[local])
    state, tx, grad_fn, apply_fn = _train_tools(cfg, model, mesh)
    audit = []
    with record_collectives(audit):
        loss, grads = grad_fn(state.params, batch, layout)
        grads = {k: v.clone() for k, v in grads.items()}
        apply_fn(state, grads)
    train_audit = list(audit)

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
    # TP decode: greedy ids of the sharded model against the unsharded
    dec_ref = _fresh_model(cfg)
    prompt = [np.array([1, 5, 9, 13, 17]), np.array([1, 6, 10])]
    want = dec_ref.generate(prompt, {}, max_new_tokens=6)
    dec = _fresh_model(cfg)
    served = dec.serving  # made before the model is sharded
    apply_tensor_parallel(dec, world)
    serving_rebuilt = (dec.serving is not served
                       and dec.serving.group is dec.tp_group
                       and dec.serving.mirrored == (world > 1))
    # collectives are not captured: a sharded model decodes eagerly
    got = dec.generate(prompt, {}, max_new_tokens=6, device_loop=False)
    decode_audit = []
    with record_collectives(decode_audit), torch.no_grad(), \
            tp.scope(dec.tp_group):
        _one_decode_step(dec, cfg)
    frozen = [t.numel() * t.element_size() for p, t in tree_leaves(
        dec_ref.params) if p[-1] == "w" or p[0] in ("embed_tokens",
                                                     "lm_head")]
    return {"loss": float(loss), "ref_loss": float(ref_loss),
            "loss_err": abs(float(loss) - float(ref_loss))
            / abs(float(ref_loss)),
            "grad_err": grad_err, "param_err": param_err,
            "moment_bytes": moment_bytes, "ids": got, "ref_ids": want,
            "train_audit": train_audit,
            "decode_audit": decode_audit, "min_frozen_bytes": min(frozen),
            "serving_rebuilt": serving_rebuilt,
            "layers": cfg.num_hidden_layers, "data": data, "model": model_w,
            "valid_targets": int((batch["labels"][:, 1:] != -100).sum()),
            "local_batch": [int(t.shape[0]) for t in [batch["labels"]]],
            "bucket": int(batch["labels"].shape[1])}


def _one_decode_step(model, cfg):
    """One ``_decode_step`` of B=2 over a 32-position cache (the audit's
    decode shape)."""
    from modelcompose_tpu_torch.core.generate import _decode_step
    from modelcompose_tpu_torch.core.llama import KVCache, local_kv_heads
    cache = KVCache.zeros(cfg, 2, 32, kv_heads=local_kv_heads(model.params,
                                                              cfg))
    _decode_step(model.params, cfg, cache, torch.tensor([3, 5]),
                 torch.tensor([4, 6], dtype=torch.int32),
                 model.decode_routing_table())


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
        if res["ids"] != res["ref_ids"]:
            bad.append(f"rank {r}: TP greedy ids {res['ids']} != "
                       f"{res['ref_ids']}")
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
    variant of ``spec['variants']``): greedy ids of two requests; with
    ``spec['slot']`` the chunked prefill's logits and the slot decoder's
    schedule (rank 0 leads, the others follow); with ``spec['worker']`` the
    model worker's wire chunks (continuous batching, then the
    micro-batching engine).  Without a process group: the tp 1 run."""
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
        out[name] = model.generate(prompts, inputs, max_new_tokens=6,
                                   device_loop=False)
    if spec.get("slot"):
        from modelcompose_tpu_torch.serve.slot_engine import SlotDecoder
        with torch.no_grad(), tp.scope(model.tp_group):
            embeds, plan = model.prepare_batch(prompts[:1], inputs,
                                               bucket_len=16)
            logits, _ = prefill_chunked(
                model.params, model.cfg, embeds,
                torch.as_tensor(plan.route_ids), model.routing_table,
                plan.lengths, 64, chunk=4)
        out["chunked_logits"] = logits.tolist()
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
    rank's moment bytes and the files it saved."""
    from unittest import mock

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
        with mock.patch.object(entry, "TrainConfig", functools.partial(
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
                    "rank": distributed.rank()})
    return out


CASES = {"dpxtp": case_dpxtp, "tp": case_tp, "train": case_train}


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------

def _child(args) -> None:
    torch.set_num_threads(1)
    distributed.initialize(args.init, args.world, args.rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=args.timeout))
    try:
        spec = {}
        if args.spec:
            with open(args.spec) as f:
                spec = json.load(f)
        result = CASES[args.case](spec)
        with open(os.path.join(args.out, f"{args.case}-rank{args.rank}.json"),
                  "w") as f:
            json.dump(result, f)
    finally:
        distributed.shutdown()


def launch(case: str, world: int, out: str, spec=None, timeout: float = 120,
           cwd=None) -> list:
    """Run ``case`` in ``world`` gloo processes; returns the ranks' results.
    Raises RuntimeError (with the failing ranks' output) when a rank fails
    or outlives ``timeout``; every process is ended first."""
    os.makedirs(out, exist_ok=True)
    rendezvous = tempfile.mkdtemp(prefix="rendezvous_", dir=out)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(out, f"{case}-rank{rank}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, os.path.abspath(__file__), "--case", case,
               "--world", str(world), "--rank", str(rank), "--out",
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
    args = p.parse_args(argv)
    if args.rank is not None:
        _child(args)
        return 0
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        results = launch(args.case, args.world, args.out or tmp, args.spec,
                         args.timeout)
    bad = dryrun_checks(results) if args.case == "dpxtp" else []
    print(json.dumps({"ok": not bad, "case": args.case, "world": args.world,
                      "failures": bad, "ranks": [
                          {k: v for k, v in r.items()
                           if not k.endswith("audit")} for r in results]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
