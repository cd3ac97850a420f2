#!/usr/bin/env python3
"""Phase 13's kernel-against-plain answers on the random draw they take
when phase 4d shares the smoke's generator, with an fp32 witness at every
answer that leaves the plain path's.

    python3 scripts/torch_phase13_witness.py   # -> chiprun_out/phase13_witness.json

``chip_smoke.py`` gives phase 4d (K7) a generator of its own.  This script
runs the smoke's phases up to phase 13 in the smoke's order with phase 4d
on the shared generator instead, so every later phase draws what it drew
then.  Phase 13's check (``chip_smoke._kernel_vs_plain``) runs on each
entry and is recorded instead of raised; at the first differing step of
each answer that differs, the teacher-forced logits of three paths are
taken on the kernel path's prompt and tokens:

- ``kernel``: bf16 activations, K1/K6 (the kernel path);
- ``plain``: bf16 activations, the plain attention and products;
- ``fp32``: the plain path with the model's bf16 leaves in fp32 and fp32
  activations (the int8 weights and their scales as they are).

Each path's distance from the fp32 logits (max |a - f| over max |f|), the
token each picks, the fp32 logits' margin between the two paths' tokens
and whether the plain path's prompt was the kernel path's say which bf16
path the fp32 one sides with.  Runs on one CUDA card; the phases' own
checks still raise.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "phase13_witness.json")


def _fp32(tree):
    """``tree`` with its bf16 and fp16 tensors in fp32; other leaves (the
    int8 weights, fp32 scales, ints) as they are."""
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fp32(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype in (torch.bfloat16,
                                                         torch.float16):
        return tree.float()
    return tree


def fp32_teacher_forced(model, ids, inputs, tokens):
    """``chip_smoke._teacher_forced`` on the plain path (no int8 cache) in
    fp32: the bf16 embeddings of the prompt in fp32, the model's bf16
    leaves in fp32."""
    import numpy as np
    from modelcompose_tpu_torch.core.generate import _decode_step, _prefill
    embeds, plan = model.prepare_batch(ids, inputs)
    embeds = embeds.float()
    params = _fp32(model.params)
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    route_ids = torch.as_tensor(plan.route_ids, device=embeds.device)
    lengths = torch.as_tensor(plan.lengths, device=embeds.device)
    seg = torch.as_tensor(plan.segment_ids, device=embeds.device)
    table = torch.as_tensor(np.asarray(model.routing_table),
                            device=embeds.device)
    logits, cache = _prefill(params, cfg, embeds, route_ids, table, seg,
                             lengths, embeds.shape[1] + max(
                                 smoke.NEW_TOKENS, tokens.shape[1]),
                             "reference", kv_quant=False)
    steps, kv_lens = [logits], lengths
    for t in range(tokens.shape[1] - 1):
        logits, cache, kv_lens = _decode_step(
            params, cfg, cache, tokens[:, t], kv_lens,
            model.decode_routing_table(), "reference")
        steps.append(logits)
    return torch.stack(steps, dim=1)


def witness(model, kernel_calls, plain_calls, rows, check):
    """Phase 13's comparison, recorded: ``check`` (the smoke's own) on an
    entry's calls, its failure kept in ``rows`` instead of raised; at each
    answer that differs, the three paths' logits at the first differing
    step on the kernel path's prompt, and whether the plain path's prompt
    was the same."""
    import numpy as np
    try:
        out = check(model, kernel_calls, plain_calls)
        rows.append({"check_passed": True,
                     "follow_ups": sum(bool(r.get("follow_up"))
                                       for r in out)})
    except AssertionError as e:
        out = [{"equal": False}] * len(kernel_calls)
        rows.append({"check_passed": False, "check_error": str(e)})
    for i, (k_call, p_call) in enumerate(zip(kernel_calls, plain_calls)):
        ids, inputs, got = k_call
        got, want = got[0], p_call[2][0]
        if got == want:
            continue
        step = next(j for j, (a, b) in enumerate(zip(got + [None],
                                                     want + [None]))
                    if a != b)
        eos = model.cfg.eos_token_id
        tokens = torch.tensor([(got + [eos])[:step + 1]], device=model.device)
        with torch.no_grad():
            k, p = (smoke._teacher_forced(model, ids, inputs, tokens, impl,
                                          kv_quant=False)[0, step].float()
                    for impl in ("auto", "reference"))
            f = fp32_teacher_forced(model, ids, inputs, tokens)[0, step]
        scale = f.abs().max()
        t_k = got[step] if step < len(got) else eos
        t_p = want[step] if step < len(want) else eos
        row = dict(
            call=i, diverge_step=step, kernel_token=t_k, plain_token=t_p,
            same_prompt=len(ids) == len(p_call[0]) and all(
                np.array_equal(a, b) for a, b in zip(ids, p_call[0])),
            argmax={"kernel": int(k.argmax()), "plain": int(p.argmax()),
                    "fp32": int(f.argmax())},
            rel_to_fp32={"kernel": ((k - f).abs().max() / scale).item(),
                         "plain": ((p - f).abs().max() / scale).item()},
            kernel_vs_plain=((k - p).abs().max()
                             / p.abs().max()).item(),
            fp32_margin_kernel_minus_plain_token=(
                (f[t_k] - f[t_p]) / scale).item(),
            fp32_top2_gap=((lambda v: (v[0] - v[1]) / scale)(
                f.topk(2).values)).item())
        smoke.log("witness", **{k_: json.dumps(v) for k_, v in row.items()})
        rows.append(row)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rows = []
    check = smoke._kernel_vs_plain
    smoke._kernel_vs_plain = lambda m, k, p: witness(m, k, p, rows, check)
    device = smoke.phase_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(smoke.SEED)
    smoke.phase_build()
    for phase in (smoke.phase_k1, smoke.phase_k2, smoke.phase_k5,
                  smoke.phase_k6, smoke.phase_k7):  # 4d on the shared one
        phase(device, gen)
    gc.collect()
    torch.cuda.empty_cache()
    smoke.phase_main_path(device, gen)
    gc.collect()
    torch.cuda.empty_cache()
    _, model, request = smoke.phase_composed(device, gen)
    smoke.phase_decode_variants(model, request)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tmp_loader_", dir=".") as root:
        merged, base_dir = smoke.phase_loader(device, gen, root)
        gc.collect()
        torch.cuda.empty_cache()
        smoke.phase_qa_loader(device, root, merged, base_dir, model)
        gc.collect()
        torch.cuda.empty_cache()
        smoke.phase_serve(device, gen, model, request, root, merged,
                          base_dir)
        model.prefill_graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        smoke.phase_towers(device)
        smoke.phase_eva_imagebind(device, gen)
        smoke.phase_entries(device, gen, root, model)
        gc.collect()
        torch.cuda.empty_cache()
        legacy = smoke.phase_legacy_eval(device, gen, root, merged,
                                         base_dir, model)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"card": card,
              "equal_to_plain": {e: [v["equal"] for v in r["vs_plain"]]
                                 for e, r in legacy["entries"].items()},
              "diverged": rows}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
