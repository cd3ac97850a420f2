#!/usr/bin/env python3
"""One workload of two checkouts of the port, in turns on one CUDA card,
or the routes of this checkout's phase-6 path in turns.

    git archive <commit> modelcompose_tpu_torch chip_smoke.py \
        | tar -x -C tmp_old                       # a gitignored directory
    python3 scripts/torch_path_ab.py --old tmp_old --workload path|tick|step \
        [--pairs 1]
    python3 scripts/torch_path_ab.py --workload routes

Each turn is a fresh process that imports its checkout's package and
``chip_smoke.py`` (so builds that checkout's kernels), in the order old,
new, new, old (``--pairs`` times); ``routes`` is one process of this
checkout.  The workloads:

- ``path``: ``chip_smoke``'s vision serving path (phase 5: prefill s and
  greedy decode tokens/s at Vicuna-7B width) and its stage-2 train step
  (phase 9: step s of its four steps);
- ``tick``: the 8-slot pool's decode tick: ``chip_smoke.build_main_model``
  (the vision DAMC composition at Vicuna-7B width, random weights, int8
  base), a ``SlotDecoder`` of 8 int8 slots of 3,456 positions, every slot
  active at kv_len 34-3,290; 200 ticks (a draw on the device for every
  slot, then ``step`` through the pool's graph) on the host clock, then 50
  replays of the pool's graph between CUDA events (device time), and the
  K5 launches a tick;
- ``step``: one replayed one-row MCUB-4 decode step: the backbone at
  Vicuna-7B width and depth (``configs.mcub4_damc_7b``: 32 layers, random
  weights from seed 0, int8 base, the dense fold: no adapter branch at
  decode) and a ``DecodeGraph`` of one row over an int8 cache of 3,360
  positions filled with random bytes, the token at position 3,303
  (MCUB-4's 3,287 prompt positions and 16 answer tokens): 200 back-to-back
  replays between CUDA events (``replay_ms``), one replay under
  torch.profiler (``kernels`` and their summed ``device_ms``, by profile
  split, ``chip_smoke.PROFILE_SPLITS``), the launches the replay counts on
  the counters both trees have (K2, K5, K8, K9, K10), and the step's fp32
  logits, which every turn must reproduce bit for bit;
- ``routes``: phase 6's MCUB-4 model and request (``configs.mcub4_damc_7b``
  at Vicuna-7B width and depth, random weights from ``chip_smoke.SEED``)
  through the graphs on the arms of the smoke's three A/Bs in turns,
  each with the smoke's own checks (exact launches, ids equal or parting
  at a named near tie): K5 against the plain int8 product
  (``chip_smoke.K5_AB_TURNS``: decode tok/s, a replayed step's device ms),
  the decode layer unfused, K8-K10 separate and inside K5
  (``FUSED_AB_TURNS``: decode tok/s, a replayed step's device ms and
  kernels), K6 against the plain route above 8 rows (``K6_AB_TURNS``: the
  one-shot prefill s, a 512-row chunk step's ms).

Prints the card's name and power limit, one JSON line a turn and a JSON
summary (each key's values by side, in turn order) as its last line, also
written to ``chiprun_out/ab_<workload>.json``.  Every process it starts is
waited for (``--timeout`` each).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRATCH = os.path.join(ROOT, "tmp_step_ab")  # gitignored: the turns' logits
KEYS = {"path": ("prefill_s", "decode_tok_per_s", "train_step_s"),
        "tick": ("tick_ms_median", "replay_ms", "k5_per_tick"),
        "step": ("replay_ms", "kernels", "device_ms"),
        "routes": ("k5", "fused", "k6")}
STEP_CACHE_LEN = 3360
STEP_POSITION = 3303
STEP_REPLAYS = 200


def _enter(root: str):
    sys.path.insert(0, root)
    os.chdir(root)


def path_run(root: str, out_file: str) -> dict:
    """Phases 5 and 9 of one checkout's smoke (in a process of its own)."""
    _enter(root)
    import contextlib
    import gc
    import io
    import re
    import torch
    import chip_smoke as c
    device = c.phase_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(c.SEED)
    c.phase_build()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        c.phase_main_path(device, gen)
    m = re.search(r"\[main\] prefill_s=(\S+) decode_s=(\S+) "
                  r"decode_tok_per_s=(\S+)", out.getvalue())
    gc.collect()
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        train = c.phase_train(device)
    return {"prefill_s": float(m.group(1)),
            "decode_tok_per_s": float(m.group(3)),
            "train_step_s": train["step_s"]}


def tick_run(root: str, out_file: str) -> dict:
    """One checkout's pool tick (in a process of its own)."""
    _enter(root)
    import numpy as np
    import torch
    import chip_smoke
    from modelcompose_tpu_torch.ops import quant
    from modelcompose_tpu_torch.serve.slot_engine import SlotDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, model = chip_smoke.build_main_model(torch.device("cuda"), gen)
    kv_lens = np.linspace(34, 3290, 8).astype(np.int64)
    with torch.inference_mode():
        dec = SlotDecoder(model, 8, 3456, kv_quant=True)
        dec.active[:] = True
        draws = torch.Generator(device="cuda").manual_seed(1)
        temps, top_ps = np.zeros(8, np.float32), np.ones(8, np.float32)
        tokens = np.full(8, 100, np.int32)

        def tick():
            dec.sample(draws, temps, top_ps)
            dec.kv_lens = kv_lens.copy()
            dec.step(tokens)
        for _ in range(10):
            tick()
        torch.cuda.synchronize()
        n5 = quant.dequant_matmul.launches
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            tick()
            times.append((time.perf_counter() - t0) * 1e3)
        k5 = (quant.dequant_matmul.launches - n5) / 200
        graph = model.serving.graphs["pool"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
    return {"tick_ms_median": float(np.median(times)),
            "tick_ms_p10_p90": [float(np.percentile(times, 10)),
                                float(np.percentile(times, 90))],
            "replay_ms": start.elapsed_time(end) / 50, "k5_per_tick": k5}


def step_run(root: str, out_file: str) -> dict:
    """One checkout's replayed one-row MCUB-4 step (in a process of its
    own); its logits go to ``out_file``."""
    _enter(root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from modelcompose_tpu_torch.configs import mcub4_damc_7b
    from modelcompose_tpu_torch.core import llama
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.ops import decode_fused, flash_decode, quant
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cfg = mcub4_damc_7b()
    gen = torch.Generator(device=device).manual_seed(0)
    counters = {"flash_decode": flash_decode.flash_decode_attention,
                "w8a16_gemv": quant.dequant_matmul,
                "add_rms_norm": decode_fused.add_rms_norm,
                "rope_kv_write": decode_fused.rope_kv_write,
                "silu_mul": decode_fused.silu_mul}
    with torch.no_grad():
        params = quant.quantize_backbone(llama.init_params(cfg, gen, device))
        graph = DecodeGraph(params, cfg, 1, STEP_CACHE_LEN, kv_quant=True)
        for part in (graph.cache.k, graph.cache.v):
            part["q"].random_(-127, 128, generator=gen)
            part["scale"].uniform_(1e-3, 2e-2, generator=gen)
        tokens = torch.tensor([100], device=device)
        kv_lens = torch.tensor([STEP_POSITION], dtype=torch.int32,
                               device=device)
        for _ in range(3):  # eager, capture, replay
            logits = graph(tokens, kv_lens)
        if graph.graph is None:
            raise RuntimeError("the decode step was not captured")
        torch.save(logits.cpu(), out_file)
        before = {k: f.launches for k, f in counters.items()}
        graph.run()
        launches = {k: f.launches - before[k] for k, f in counters.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(STEP_REPLAYS):
            graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.graph.replay()
            torch.cuda.synchronize()
    kernels, device_us, by_split = 0, 0.0, {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.device_time_total <= 0:
            continue
        kernels += e.count
        device_us += e.device_time_total
        split = chip_smoke._split_of(e.key) or "other"
        by_split[split] = by_split.get(split, 0) + e.count
    return {"replay_ms": start.elapsed_time(end) / STEP_REPLAYS,
            "kernels": kernels, "device_ms": device_us / 1e3,
            "kernels_by_split": by_split, "launches": launches}


def routes_run(root: str, out_file: str) -> dict:
    """Phase 6's three A/Bs of one checkout in turns (in a process of its
    own)."""
    _enter(root)
    import contextlib
    import io
    import torch
    import chip_smoke as c
    from modelcompose_tpu_torch.configs import mcub4_damc_7b
    device = c.phase_device()
    c.phase_build()
    gen = torch.Generator(device=device)
    gen.manual_seed(c.SEED)
    cfg = mcub4_damc_7b()
    with contextlib.redirect_stdout(io.StringIO()):
        model = c.build_served_model(cfg, device, gen, "composed")
        ids, inputs = c._mcub4_request(cfg, device, gen)
        kw = dict(kv_quant=True, compact_adapters=True)
        k5 = c._k5_decode_ab(model, ids, inputs, kw, c.K5_AB_TURNS)
        fused = c._fused_decode_ab(model, ids, inputs, kw, c.FUSED_AB_TURNS)
        k6 = c._k6_prefill_ab(model, ids, inputs, kw, c.K6_AB_TURNS)
    return {"k5": {k: k5[k] for k in ("decode_tok_per_s", "step_device_ms",
                                      "ids_equal")},
            "fused": {k: fused[k] for k in ("decode_tok_per_s",
                                            "step_device_ms", "step_kernels",
                                            "ids_equal")},
            "k6": {k: k6[k] for k in ("prefill_s", "chunk_step_ms",
                                      "prefill_logit_rel_err", "ids_equal")}}


RUNS = {"path": path_run, "tick": tick_run, "step": step_run,
        "routes": routes_run}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="root of the earlier checkout")
    ap.add_argument("--workload", choices=sorted(RUNS), default="path")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print("AB " + json.dumps(RUNS[args.workload](*args.worker)),
              flush=True)
        return 0
    if not args.old and args.workload != "routes":
        ap.error("--old is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    os.makedirs(SCRATCH, exist_ok=True)
    trees = {"new": ROOT}
    order = ("new",)
    if args.workload != "routes":
        trees["old"] = os.path.abspath(args.old)
        order = ("old", "new", "new", "old")
    rows = []
    for _ in range(args.pairs):
        for side in order:
            out_file = os.path.join(SCRATCH, f"{len(rows)}_{side}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--workload",
                 args.workload, "--worker", trees[side], out_file],
                capture_output=True, text=True, timeout=args.timeout)
            if proc.returncode:
                raise RuntimeError(f"{side} turn failed: exit "
                                   f"{proc.returncode}\n{proc.stdout[-2000:]}"
                                   f"{proc.stderr[-3000:]}")
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("AB ")][-1]
            row = dict(json.loads(line[3:]), side=side)
            if args.workload == "step":
                import torch
                row["logits_equal_first"] = torch.equal(
                    torch.load(out_file),
                    torch.load(os.path.join(SCRATCH, "0_old.pt")))
            rows.append(row)
            print(f"[ab] {json.dumps(row)}", flush=True)
    summary = {"card": card, "workload": args.workload, "turns": rows,
               "runs": {side: {k: [r[k] for r in rows if r["side"] == side]
                               for k in KEYS[args.workload]}
                        for side in trees}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"ab_{args.workload}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    if args.workload == "step" and not all(r["logits_equal_first"]
                                           for r in rows):
        raise AssertionError("the turns' logits differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
