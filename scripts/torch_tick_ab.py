#!/usr/bin/env python3
"""The 8-slot pool's decode tick of two checkouts in turns (old, new, new,
old) on one CUDA card: each turn a fresh process that imports its
checkout's package and ``chip_smoke.build_main_model`` (the vision DAMC
composition at Vicuna-7B width, random weights, int8 base), fills a
``SlotDecoder`` of 8 int8 slots of 3,456 positions with every slot active
at kv_len 34-3,290, and times 200 ticks (a draw on the device for every
slot, then ``step`` through the pool's decode graph) on the host clock,
then 50 replays of the pool's graph between CUDA events (device time).

    python3 scripts/torch_tick_ab.py --old DIR

DIR is the root of an earlier checkout holding its package and its
``chip_smoke.py`` (``git archive <commit> modelcompose_tpu_torch
chip_smoke.py | tar -x -C DIR``).  Prints one JSON line a turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tick_run(root: str) -> dict:
    """One checkout's tick (run in a process of its own)."""
    sys.path.insert(0, root)
    os.chdir(root)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="root of the earlier checkout")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(tick_run(args.worker)), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for who, root in (("old", args.old), ("new", ROOT), ("new", ROOT),
                      ("old", args.old)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", os.path.abspath(root)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise RuntimeError(f"{who} turn failed:\n{out.stderr[-3000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(row, turn=who, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
