#!/usr/bin/env python3
"""K6 of this checkout against an earlier checkout's K6 on the MCUB-4
serving path, in turns on one CUDA card: the one-shot prefill of
chip_smoke.py's phase-6 request (3,287 positions in the 3,328 bucket,
Vicuna-7B width, int8 base, random weights from chip_smoke.SEED) through
its prefill graph, its chunked admission through the chunk-step graphs
(512-row chunks), and phase 9b's int8-base (QLoRA) train step through its
graph (``chip_smoke.phase_train_int8``: B=4 x 2,048, 32 layers, 464 K6
launches a step), in the order old, new, new, old.

    git archive <commit> modelcompose_tpu_torch | tar -x -C tmp_old
    python3 scripts/torch_k6_e2e_ab.py --old tmp_old

Each turn is a fresh process that builds the model and its kernels.  The
old arm swaps the port's K6 launcher (``ops/quant._k6``) for the earlier
checkout's, built by its own ``_build.py`` into DIR, its launches counted
by and recorded into the port's counters and capture records; everything
else is this checkout's.  A turn: three one-token requests (eager,
capturing, replayed) and the third's prefill s, K6's launches in them
(three prefills' worth), and the median ms of the replayed admission's
full chunks (``chip_smoke._chunk_step_ms``); then, with the serving
model freed, phase 9b, whose replayed step's seconds the turn reports.
The arms' prefill logits must agree within chip_smoke.LOGIT_TOL.
Prints the card's name and power limit, one line per turn and a JSON
summary as its last line, also written to ``chiprun_out/k6_e2e_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRATCH = os.path.join(ROOT, "tmp_k6_e2e")  # gitignored: the arms' logits


def turn(arm: str, old: str) -> dict:
    """One arm in this process: the model, the three requests, the chunked
    admission, phase 9b; the prefill logits saved to SCRATCH/<arm>.pt."""
    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as c
    from modelcompose_tpu_torch.configs import mcub4_damc_7b
    from modelcompose_tpu_torch.ops import quant
    torch.backends.cuda.matmul.allow_tf32 = False
    if arm == "old":
        from torch_kernel_ab import old_quant
        old_q = old_quant(old)
        old_q._capture_record = quant._capture_record
        old_q.w8a16_gemm = quant.w8a16_gemm
        quant._k6 = old_q._k6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c.SEED)
    cfg = mcub4_damc_7b()
    model = c.build_served_model(cfg, "cuda", gen, f"k6_e2e {arm}")
    ids, inputs = c._mcub4_request(cfg, "cuda", gen)
    kw = dict(kv_quant=True, compact_adapters=True)
    n6 = quant.w8a16_gemm.launches
    for _ in range(3):
        timings = {}
        with c._PrefillLogits() as pl:
            model.generate(ids, inputs, max_new_tokens=1, timings=timings,
                           **kw)
    launches = quant.w8a16_gemm.launches - n6
    want = 3 * c._k6_per_forward(model.params)
    if launches != want:
        raise AssertionError(f"{arm}: K6 launched {launches} times, want "
                             f"{want}")
    chunks = statistics.median(c._chunk_step_ms(model, ids, inputs))
    os.makedirs(SCRATCH, exist_ok=True)
    torch.save(pl.logits[0].float().cpu(), os.path.join(SCRATCH,
                                                        f"{arm}.pt"))
    del model, inputs, pl
    torch.cuda.empty_cache()
    train = c.phase_train_int8("cuda")
    return {"arm": arm, "prefill_s": timings["prefill_s"],
            "chunk_step_ms": chunks, "k6_launches": launches,
            "train_int8_replay_s": train["replay_step_s"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="root of a checkout of the earlier sources")
    ap.add_argument("--arm", choices=("old", "new"),
                    help="run one turn in this process (each turn's own)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a turn may take")
    args = ap.parse_args()
    if args.arm:
        print(json.dumps(turn(args.arm, args.old)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_e2e_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    prefill_s, chunk_ms, train_s = {}, {}, {}
    for arm in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--old", args.old,
             "--arm", arm], capture_output=True, text=True,
            timeout=args.timeout, cwd=ROOT)
        if proc.returncode:
            raise RuntimeError(f"{arm} turn failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        prefill_s.setdefault(arm, []).append(row["prefill_s"])
        chunk_ms.setdefault(arm, []).append(row["chunk_step_ms"])
        train_s.setdefault(arm, []).append(row["train_int8_replay_s"])
        print(json.dumps(row), flush=True)
    logits = {arm: torch.load(os.path.join(SCRATCH, f"{arm}.pt"))
              for arm in ("old", "new")}
    rel = ((logits["new"] - logits["old"]).abs().max()
           / logits["old"].abs().max()).item()
    sys.path.insert(0, ROOT)
    from chip_smoke import LOGIT_TOL
    out = {"card": card, "prefill_s": prefill_s, "chunk_step_ms": chunk_ms,
           "train_int8_replay_s": train_s, "prefill_logit_rel_err": rel,
           "tol": LOGIT_TOL}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k6_e2e_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    if rel > LOGIT_TOL:
        raise AssertionError(f"the arms' prefill logits {rel:.3g} apart")
    return 0


if __name__ == "__main__":
    sys.exit(main())
