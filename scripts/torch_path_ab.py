#!/usr/bin/env python3
"""The one-device paths of two checkouts of the port, in turns on one card.

    git archive <commit> | tar -x -C tmp_old     # a gitignored directory
    python3 scripts/torch_path_ab.py --old tmp_old [--pairs 2]

Runs ``chip_smoke``'s vision serving path (phase 5: prefill s and greedy
decode tokens/s at Vicuna-7B width) and its stage-2 train step (phase 9:
step s of its four steps) in a fresh process per run, from this checkout
and from ``--old``, in the order old, new, new, old (``--pairs`` times),
each process building its own checkout's kernels.  Prints one line per
run and a JSON summary as its last line.  Needs a CUDA card; every
process it starts is waited for (``--timeout`` each).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import contextlib, gc, io, json, re, sys
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
print("AB " + json.dumps({"prefill_s": float(m.group(1)),
                          "decode_tok_per_s": float(m.group(3)),
                          "train_step_s": train["step_s"]}), flush=True)
"""


def run(tree: str, timeout: float) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--old", required=True, help="the other checkout")
    p.add_argument("--pairs", type=int, default=1)
    p.add_argument("--timeout", type=float, default=400)
    args = p.parse_args(argv)
    trees = {"old": os.path.abspath(args.old), "new": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(args.pairs):
        for side in ("old", "new", "new", "old"):
            res = dict(run(trees[side], args.timeout), side=side)
            print(f"[ab] {json.dumps(res)}", flush=True)
            runs.append(res)
    summary = {side: {key: [r[key] for r in runs if r["side"] == side]
                      for key in ("prefill_s", "decode_tok_per_s",
                                  "train_step_s")}
               for side in trees}
    print(json.dumps({"device": smi, "runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
