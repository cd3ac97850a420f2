#!/usr/bin/env python3
"""K6's schedules on one CUDA card: each block (128 weight columns by 64,
128 or 256 rows of x) and each split of K over a cluster (1, 2 or 4
blocks), forced, at every Vicuna-7B layer product (q/k/v/o 4096 x 4096,
gate/up 4096 x 11008, down 11008 x 4096) at 256-8,192 rows, beside the
schedule ``ops/quant._k6_plan`` picks and ``torch.mm`` on the weight
converted to bf16 beforehand (the GEMM the plain route runs, without its
convert and its scale pass).  Each schedule runs from this tree's
``csrc/w8a16_gemm.cu`` and from copies with a part taken out, each result
wrong: ``noconvert`` (A a constant: what converting the int8 tiles
costs), and at splits of 2 and 4 ``noexchange`` (a block's partials of
its peers' rows not sent) and ``nosum`` (a block's rows not summed,
scaled or stored): what a split's exchange through distributed shared
memory and its epilogue cost.  Split 1 takes every tile whole;
a split of 2 or 4 splits every tile (no whole waves), so each measures
one kind of unit.  Times are CUDA-graph replays cycling over 4 weight
copies (more bytes than L2 holds, as phase 4c of chip_smoke.py times K6).

    python3 scripts/torch_k6_blocks.py

Per case each schedule's time, TFLOP/s, its result's largest difference
from the plain product relative to max |y| (``rel_err``, fp32 out; a split
adds the partials in another order), and its rate in a round: the flops
one unit does (a tile's, over 1/split of K) times 132 SMs over the time of
one round of units (one unit a block on every block the card runs at
once, ``_k6_active``), the quantity ``ops/quant._K6_RATES`` holds (the
plan compares rounds of units; the last round of a grid may run part
full).  Prints the card's name and power limit, one line per case (times
and differences), and writes every figure, with each schedule's median
rate, to ``chiprun_out/k6_blocks.json``.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

VARIANTS = {
    "base": [],
    "noconvert": [("      convert(s, cur);\n",
                   "      for (int i = 0; i < 16; ++i)\n"
                   "        cur[i] = 0x3F803F80u + (s & 1);\n")],
    # a split unit without its exchange through distributed shared memory
    # (each block sums whatever its ring holds), and without the sum, the
    # scale and the stores of its rows: what each part of a split costs
    "noexchange": [("        st_cluster_f4(mapa_shared(slot, o),\n",
                    "        if (o == units.rank) st_cluster_f4(\n"
                    "            mapa_shared(slot, o),\n")],
    "nosum": [("      for (int i = 0; i < per; ++i) {\n",
               "      for (int i = 0; i < 0; ++i) {\n")],
}
SPLIT_ONLY = ("noexchange", "nosum")  # variants that change split units
SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
          "down": (11008, 4096)}
ROWS = (8192, 3328, 2048, 1024, 512, 256)
COPIES = 4
OUT = os.path.join(ROOT, "chiprun_out", "k6_blocks.json")


def build(name, scratch):
    """A copy of the K6 source with the variant's patches, built by nvcc
    with the tree's flags; its ``mc_w8a16_gemm`` entry."""
    src = open(os.path.join(_build.CSRC, "w8a16_gemm.cu")).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: patch target not in the source")
        src = src.replace(old, new)
    path = os.path.join(_build.CSRC, f"tmp_k6_{name}.cu")  # finds hopper.cuh
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(scratch, f"k6_{name}.so")
    try:
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       check=True, capture_output=True, text=True)
    finally:
        os.remove(path)
    fn = ctypes.CDLL(so).mc_w8a16_gemm
    fn.argtypes, fn.restype = _build.SIGNATURES["w8a16_gemm"]["mc_w8a16_gemm"]
    return fn


def forced(M, K, N, rows, split, active):
    """The schedule of one kind of unit: split 1 every tile whole over the
    card's blocks, a split of 2 or 4 every tile split over its clusters;
    with the rounds of units it runs."""
    m_tiles = -(-M // rows)
    n_tiles = -(-N // quant._K6_COLS)
    tiles = m_tiles * n_tiles
    clusters = active[rows, split]
    plan = quant.K6Plan(rows, split, m_tiles, n_tiles,
                        min(quant._K6_GROUP, m_tiles), min(tiles, clusters),
                        tiles if split == 1 else 0)
    return plan, -(-tiles // clusters)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_blocks: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    scratch = os.path.join(ROOT, "tmp_k6_blocks")
    os.makedirs(scratch, exist_ok=True)
    fns = {name: build(name, scratch) for name in VARIANTS}
    active = quant._k6_active(torch.device("cuda"))
    print(json.dumps({"active_clusters": {f"{r}x{s}": n for (r, s), n in
                                          sorted(active.items())}}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, rates = [], {}
    for shape, (K, N) in SHAPES.items():
        weights = [(torch.randint(-127, 128, (K, N), generator=gen,
                                  device="cuda", dtype=torch.int8),
                    torch.rand(N, generator=gen, device="cuda") * 1e-3
                    + 1e-4) for _ in range(COPIES)]
        dense = [q.to(torch.bfloat16) for q, _ in weights]
        for M in ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            out = torch.empty((M, N), device="cuda")
            q0, s0 = weights[0]
            want = quant.dequant_matmul_reference(
                x, {"q": q0, "scale": s0[None]}, torch.float32)
            flops = 2 * M * K * N
            copies = itertools.cycle(range(COPIES))
            mm_ms = graph_time_ms(lambda: torch.mm(
                x, dense[next(copies)], out_dtype=torch.float32), n=COPIES)
            pick = quant._k6_plan(M, K, N, active)
            row = {"M": M, "K": K, "N": N, "shape": shape, "mm_ms": mm_ms,
                   "mm_tflops": flops / mm_ms / 1e9,
                   "plan": {"rows": pick.rows, "split": pick.split,
                            "whole": pick.whole,
                            "clusters": pick.clusters}}
            schedules = [(f"{r}x{s}",) + forced(M, K, N, r, s, active)
                         for r, s in sorted(quant._K6_RATES)
                         if s == 1 or -(-K // quant._K6_STEP) >= s]
            schedules.append(("plan", pick, None))
            for name, fn in fns.items():
                for label, plan, rounds in schedules:
                    if name in SPLIT_ONLY and plan.split == 1:
                        continue
                    def call(plan=plan, fn=fn, label=label):
                        q, s = weights[next(copies)]
                        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                 out.data_ptr(), M, K, N, plan.rows,
                                 plan.group, plan.split, plan.clusters,
                                 plan.whole, 1, 0,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"K6 {label}: error {err}")
                    cell = {}
                    if name == "base":  # the first copy's result, recorded
                        copies = itertools.repeat(0)
                        call()
                        torch.cuda.synchronize()
                        cell["rel_err"] = ((out - want).abs().max()
                                           / want.abs().max()).item()
                    copies = itertools.cycle(range(COPIES))
                    ms = graph_time_ms(call, n=COPIES)
                    cell.update(ms=ms, tflops=flops / ms / 1e9)
                    if rounds is not None:
                        unit = 2 * plan.rows * quant._K6_COLS * K \
                            / plan.split
                        cell["round_tflops"] = (unit * quant._SMS
                                                / (ms / rounds) / 1e9)
                        cell["rounds"] = rounds
                        rates.setdefault(f"{name}_{label}", []).append(
                            cell["round_tflops"])
                    row[f"{name}_{label}"] = cell
            print(json.dumps({"M": M, "shape": shape, "mm_ms": mm_ms,
                              "plan": row["plan"], "ms": {
                                  k: round(v["ms"], 4) for k, v in row.items()
                                  if isinstance(v, dict) and "ms" in v},
                              "rel_err": {k: v["rel_err"] for k, v in
                                          row.items() if isinstance(v, dict)
                                          and "rel_err" in v}}), flush=True)
            cases.append(row)
        del weights, dense
        torch.cuda.empty_cache()
    median = {k: statistics.median(v) for k, v in rates.items()}
    print(json.dumps({"median_round_tflops": median}), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"device": smi, "active_clusters": {
            f"{r}x{s}": n for (r, s), n in sorted(active.items())},
            "cases": cases, "median_round_tflops": median}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
