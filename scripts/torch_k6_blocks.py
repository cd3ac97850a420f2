#!/usr/bin/env python3
"""K6's blocks (128 weight columns by 64, 128 or 256 rows of x) on one CUDA
card, each at every Vicuna-7B layer product (q/k/v/o 4096 x 4096, gate/up
4096 x 11008, down 11008 x 4096) at 256-3,328 rows, beside ``torch.mm`` on
the weight converted to bf16 beforehand (the GEMM the plain route runs,
without its convert and its scale pass).  Each block runs from this tree's
``csrc/w8a16_gemm.cu`` and from a copy with the conversion taken out
(``noconvert``: A is a constant, so the difference is what converting the
int8 tiles costs; its result is wrong).  Times are CUDA events over 20
launches after a warm-up.

    python3 scripts/torch_k6_blocks.py

Per case the block's time, TFLOP/s, and its rate within a wave: the flops
of one wave of the 132 SMs (one block an SM) over the time of a wave, the
quantity ``ops/quant._K6_RATES`` holds (a wave's rate is what the plan
compares; the last wave of a grid may run part full).  Prints one JSON line
per case and writes them, with each block's median wave rate, to
``chiprun_out/k6_blocks.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

VARIANTS = {
    "base": [],
    "noconvert": [("      convert(s, cur);\n",
                   "      for (int i = 0; i < 16; ++i)\n"
                   "        cur[i] = 0x3F803F80u + (s & 1);\n")],
}
SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
          "down": (11008, 4096)}
ROWS = (3328, 2048, 1024, 512, 256)
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_of = sorted(quant._K6_RATES)
    cases, waves_rate = [], {}
    for M in ROWS:
        for shape, (K, N) in SHAPES.items():
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            q = torch.randint(-127, 128, (K, N), generator=gen,
                              device="cuda", dtype=torch.int8)
            scale = torch.rand(N, generator=gen, device="cuda") * 1e-3 + 1e-4
            out = torch.empty((M, N), device="cuda")
            want = quant.dequant_matmul_reference(x, {"q": q, "scale": scale[
                None]}, torch.float32)
            w = q.to(torch.bfloat16)
            flops = 2 * M * K * N
            mm_ms = cuda_time_ms(lambda: torch.mm(x, w,
                                                  out_dtype=torch.float32),
                                 20)
            row = {"M": M, "K": K, "N": N, "shape": shape, "mm_ms": mm_ms,
                   "mm_tflops": flops / mm_ms / 1e9,
                   "plan_rows": quant._k6_plan(M, K, N)[0]}
            for name, fn in fns.items():
                for rows in rows_of:
                    m_tiles = -(-M // rows)
                    n_tiles = -(-N // quant._K6_COLS)
                    waves = -(-m_tiles * n_tiles // quant._SMS)

                    def call():
                        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), M, K, N, rows,
                                 min(quant._K6_GROUP, m_tiles), 1, 0, stream)
                        if err:
                            raise RuntimeError(f"K6 rows {rows}: error {err}")
                    call()
                    torch.cuda.synchronize()
                    if name == "base":
                        rel = ((out - want).abs().max()
                               / want.abs().max()).item()
                        if rel > 1e-5:
                            raise AssertionError(f"rows {rows} M{M} K{K} "
                                                 f"N{N}: rel err {rel:.3g}")
                    ms = cuda_time_ms(call, 20)
                    wave = (2 * rows * quant._K6_COLS * K * quant._SMS
                            / (ms / waves) / 1e9)
                    row[f"{name}_{rows}"] = {"ms": ms,
                                             "tflops": flops / ms / 1e9,
                                             "wave_tflops": wave,
                                             "waves": waves}
                    waves_rate.setdefault(f"{name}_{rows}", []).append(wave)
            print(json.dumps(row), flush=True)
            cases.append(row)
    median = {k: statistics.median(v) for k, v in waves_rate.items()}
    print(json.dumps({"median_wave_tflops": median}), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"device": smi, "cases": cases,
                   "median_wave_tflops": median}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
