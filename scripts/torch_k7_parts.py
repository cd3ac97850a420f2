#!/usr/bin/env python3
"""Where K7's time goes: copies of ``csrc/w8a16_dx.cu`` with one part of a
tile's work taken out, each timed beside the kernel itself on one CUDA
card, at q/k/v/o's and gate/up's dL/dx at 8,192 rows (B=4 x 2,048) with an
fp32 cotangent.

    python3 scripts/torch_k7_parts.py   # -> chiprun_out/k7_parts.json

The copies compute wrong values (each skips work the result needs); they
only say what each part costs:

- ``no_convert_g``: the B tile is not written from g's tile (the scale,
  the rounding and the shared-memory stores go; g's tile still lands);
- ``no_convert_q``: the A words are not converted from the q tile;
- ``no_g_load``: g's tile is not loaded by TMA (its L2 traffic goes);
- ``mma_only``: none of the three: the pipeline, the barriers and the
  products alone.

Each row gives ms (CUDA-graph replay over 4 weight copies, in turns:
kernel, copy, copy, kernel), TFLOP/s, and the bytes the blocks read from
L2 (every block reads its g tile and q tile each 64-deep step) over the
time.  The copies are built with ``_build.NVCC_FLAGS`` into
``tmp_k7_parts/`` (gitignored) and called through the same C entry.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

OUT = os.path.join(ROOT, "tmp_k7_parts")
CONVERT = """      convert_q(s, cur);
      convert_g(s, b);
"""
G_LOAD = """          mbar_arrive_expect_tx(full0 + 8 * s,
                                C::kGBytes + kQBytes + kBN * 4);
          tma_load_3d(st, &tg, full0 + 8 * s, t * kBN, m0, 0);
"""
NO_G_LOAD = """          mbar_arrive_expect_tx(full0 + 8 * s, kQBytes + kBN * 4);
"""
CUTS = {
    "no_convert_g": [(CONVERT, "      convert_q(s, cur);\n")],
    "no_convert_q": [(CONVERT, "      convert_g(s, b);\n")],
    "no_g_load": [(G_LOAD, NO_G_LOAD)],
    "mma_only": [(CONVERT, ""), (G_LOAD, NO_G_LOAD)],
}
SHAPES = {"qkvo": (8192, 4096, 4096), "gate_up": (8192, 4096, 11008)}
COPIES = 4


def build(name, source):
    """The copy ``name`` of K7's source, built and loaded."""
    for old, new in CUTS[name]:
        if old not in source:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        source = source.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    so = os.path.join(OUT, f"{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in _build.SIGNATURES["w8a16_dx"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    src_dir = os.path.join(ROOT, "modelcompose_tpu_torch", "csrc")
    shutil.copy(os.path.join(src_dir, "hopper.cuh"), OUT)
    with open(os.path.join(src_dir, "w8a16_dx.cu")) as f:
        source = f.read()
    libs = {"kernel": _build.load("w8a16_dx")}
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs.update(zip(CUTS, pool.map(lambda n: build(n, source), CUTS)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, (M, K, N) in SHAPES.items():
        weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                       device="cuda", dtype=torch.int8),
                    "scale": torch.rand(N, generator=gen, device="cuda")
                    * 1e-3 + 1e-4} for _ in range(COPIES)]
        g = torch.randn((M, N), generator=gen, device="cuda")
        dx = torch.empty((M, K), dtype=torch.bfloat16, device="cuda")
        block, m_tiles, k_tiles, group = quant._k7_plan(M, K, N)
        steps = -(-N // 64)
        per_step = {"kernel": block * 64 * 4 + quant._K7_COLS * 64,
                    "no_convert_g": block * 64 * 4 + quant._K7_COLS * 64,
                    "no_convert_q": block * 64 * 4 + quant._K7_COLS * 64,
                    "no_g_load": quant._K7_COLS * 64,
                    "mma_only": quant._K7_COLS * 64}

        def timed(lib):
            layers = itertools.cycle(range(COPIES))

            def call():
                w = weights[next(layers)]
                err = lib.mc_w8a16_dx(
                    g.data_ptr(), w["q"].data_ptr(), w["scale"].data_ptr(),
                    dx.data_ptr(), M, K, N, group, 0, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"w8a16_dx: CUDA error {err}")
            return graph_time_ms(call, n=COPIES)
        for name in CUTS:
            ms = {"kernel": [], name: []}
            for who in ("kernel", name, name, "kernel"):
                ms[who].append(timed(libs[who]))
            row = {"shape": shape, "M": M, "K": K, "N": N, "block": block,
                   "part_taken_out": name, "ms": ms, "card": card}
            for who, t in ms.items():
                best = min(t)
                row[f"{who}_tflops"] = 2 * M * K * N / best / 1e9
                row[f"{who}_l2_tb_per_s"] = (m_tiles * k_tiles * steps
                                             * per_step[who] / best / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k7_parts.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
