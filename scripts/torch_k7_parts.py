#!/usr/bin/env python3
"""Where K7's time goes, pass by pass, on one CUDA card: its first pass
(the scaled cotangent) alone, its second (the product) at each block the
plan can pick, and copies of ``csrc/w8a16_dx.cu`` with one part of the
product's tile work taken out, each timed beside the kernel itself, at
phase 4d's layer products at 8,192 rows (B=4 x 2,048; ``chip_smoke.
K7_SHAPES``) and the lm_head's at the loss chunks of B=4, B=2 and B=1
(1,024, 512 and 256 rows at ``--loss_chunk 256``; B=2 is the int8-base
pipeline bench's per-device batch, scripts/bench_train_pipeline.py), with
an fp32 cotangent and bf16 dx.

    python3 scripts/torch_k7_parts.py   # -> chiprun_out/k7_parts.json

The copies compute wrong values (each skips work the result needs); they
only say what each part costs:

- ``no_convert``: the A words are constants, not read from the q tile and
  converted (K6's ``noconvert`` in scripts/torch_k6_blocks.py);
- ``mma_only``: that, and no TMA loads either (the producer arrives on a
  stage's barrier without bytes): the pipeline, the barriers and the
  products alone.

Each row gives ms by CUDA-graph replay over 4 weight copies (the copies
in turns: kernel, copy, copy, kernel), TFLOP/s, and for the product at
each block its rate within a wave (the flops of one wave of the 132 SMs,
one block an SM, over the time of a wave: what ``ops/quant._K7_RATES``
holds, as ``_K6_RATES`` for K6); for pass 1 its bytes (g read, gs
written) over the time against the card's 3.35 TB/s.  The copies are
built with ``_build.NVCC_FLAGS`` into ``tmp_k7_parts/`` (gitignored) and
called through the same C entry.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import K7_LM_HEAD, K7_SHAPES, graph_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

OUT = os.path.join(ROOT, "tmp_k7_parts")
CONVERT = "      convert(s, cur);\n"
CONSTANT_A = ("      for (int i = 0; i < 16; ++i)\n"
              "        cur[i] = 0x3F803F80u + (s & 1);\n")
LOADS = """          mbar_arrive_expect_tx(full0 + 8 * s, C::kStageBytes);
          tma_load_3d(st, &tg, full0 + 8 * s, t * kBN, m0, 0);
          tma_load_3d(st + C::kGBytes, &tq, full0 + 8 * s, t * kBN, k0, 0);
"""
NO_LOADS = """          mbar_arrive(full0 + 8 * s + 0 * st);
"""
CUTS = {
    "no_convert": [(CONVERT, CONSTANT_A)],
    "mma_only": [(CONVERT, CONSTANT_A), (LOADS, NO_LOADS)],
}
SHAPES = {**{name: (8192, K, N) for name, (K, N) in K7_SHAPES.items()},
          "lm_head_1024": (1024, *K7_LM_HEAD),
          "lm_head_512": (512, *K7_LM_HEAD),
          "lm_head_256": (256, *K7_LM_HEAD)}
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
    shutil.copy(os.path.join(_build.CSRC, "hopper.cuh"), OUT)
    with open(os.path.join(_build.CSRC, "w8a16_dx.cu")) as f:
        source = f.read()
    libs = {"kernel": _build.load("w8a16_dx")}
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs.update(zip(CUTS, pool.map(lambda n: build(n, source), CUTS)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows_out, wave_rates = [], {}
    for shape, (M, K, N) in SHAPES.items():
        weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                       device="cuda", dtype=torch.int8),
                    "scale": torch.rand((1, N), generator=gen, device="cuda")
                    * 1e-3 + 1e-4} for _ in range(COPIES)]
        g = torch.randn((M, N), generator=gen, device="cuda")
        gs = quant._k7_scale(g, weights[0]["scale"], bf16)
        dx = torch.empty((M, K), dtype=bf16, device="cuda")
        plan_rows = quant._k7_plan(M, K, N)[0]
        flops = 2 * M * K * N

        def cycled(fn):
            layers = itertools.cycle(range(COPIES))
            return graph_time_ms(lambda: fn(weights[next(layers)]), n=COPIES)

        def product(lib, rows):
            m_tiles = -(-M // rows)

            def call(w):
                err = lib.mc_w8a16_dx_product(
                    gs.data_ptr(), w["q"].data_ptr(), dx.data_ptr(), M, K, N,
                    rows, min(quant._K7_GROUP, m_tiles), 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"w8a16_dx product: CUDA error {err}")
            return call
        row = {"shape": shape, "M": M, "K": K, "N": N, "card": card,
               "plan_rows": plan_rows}
        row["k7_ms"] = cycled(lambda w: quant.w8a16_dx(g, w, bf16))
        row["pass1_ms"] = cycled(lambda w: quant._k7_scale(g, w["scale"],
                                                           bf16))
        row["pass1_tb_per_s"] = (6 * M * N + 4 * N) / row["pass1_ms"] / 1e9
        row["pass2"] = {}
        for rows in quant._K7_RATES:
            ms = cycled(product(libs["kernel"], rows))
            waves = -(-(-(-M // rows) * -(-K // quant._K7_COLS)) // quant._SMS)
            wave = (2 * rows * quant._K7_COLS * N * quant._SMS
                    / (ms / waves) / 1e9)
            row["pass2"][rows] = {"ms": ms, "tflops": flops / ms / 1e9,
                                  "wave_tflops": wave, "waves": waves}
            wave_rates.setdefault(rows, []).append(wave)
        for name in CUTS:
            ms = {"kernel": [], name: []}
            for who in ("kernel", name, name, "kernel"):
                ms[who].append(cycled(product(libs[who], plan_rows)))
            row[name] = {"ms": ms, "tflops": {
                who: flops / min(t) / 1e9 for who, t in ms.items()}}
        rows_out.append(row)
        print(json.dumps(row), flush=True)
        del weights, g, gs, dx
        torch.cuda.empty_cache()
    median = {rows: statistics.median(v) for rows, v in wave_rates.items()}
    print(json.dumps({"median_wave_tflops": median}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k7_parts.json"), "w") as f:
        json.dump({"rows": rows_out, "median_wave_tflops": median}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
