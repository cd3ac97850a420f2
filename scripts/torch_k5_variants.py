#!/usr/bin/env python3
"""The choices of K5's streaming kernel (1-2 rows) against their
alternatives, on one CUDA card: each variant is a patched copy of
``csrc/w8a16_gemv.cu`` built into a scratch directory, and every variant
is timed in turns (forward, then backward order) by CUDA-graph replay over
32 weight copies (every launch cold in L2) at the main path's products and
groups, each at the streaming rule's split and the splits beside it.

    python3 scripts/torch_k5_variants.py [--out DIR]

(The split rule itself is swept by scripts/torch_kernel_ab.py --only K5.)

Variants (``base`` is this tree's kernel):
  batch16    16 row loads in flight a thread instead of 8;
  fence      every thread fences its partials and thread 0 bumps the
             counter with a plain atomicAdd (the first combine's way)
             instead of one release-acquire atom behind the barrier;
  ldcs       weights by ``__ldcs`` (ld.global.cs) instead of
             ``ld.global.nc.L1::no_allocate.L2::256B``;
  nocombine  each block writes its partial and ends (a probe: the result
             is wrong; the difference to ``base`` is the combine's cost);
  nox        x taken as 1.0, never read (a probe, as ``nocombine``).
Prints one JSON line per case and writes them to
``chiprun_out/k5_variants.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import K5_LAYERS, graph_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

COMBINE = '''  __syncthreads();
  if (tid == 0) {
    unsigned done;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\\n"
                 : "=r"(done)
                 : "l"(counters + t)
                 : "memory");
    sLast = done == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!sLast) return;'''
FENCED = '''  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd(&counters[t], 1u);
    sLast = done == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();'''
LOAD = '''  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));'''
VARIANTS = {
    "base": [],
    "batch16": [("constexpr int kSBatch = 8;", "constexpr int kSBatch = 16;")],
    "fence": [(COMBINE, FENCED)],
    "ldcs": [(LOAD, "  v = __ldcs(reinterpret_cast<const uint4*>(p));")],
    "nocombine": [(COMBINE, "  if (n_splits > 0) return;\n" + COMBINE)],
    "nox": [("xv[m] = __shfl_sync(0xffffffffu, xr, m * kSBatch + u);",
             "xv[m] = 1.f;"),
            ("float xr = x_of(0);", "float xr = 0.f;"),
            ("const float xn = x_of(b + 1);", "const float xn = 0.f;")],
}
# (name, K, [N, ...]) at 1 and 2 rows: the Vicuna-7B products a one-row
# step launches (q/k/v and gate/up grouped)
CASES = [("group qkv", 4096, [4096] * 3), ("qkvo", 4096, [4096]),
         ("group gate_up", 4096, [11008] * 2), ("down", 11008, [4096]),
         ("lm_head", 4096, [32000])]


def build(out_dir):
    """Every variant's library, built in parallel: {name: CDLL}."""
    src = (_build.CSRC / "w8a16_gemv.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer has "
                                   f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"k5_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"k5_{name}.so"))
        for fn, (argtypes, restype) in _build.SIGNATURES[
                "w8a16_gemv"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tmp_k5_variants"),
                    help="scratch directory for the variants' builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build(args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out = []
    for case, K, Ns in CASES:
        members = [[{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                        device="cuda", dtype=torch.int8),
                     "scale": torch.rand((1, N), generator=gen,
                                         device="cuda") * 1e-3 + 1e-4}
                    for _ in range(K5_LAYERS)] for N in Ns]
        tiles = sum(-(-N // 512) for N in Ns)
        n = len(Ns)
        for M in (1, 2):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            wants = [quant.dequant_matmul_reference(
                x, c[0], out_dtype=torch.float32) for c in members]
            outs = [torch.empty((M, N), device="cuda") for N in Ns]
            counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")
            rule_rows = quant._stream_plan(K, tiles)[0]
            splits_seen = set()
            for rows in sorted({rule_rows, rule_rows * 2,
                                max(quant._STREAM_STEP, rule_rows // 2)}):
                splits = -(-K // rows)
                if splits in splits_seen:
                    continue
                splits_seen.add(splits)
                part = torch.empty(tiles * splits * M * 512, device="cuda")

                def call(lib, i, rows=rows, part=part):
                    ptr = ctypes.c_void_p * n
                    err = lib.mc_w8a16_gemv(
                        x.data_ptr(), n,
                        ptr(*[c[i]["q"].data_ptr() for c in members]),
                        ptr(*[c[i]["scale"].data_ptr() for c in members]),
                        ptr(*[o.data_ptr() for o in outs]),
                        (ctypes.c_int * n)(*Ns), part.data_ptr(),
                        counters.data_ptr(), M, K, K, rows, 512, 1, 0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
                errs = {}
                for name, lib in libs.items():
                    call(lib, 0)
                    torch.cuda.synchronize()
                    errs[name] = max(float((o - w).abs().max()
                                           / w.abs().max())
                                     for o, w in zip(outs, wants))
                for name in ("base", "batch16", "fence", "ldcs"):
                    if errs[name] > 1e-5:
                        raise AssertionError(f"{name} {case} M{M}: rel err "
                                             f"{errs[name]:.3g}")
                times = {k: [] for k in libs}
                for name in list(libs) + list(libs)[::-1]:
                    it = itertools.cycle(range(K5_LAYERS))
                    lib = libs[name]
                    t = graph_time_ms(lambda: call(lib, next(it)),
                                      n=K5_LAYERS)
                    if t is None:
                        raise RuntimeError(f"{name}: not captured")
                    times[name].append(t)
                row = dict(case=case, M=M, K=K, N=Ns, rows=rows,
                           splits=splits, rule=rows == rule_rows,
                           us={k: [round(t * 1e3, 3) for t in v]
                               for k, v in times.items()}, card=card)
                print(json.dumps(row), flush=True)
                rows_out.append(row)
        del members
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k5_variants.json"),
              "w") as f:
        json.dump(rows_out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
