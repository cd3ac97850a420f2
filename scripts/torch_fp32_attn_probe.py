#!/usr/bin/env python3
"""Where K1's and K4's fp32 kernels spend their time, on one CUDA card.

Copies of ``csrc/flash_attention_fwd.cu`` / ``flash_attention_bwd.cu``
with one part of the work removed are built into a gitignored folder and
timed beside the unchanged source by CUDA-graph replay, two rounds in
turns, through the C entry (their outputs are wrong by design; only the
time is read):

    python3 scripts/torch_fp32_attn_probe.py [--out tmp_attn_probe]

K1 (the MCUB-4 prefill bucket, B=1, 3,328 positions, 3,287 valid, 32
heads, D=128, causal): ``noconvert`` (the converter warps split and
transpose nothing), ``nopv`` (no P.V), ``1xtf32`` (the two cross-term
products of each step dropped, scores and P.V). K4 (the smoke's ``ms``
shape, B=2, 2,048, rows of 2,048 and 1,391): ``noconvert``, ``noaccum``
(no dV and dK products). Prints one JSON line per kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_time_ms  # noqa: E402
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.ops import flash_attention as fa  # noqa: E402

K1_CUTS = {
    "noconvert": ['''        tf32x3::split_tile<BN, D>(st + L::kK, st + L::kKlo, ct, kConverters);
        tf32x3::transpose_split_tile<D>(st + L::kV, st + L::kVhi,
                                        st + L::kVlo, ct, kConverters);'''],
    "nopv": ['''      for (int c = 0; c < D / 32; ++c) {
        float big[16], small[16];'''],
    "1xtf32": ['''        tf32x3::wgmma_rs32(sx, qlo[kk], dk, kk > 0);
        tf32x3::wgmma_ss32(sx, dq, sw128_desc(st + L::kKlo + step, 16, 1024),
                           1);''',
               '''          tf32x3::wgmma_rs32(small, pl[kk], vh, kk > 0);
          tf32x3::wgmma_rs32(small, ph[kk],
                             sw128_desc(st + L::kVlo + off, 16, 1024), 1);'''],
}
# what each cut puts in place of its text ("" removes it)
K1_WITH = {"nopv": ['''      for (int c = 0; c < 0; ++c) {
        float big[16], small[16];''']}
K4_CUTS = {
    "noconvert": ['''          tf32x3::split_tile<BQ, D>(st + L::kQ, st + L::kQlo, ct,
                                    kConvertersF32);
          tf32x3::split_tile<BQ, D>(st + L::kDO, st + L::kDOlo, ct,
                                    kConvertersF32);'''],
    "noaccum": [
        "        accumulate(st + L::kQ, st + L::kQlo, xs + L::kShi, xs + L::kSlo);",
        "        accumulate(st + L::kDO, st + L::kDOlo, xs + L::kPhi, xs + L::kPlo);"],
}


def build(out, name, tag, cuts, withs):
    """``csrc/<name>.cu`` with each text of ``cuts`` replaced (by the
    matching text of ``withs``, or removed), built into ``out``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for i, text in enumerate(cuts):
        if text not in src:
            raise RuntimeError(f"{name}.cu no longer holds the {tag} cut")
        src = src.replace(text, withs[i] if withs else "")
    path = os.path.join(out, f"{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _seg(L, lengths):
    return (torch.arange(L, device="cuda")[None]
            < torch.tensor(lengths, device="cuda")[:, None]).int()


def _rounds(calls):
    for c in calls.values():
        c()
    torch.cuda.synchronize()
    times = {t: [] for t in calls}
    for _ in range(2):
        for t, c in calls.items():
            times[t].append(graph_time_ms(c))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tmp_attn_probe"),
                    help="gitignored folder for the built copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)

    B, L, H, D = 1, 3328, 32, 128
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda")
               for _ in range(3))
    seg = _seg(L, [3287])
    out, lse = torch.empty_like(q), torch.empty((B, H, L), device="cuda")
    libs = {"base": build(args.out, "flash_attention_fwd", "base", [], [])}
    for tag, cuts in K1_CUTS.items():
        libs[tag] = build(args.out, "flash_attention_fwd", tag, cuts,
                          K1_WITH.get(tag))

    def k1(lib):
        def call():
            err = lib.mc_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                seg.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, H, L,
                L, D, D ** -0.5, 1, 0, 2, stream())
            if err:
                raise RuntimeError(f"K1 copy: CUDA error {err}")
        return call
    print(json.dumps({"kernel": "K1 fp32", "case": "mcub4_3328",
                      "ms_graph": _rounds({t: k1(lb)
                                           for t, lb in libs.items()}),
                      "card": card}), flush=True)

    B, L = 2, 2048
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                   for _ in range(4))
    seg = _seg(L, [2048, 1391])
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = fa.flash_attention_forward(q, k, v, **kw)
    di = fa._di(out, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    libs = {"base": build(args.out, "flash_attention_bwd", "base", [], [])}
    for tag, cuts in K4_CUTS.items():
        libs[tag] = build(args.out, "flash_attention_bwd", tag, cuts, None)

    def k4(lib):
        def call():
            err = lib.mc_flash_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), seg.data_ptr(),
                seg.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, H, L, L,
                D, D ** -0.5, 1, 0, 2, stream())
            if err:
                raise RuntimeError(f"K4 copy: CUDA error {err}")
        return call
    print(json.dumps({"kernel": "K4 fp32", "case": "ms_2048",
                      "ms_graph": _rounds({t: k4(lb)
                                           for t, lb in libs.items()}),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
