#!/usr/bin/env python3
"""K1-K5 of the PyTorch port against an earlier version of their sources,
on one CUDA card, in turns (old, new, new, old), plus K1's kv-tile probe
(64 against 128 rows), K2's split probe (256 against 128 positions per
block) and K3's kv-tile probe (128 against 64 rows), in turns.

    python3 scripts/torch_kernel_ab.py --old DIR [--only K5]

DIR is the root of a checkout of the earlier commit (``git archive``).  Its
kernels are called through its own wrappers (``ops/flash_attention.py``,
``ops/flash_decode.py``) and built by its own ``_build.py`` into DIR, so
nothing of it enters this tree and any earlier checkout whose wrappers take
the same arguments can be compared.  The probes build a copy of this tree's
source with the other tile or split length into DIR.  Shapes are the main
paths': K1 at the MCUB-4 prefill bucket (B=1, Lq=S=3,328, 3,287 valid, 32
heads, D=128, causal) and the vision bucket (B=2, 1,024, rows of 1,024 and
637); K2 over the int8 cache of the MCUB-4 decode (B=1, 32 layers, S=3,360,
kv_len 3,287) and the vision decode (B=2, S=1,056, kv_len 660/630), each
launch on the next of the 32 layers so that every read is cold in L2, and
once more on one warm layer; K3 (dQ) and K4 (dK, dV) at the smoke's `ms`
shape (B=2, L=2,048, rows of 2,048 and 1,391, 32 heads, D=128, causal),
the train step's batch (B=2, rows of 1,400 and 1,100) and its
micro-batches (B=1, one of those rows each), on K1's output and LSE.  K2
is timed three ways: CUDA events around the loop (the host's launch gaps
included), its kernels' device time from torch.profiler, and the host's
time to enqueue a call.  K5 (the int8 product, ``ops/quant.py``) runs at
every Vicuna-7B int8 shape and tp 2 / tp 4 shard (``chip_smoke.K5_SHAPES``,
``K5_TP_SHAPES``) at 1, 2, 3, 4 and 8 rows with an fp32 result, each
version timed by CUDA-graph replay over 32 weight copies (every launch
cold in L2), the plain convert + GEMM beside them, and the sums over one
32-layer decode step's 225 products.  Prints one JSON line per
measurement and writes them all to ``chiprun_out/kernel_ab.json``
(``--only`` runs a subset of K1,K2,K3,K4,K5; K3 and K4 run together).
At 2-8 rows K5 is also timed at each column tile of its tensor-core kernel
(64, 128, 256), the rule's split for each, beside the tile the rule picks.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (K5_LAYERS, K5_ROWS, K5_SHAPES,  # noqa: E402
                        K5_TP_SHAPES, cuda_time_cycle_ms,
                        device_time_cycle_ms, graph_time_ms)
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.core.llama import quantize_kv  # noqa: E402
from modelcompose_tpu_torch.ops import flash_attention as fa  # noqa: E402
from modelcompose_tpu_torch.ops import flash_decode as fd  # noqa: E402
from modelcompose_tpu_torch.ops import quant  # noqa: E402

K1_CASES = {"mcub4_3328": (1, 3328, 32, 128, [3287]),
            "vision_1024": (2, 1024, 32, 128, [1024, 637])}
K2_CASES = {"mcub4_3360": (1, 3328 + 32, [3287]),
            "vision_1056": (2, 1024 + 32, [660, 630])}
K34_CASES = {"ms_2048": (2, 2048, [2048, 1391]),
             "train_2048": (2, 2048, [1400, 1100]),
             "micro_1400": (1, 2048, [1400]),
             "micro_1100": (1, 2048, [1100])}
NL, H, D = 32, 32, 128


def old_wrappers(root):
    """The earlier checkout's wrapper modules (K1, K3 and K4; K2), imported
    as ``old_port.ops.*`` without running its package ``__init__`` (only
    the wrappers and their ``_build`` are loaded)."""
    pkg = os.path.join(root, "modelcompose_tpu_torch")
    for name, path in (("old_port", pkg),
                       ("old_port.ops", os.path.join(pkg, "ops"))):
        mod = types.ModuleType(name)
        mod.__path__ = [path]
        sys.modules[name] = mod
    return (importlib.import_module("old_port.ops.flash_attention"),
            importlib.import_module("old_port.ops.flash_decode"))


def old_quant(root):
    """The earlier checkout's ``ops/quant.py`` (K5's wrapper), imported as
    ``old_port.ops.quant`` beside the other old wrappers."""
    if "old_port.ops" not in sys.modules:
        old_wrappers(root)
    return importlib.import_module("old_port.ops.quant")


def variant(scratch, name, line, value):
    """``csrc/<name>.cu`` of this tree with ``line`` set to ``value``,
    built into ``scratch`` and loaded with the port's signatures."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    if line not in src:
        raise RuntimeError(f"{name}.cu no longer defines {line!r}")
    new_line = line.rsplit("=", 1)[0] + f"= {value};"
    path = os.path.join(scratch, f"{name}_{value}.cu")
    with open(path, "w") as f:
        f.write(src.replace(line, new_line))
    out = path[:-3] + ".so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", out, path], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    for fn, (argtypes, restype) in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _host_us(fn, n, calls=320):
    """Host microseconds to enqueue one fn(i) call (no synchronization
    inside the loop; the card runs behind)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(calls):
        fn(c % n)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _stream():
    return torch.cuda.current_stream().cuda_stream


def lib_k1(lib, q, k, v, seg):
    """K1 from ``lib`` (this tree's C interface), causal, one segment."""
    B, L, H_, D_ = q.shape
    out, lse = torch.empty_like(q), torch.empty((B, H_, L), device="cuda")

    def call(_):
        err = lib.mc_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H_, H_, L, L,
            D_, D_ ** -0.5, 1, 0, _stream())
        if err:
            raise RuntimeError(f"K1 variant: CUDA error {err}")
        return out, lse
    return call


def lib_k2(lib, q, k, v, kv):
    """K2 from ``lib`` (this tree's C interface) with its own scratch."""
    kq = k["q"]
    NL_, B, S = kq.shape[:3]
    n_splits = -(-S // lib.mc_flash_decode_split_len())
    pm = torch.empty((B, H, n_splits), device="cuda")
    pl = torch.empty_like(pm)
    pa = torch.empty((B, H, n_splits, D), device="cuda")
    cnt = torch.zeros(B * H, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)

    def call(i):
        err = lib.mc_flash_decode(
            q.data_ptr(), kq.data_ptr(), v["q"].data_ptr(),
            k["scale"].data_ptr(), v["scale"].data_ptr(), kv.data_ptr(),
            pm.data_ptr(), pl.data_ptr(), pa.data_ptr(), cnt.data_ptr(),
            out.data_ptr(), NL_, B, H, H, S, D, i, 1, D ** -0.5, _stream())
        if err:
            raise RuntimeError(f"K2 variant: CUDA error {err}")
        return out
    return call


def lib_k3(lib, q, k, v, do, lse, di, seg):
    """K3 from ``lib`` (this tree's C interface), causal, one segment."""
    B, L, H_, D_ = q.shape
    dq = torch.empty_like(q)

    def call(_):
        err = lib.mc_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), seg.data_ptr(), seg.data_ptr(),
            dq.data_ptr(), B, H_, H_, L, L, D_, D_ ** -0.5, 1, 0, _stream())
        if err:
            raise RuntimeError(f"K3 variant: CUDA error {err}")
        return dq
    return call


def ab_k34(old_fa, bn_probe, gen, emit):
    """K3 and K4, old against new in turns, and K3's kv-tile probe."""
    for name, (B, L, lengths) in K34_CASES.items():
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()
        q, k, v = rnd(B, L, H, D), rnd(B, L, H, D), rnd(B, L, H, D)
        seg = (torch.arange(L, device="cuda")[None]
               < torch.tensor(lengths, device="cuda")[:, None]).int()
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        do = (rnd(B, L, H, D) * (seg != 0)[..., None, None]).contiguous()
        di = fa._di(out, do)
        args = (q, k, v, do, lse, di)
        valid = seg != 0
        k3 = {"old": lambda _: old_fa.flash_attention_bwd_dq(*args, **kw),
              "new": lambda _: fa.flash_attention_bwd_dq(*args, **kw),
              "bn_probe": lib_k3(bn_probe, *args, seg)}
        k4 = {"old": lambda _: old_fa.flash_attention_bwd_dkv(*args, **kw),
              "new": lambda _: fa.flash_attention_bwd_dkv(*args, **kw)}
        new3, new4 = k3["new"](0), k4["new"](0)
        for kernel, versions, others in (("K3", k3, ("old", "bn_probe")),
                                         ("K4", k4, ("old",))):
            for a in others:
                got = versions[a](0)
                pairs = [(got, new3)] if kernel == "K3" else zip(got, new4)
                diff = max(float((g[valid].float() - w[valid].float())
                                 .abs().max()) for g, w in pairs)
                times = {a: [], "new": []}
                for who in (a, "new", "new", a):
                    times[who].append(cuda_time_cycle_ms(versions[who], 1, 20))
                emit(kernel=kernel, case=name, compare=f"{a} vs new",
                     ms=times, max_abs_diff_from_new=diff)


# K5 launches in one decode step of the 32-layer model: 32 x (4 q/k/v/o, 2
# gate/up, 1 down) + the lm_head.
K5_PER_STEP = {"qkvo": 4 * 32, "gate_up": 2 * 32, "down": 32, "lm_head": 1}


def k5_tiles(x, weights, want):
    """{tile: ms} of the tensor-core kernel at each of its column tiles with
    the rule's split for that tile (``quant._mma_plan``), each by CUDA-graph
    replay over the weight copies: how far the rule's choice is from the
    fastest tile.  Raises if a tile's result leaves the plain one."""
    import itertools
    lib = _build.load("w8a16_gemv")
    M, K = x.shape
    N = weights[0]["q"].shape[1]
    out = torch.empty((M, N), device="cuda")
    res = {}
    for tile in quant._TILE_RATES:
        _, rows, splits, tiles = quant._mma_plan(M, K, N, tile)
        part = torch.empty(splits * M * N, device="cuda")
        counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")

        def call(w, tile=tile, rows=rows, part=part, counters=counters):
            err = lib.mc_w8a16_gemv(
                x.data_ptr(), w["q"].data_ptr(), w["scale"].data_ptr(),
                part.data_ptr(), counters.data_ptr(), out.data_ptr(), M, K, N,
                x.stride(0), rows, tile, 1, 0, _stream())
            if err:
                raise RuntimeError(f"K5 tile {tile}: CUDA error {err}")
        call(weights[0])
        rel = float((out - want.reshape(M, N)).abs().max()
                    / want.abs().max())
        if rel > 1e-5:
            raise AssertionError(f"K5 tile {tile}: rel err {rel:.3g}")
        layers = itertools.cycle(range(len(weights)))
        res[tile] = graph_time_ms(lambda: call(weights[next(layers)]),
                                  n=len(weights))
    return res


def ab_k5(old_q, gen, emit):
    """K5, old against new in turns (old, new, new, old) by CUDA-graph
    replay cycling over 32 weight copies, with the plain product timed
    the same way before and after; fp32 results, as the decode path asks.
    Then the step sums of each version at every row count."""
    import itertools
    means = {}
    for name, (K, N) in {**K5_SHAPES, **K5_TP_SHAPES}.items():
        weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                       device="cuda", dtype=torch.int8),
                    "scale": torch.rand((1, N), generator=gen,
                                        device="cuda") * 1e-3 + 1e-4}
                   for _ in range(K5_LAYERS)]
        for M in K5_ROWS:
            x = torch.randn((M, 1, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            f32 = torch.float32
            versions = {
                "old": lambda w: old_q.dequant_matmul(x, w, out_dtype=f32),
                "new": lambda w: quant.dequant_matmul(x, w, out_dtype=f32),
                "plain": lambda w: quant.dequant_matmul_reference(
                    x, w, out_dtype=f32)}
            want = versions["plain"](weights[0])
            diffs = {who: float((versions[who](weights[0]) - want).abs().max()
                                / want.abs().max())
                     for who in ("old", "new")}
            times = {"old": [], "new": [], "plain": []}
            for who in ("plain", "old", "new", "new", "old", "plain"):
                layers = itertools.cycle(range(K5_LAYERS))
                times[who].append(graph_time_ms(
                    lambda: versions[who](weights[next(layers)]),
                    n=K5_LAYERS, records=(old_q.capturing,)))
            means[name, M] = {k: sum(v) / len(v) for k, v in times.items()}
            emit(kernel="K5", case=name, M=M, K=K, N=N,
                 compare="old vs new", ms=times,
                 grid=dict(zip(("tile", "rows", "splits", "tiles"),
                               quant._k5_plan(M, K, N))),
                 rel_err_vs_plain=diffs)
            if M > 1:
                emit(kernel="K5", case=name, M=M, K=K, N=N,
                     compare="tensor-core tiles",
                     ms=k5_tiles(x.reshape(M, K), weights, want))
        del weights
        torch.cuda.empty_cache()
    for M in K5_ROWS:
        emit(kernel="K5", case="decode step (225 products, 32 layers)", M=M,
             compare="old vs new", ms_sum={
                 who: sum(n * means[s, M][who]
                          for s, n in K5_PER_STEP.items())
                 for who in ("old", "new", "plain")})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="root of a checkout of the earlier sources")
    ap.add_argument("--only", default="K1,K2,K3,K4,K5",
                    help="comma-separated kernels to compare")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    old_fa, old_fd = old_wrappers(args.old)
    device_time_cycle_ms(lambda _: torch.ones(1, device="cuda").sum(), 1, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def emit(**row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "K5" in only:
        ab_k5(old_quant(args.old), gen, emit)

    if "K1" in only:
        bn64 = variant(args.old, "flash_attention_fwd",
                       "constexpr int kBlockN = 128;", 64)
        for name, (B, L, H_, D_, lengths) in K1_CASES.items():
            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").bfloat16()
            q, k, v = rnd(B, L, H_, D_), rnd(B, L, H_, D_), rnd(B, L, H_, D_)
            seg = (torch.arange(L, device="cuda")[None]
                   < torch.tensor(lengths, device="cuda")[:, None]).int()
            kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
            valid = seg != 0
            versions = {
                "old": lambda _: old_fa.flash_attention_forward(q, k, v,
                                                                **kw),
                "new": lambda _: fa.flash_attention_forward(q, k, v, **kw),
                "bn64": lib_k1(bn64, q, k, v, seg)}
            new_out = versions["new"](0)[0]
            diffs = {who: float((versions[who](0)[0][valid].float()
                                 - new_out[valid].float()).abs().max())
                     for who in ("old", "bn64")}
            for a in ("old", "bn64"):
                times = {a: [], "new": []}
                for who in (a, "new", "new", a):
                    times[who].append(cuda_time_cycle_ms(versions[who], 1,
                                                         20))
                emit(kernel="K1", case=name, compare=f"{a} vs new", ms=times,
                     max_abs_diff_from_new=diffs[a])

    if "K2" in only:
        split256 = variant(args.old, "flash_decode",
                           "constexpr int kSplit = 128;", 256)
        for name, (B, S, kv_len) in K2_CASES.items():
            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").bfloat16()
            q = rnd(B, 1, H, D)
            k = quantize_kv(rnd(NL, B, S, H, D))
            v = quantize_kv(rnd(NL, B, S, H, D))
            kv = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            scale = D ** -0.5
            versions = {
                "old": lambda i: old_fd.flash_decode_attention(
                    q, k, v, kv, i, sm_scale=scale),
                "new": lambda i: fd.flash_decode_attention(q, k, v, kv, i,
                                                           sm_scale=scale),
                "old_warm": lambda _: old_fd.flash_decode_attention(
                    q, k, v, kv, NL - 1, sm_scale=scale),
                "new_warm": lambda _: fd.flash_decode_attention(
                    q, k, v, kv, NL - 1, sm_scale=scale),
                "split256": lib_k2(split256, q, k, v, kv)}
            new_out = versions["new"](5).float()
            diffs = {who: float((versions[who](5).float() - new_out)
                                .abs().max())
                     for who in ("old", "split256")}
            for a, b, n in (("old", "new", NL), ("old_warm", "new_warm", 50),
                            ("split256", "new", NL)):
                times = {a: [], b: []}
                device = {a: [], b: []}
                host = {a: [], b: []}
                for who in (a, b, b, a):
                    times[who].append(cuda_time_cycle_ms(versions[who], n,
                                                         3 if n == NL else 1))
                    device[who].append(device_time_cycle_ms(versions[who],
                                                             n, 2))
                    host[who].append(_host_us(versions[who], n))
                emit(kernel="K2", case=name, compare=f"{a} vs {b}",
                     cold=n == NL, ms_events=times, ms_device=device,
                     host_us_per_call=host,
                     max_abs_diff_from_new=diffs[a.split("_")[0]])
            del k, v

    if "K3" in only or "K4" in only:
        bn128 = variant(args.old, "flash_attention_bwd",
                        "constexpr int kBlockN = 64;", 128)
        ab_k34(old_fa, bn128, gen, emit)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
