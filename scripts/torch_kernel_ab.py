#!/usr/bin/env python3
"""K1-K7 of the PyTorch port against an earlier version of their
sources, on one CUDA card, in turns (old, new, new, old), plus K1's kv-tile
probe (64 against 128 rows), K2's split probe (256 against 128 positions
per block) and K3's kv-tile probe (128 against 64 rows), in turns; K6 and
K7 also against the library GEMM, K7 against its plain route.

    python3 scripts/torch_kernel_ab.py --old DIR [--only K5]
    python3 scripts/torch_kernel_ab.py [--old DIR] --only K7,K6

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
(64, 128, 256), the rule's split for each, beside the tile the rule picks;
at 1-2 rows at each split of its streaming kernel; the products of one
input (q/k/v, gate/up and their shards) grouped in one launch against one
by one at 1-2 rows.  Before that, the fixed cost of the first one-row
kernel's launch is taken apart by ``scripts/k5_fixed_cost.cu`` (a copy of
that kernel with x staging and the split combine switched off, and an
empty kernel), on the earlier checkout's one-row grid
(``ops/quant._row_plan``, which a checkout before the streaming kernel
has; a later checkout skips this part).  K7 (the int8 products' dL/dx,
``ops/quant.w8a16_dx``) runs at phase 4d's shapes
(``chip_smoke.K7_SHAPES`` at ``K7_ROWS``, the lm_head at
``K7_LM_HEAD_ROWS``) for an fp32 cotangent, against the plain route
(``_dequant_matmul_dx``), ``torch.mm`` on bf16 copies of the scaled
cotangent and of q^T made beforehand and, given ``--old``, the earlier
checkout's K7 through its own wrapper, in turns (plain, old, K7, mm, mm,
K7, old, plain), each by CUDA-graph replay over 4 weight copies, with the
bound; without ``--old`` K7 needs no earlier checkout.  K6 (``--only
K6``) runs a layer's products (q/k/v/o, gate/up, down) at 512, 2,048,
3,328 and 8,192 rows and the tp 2 / tp 4 shards at 3,328 (fp32 out)
against ``torch.mm`` on bf16 copies of the weights made beforehand and,
given ``--old``, the earlier checkout's K6 through its own wrapper, in
turns (old, new, mm, mm, new, old), each by CUDA-graph replay over 4
weight copies, with the new schedule, the bound and the sums over a
layer's seven.

    git archive df22bc8 modelcompose_tpu_torch | tar -x -C tmp_old
    python3 scripts/torch_kernel_ab.py --old tmp_old --only K6

``--only K1F32`` and ``--only K4F32`` time K1's and K4's fp32 kernels
against the earlier checkout's (built from its own sources into DIR) and
one ``scaled_dot_product_attention`` call on the same fp32 operands (the
memory-efficient backend PyTorch picks at fp32; for K4 its backward, dQ,
dK and dV together), in turns, by CUDA-graph replay: K1 at the MCUB-4
bucket, K4 at the smoke's `ms` shape and the train step's batch.

    git archive 828894d modelcompose_tpu_torch | tar -x -C tmp_old
    python3 scripts/torch_kernel_ab.py --old tmp_old --only K1F32,K4F32
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

from chip_smoke import (K5_GROUPS, K5_LAYERS, K5_ROWS,  # noqa: E402
                        K5_SHAPES, K5_TP_SHAPES, K6_COPIES, K6_LAYER,
                        K6_SHAPES, K7_COPIES, K7_LM_HEAD, K7_LM_HEAD_ROWS,
                        K7_ROWS, K7_SHAPES, bound, cuda_time_ms,
                        cuda_time_cycle_ms, device_time_cycle_ms,
                        graph_time_ms)
from modelcompose_tpu_torch import _build  # noqa: E402
from modelcompose_tpu_torch.core.llama import quantize_kv  # noqa: E402
from modelcompose_tpu_torch.ops import _route  # noqa: E402
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
            D_, D_ ** -0.5, 1, 0, _route.dtype_code(q), _stream())
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
            out.data_ptr(), NL_, B, H, H, S, D, i, 1, _route.dtype_code(q),
            D ** -0.5, _stream())
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
            dq.data_ptr(), B, H_, H_, L, L, D_, D_ ** -0.5, 1, 0,
            _route.dtype_code(q), _stream())
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


def _seg(L, lengths):
    return (torch.arange(L, device="cuda")[None]
            < torch.tensor(lengths, device="cuda")[:, None]).int()


def _turns(versions, order, records):
    """{version: [ms, ms]} by CUDA-graph replay in turns: ``order``, then
    the same backwards (each run once eagerly first); a version that a
    graph cannot capture (SDPA's backward with a boolean mask, at some
    shapes) is timed by CUDA events over 10 calls instead, and named in
    ``events``."""
    for who in order:
        versions[who]()
    torch.cuda.synchronize()
    times = {who: [] for who in order}
    events = []
    for who in (*order, *reversed(order)):
        ms = graph_time_ms(versions[who], records=records.get(who, ()))
        if ms is None:
            ms = cuda_time_ms(versions[who])
            events.append(who)
        times[who].append(ms)
    return dict(times, events=sorted(set(events)))


def ab_f32(old_fa, gen, emit, only):
    """K1's (``K1F32``) and K4's (``K4F32``) fp32 kernels against the
    earlier checkout's through its own wrappers, and one
    ``scaled_dot_product_attention`` call on the same fp32 operands (its
    forward, or its backward through autograd: dQ, dK and dV together),
    in turns (old, new, sdpa, sdpa, new, old), each by CUDA-graph replay,
    with the bound (3 TF32 products for each fp32 one at 494.7 TFLOP/s)
    and each version's error against the plain version."""
    import torch.nn.functional as F
    from chip_smoke import _sdpa_inputs, _valid_pairs, attention_bound
    records = {"old": (old_fa.capturing,)}
    if "K1F32" in only:
        B, L, H_, D_, lengths = K1_CASES["mcub4_3328"]
        q, k, v = (torch.randn((B, L, H_, D_), generator=gen, device="cuda")
                   for _ in range(3))
        seg = _seg(L, lengths)
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        valid = seg != 0
        args, extra = _sdpa_inputs(q, k, v, dict(kw, q_offset=0), lengths)
        versions = {
            "old": lambda: old_fa.flash_attention_forward(q, k, v, **kw),
            "new": lambda: fa.flash_attention_forward(q, k, v, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(*args, **extra)}
        ref = fa.flash_attention_reference(q, k, v, **kw)[0][valid]
        errs = {who: float((versions[who]()[0][valid] - ref).abs().max()
                           / ref.abs().max()) for who in ("old", "new")}
        n = int(valid.sum())
        nbytes = 4 * D_ * H_ * (2 * n + 2 * L) + 4 * B * H_ * L + 8 * B * L
        bound_ms, bound_by = attention_bound(
            4 * D_ * H_ * _valid_pairs(dict(kw, q_offset=0), L, L), nbytes,
            torch.float32)
        times = _turns(versions, ("old", "new", "sdpa"), records)
        emit(kernel="K1 fp32", case="mcub4_3328", ms_graph=times,
             bound_ms=bound_ms, bound_by=bound_by, rel_err_vs_plain=errs)
    if "K4F32" in only:
        for name in ("ms_2048", "train_2048"):
            B, L, lengths = K34_CASES[name]
            q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                                       device="cuda") for _ in range(4))
            seg = _seg(L, lengths)
            kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
            do = (do * (seg != 0)[..., None, None]).contiguous()
            di = fa._di(out, do)
            bwd = (q, k, v, do, lse, di)
            sargs, extra = _sdpa_inputs(q, k, v, dict(kw, q_offset=0),
                                        lengths, grad=True)
            sout = F.scaled_dot_product_attention(*sargs, **extra)
            g = do[:, :sargs[0].shape[2]].transpose(1, 2)

            def sdpa_bwd():
                for t in sargs:
                    t.grad = None
                sout.backward(g, retain_graph=True)
            versions = {
                "old": lambda: old_fa.flash_attention_bwd_dkv(*bwd, **kw),
                "new": lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                "sdpa": sdpa_bwd}
            ref = fa.flash_attention_backward_reference(q, k, v, out, lse,
                                                        do, **kw)
            kv_valid = seg != 0
            errs = {}
            for who in ("old", "new"):
                dk, dv = versions[who]()
                errs[who] = max(
                    float((g_[kv_valid] - w[kv_valid]).abs().max()
                          / w[kv_valid].abs().max())
                    for g_, w in ((dk, ref[1]), (dv, ref[2])))
            n = int(kv_valid.sum())
            nbytes = 4 * D * H * 4 * n + 8 * H * n + 4 * 2 * k.numel()
            bound_ms, bound_by = attention_bound(
                8 * D * H * _valid_pairs(dict(kw, q_offset=0), L, L), nbytes,
                torch.float32)
            times = _turns(versions, ("old", "new", "sdpa"), records)
            emit(kernel="K4 fp32", case=name, ms_graph=times,
                 sdpa="backward, dQ dK dV together", bound_ms=bound_ms,
                 bound_by=bound_by, rel_err_vs_plain=errs)


# K5 launches in one decode step of the 32-layer model: 32 x (4 q/k/v/o, 2
# gate/up, 1 down) + the lm_head (225); at 1-2 rows q/k/v and gate/up are one
# launch each: 32 x 4 + 1 (129).
K5_PER_STEP = {"qkvo": 4 * 32, "gate_up": 2 * 32, "down": 32, "lm_head": 1}
K5_GROUPED_STEP = {"group qkv": 32, "qkvo": 32, "group gate_up": 32,
                   "down": 32, "lm_head": 1}
K5_SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16, 22, 32, 44, 64)


def _k5_weights(gen, K, N):
    return [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                device="cuda", dtype=torch.int8),
             "scale": torch.rand((1, N), generator=gen, device="cuda") * 1e-3
             + 1e-4} for _ in range(K5_LAYERS)]


def _cycled(fn, n, records=()):
    """ms of one fn(i) by CUDA-graph replay over i = 0..n-1 (each call on
    the next weight copy: cold in L2)."""
    import itertools
    layers = itertools.cycle(range(n))
    return graph_time_ms(lambda: fn(next(layers)), n=n, records=records)


def _lib_call(lib, x, members, outs, part, counters, rows, tile):
    """One launch of this tree's K5 entry on ``members`` (weight dicts)."""
    M, K = x.shape
    n = len(members)

    def pointers(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
    err = lib.mc_w8a16_gemv(
        x.data_ptr(), n, pointers([w["q"] for w in members]),
        pointers([w["scale"] for w in members]), pointers(outs),
        (ctypes.c_int * n)(*[w["q"].shape[1] for w in members]),
        part.data_ptr(), counters.data_ptr(), M, K, x.stride(0), rows, tile,
        1, 0, _stream())
    if err:
        raise RuntimeError(f"K5 tile {tile} rows {rows}: CUDA error {err}")


def k5_tiles(x, weights, want):
    """{tile: ms} of the tensor-core kernel at each of its column tiles with
    the rule's split for that tile (``quant._mma_plan``), each by CUDA-graph
    replay over the weight copies: how far the rule's choice is from the
    fastest tile.  Raises if a tile's result leaves the plain one."""
    lib = _build.load("w8a16_gemv")
    M, K = x.shape
    N = weights[0]["q"].shape[1]
    out = torch.empty((M, N), device="cuda")
    res = {}
    for tile in quant._TILE_RATES:
        _, rows, splits, tiles = quant._mma_plan(M, K, N, tile)
        part = torch.empty(splits * M * N, device="cuda")
        counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")

        def call(i, tile=tile, rows=rows, part=part, counters=counters):
            _lib_call(lib, x, [weights[i]], [out], part, counters, rows, tile)
        call(0)
        rel = float((out - want.reshape(M, N)).abs().max()
                    / want.abs().max())
        if rel > 1e-5:
            raise AssertionError(f"K5 tile {tile}: rel err {rel:.3g}")
        res[tile] = _cycled(call, len(weights))
    return res


def k5_splits(x, members, wants):
    """{splits: ms} of the streaming kernel over ``members`` (one weight, or
    a group; a list of weight copies each) at every split count of
    K5_SPLITS that gives another grid of at most four blocks an SM, by
    CUDA-graph replay over the copies: the measurements the streaming
    rule (``quant._stream_plan``) was fitted to.  Raises if a result
    leaves the plain one."""
    lib = _build.load("w8a16_gemv")
    M, K = x.shape
    Ns = [copies[0]["q"].shape[1] for copies in members]
    tiles = sum(-(-N // 512) for N in Ns)
    steps = -(-K // quant._STREAM_STEP)
    outs = [torch.empty((M, N), device="cuda") for N in Ns]
    counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")
    res, seen = {}, set()
    for s in K5_SPLITS:
        rows = -(-steps // s) * quant._STREAM_STEP
        splits = -(-K // rows)
        if splits in seen or tiles * splits > 4 * quant._SMS:
            continue
        seen.add(splits)
        part = torch.empty(max(1, tiles * splits * M * 512), device="cuda")

        def call(i, rows=rows, part=part):
            _lib_call(lib, x, [copies[i] for copies in members], outs, part,
                      counters, rows, 512)
        call(0)
        for out, want in zip(outs, wants):
            rel = float((out - want.reshape(out.shape)).abs().max()
                        / want.abs().max())
            if rel > 1e-5:
                raise AssertionError(f"K5 {splits} splits: rel err {rel:.3g}")
        res[splits] = _cycled(call, K5_LAYERS)
    return res


def k5_fixed_cost(old_q, scratch, gen, emit):
    """The fixed cost of the first one-row kernel's launch taken apart
    (``scripts/k5_fixed_cost.cu``, built into ``scratch``): at q/k/v/o,
    gate/up, down and the lm_head, on that kernel's grid, the kernel as it
    was, without x staging, without the split combine, without both, and
    an empty kernel; and an empty kernel on this tree's one-row grid beside
    this tree's kernel.  Each by CUDA-graph replay over 32 cold weights,
    the probes in turns (0-4, then 4-0)."""
    src = os.path.join(ROOT, "scripts", "k5_fixed_cost.cu")
    out = os.path.join(scratch, "k5_fixed_cost.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k5_probe.argtypes = [I, P, P, P, P, P, P, I, I, I, P]
    lib.k5_probe.restype = I
    names = ("as_was", "no_x_staging", "no_combine", "neither", "empty")
    for case in ("qkvo", "gate_up", "down", "lm_head"):
        K, N = K5_SHAPES[case]
        weights = _k5_weights(gen, K, N)
        x = torch.randn((1, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        old_rows, old_splits, old_tiles = old_q._row_plan(K, N)
        part = torch.empty(old_splits * N, device="cuda")
        counters = torch.zeros(old_tiles, dtype=torch.int32, device="cuda")
        out_ = torch.empty(N, device="cuda")

        def probe(kind, rows=old_rows):
            def call(i):
                w = weights[i]
                err = lib.k5_probe(kind, x.data_ptr(), w["q"].data_ptr(),
                                   w["scale"].data_ptr(), part.data_ptr(),
                                   counters.data_ptr(), out_.data_ptr(), K, N,
                                   rows, _stream())
                if err:
                    raise RuntimeError(f"probe {kind}: CUDA error {err}")
            return call
        probe(0)(0)
        want = quant.dequant_matmul_reference(x, weights[0],
                                              out_dtype=torch.float32)
        rel = float((out_ - want[0]).abs().max() / want.abs().max())
        if rel > 1e-5:
            raise AssertionError(f"K5 probe 0 {case}: rel err {rel:.3g}")
        ms = {k: [] for k in names}
        for kind in (0, 1, 2, 3, 4, 4, 3, 2, 1, 0):
            ms[names[kind]].append(_cycled(probe(kind), K5_LAYERS))
        _, rows, splits, tiles = quant._k5_plan(1, K, N)
        new = {"kernel": [], "empty": []}
        for who in ("kernel", "empty", "empty", "kernel"):
            new[who].append(_cycled(
                (lambda i: quant.dequant_matmul(x, weights[i],
                                                out_dtype=torch.float32))
                if who == "kernel" else probe(4, rows), K5_LAYERS))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        emit(kernel="K5", case=case, M=1, K=K, N=N,
             compare="fixed cost of the first one-row launch",
             grid={"rows": old_rows, "splits": old_splits,
                   "tiles": old_tiles}, ms=ms,
             parts_ms={"empty_launch": mean["empty"],
                       "x_staging": mean["as_was"] - mean["no_x_staging"],
                       "combine": mean["as_was"] - mean["no_combine"],
                       "stream_and_sums": mean["neither"] - mean["empty"]},
             fixed_ms_at_2_98_tb_s=mean["as_was"] - K * N / 2.98e9,
             new={"grid": {"rows": rows, "splits": splits, "tiles": tiles},
                  "ms": new})
        del weights
        torch.cuda.empty_cache()


def ab_k5(old_q, gen, emit):
    """K5, old against new in turns (old, new, new, old) by CUDA-graph
    replay cycling over 32 weight copies, with the plain product timed
    the same way before and after; fp32 results, as the decode path asks.
    At 2-8 rows each tensor-core tile, at 1-2 rows each streaming split.
    Then the groups (q/k/v, gate/up and their shards) at 1-2 rows: the
    grouped launch against the members launched one by one (old and new)
    and each streaming split; and the step sums of each version at every
    row count (the new one's at 1-2 rows with q/k/v and gate/up grouped:
    129 launches, beside its 225 products one by one)."""
    means = {}
    for name, (K, N) in {**K5_SHAPES, **K5_TP_SHAPES}.items():
        weights = _k5_weights(gen, K, N)
        for M in K5_ROWS:
            x = torch.randn((M, 1, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            f32 = torch.float32
            versions = {
                "old": lambda i: old_q.dequant_matmul(x, weights[i],
                                                      out_dtype=f32),
                "new": lambda i: quant.dequant_matmul(x, weights[i],
                                                      out_dtype=f32),
                "plain": lambda i: quant.dequant_matmul_reference(
                    x, weights[i], out_dtype=f32)}
            want = versions["plain"](0)
            diffs = {who: float((versions[who](0) - want).abs().max()
                                / want.abs().max())
                     for who in ("old", "new")}
            times = {"old": [], "new": [], "plain": []}
            for who in ("plain", "old", "new", "new", "old", "plain"):
                times[who].append(_cycled(versions[who], K5_LAYERS,
                                          (old_q.capturing,)))
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
            if M <= 2:
                emit(kernel="K5", case=name, M=M, K=K, N=N,
                     compare="streaming splits",
                     ms=k5_splits(x.reshape(M, K), [weights], [want]))
        del weights
        torch.cuda.empty_cache()
    for name, (K, Ns) in K5_GROUPS.items():
        members = [_k5_weights(gen, K, N) for N in Ns]
        for M in (1, 2):
            x = torch.randn((M, 1, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            f32 = torch.float32

            def each(dm, i):
                return [dm(x, copies[i], out_dtype=f32) for copies in members]
            versions = {
                "old_each": lambda i: each(old_q.dequant_matmul, i),
                "new_each": lambda i: each(quant.dequant_matmul, i),
                "grouped": lambda i: quant.dequant_matmul_group(
                    x, [copies[i] for copies in members], out_dtype=f32)}
            wants = each(quant.dequant_matmul_reference, 0)
            grouped = versions["grouped"](0)
            rel = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(grouped, wants))
            if rel > 1e-5:
                raise AssertionError(f"K5 group {name} M{M}: rel {rel:.3g}")
            times = {k: [] for k in versions}
            for who in ("old_each", "new_each", "grouped", "grouped",
                        "new_each", "old_each"):
                times[who].append(_cycled(versions[who], K5_LAYERS,
                                          (old_q.capturing,)))
            means["group " + name, M] = {k: sum(v) / len(v)
                                         for k, v in times.items()}
            emit(kernel="K5", case=name, M=M, K=K, N=list(Ns),
                 compare="grouped vs one by one", ms=times,
                 grid=dict(zip(("tile", "rows", "splits", "tiles"),
                               quant._k5_group_plan(M, K, Ns))),
                 rel_err_vs_plain=rel)
            emit(kernel="K5", case=name, M=M, K=K, N=list(Ns),
                 compare="streaming splits",
                 ms=k5_splits(x.reshape(M, K), members, wants))
        del members
        torch.cuda.empty_cache()
    for M in K5_ROWS:
        sums = {who: sum(n * means[s, M][who]
                         for s, n in K5_PER_STEP.items())
                for who in ("old", "new", "plain")}
        if M <= quant.K5_GROUP_ROWS:
            sums["new_one_by_one"] = sums["new"]
            sums["new"] = sum(n * means[s, M]["grouped" if s.startswith(
                "group") else "new"] for s, n in K5_GROUPED_STEP.items())
        emit(kernel="K5", case="decode step (32 layers)", M=M,
             launches=129 if M <= quant.K5_GROUP_ROWS else 225,
             compare="old vs new", ms_sum=sums)


def ab_k7(gen, emit, old_q=None):
    """K7 against the plain route, the library GEMM and (``old_q``, an
    earlier checkout's ``ops/quant``) its earlier version, in turns, at
    phase 4d's shapes."""
    bf16 = torch.bfloat16
    table = [(name, K, N, M) for M in K7_ROWS
             for name, (K, N) in K7_SHAPES.items()]
    table += [("lm_head", *K7_LM_HEAD, M) for M in K7_LM_HEAD_ROWS]
    records = () if old_q is None else (old_q.capturing,)
    turns = ("plain", "old", "k7", "mm", "mm", "k7", "old", "plain")
    for name, K, N, M in table:
        weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                       device="cuda", dtype=torch.int8),
                    "scale": torch.rand((1, N), generator=gen,
                                        device="cuda") * 1e-3 + 1e-4}
                   for _ in range(K7_COPIES)]
        g = torch.randn((M, N), generator=gen, device="cuda")
        pairs = [((g * w["scale"].reshape(-1)).to(bf16),
                  w["q"].to(bf16).t().contiguous()) for w in weights]
        versions = {
            "k7": lambda i: quant.w8a16_dx(g, weights[i], bf16),
            "plain": lambda i: quant._dequant_matmul_dx(
                g, weights[i]["q"], weights[i]["scale"], bf16),
            "mm": lambda i: torch.mm(*pairs[i])}
        if old_q is not None:
            versions["old"] = lambda i: old_q.w8a16_dx(g, weights[i], bf16)
        want = versions["plain"](0)
        err = {who: float((versions[who](0).float() - want.float()).abs()
                          .max()) for who in ("k7", "old") if who in versions}
        times = {who: [] for who in versions}
        for who in turns:
            if who in versions:
                times[who].append(_cycled(versions[who], K7_COPIES, records))
        t_bound, by = bound(2 * M * K * N, 4 * M * N + K * N + 4 * N
                            + 2 * M * K)
        emit(kernel="K7", case=name, M=M, K=K, N=N,
             rows=quant._k7_plan(M, K, N)[0],
             compare="/".join(w for w in turns[:4] if w in versions),
             ms=times, bound_ms=t_bound, bound_by=by,
             max_abs_diff_from_plain=err)
        del weights, g, pairs
        torch.cuda.empty_cache()


# K6's rows in turns: a 512-row chunk, the vision pair's 2,048, MCUB-4's
# 3,328 bucket and the int8-base train forward's B=4 x 2,048; the tp 2 / tp
# 4 shards at 3,328
K6_AB_ROWS = (512, 2048, 3328, 8192)
K6_TP_ROWS = 3328


def ab_k6(gen, emit, old_q=None):
    """K6 (fp32 out) at a layer's products (q/k/v/o, gate/up, down) at
    K6_AB_ROWS and the tp 2 / tp 4 shards at K6_TP_ROWS, against
    ``torch.mm`` on bf16 copies of the weights made beforehand and, given
    ``old_q`` (an earlier checkout's ``ops/quant``), the earlier K6
    through its own wrapper, in turns (old, new, mm, mm, new, old), each
    by CUDA-graph replay over K6_COPIES weight copies, with the new
    schedule and the bound; and the sums over a layer's seven at each row
    count, one per reading."""
    records = () if old_q is None else (old_q.capturing,)
    turns = ("old", "new", "mm", "mm", "new", "old")
    tp = {k: v for k, v in K5_TP_SHAPES.items() if not k.endswith("lm_head")}
    table = [(name, *K6_SHAPES[name], M) for M in K6_AB_ROWS
             for name in K6_LAYER]
    table += [(name, K, N, K6_TP_ROWS) for name, (K, N) in tp.items()]
    active = quant._k6_active(torch.device("cuda"))
    layer = {}
    f32 = torch.float32
    for name, K, N, M in table:
        weights = [{"q": torch.randint(-127, 128, (K, N), generator=gen,
                                       device="cuda", dtype=torch.int8),
                    "scale": torch.rand((1, N), generator=gen,
                                        device="cuda") * 1e-3 + 1e-4}
                   for _ in range(K6_COPIES)]
        dense = [w["q"].to(torch.bfloat16) for w in weights]
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        versions = {
            "new": lambda i: quant.dequant_matmul(x, weights[i],
                                                  out_dtype=f32),
            "mm": lambda i: torch.mm(x, dense[i], out_dtype=f32)}
        if old_q is not None:
            versions["old"] = lambda i: old_q.dequant_matmul(
                x, weights[i], out_dtype=f32)
        want = quant.dequant_matmul_reference(x, weights[0], out_dtype=f32)
        err = {who: float(((versions[who](0) - want).abs().max()
                           / want.abs().max()))
               for who in ("new", "old") if who in versions}
        if err["new"] > 1e-5:
            raise AssertionError(f"K6 {name} M{M}: rel err {err['new']:.3g}")
        times = {who: [] for who in versions}
        for who in turns:
            if who in versions:
                times[who].append(_cycled(versions[who], K6_COPIES, records))
        t_bound, by = bound(2 * M * K * N, K * N + 4 * N + 2 * M * K
                            + 4 * M * N)
        plan = quant._k6_plan(M, K, N, active)
        emit(kernel="K6", case=name, M=M, K=K, N=N,
             schedule={"rows": plan.rows, "split": plan.split,
                       "clusters": plan.clusters, "whole": plan.whole,
                       "tiles": plan.m_tiles * plan.n_tiles},
             compare="/".join(w for w in turns[:3] if w in versions),
             ms=times, bound_ms=t_bound, bound_by=by,
             rel_err_vs_plain=err)
        if name in K6_LAYER:
            sums = layer.setdefault(M, {"bound_ms": 0.0})
            sums["bound_ms"] += K6_LAYER[name] * t_bound
            for who, ts in times.items():
                acc = sums.setdefault(who, [0.0] * len(ts))
                for i, t in enumerate(ts):
                    acc[i] += K6_LAYER[name] * t
        del weights, dense, x
        torch.cuda.empty_cache()
    for M, sums in layer.items():
        emit(kernel="K6", case="a layer's seven", M=M,
             compare="/".join(w for w in turns[:3] if w in sums),
             ms_sum=sums)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old",
                    help="root of a checkout of the earlier sources (K1-K7)")
    ap.add_argument("--only", default="K1,K2,K3,K4,K5",
                    help="comma-separated kernels to compare (K1-K7, "
                         "K1F32, K4F32)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if only - {"K6", "K7"} and not args.old:
        ap.error("K1-K5 are compared with an earlier checkout: --old DIR")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    old_fa, old_fd = old_wrappers(args.old) if args.old else (None, None)
    device_time_cycle_ms(lambda _: torch.ones(1, device="cuda").sum(), 1, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def emit(**row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "K7" in only:
        ab_k7(gen, emit, old_quant(args.old) if args.old else None)

    if only & {"K1F32", "K4F32"}:
        ab_f32(old_fa, gen, emit, only)

    if "K6" in only:
        ab_k6(gen, emit, old_quant(args.old) if args.old else None)

    if "K5" in only:
        old_q = old_quant(args.old)
        if hasattr(old_q, "_row_plan"):  # only before the streaming kernel
            k5_fixed_cost(old_q, args.old, gen, emit)
        ab_k5(old_q, gen, emit)

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
