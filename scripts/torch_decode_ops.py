#!/usr/bin/env python3
"""The small kernels of one eager decode step, named by the op that launched
them, on the unfused route, through K8-K10 as launches of their own, and
with K8-K10 inside K5's launches, on one CUDA card.

The step is MCUB-4's decode at Vicuna-7B width and depth (32 layers, 32
heads of 128, random weights from a seed, int8 base, the dense fold: no
adapter branch at decode) over an int8 cache of 3,360 positions, one row
at position 3,303.  Each route (``unfused``: ``core.llama.fused_decode``
off, the layer's ops as PyTorch kernels and K5 writing fp32 and a cast
after it; ``separate``: K8 add + RMSNorm, K9 RoPE + cache write, K10 SiLU
product, K5 writing bf16, each its own launch (``decode_fused.norm_fuses``
and ``silu_fuses`` off); ``in_k5``: the main path, each norm in the
prologue of the K5 launch that reads it, RoPE + the cache write in the
q/k/v launch's epilogue and the SiLU product in the prologue of the down
product's launch) is warmed up, then one step is profiled by
torch.profiler with ``record_shapes``, in turns unfused, separate, in_k5,
in_k5, separate, unfused.  Every device kernel goes under the outermost
aten op that
launched it (with that op's input shapes), or, launched by no aten op (the
hand-written kernels, called through ctypes), under its kernel's name: per
op the kernels and device microseconds of one step.

    python3 scripts/torch_decode_ops.py

Prints the card's name and power limit, then one JSON line a turn
(``route``, ``kernels``, ``device_us``, ``by_op``: [op, kernels, us] by
time); the full table of each turn goes to
``chiprun_out/decode_ops_<route>_<turn>.txt``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_LEN = 3360
POSITION = 3303  # MCUB-4's 3,287 prompt positions and 16 answer tokens
TURNS = ("unfused", "separate", "in_k5", "in_k5", "separate", "unfused")


def _label(fe):
    """The outermost aten op above ``fe`` (its name and input shapes)."""
    top = fe
    while top.cpu_parent is not None \
            and top.cpu_parent.name.startswith("aten::"):
        top = top.cpu_parent
    shapes = [list(s) for s in (top.input_shapes or []) if s]
    return f"{top.name} {json.dumps(shapes)}" if shapes else top.name


def step_ops(prof, split_of):
    """{op label: [kernels, device us]} of one profiled step."""
    from torch.autograd import DeviceType
    rows = collections.defaultdict(lambda: [0, 0.0])
    linked = collections.Counter()
    for fe in prof.events():
        if fe.device_type != DeviceType.CPU or not fe.kernels:
            continue
        label = _label(fe)
        for k in fe.kernels:
            rows[label][0] += 1
            rows[label][1] += k.duration
            linked[k.name] += 1
    for fe in prof.events():  # kernels no aten op launched
        if fe.device_type != DeviceType.CUDA:
            continue
        if linked[fe.name] > 0:
            linked[fe.name] -= 1
            continue
        label = split_of(fe.name) or fe.name
        rows[label][0] += 1
        rows[label][1] += fe.time_range.end - fe.time_range.start
    return rows


def main() -> int:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from modelcompose_tpu_torch.configs import mcub4_damc_7b
    from modelcompose_tpu_torch.core import llama
    from modelcompose_tpu_torch.core.decode_graph import _decode_step
    from modelcompose_tpu_torch.ops import decode_fused
    from modelcompose_tpu_torch.ops.quant import quantize_backbone
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_ops: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cfg = mcub4_damc_7b()
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        params = quantize_backbone(llama.init_params(cfg, gen, device))
        cache = llama.KVCache.zeros(cfg, 1, CACHE_LEN, quantized=True,
                                    device=device)
        for part in (cache.k, cache.v):
            part["q"].random_(-127, 128, generator=gen)
            part["scale"].uniform_(1e-3, 2e-2, generator=gen)
    tokens = torch.tensor([100], device=device)
    kv_lens = torch.tensor([POSITION], dtype=torch.int32, device=device)
    fused, norm_fuses = llama.fused_decode, decode_fused.norm_fuses
    silu_fuses = decode_fused.silu_fuses

    def step():
        with torch.no_grad():
            return _decode_step(params, cfg, cache, tokens, kv_lens, None)[0]
    os.makedirs("chiprun_out", exist_ok=True)
    for turn, route in enumerate(TURNS):
        if route == "unfused":
            llama.fused_decode = lambda x, attn_impl: False
        if route == "separate":
            decode_fused.norm_fuses = lambda x, weights: False
            decode_fused.silu_fuses = lambda gate, w: False
        try:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                step()
                torch.cuda.synchronize()
        finally:
            llama.fused_decode, decode_fused.norm_fuses = fused, norm_fuses
            decode_fused.silu_fuses = silu_fuses
        rows = step_ops(prof, chip_smoke._split_of)
        ranked = sorted(rows.items(), key=lambda kv: -kv[1][1])
        with open(os.path.join("chiprun_out",
                               f"decode_ops_{route}_{turn}.txt"), "w") as f:
            for label, (n, us) in ranked:
                f.write(f"{n:6d} {us:10.1f}  {label}\n")
        print(json.dumps({
            "route": route, "turn": turn,
            "kernels": sum(n for n, _ in rows.values()),
            "device_us": round(sum(us for _, us in rows.values()), 1),
            "by_op": [[label, n, round(us, 1)]
                      for label, (n, us) in ranked]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
