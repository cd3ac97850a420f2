#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``modelcompose_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
nonzero:

1. device: the card's name and power limit, TF32 off for the comparisons;
2. build: both hand-written kernels compiled by nvcc from ``csrc/``;
3. K1 (flash-attention forward) against its plain PyTorch version;
4. K2 (split-KV flash-decode) against its plain PyTorch version;
5. the main path at Vicuna-7B width: a vision DAMC composition (CLIP
   ViT-L/14-336, linear projector, routed LoRA r=128) with random weights,
   int8 base, the default adapter mix folded into W, int8 KV cache,
   answering two image+question requests greedily through
   ``MultimodalLM.generate``; then prefill and teacher-forced decode on the
   plain path with the same weights and tokens, logits held to a bf16
   tolerance.

The line before the last is a JSON object with each kernel's launches on the
main path, its largest error against the plain version and both times; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

K1_SOURCE = "modelcompose_tpu_torch/csrc/flash_attention_fwd.cu"
K1_REPLACES = "modelcompose_tpu/ops/flash_attention.py:113"
K2_SOURCE = "modelcompose_tpu_torch/csrc/flash_decode.cu"
K2_REPLACES = "modelcompose_tpu/ops/flash_decode.py:50"

# bf16 tolerances, relative to max |reference| on the compared rows: bf16
# keeps 8 mantissa bits (~0.4% per rounding); the kernel and its plain
# version round P, the output and (K2) the accumulation order differently.
ATTN_TOL = 2e-2
LSE_TOL = 1e-3      # fp32 statistics from identical bf16 operands
# Logits of the 7B path, relative to max |logit|.  The random 32-layer bf16
# network amplifies any rounding difference: on an H100 two plain PyTorch
# attentions (attention_reference vs the kernels' plain versions) gave
# logits 4.6% apart at every step, the kernel path 4.1-4.8% from either.
LOGIT_TOL = 8e-2

SEED = 0
NEW_TOKENS = 32


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false); nothing ran")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return torch.device("cuda", 0)


def phase_build():
    from modelcompose_tpu_torch import _build
    t0 = time.perf_counter()
    for name in ("flash_attention_fwd", "flash_decode"):
        _build.load(name)
        log_lines = _build.build_log.get(name, "").splitlines()
        ptxas = [ln.strip() for ln in log_lines
                 if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=f"{_build.build_seconds[name]:.1f}",
            ptxas=json.dumps(ptxas))
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")


def _rel_err(got, want, rows=None):
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs().max().item()
    return err, err / max(w.abs().max().item(), 1e-6)


def _k1_case(device, gen, *, B, Lq, S, H, Hkv, D, q_offset, lengths):
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v = rnd(B, Lq, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (torch.arange(S, device=device)[None]
              < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    ref_out, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    valid = q_seg != 0  # padding rows are garbage on both sides
    err, rel = _rel_err(out, ref_out, valid)
    lse_err = (lse.transpose(1, 2)[valid] - ref_lse.transpose(1, 2)[valid]
               ).abs().max().item()
    lse_tol = LSE_TOL * max(ref_lse.transpose(1, 2)[valid].abs().max().item(),
                            1.0)
    name = f"B{B} Lq{Lq} S{S} H{H}/{Hkv} D{D} q_offset{q_offset}"
    if not (rel <= ATTN_TOL and lse_err <= lse_tol):
        raise AssertionError(f"K1 {name}: out rel err {rel:.3g} (tol "
                             f"{ATTN_TOL}), lse err {lse_err:.3g} (tol "
                             f"{lse_tol:.3g})")
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, **kw))
    log("K1", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        lse_err=f"{lse_err:.3g}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return err, ms, plain_ms


def phase_k1(device, gen):
    """K1 at the slice's bucket (B=2, 32 heads, D=128, Lq=S=1024, one row
    padded), at a ragged length, with GQA group 4 and a query offset, and
    at D=64."""
    main = _k1_case(device, gen, B=2, Lq=1024, S=1024, H=32, Hkv=32, D=128,
                    q_offset=0, lengths=[1024, 637])
    errs = [main[0]]
    for case in (dict(B=2, Lq=150, S=150, H=32, Hkv=32, D=128, q_offset=0,
                      lengths=[150, 97]),
                 dict(B=2, Lq=256, S=1024, H=32, Hkv=8, D=128, q_offset=768,
                      lengths=[1024, 900]),
                 dict(B=2, Lq=150, S=150, H=8, Hkv=4, D=64, q_offset=0,
                      lengths=[150, 61])):
        errs.append(_k1_case(device, gen, **case)[0])
    return {"max_abs_err": max(errs), "ms": main[1], "plain_ms": main[2]}


def _k2_case(device, gen, *, B, NL, S, H, Hkv, D, kv_len, quantized, layer):
    import torch
    from modelcompose_tpu_torch.core.llama import quantize_kv
    from modelcompose_tpu_torch.ops.attention import decode_attention
    from modelcompose_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    q = rnd(B, 1, H, D)
    k, v = rnd(NL, B, S, Hkv, D), rnd(NL, B, S, Hkv, D)
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
    scale = D ** -0.5
    out = flash_decode_attention(q, k, v, kv, layer, sm_scale=scale)
    ref = flash_decode_reference(q, k, v, kv, layer, sm_scale=scale)
    loop = decode_attention(q, k, v, kv, layer_idx=layer, impl="reference")
    torch.cuda.synchronize()
    err, rel = _rel_err(out, ref)
    _, rel_loop = _rel_err(out, loop)
    name = (f"{'int8' if quantized else 'bf16'} B{B} NL{NL} S{S} H{H}/{Hkv} "
            f"D{D} kv_len{kv_len}")
    if not (rel <= ATTN_TOL and rel_loop <= ATTN_TOL):
        raise AssertionError(f"K2 {name}: rel err {rel:.3g} vs plain, "
                             f"{rel_loop:.3g} vs the chunked loop (tol "
                             f"{ATTN_TOL})")
    ms = cuda_time_ms(lambda: flash_decode_attention(q, k, v, kv, layer,
                                                     sm_scale=scale), 50)
    plain_ms = cuda_time_ms(lambda: flash_decode_reference(
        q, k, v, kv, layer, sm_scale=scale), 50)
    log("K2", case=repr(name), max_abs_err=f"{err:.4g}", rel_err=f"{rel:.3g}",
        rel_err_loop=f"{rel_loop:.3g}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    return err, ms, plain_ms


def phase_k2(device, gen):
    """K2 on bf16 and int8 caches with S not a multiple of 128, GQA group
    4 and per-row kv_len; then at the main path's shape (32 layers, 32 kv
    heads, the 1024 bucket plus 32 new tokens, int8)."""
    errs = []
    for quantized in (False, True):
        errs.append(_k2_case(device, gen, B=2, NL=4, S=1000, H=32, Hkv=8,
                             D=128, kv_len=[1000, 517], quantized=quantized,
                             layer=2)[0])
    errs.append(_k2_case(device, gen, B=2, NL=4, S=333, H=8, Hkv=8, D=64,
                         kv_len=[1, 333], quantized=True, layer=3)[0])
    main = _k2_case(device, gen, B=2, NL=32, S=1024 + NEW_TOKENS, H=32,
                    Hkv=32, D=128, kv_len=[660, 630], quantized=True,
                    layer=31)
    errs.append(main[0])
    return {"max_abs_err": max(errs), "ms": main[1], "plain_ms": main[2]}


def _requests(cfg, device, gen):
    """Two image+question prompts of different text lengths: token ids on
    the host, normalized NHWC pixels on the card."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
    img = MODAL_TOKEN_INDEXES["vision"]
    rng = np.random.default_rng(SEED)

    def text(n):
        return rng.integers(3, cfg.vocab_size, n)
    ids = [np.concatenate([[1], text(34), [img], text(16)]),
           np.concatenate([[1], text(5), [img], text(12)])]
    pixels = torch.randn((2, 336, 336, 3), generator=gen, device=device)
    return ids, {"vision": pixels}


def _teacher_forced(model, ids, inputs, tokens, attn_impl, kv_quant=True):
    """Prefill + decode fed the given tokens; fp32 logits of every step."""
    import numpy as np
    import torch
    from modelcompose_tpu_torch.core.generate import _decode_step, _prefill
    embeds, plan = model.prepare_batch(ids, inputs)
    route_ids = torch.as_tensor(plan.route_ids, device=embeds.device)
    lengths = torch.as_tensor(plan.lengths, device=embeds.device)
    seg = torch.as_tensor(plan.segment_ids, device=embeds.device)
    table = torch.as_tensor(np.asarray(model.routing_table),
                            device=embeds.device)
    logits, cache = _prefill(model.params, model.cfg, embeds, route_ids,
                             table, seg, lengths,
                             embeds.shape[1] + NEW_TOKENS, attn_impl,
                             kv_quant=kv_quant)
    steps, kv_lens = [logits], lengths
    for t in range(tokens.shape[1] - 1):
        logits, cache, kv_lens = _decode_step(
            model.params, model.cfg, cache, tokens[:, t], kv_lens,
            model.decode_routing_table(), attn_impl)
        steps.append(logits)
    return torch.stack(steps, dim=1)  # [B, steps, V]


def build_main_model(device, gen):
    """The vision DAMC composition at Vicuna-7B width, random weights,
    in the production decode variant (int8 base, default mix folded)."""
    import torch
    from modelcompose_tpu_torch import ModelConfig, MultimodalLM
    from modelcompose_tpu_torch.ops.quant import quantize_backbone
    from modelcompose_tpu_torch.ops.routed_lora import fold_dense

    cfg = ModelConfig(lora_strategy="modal+language", lora_r=128,
                      lora_alpha=256, local_prefix_tokens=5,
                      local_suffix_tokens=5,
                      mm_vision_encoder="clip-vit-large-patch14-336",
                      mm_hidden_size=1024, dtype="bfloat16")
    t0 = time.perf_counter()
    with warnings.catch_warnings():  # random tower weights are the point
        warnings.simplefilter("ignore")
        model = MultimodalLM.random_init(cfg, gen, device)
    with torch.no_grad():
        # Small nonzero LoRA B, so the vision adapter changes the answer.
        for grp in ("attn", "mlp"):
            for p in model.params["layers"][grp].values():
                p["lora_b"].normal_(0.0, 0.01, generator=gen)
        for key in ("prefix_tokens", "suffix_tokens"):
            for t in model.params[key].values():
                t.normal_(0.0, 0.02, generator=gen)
        # The production decode variant: int8 base, default mix folded.
        model.params = quantize_backbone(model.params)
        model.params, table = fold_dense(model.params, model.routing_table)
        model.routing_table = table.cpu().numpy()
    torch.cuda.synchronize()
    assert model.decode_routing_table() is None  # decode skips adapters
    log("main", setup_s=f"{time.perf_counter() - t0:.1f}",
        layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
        adapters=cfg.adapter_names(),
        gpu_mem_gb=f"{torch.cuda.memory_allocated() / 2**30:.1f}")
    return cfg, model


def phase_main_path(device, gen):
    import torch
    from modelcompose_tpu_torch.ops.flash_attention import (
        flash_attention_forward)
    from modelcompose_tpu_torch.ops.flash_decode import flash_decode_attention

    cfg, model = build_main_model(device, gen)
    ids, inputs = _requests(cfg, device, gen)
    model.generate(ids, inputs, max_new_tokens=2, kv_quant=True)  # warm-up
    flash_attention_forward.launches = 0
    flash_decode_attention.launches = 0
    timings = {}
    answers = model.generate(ids, inputs, max_new_tokens=NEW_TOKENS,
                             kv_quant=True, timings=timings)
    launches = {"flash_attention_fwd": flash_attention_forward.launches,
                "flash_decode": flash_decode_attention.launches}
    n_layers = cfg.num_hidden_layers
    decode_steps = NEW_TOKENS - 1
    decode_tok_s = len(ids) * decode_steps / timings["decode_s"]
    log("main", prefill_s=f"{timings['prefill_s']:.4f}",
        decode_s=f"{timings['decode_s']:.4f}",
        decode_tok_per_s=f"{decode_tok_s:.2f}",
        answer_lens=[len(a) for a in answers], launches=json.dumps(launches))
    if launches["flash_attention_fwd"] < n_layers:
        raise AssertionError(f"K1 launched {launches} < {n_layers} times")
    if launches["flash_decode"] < n_layers * decode_steps:
        raise AssertionError(f"K2 launched {launches} < "
                             f"{n_layers * decode_steps} times")
    # generate() keeps feeding EOS to a finished row: pad the answers the
    # same way, and hold argmax to the tokens only up to the EOS step.
    eos = cfg.eos_token_id
    tokens = torch.tensor([a + [eos] * (NEW_TOKENS - len(a)) for a in answers],
                          device=device)
    live = torch.arange(NEW_TOKENS, device=device)[None] <= torch.tensor(
        [len(a) for a in answers], device=device)[:, None]
    with torch.no_grad():
        kernel = _teacher_forced(model, ids, inputs, tokens, "auto")
        plain = _teacher_forced(model, ids, inputs, tokens, "reference")
    if not (torch.isfinite(kernel).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    if kernel.shape != (len(ids), NEW_TOKENS, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(kernel.shape)}")
    if not torch.equal(kernel.argmax(-1)[live], tokens[live]):
        raise AssertionError("teacher-forced kernel path disagrees with the "
                             "tokens generate() returned")
    scale = plain.abs().amax(dim=-1)  # [B, steps]
    rel = ((kernel - plain).abs().amax(dim=-1) / scale)
    agree = (plain.argmax(-1) == tokens)[live].float().mean().item()
    log("main", prefill_logit_rel_err=f"{rel[:, 0].max().item():.3g}",
        decode_logit_rel_err=f"{rel[:, 1:].max().item():.3g}",
        logit_tol=LOGIT_TOL, greedy_id_agreement=f"{agree:.4f}")
    if rel.max().item() > LOGIT_TOL:
        raise AssertionError(f"kernel path logits differ from the plain path "
                             f"by {rel.max().item():.3g} of max |logit|")
    return launches


def main() -> int:
    try:
        import torch
        import modelcompose_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from the repository root ({e})")
    device = phase_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    phase_build()
    k1 = phase_k1(device, gen)
    k2 = phase_k2(device, gen)
    launches = phase_main_path(device, gen)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES, launches=launches["flash_attention_fwd"],
             **k1),
        dict(name="flash_decode", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES, launches=launches["flash_decode"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
