"""Weight-only int8 quantization for decode (counterpart of
modelcompose_tpu/ops/quant.py).

Per-output-channel symmetric int8 halves the bytes batch-1 decode streams
per step.  ``dequant_matmul`` is plain PyTorch for now: ``q.to(x.dtype)``
materializes a bf16 copy of the weight before the product, so the int8
saving is in residency only, not yet in the bytes the product reads (a
W8A16 kernel is later work; see PERF.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., i] @ w [i, o]`` with fp32 accumulation and an fp32 result
    (the JAX package's ``preferred_element_type=float32``).

    A bf16 product rounded to bf16 before a later add or cast would lose
    mantissa the JAX path keeps, so half-precision operands on the card use
    the fp32-output GEMM; elsewhere the operands are upcast (products of
    bf16 values are exact in fp32, so only the summation order differs).
    """
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda and x.dtype == w.dtype and x.dtype in (torch.bfloat16,
                                                         torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def quantize_int8(w: torch.Tensor, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over ``axis`` (the contraction axis for weights, the
    vector axis for the KV cache), one fp32 scale per remaining index."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequant_matmul(x: torch.Tensor, wq: Dict[str, torch.Tensor],
                   out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(wq), fp32-accumulated; the per-column scale is an
    epilogue multiply.  ``out_dtype`` keeps the fp32 result when the
    consumer wants it (logits, the adapter add)."""
    y = matmul_f32(x, wq["q"].to(x.dtype)) * wq["scale"][..., 0, :]
    return y.to(out_dtype or x.dtype)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_backbone(params: Dict[str, Any],
                      quantize_lm_head: bool = True) -> Dict[str, Any]:
    """Quantize the dense base weights of a core/llama.py param tree; LoRA
    stacks, norms and the embedding stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for grp in ("attn", "mlp"):
        group = {}
        for name, p in layers[grp].items():
            p2 = dict(p)
            p2["w"] = quantize_int8(p["w"], axis=-2)
            group[name] = p2
        layers[grp] = group
    out["layers"] = layers
    if quantize_lm_head:
        out["lm_head"] = quantize_int8(params["lm_head"], axis=-2)
    return out
