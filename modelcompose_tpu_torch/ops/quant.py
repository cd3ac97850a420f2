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


_HALF = (torch.bfloat16, torch.float16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` accumulated and returned in fp32: the fp32-output GEMM
    for half-precision operands on the card, upcast operands elsewhere
    (products of bf16 values are exact in fp32, so only the summation order
    differs)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _HALF:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x [M, i] @ w [i, o]`` -> fp32, differentiable.

    ``torch.mm(..., out_dtype=...)`` has no derivative, so the backward is
    written out: dX = g W^T and dW = X^T g, each accumulated in fp32 and
    cast to its input's dtype.  The fp32 cotangent is rounded to the
    operands' half type first, on every device, so both products are the
    same fp32-output GEMM as the forward.  This is the arithmetic of the
    JAX package on a TPU: JAX transposes ``dot_general(x, w,
    preferred_element_type=f32)`` into an fp32 x fp32 ``dot_general`` at
    precision DEFAULT (the bf16 operand upcast) and a convert to the
    operand's dtype, and XLA runs a DEFAULT-precision fp32 dot on a TPU as
    one bf16 pass.  (XLA on a CPU keeps fp32 there: the JAX CPU gradient
    differs from this one by g's bf16 rounding.)  dW is computed, and X
    kept, only when W needs a gradient: a frozen base weight costs no dW
    GEMM."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g.to(w.dtype), w.t()).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), g.to(x.dtype)).to(x.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., i] @ w [i, o]`` with fp32 accumulation and an fp32 result
    (the JAX package's ``preferred_element_type=float32``).

    A bf16 product rounded to bf16 before a later add or cast would lose
    mantissa the JAX path keeps, so operands of one half type go through
    ``_MatmulF32`` (the fp32-output GEMM on the card, with its own
    backward); fp32 or mixed operands are plain (upcast) products.
    """
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.dtype == w.dtype and x.dtype in _HALF:
        y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
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
    consumer wants it (logits, the adapter add).  Differentiable through x
    only: an int8 weight is frozen."""
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
