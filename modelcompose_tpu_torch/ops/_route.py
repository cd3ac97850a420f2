"""The rule every kernel wrapper of the port routes by.

A CPU tensor takes a kernel's plain version, as the JAX package runs its
Pallas kernels in interpret mode off the TPU; a CUDA tensor launches the
kernel or raises (a type, shape or layout the kernel does not take).

Attention's kernels (K1-K4, K2) take bf16, fp16 and fp32 operands
(``ATTENTION``), as the JAX Pallas kernels feed their dots any of the
three; their C entries are told the type by ``dtype_code``.  The int8
products (K5-K7, ``ops/quant``) and the fused decode layer (K8-K10,
``ops/decode_fused``) take bf16 and fp16 (``HALF``) and also route by
dtype: fp32 activations take their plain versions on every device, as the
JAX package computes those outside any Pallas kernel (it converts an int8
weight to x's type, whatever that is).
"""

from __future__ import annotations

import torch

HALF = (torch.bfloat16, torch.float16)
ATTENTION = HALF + (torch.float32,)
FAMILIES = ("attention", "products", "decode")
# The attention C entries' dtype codes (csrc/hopper.cuh ``DType``).
DTYPE_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


def kernel_dtype(x: torch.Tensor) -> bool:
    """Whether x's type is one the products and the decode layer's kernels
    take (bf16, fp16)."""
    return x.dtype in HALF


def dtype_code(x: torch.Tensor) -> int:
    """The code of x's type (bf16, fp16 or fp32) for an attention kernel's
    C entry."""
    return DTYPE_CODES[x.dtype]


def on_card(x: torch.Tensor, kernels: str) -> bool:
    """Whether the kernels of ``kernels`` take x: a CUDA tensor.

    ``kernels`` names the family that asks: "attention" (K1-K4, K2),
    "products" (K5-K7) or "decode" (K8-K10 and the K5 launches that hold
    them).  Every family answers alike on the card; the CPU tests emulate
    the card's rule for one family at a time by replacing this function
    and that family's launchers."""
    assert kernels in FAMILIES, kernels
    return x.is_cuda
