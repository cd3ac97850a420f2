"""The rule every kernel wrapper of the port routes by.

A CPU tensor takes a kernel's plain version, as the JAX package runs its
Pallas kernels in interpret mode off the TPU; a CUDA tensor launches the
kernel or raises (a type, shape or layout the kernel does not take).

The kernels take bf16 and fp16 operands (``HALF``).  Only the int8
products (K5-K7, ``ops/quant``) and the fused decode layer (K8-K10,
``ops/decode_fused``) also route by dtype: fp32 activations take their
plain versions on every device, as the JAX package converts an int8 weight
to x's type whatever it is.  Attention has no such rule: K1-K4 and K2
raise on an fp32 CUDA tensor.
"""

from __future__ import annotations

import torch

HALF = (torch.bfloat16, torch.float16)
FAMILIES = ("attention", "products", "decode")


def kernel_dtype(x: torch.Tensor) -> bool:
    """Whether x's type is one the kernels take (bf16, fp16)."""
    return x.dtype in HALF


def on_card(x: torch.Tensor, kernels: str) -> bool:
    """Whether the kernels of ``kernels`` take x: a CUDA tensor.

    ``kernels`` names the family that asks: "attention" (K1-K4, K2),
    "products" (K5-K7) or "decode" (K8-K10 and the K5 launches that hold
    them).  Every family answers alike on the card; the CPU tests emulate
    the card's rule for one family at a time by replacing this function
    and that family's launchers."""
    assert kernels in FAMILIES, kernels
    return x.is_cuda
