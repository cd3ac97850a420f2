"""RMSNorm with Llama semantics: fp32 statistics, cast back to the input
dtype (counterpart of modelcompose_tpu/ops/norms.py)."""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    # HF 4.31 LlamaRMSNorm casts the normed states back to the input dtype
    # BEFORE the weight multiply; keep that order so bf16 activations
    # round identically to the reference.
    normed = (xf * torch.rsqrt(var + eps)).to(dtype)
    return weight.to(dtype) * normed
