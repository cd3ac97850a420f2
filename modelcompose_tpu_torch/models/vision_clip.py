"""CLIP ViT vision tower (openai/clip-vit-large-patch14-336 class;
counterpart of modelcompose_tpu/models/vision_clip.py).

Pre-LN ViT with a class token, learned absolute position embeddings and
quick-GELU MLPs.  ``select_layer`` taps an intermediate hidden state (DAMC
uses -2) and ``select_feature='patch'`` drops the CLS token, so the tower
runs only the layers it needs.  Layers are stacked on a leading axis, as
in the JAX package; pixels are NHWC.  Attention is plain PyTorch: the JAX
tower's is an einsum softmax, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..compose.state_io import load_state
from ..ops.quant import matmul_f32
from ..tree import numpy_to_torch


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    select_layer: int = -2
    select_feature: str = "patch"
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1

    @property
    def layers_to_run(self) -> int:
        """hidden_states[k] is the output after k layers; select_layer -2
        means index L-1, i.e. run L-1 layers."""
        if self.select_layer < 0:
            n = self.num_hidden_layers + 1 + self.select_layer
        else:
            n = self.select_layer
        if not 0 <= n <= self.num_hidden_layers:
            raise ValueError(f"select_layer {self.select_layer} out of range")
        return n


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _ln(p, x, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def init_clip_vision(cfg: ClipVisionConfig, generator: torch.Generator,
                     dtype=torch.float32, device=None) -> Dict[str, Any]:
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    std = 0.02

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stacked(d_in, d_out):
        return {"w": normal((L, d_in, d_out)), "b": zeros(L, d_out)}

    return {
        "class_embedding": zeros(H),
        "patch_embedding": normal((cfg.patch_size, cfg.patch_size,
                                   cfg.num_channels, H)),  # HWIO
        "position_embedding": normal((cfg.num_positions, H)),
        "pre_layernorm": {"scale": ones(H), "bias": zeros(H)},
        "layers": {
            "ln1": {"scale": ones(L, H), "bias": zeros(L, H)},
            "ln2": {"scale": ones(L, H), "bias": zeros(L, H)},
            "q": stacked(H, H), "k": stacked(H, H), "v": stacked(H, H),
            "o": stacked(H, H),
            "fc1": stacked(H, I), "fc2": stacked(I, H),
        },
    }


def _proj(p, x):
    return (matmul_f32(x, p["w"]) + p["b"]).to(x.dtype)


def _attn(lp, x, n_heads):
    B, T, H = x.shape
    hd = H // n_heads
    q = _proj(lp["q"], x).view(B, T, n_heads, hd)
    k = _proj(lp["k"], x).view(B, T, n_heads, hd)
    v = _proj(lp["v"], x).view(B, T, n_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return _proj(lp["o"], ctx.reshape(B, T, H).to(x.dtype))


def clip_vision_features(params: Dict[str, Any], cfg: ClipVisionConfig,
                         pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [B, H_img, W_img, 3] normalized.  Returns the selected hidden
    state, [B, num_patches(+1), hidden] per select_feature."""
    B = pixels.shape[0]
    H = cfg.hidden_size
    eps = cfg.layer_norm_eps
    dtype = params["class_embedding"].dtype

    weight = params["patch_embedding"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    patches = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2), weight,
                       stride=cfg.patch_size)
    patches = patches.permute(0, 2, 3, 1).reshape(B, -1, H)
    cls = params["class_embedding"].expand(B, 1, H)
    x = torch.cat([cls, patches], dim=1) + params["position_embedding"][None]
    x = _ln(params["pre_layernorm"], x, eps)

    for li in range(cfg.layers_to_run):
        lp = {k: {n: t[li] for n, t in v.items()}
              for k, v in params["layers"].items()}
        x = x + _attn(lp, _ln(lp["ln1"], x, eps), cfg.num_attention_heads)
        m = _proj(lp["fc1"], _ln(lp["ln2"], x, eps))
        m = quick_gelu(m) if cfg.hidden_act == "quick_gelu" else F.gelu(m)
        x = x + _proj(lp["fc2"], m)

    if cfg.select_feature == "patch":
        return x[:, 1:]
    if cfg.select_feature == "cls_patch":
        return x
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def load_hf_dir_state(directory: str) -> Dict[str, np.ndarray]:
    """The state dict of an HF model directory (``model.safetensors``,
    else ``pytorch_model.bin``), as numpy."""
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return load_state(path)
    raise FileNotFoundError(f"no model weights under {directory}")


def stacked_dense_from(g, fmt: str, n: int) -> Dict[str, np.ndarray]:
    """Layers 0..n-1 of torch Linears ``fmt.format(i=i)`` ([out, in]
    weights, read through ``g``) stacked as ``{"w": [n, in, out], "b"}``."""
    return {"w": np.stack([g(fmt.format(i=i) + ".weight").T
                           for i in range(n)]),
            "b": np.stack([g(fmt.format(i=i) + ".bias") for i in range(n)])}


def stacked_ln_from(g, fmt: str, n: int) -> Dict[str, np.ndarray]:
    """Layers 0..n-1 of LayerNorms stacked as ``{"scale", "bias"}``."""
    return {"scale": np.stack([g(fmt.format(i=i) + ".weight")
                               for i in range(n)]),
            "bias": np.stack([g(fmt.format(i=i) + ".bias")
                              for i in range(n)])}


def convert_hf_clip_vision(state: Dict[str, np.ndarray],
                           cfg: ClipVisionConfig, dtype=torch.float32,
                           device=None) -> Dict[str, Any]:
    """An HF CLIPVisionModel state dict (numpy, keys rooted at
    ``vision_model.``) -> the stacked tree, as tensors of ``dtype`` on
    ``device``."""
    def g(key):
        return np.asarray(state[f"vision_model.{key}"], np.float32)

    L = cfg.num_hidden_layers

    def dense(fmt):
        return stacked_dense_from(g, "encoder.layers.{i}." + fmt, L)

    def ln(fmt):
        return stacked_ln_from(g, "encoder.layers.{i}." + fmt, L)

    params = {
        "class_embedding": g("embeddings.class_embedding"),
        # torch conv weight [out, in, kh, kw] -> HWIO
        "patch_embedding": g("embeddings.patch_embedding.weight")
            .transpose(2, 3, 1, 0),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_layernorm": {"scale": g("pre_layrnorm.weight"),
                          "bias": g("pre_layrnorm.bias")},
        "layers": {
            "ln1": ln("layer_norm1"), "ln2": ln("layer_norm2"),
            "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
            "v": dense("self_attn.v_proj"), "o": dense("self_attn.out_proj"),
            "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2"),
        },
    }
    return numpy_to_torch(params, dtype, device)
