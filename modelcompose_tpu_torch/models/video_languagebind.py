"""LanguageBind video tower: a CLIP ViT with temporal attention in every
layer (counterpart of modelcompose_tpu/models/video_languagebind.py).

8 frames of 224x224 are embedded one by one by a CLIP ViT (256 patches +
CLS = 257 tokens).  Every encoder layer first adds its learned temporal
embedding over the frame axis and runs a temporal attention block (its own
LayerNorm and attention, residual) in which each spatial position attends
across the frames, then the pre-LN CLIP spatial attention and MLP.
``select_layer`` -2 runs 23 of 24 layers and returns [B, T, 257, C]; the
model flattens that to [B, T*257, C].  The published weights are
OpenCLIP-derived (exact GELU); HF-CLIP-derived ones use quick_gelu.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..tree import numpy_to_torch
from .vision_clip import (_ln, _proj, load_hf_dir_state, quick_gelu,
                          stacked_dense_from, stacked_ln_from)


@dataclasses.dataclass(frozen=True)
class LanguageBindVideoConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_frames: int = 8
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    select_layer: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1

    @property
    def layers_to_run(self) -> int:
        if self.select_layer < 0:
            n = self.num_hidden_layers + 1 + self.select_layer
        else:
            n = self.select_layer
        if not 0 <= n <= self.num_hidden_layers:
            raise ValueError(f"select_layer {self.select_layer}")
        return n


def _act(cfg: LanguageBindVideoConfig, x):
    return quick_gelu(x) if cfg.hidden_act == "quick_gelu" else F.gelu(x)


def init_languagebind_video(cfg: LanguageBindVideoConfig,
                            generator: torch.Generator, dtype=torch.float32,
                            device=None) -> Dict[str, Any]:
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def normal(shape, std=0.02):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def stacked(d_in, d_out):
        return {"w": normal((L, d_in, d_out)), "b": zeros(L, d_out)}

    def stacked_ln():
        return {"scale": torch.ones((L, H), dtype=dtype, device=device),
                "bias": zeros(L, H)}

    return {
        "class_embedding": zeros(H),
        "patch_embedding": normal((cfg.patch_size, cfg.patch_size,
                                   cfg.num_channels, H)),  # HWIO
        "position_embedding": normal((cfg.num_positions, H)),
        "pre_layernorm": {"scale": torch.ones((H,), dtype=dtype,
                                              device=device),
                          "bias": zeros(H)},
        "layers": {
            "temporal_embedding": normal((L, cfg.num_frames, H), H ** -0.5),
            "t_ln": stacked_ln(),
            "t_q": stacked(H, H), "t_k": stacked(H, H),
            "t_v": stacked(H, H), "t_o": stacked(H, H),
            "ln1": stacked_ln(),
            "q": stacked(H, H), "k": stacked(H, H),
            "v": stacked(H, H), "o": stacked(H, H),
            "ln2": stacked_ln(),
            "fc1": stacked(H, I), "fc2": stacked(I, H),
        },
    }


def _mha(lp, pre: str, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: [B*, S, H] -> self-attention over S."""
    Bx, S, H = x.shape
    hd = H // n_heads
    q = _proj(lp[pre + "q"], x).view(Bx, S, n_heads, hd)
    k = _proj(lp[pre + "k"], x).view(Bx, S, n_heads, hd)
    v = _proj(lp[pre + "v"], x).view(Bx, S, n_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / hd ** 0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return _proj(lp[pre + "o"], ctx.reshape(Bx, S, H).to(x.dtype))


def languagebind_video_features(params: Dict[str, Any],
                                cfg: LanguageBindVideoConfig,
                                pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [B, T, H_img, W_img, 3] normalized frames.  Returns
    [B, T, 257, hidden] at the selected layer."""
    B, T = pixels.shape[:2]
    H = cfg.hidden_size
    eps = cfg.layer_norm_eps
    dtype = params["class_embedding"].dtype
    frames = pixels.reshape((B * T,) + tuple(pixels.shape[2:]))
    weight = params["patch_embedding"]
    patches = F.conv2d(frames.to(dtype).float().permute(0, 3, 1, 2),
                       weight.float().permute(3, 2, 0, 1),  # HWIO -> OIHW
                       stride=cfg.patch_size).to(dtype)
    patches = patches.permute(0, 2, 3, 1).reshape(B * T, -1, H)
    cls = params["class_embedding"].expand(B * T, 1, H)
    x = torch.cat([cls, patches], dim=1) + params["position_embedding"][None]
    x = _ln(params["pre_layernorm"], x, eps)

    N = x.shape[1]
    layers = params["layers"]
    for li in range(cfg.layers_to_run):
        lp = {k: (v[li] if isinstance(v, torch.Tensor)
                  else {n: t[li] for n, t in v.items()})
              for k, v in layers.items()}
        # temporal block: [B*T, N, H] -> [B*N, T, H] and back
        ht = x.view(B, T, N, H) + lp["temporal_embedding"][None, :T, None, :]
        ht = ht.transpose(1, 2).reshape(B * N, T, H)
        ht = ht + _mha(lp, "t_", _ln(lp["t_ln"], ht, eps),
                       cfg.num_attention_heads)
        x = ht.view(B, N, T, H).transpose(1, 2).reshape(B * T, N, H)
        # spatial attention + MLP (pre-LN CLIP)
        x = x + _mha(lp, "", _ln(lp["ln1"], x, eps), cfg.num_attention_heads)
        m = _act(cfg, _proj(lp["fc1"], _ln(lp["ln2"], x, eps)))
        x = x + _proj(lp["fc2"], m)
    return x.view(B, T, N, H)


def convert_languagebind_video(state, cfg: LanguageBindVideoConfig,
                               dtype=torch.float32, device=None
                               ) -> Dict[str, Any]:
    """An HF-layout LanguageBind video state dict (numpy, keys rooted at
    ``vision_model.``, with per-layer ``temporal_attn``,
    ``temporal_layer_norm1`` and ``temporal_embedding``) -> the stacked
    tree, as tensors of ``dtype`` on ``device``."""
    def g(key):
        return np.asarray(state[f"vision_model.{key}"], np.float32)

    L = cfg.num_hidden_layers

    def dense(fmt):
        return stacked_dense_from(g, "encoder.layers.{i}." + fmt, L)

    def ln(fmt):
        return stacked_ln_from(g, "encoder.layers.{i}." + fmt, L)

    params = {
        "class_embedding": g("embeddings.class_embedding"),
        "patch_embedding": g("embeddings.patch_embedding.weight")
            .transpose(2, 3, 1, 0),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_layernorm": {"scale": g("pre_layrnorm.weight"),
                          "bias": g("pre_layrnorm.bias")},
        "layers": {
            "temporal_embedding": np.stack(
                [g(f"encoder.layers.{i}.temporal_embedding")[0]
                 for i in range(L)]),
            "t_ln": ln("temporal_layer_norm1"),
            "t_q": dense("temporal_attn.q_proj"),
            "t_k": dense("temporal_attn.k_proj"),
            "t_v": dense("temporal_attn.v_proj"),
            "t_o": dense("temporal_attn.out_proj"),
            "ln1": ln("layer_norm1"),
            "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
            "v": dense("self_attn.v_proj"),
            "o": dense("self_attn.out_proj"),
            "ln2": ln("layer_norm2"),
            "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2"),
        },
    }
    return numpy_to_torch(params, dtype, device)


class LanguageBindVideoTower:
    """Video tower; ``encode`` returns [B, T, 257, hidden] (the model
    flattens T*N)."""

    modality = "video"

    def __init__(self, spec: str, model_cfg=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        select_layer = getattr(model_cfg, "mm_video_select_layer", -2) \
            if model_cfg is not None else -2
        if spec.startswith("test:"):
            h, l = spec.split(":")[1].split("x")
            self.cfg = LanguageBindVideoConfig(
                hidden_size=int(h), intermediate_size=2 * int(h),
                num_hidden_layers=int(l), num_attention_heads=4,
                image_size=28, patch_size=14, num_frames=2,
                select_layer=select_layer)
        else:
            self.cfg = LanguageBindVideoConfig(select_layer=select_layer)
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            if os.path.isdir(spec):
                params = self.load_model(dtype, device)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_languagebind_video(self.cfg, generator, dtype,
                                                 device)
        self.params = params

    def load_model(self, dtype=torch.float32, device=None) -> Dict[str, Any]:
        """HF-layout LanguageBind video weights from the ``spec``
        directory."""
        return convert_languagebind_video(load_hf_dir_state(self.spec),
                                          self.cfg, dtype, device)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def num_frames(self) -> int:
        return self.cfg.num_frames

    @property
    def tokens_per_frame(self) -> int:
        return self.cfg.num_positions  # CLS kept, as the reference returns it

    @property
    def feature_len(self) -> int:
        return self.num_frames * self.tokens_per_frame

    @property
    def modal_processor(self):
        from ..data.video_processing import (
            LanguageBindVideoProcessor)
        return LanguageBindVideoProcessor(num_frames=self.cfg.num_frames,
                                          size=self.cfg.image_size)

    def encode(self, videos) -> torch.Tensor:
        device = self.params["class_embedding"].device
        return languagebind_video_features(
            self.params, self.cfg, torch.as_tensor(videos, device=device))
