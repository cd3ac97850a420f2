"""CLIP text encoder with projection (counterpart of
modelcompose_tpu/models/text_clip.py).

HF ``CLIPTextModelWithProjection`` semantics: a causal text transformer
(an optional key-padding mask on top; masked logits are filled with
-1e30), quick-GELU MLPs, a final LayerNorm, pooling at the EOT token (the
argmax of the ids: EOT has the largest id), and a projection without bias,
one feature token per text ([B, 1, projection_dim]).  Layers are stacked
on a leading axis, as in the JAX package.  Nothing in the package routes a
``text`` modality to it: it is a standalone encoder with its HF converter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..devices import resolve_device
from ..ops.quant import matmul_f32
from ..tree import numpy_to_torch
from .vision_clip import (_ln, _proj, quick_gelu, stacked_dense_from,
                          stacked_ln_from)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


def init_clip_text(cfg: ClipTextConfig, generator: torch.Generator,
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
        "token_embedding": normal((cfg.vocab_size, H)),
        "position_embedding": normal((cfg.max_position_embeddings, H)),
        "layers": {
            "ln1": {"scale": ones(L, H), "bias": zeros(L, H)},
            "ln2": {"scale": ones(L, H), "bias": zeros(L, H)},
            "q": stacked(H, H), "k": stacked(H, H), "v": stacked(H, H),
            "o": stacked(H, H),
            "fc1": stacked(H, I), "fc2": stacked(I, H),
        },
        "final_layernorm": {"scale": ones(H), "bias": zeros(H)},
        "text_projection": normal((H, cfg.projection_dim)),
    }


def clip_text_embeds(params: Dict[str, Any], cfg: ClipTextConfig,
                     input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """input_ids: [B, T] (EOT = the largest id); attention_mask: [B, T],
    nonzero = a real token.  Returns the projected embeddings [B,
    projection_dim]."""
    B, T = input_ids.shape
    eps = cfg.layer_norm_eps
    device = params["token_embedding"].device
    input_ids = input_ids.to(device=device, dtype=torch.long)
    x = params["token_embedding"][input_ids]
    x = x + params["position_embedding"][None, :T]

    mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()[None]
    if attention_mask is not None:
        mask = mask & attention_mask.to(device).bool()[:, None, :]

    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    for li in range(cfg.num_hidden_layers):
        lp = {k: {n: t[li] for n, t in v.items()}
              for k, v in params["layers"].items()}
        y = _ln(lp["ln1"], x, eps)
        q, k, v = (_proj(lp[n], y).view(B, T, nh, hd) for n in "qkv")
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            / hd ** 0.5
        # a Python scalar, not a tensor made from the host: the encode is
        # captured into a CUDA graph (models/towers.TowerGraph)
        logits = torch.where(mask[:, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        x = x + _proj(lp["o"], ctx.reshape(B, T, -1).to(x.dtype))
        m = quick_gelu(_proj(lp["fc1"], _ln(lp["ln2"], x, eps)))
        x = x + _proj(lp["fc2"], m)
    x = _ln(params["final_layernorm"], x, eps)
    eot = input_ids.argmax(dim=-1)
    pooled = x[torch.arange(B, device=device), eot]
    return matmul_f32(pooled, params["text_projection"]).to(x.dtype)


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def convert_hf_clip_text(state: Dict[str, np.ndarray], cfg: ClipTextConfig,
                         dtype=torch.float32, device=None) -> Dict[str, Any]:
    """An HF CLIPTextModelWithProjection state dict (numpy; keys rooted at
    ``text_model.`` plus ``text_projection.weight``) -> the stacked tree,
    as tensors of ``dtype`` on ``device``."""
    def g(key):
        return np.asarray(state[f"text_model.{key}"], np.float32)

    L = cfg.num_hidden_layers

    def dense(fmt):
        return stacked_dense_from(g, "encoder.layers.{i}." + fmt, L)

    def ln(fmt):
        return stacked_ln_from(g, "encoder.layers.{i}." + fmt, L)

    params = {
        "token_embedding": g("embeddings.token_embedding.weight"),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "layers": {
            "ln1": ln("layer_norm1"), "ln2": ln("layer_norm2"),
            "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
            "v": dense("self_attn.v_proj"), "o": dense("self_attn.out_proj"),
            "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2"),
        },
        "final_layernorm": {"scale": g("final_layer_norm.weight"),
                            "bias": g("final_layer_norm.bias")},
        "text_projection": np.asarray(state["text_projection.weight"],
                                      np.float32).T,
    }
    return numpy_to_torch(params, dtype, device)


class ClipTextEncoder:
    """Tower-protocol wrapper: one feature token per text."""

    def __init__(self, cfg: Optional[ClipTextConfig] = None, params=None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        self.cfg = cfg or ClipTextConfig()
        if params is None:
            device = resolve_device(device)
            if generator is None:
                generator = torch.Generator(device=device)
                generator.manual_seed(0)
            params = init_clip_text(self.cfg, generator, dtype, device)
        self.params = params
        self.hidden_size = self.cfg.projection_dim
        self.feature_len = 1

    def encode(self, input_ids, attention_mask=None) -> torch.Tensor:
        """[B, T] ids (and mask) -> [B, 1, projection_dim]."""
        device = self.params["token_embedding"].device
        mask = None if attention_mask is None else torch.as_tensor(
            attention_mask, device=device)
        out = clip_text_embeds(self.params, self.cfg,
                               torch.as_tensor(input_ids, device=device),
                               mask)
        return out[:, None, :]

    @property
    def modal_processor(self):
        return None  # the caller tokenizes (HF CLIPTokenizer)
