"""BEATs audio encoder, iter3+ AS2M class (counterpart of
modelcompose_tpu/models/audio_beats.py).

fbank [B, N, 128] -> 16x16 conv patch embedding (512) -> LayerNorm ->
projection to 768 -> a 12-layer post-LN transformer with

- a convolutional positional embedding (grouped conv, kernel 128, 16
  groups, weight-normed; the even kernel's trailing step is trimmed; exact
  GELU) added residually,
- a T5-style bucketed relative position bias shared by every layer (320
  buckets, max distance 800), gated per layer from an 8-way projection of
  the raw queries (``gru_rel_pos``),
- deep-norm residual scaling, alpha = (2L)^(1/4).

Layers are stacked on a leading axis, as in the JAX package; the layer loop
is eager.  Each line keeps the JAX function's dtype flow: products
accumulate in fp32 and activations keep the input's dtype.  The
checkpoint converter reads the public BEATs ``.pt`` layout (fairseq keys,
weight-norm ``weight_g``/``weight_v`` pairs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..tree import numpy_to_torch
from .vision_clip import _ln, _proj, stacked_dense_from, stacked_ln_from


@dataclasses.dataclass(frozen=True)
class BeatsConfig:
    input_patch_size: int = 16
    embed_dim: int = 512
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    deep_norm: bool = True
    layer_norm_first: bool = False
    fbank_bins: int = 128

    @property
    def deep_norm_alpha(self) -> float:
        return float((2 * self.encoder_layers) ** 0.25) if self.deep_norm \
            else 1.0

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads


def relative_position_bucket(relative_positions: torch.Tensor,
                             num_buckets: int, max_distance: int
                             ) -> torch.Tensor:
    """T5 bidirectional buckets.  The log term is an fp32 value truncated
    to int, with fp32 constants, as the JAX function computes it (the
    buckets agree with it over +-4096)."""
    num_buckets = num_buckets // 2
    buckets = (relative_positions > 0).to(torch.int32) * num_buckets
    rel = relative_positions.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_if_large = max_exact + (
        torch.log(rel.float() / max_exact)
        / np.float32(np.log(max_distance / max_exact))
        * np.float32(num_buckets - max_exact)).to(torch.int32)
    rel_if_large = torch.clamp_max(rel_if_large, num_buckets - 1)
    return buckets + torch.where(is_small, rel.to(torch.int32), rel_if_large)


def compute_position_bias(rel_bias_table: torch.Tensor, q_len: int,
                          k_len: int, num_buckets: int, max_distance: int
                          ) -> torch.Tensor:
    """rel_bias_table: [num_buckets, H] -> bias [H, q_len, k_len]."""
    device = rel_bias_table.device
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    buckets = relative_position_bucket(mem - ctx, num_buckets, max_distance)
    return rel_bias_table[buckets.long()].permute(2, 0, 1)


def init_beats(cfg: BeatsConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    E, H, Fd = cfg.embed_dim, cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
    L, P = cfg.encoder_layers, cfg.input_patch_size

    def normal(shape, std=0.02):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return {"w": normal((d_in, d_out)), "b": zeros(d_out)}

    def stacked(d_in, d_out):
        return {"w": normal((L, d_in, d_out)), "b": zeros(L, d_out)}

    def stacked_ln(d):
        return {"scale": ones(L, d), "bias": zeros(L, d)}

    return {
        "patch_embedding": normal((P, P, 1, E)),  # HWIO
        "layer_norm": {"scale": ones(E), "bias": zeros(E)},
        "post_extract_proj": dense(E, H),
        # the effective (weight-normed) grouped conv weight, [k, H/g, H]
        "pos_conv": {"w": normal((cfg.conv_pos, H // cfg.conv_pos_groups,
                                  H)),
                     "b": zeros(H)},
        "encoder_layer_norm": {"scale": ones(H), "bias": zeros(H)},
        "rel_bias": normal((cfg.num_buckets, cfg.encoder_attention_heads)),
        "layers": {
            "q": stacked(H, H), "k": stacked(H, H), "v": stacked(H, H),
            "o": stacked(H, H),
            "grep_linear": stacked(cfg.head_dim, 8),
            "grep_a": ones(L, 1, cfg.encoder_attention_heads, 1, 1),
            "self_attn_ln": stacked_ln(H),
            "fc1": stacked(H, Fd), "fc2": stacked(Fd, H),
            "final_ln": stacked_ln(H),
        },
    }


def _pos_conv(params, x: torch.Tensor, cfg: BeatsConfig) -> torch.Tensor:
    """Grouped conv positional embedding: fp32 accumulation, the even
    kernel's trailing output step dropped, exact GELU.  The JAX weight
    [k, H/g, H] is torch's [H, H/g, k]."""
    w = params["pos_conv"]["w"]
    conv = F.conv1d(x.to(w.dtype).float().transpose(1, 2),
                    w.float().permute(2, 1, 0),
                    padding=cfg.conv_pos // 2,
                    groups=cfg.conv_pos_groups).transpose(1, 2).to(x.dtype)
    conv = conv + params["pos_conv"]["b"]
    if cfg.conv_pos % 2 == 0:
        conv = conv[:, :-1]
    return F.gelu(conv)


def beats_extract_features(params: Dict[str, Any], cfg: BeatsConfig,
                           fbank: torch.Tensor,
                           padding_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """fbank: [B, N, bins] normalized; padding_mask: [B, N] bool (True =
    pad).  Returns (features [B, T, H], padding mask [B, T] True = pad, or
    None)."""
    B = fbank.shape[0]
    P = cfg.input_patch_size
    w = params["patch_embedding"]
    feats = F.conv2d(fbank.to(w.dtype).float()[:, None],
                     w.float().permute(3, 2, 0, 1), stride=P)  # [B, E, n1, n2]
    # token order (n1, n2) row-major, as the reference's channel-major
    # flatten and transpose give it
    feats = feats.permute(0, 2, 3, 1).reshape(B, -1, w.shape[-1])
    feats = _ln(params["layer_norm"], feats.to(fbank.dtype), 1e-5)

    new_padding = None
    if padding_mask is not None:
        T = feats.shape[1]
        extra = padding_mask.shape[1] % T
        if extra > 0:
            padding_mask = padding_mask[:, :-extra]
        new_padding = padding_mask.reshape(B, T, -1).all(-1)

    x = _proj(params["post_extract_proj"], feats)
    if new_padding is not None:
        x = torch.where(new_padding[..., None], torch.zeros_like(x), x)
    x = x + _pos_conv(params, x, cfg)
    if not cfg.layer_norm_first:
        x = _ln(params["encoder_layer_norm"], x, 1e-5)

    T = x.shape[1]
    nh, hd = cfg.encoder_attention_heads, cfg.head_dim
    bias = compute_position_bias(
        params["rel_bias"].float(), T, T, cfg.num_buckets,
        cfg.max_distance) if cfg.relative_position_embedding else None
    alpha = cfg.deep_norm_alpha
    layers = params["layers"]
    for li in range(cfg.encoder_layers):
        lp = {k: (v[li] if isinstance(v, torch.Tensor)
                  else {n: t[li] for n, t in v.items()})
              for k, v in layers.items()}
        q = _proj(lp["q"], x).view(B, T, nh, hd)
        k = _proj(lp["k"], x).view(B, T, nh, hd)
        v = _proj(lp["v"], x).view(B, T, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        if new_padding is not None:
            logits = logits.masked_fill(new_padding[:, None, None, :],
                                        float("-inf"))
        if bias is not None:
            if cfg.gru_rel_pos:
                # gates from the raw queries
                gate_in = _proj(lp["grep_linear"], q.transpose(1, 2))
                gates = torch.sigmoid(gate_in.view(B, nh, T, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0], gates[..., 1]
                grep_a = lp["grep_a"].reshape(1, nh, 1)
                gate_a_1 = gate_a * (gate_b * grep_a - 1.0) + 2.0
                logits = logits + gate_a_1[..., None] * bias[None]
            else:
                logits = logits + bias[None]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        attn = _proj(lp["o"], ctx.reshape(B, T, nh * hd).to(x.dtype))
        x = _ln(lp["self_attn_ln"], x * alpha + attn, 1e-5)
        h = _proj(lp["fc2"], F.gelu(_proj(lp["fc1"], x)))
        x = _ln(lp["final_ln"], x * alpha + h, 1e-5)
    return x, new_padding


def convert_beats_checkpoint(state: Dict[str, np.ndarray], cfg: BeatsConfig,
                             dtype=torch.float32, device=None
                             ) -> Dict[str, Any]:
    """A public BEATs state dict (numpy) -> the stacked tree, as tensors of
    ``dtype`` on ``device``."""
    def g(k):
        return np.asarray(state[k], np.float32)

    L = cfg.encoder_layers

    def stack_dense(fmt):
        return stacked_dense_from(g, fmt, L)

    def stack_ln(fmt):
        return stacked_ln_from(g, fmt, L)

    # weight-normed pos_conv: effective w = v * g / ||v|| over dims (0, 1)
    if "encoder.pos_conv.0.weight_g" in state:
        wg, wv = g("encoder.pos_conv.0.weight_g"), \
            g("encoder.pos_conv.0.weight_v")
    else:
        wg = g("encoder.pos_conv.0.parametrizations.weight.original0")
        wv = g("encoder.pos_conv.0.parametrizations.weight.original1")
    norm = np.sqrt((wv ** 2).sum(axis=(0, 1), keepdims=True))
    w_eff = wv * wg / np.maximum(norm, 1e-12)   # [out, in/g, k]

    params = {
        "patch_embedding": g("patch_embedding.weight").transpose(2, 3, 1, 0),
        "layer_norm": {"scale": g("layer_norm.weight"),
                       "bias": g("layer_norm.bias")},
        "post_extract_proj": {"w": g("post_extract_proj.weight").T,
                              "b": g("post_extract_proj.bias")},
        "pos_conv": {"w": w_eff.transpose(2, 1, 0),
                     "b": g("encoder.pos_conv.0.bias")},
        "encoder_layer_norm": {"scale": g("encoder.layer_norm.weight"),
                               "bias": g("encoder.layer_norm.bias")},
        "rel_bias": g(
            "encoder.layers.0.self_attn.relative_attention_bias.weight"),
        "layers": {
            "q": stack_dense("encoder.layers.{i}.self_attn.q_proj"),
            "k": stack_dense("encoder.layers.{i}.self_attn.k_proj"),
            "v": stack_dense("encoder.layers.{i}.self_attn.v_proj"),
            "o": stack_dense("encoder.layers.{i}.self_attn.out_proj"),
            "grep_linear": stack_dense(
                "encoder.layers.{i}.self_attn.grep_linear"),
            "grep_a": np.stack([g(f"encoder.layers.{i}.self_attn.grep_a")
                                for i in range(L)]),
            "self_attn_ln": stack_ln(
                "encoder.layers.{i}.self_attn_layer_norm"),
            "fc1": stack_dense("encoder.layers.{i}.fc1"),
            "fc2": stack_dense("encoder.layers.{i}.fc2"),
            "final_ln": stack_ln("encoder.layers.{i}.final_layer_norm"),
        },
    }
    return numpy_to_torch(params, dtype, device)


def _config_from_checkpoint(raw: Dict[str, Any]) -> BeatsConfig:
    fields = {f.name for f in dataclasses.fields(BeatsConfig)} - {
        "fbank_bins"}
    return BeatsConfig(**{k: v for k, v in raw.items() if k in fields})


class BeatsAudioTower:
    """Audio tower.  ``encode`` returns (features [B, T, 768], valid mask
    [B, T] True = valid, or None): BEATs' padding convention inverted, as
    the reference's wrapper does."""

    modality = "audio"

    def __init__(self, spec: str, model_cfg=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        if spec.startswith("test:"):
            h, l = spec.split(":")[1].split("x")
            self.cfg = BeatsConfig(
                input_patch_size=4, embed_dim=int(h), encoder_layers=int(l),
                encoder_embed_dim=int(h), encoder_ffn_embed_dim=2 * int(h),
                encoder_attention_heads=4, conv_pos=8, conv_pos_groups=4,
                num_buckets=32, max_distance=64, fbank_bins=8)
        else:
            self.cfg = BeatsConfig()
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            if os.path.isfile(spec):
                params = self.load_model(dtype, device)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_beats(self.cfg, generator, dtype, device)
        self.params = params

    def load_model(self, dtype=torch.float32, device=None) -> Dict[str, Any]:
        """A public BEATs ``.pt`` (a torch pickle with 'cfg' and 'model'):
        sets ``cfg`` from the file and returns the converted params."""
        ckpt = torch.load(self.spec, map_location="cpu", weights_only=False)
        self.cfg = _config_from_checkpoint(ckpt.get("cfg", {}))
        state = {k: v.float().numpy() for k, v in ckpt["model"].items()}
        return convert_beats_checkpoint(state, self.cfg, dtype, device)

    @property
    def hidden_size(self) -> int:
        return self.cfg.encoder_embed_dim

    @property
    def feature_len(self) -> int:
        # one eval-mode 512-frame window -> (512/P) * (bins/P) tokens
        P = self.cfg.input_patch_size
        return (512 // P) * (self.cfg.fbank_bins // P)

    @property
    def modal_processor(self):
        from ..data.audio_processing import BeatsAudioProcessor
        return BeatsAudioProcessor(num_mel_bins=self.cfg.fbank_bins)

    def encode(self, audio_inputs, audio_padding_mask=None):
        device = self.params["patch_embedding"].device
        pad = None if audio_padding_mask is None else torch.as_tensor(
            audio_padding_mask, device=device, dtype=torch.bool)
        feats, pad = beats_extract_features(
            self.params, self.cfg, torch.as_tensor(audio_inputs,
                                                   device=device), pad)
        return feats, None if pad is None else ~pad
