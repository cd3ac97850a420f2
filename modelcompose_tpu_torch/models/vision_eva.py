"""EVA-CLIP vision tower, EVA01-g and EVA02-L families (counterpart of
modelcompose_tpu/models/vision_eva.py).

The two released towers differ in their blocks:

- **EVA02-CLIP-L-14-336**: separate q/k/v projections with q and v biases
  (k has none), an inner-attention LayerNorm before ``proj`` and an FFN
  LayerNorm after the SwiGLU product (``subln``), a SwiGLU FFN of width
  ``int(hidden * 2.6667)``, and a 2D rotary embedding over the patch grid:
  interleaved pairs are rotated (not the Llama half split), row and column
  frequencies each fill half of ``head_dim``, and the grid is interpolated
  onto ``pt_hw_seq_len=16`` positions; the CLS token is not rotated.
- **EVA01-CLIP-g-14**: a fused ``qkv`` in the checkpoint (split into q/k/v
  by the converter), a plain exact-GELU MLP, no rope, no subln.

Layers are stacked on a leading axis, as in the JAX package, and only the
layers up to the ``select_layer`` tap run; ``select_feature='patch'`` drops
CLS.  Pixels are NHWC.  Attention is plain PyTorch: the JAX tower's is an
einsum softmax, not a Pallas kernel.  Each line keeps the JAX function's
dtype flow: products accumulate in fp32, activations keep the weights'
dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..compose.state_io import load_state
from ..devices import resolve_device
from ..ops.quant import matmul_f32
from ..tree import numpy_to_torch


@dataclasses.dataclass(frozen=True)
class EvaVisionConfig:
    hidden_size: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 2.6667
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True          # q/v biases (k bias is always absent)
    use_rope: bool = True
    pt_hw_seq_len: int = 16
    intp_freq: bool = True
    swiglu: bool = True            # SwiGLU FFN vs plain GELU MLP
    subln: bool = False            # inner_attn_ln + ffn_ln
    postnorm: bool = False
    select_layer: int = -2
    select_feature: str = "patch"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def ffn_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


PRESETS = {
    "EVA02-CLIP-L-14-336": EvaVisionConfig(
        hidden_size=1024, depth=24, num_heads=16, mlp_ratio=2.6667,
        image_size=336, patch_size=14, qkv_bias=True, use_rope=True,
        pt_hw_seq_len=16, intp_freq=True, swiglu=True, subln=True),
    "EVA01-CLIP-g-14": EvaVisionConfig(
        hidden_size=1408, depth=40, num_heads=16, mlp_ratio=4.3637,
        image_size=224, patch_size=14, qkv_bias=True, use_rope=False,
        swiglu=False, subln=False),
    "EVA01-CLIP-g-14-336": EvaVisionConfig(
        hidden_size=1408, depth=40, num_heads=16, mlp_ratio=4.3637,
        image_size=336, patch_size=14, qkv_bias=True, use_rope=False,
        swiglu=False, subln=False),
}


# ---------------------------------------------------------------------------
# 2D vision rope
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rope_tables_np(cfg: EvaVisionConfig):
    half = cfg.head_dim // 2  # each of the row and column halves
    n_freq = half // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, half, 2)[:n_freq] / half))
    g = cfg.grid
    if cfg.intp_freq:
        t = np.arange(g, dtype=np.float64) / g * cfg.pt_hw_seq_len
    else:
        t = np.arange(g, dtype=np.float64)
    fg = np.einsum("i,j->ij", t, freqs)          # [g, n_freq]
    fg = np.repeat(fg, 2, axis=-1)               # interleave: f0,f0,f1,f1
    # position (i, j) -> concat(row_i freqs, col_j freqs)
    full = np.concatenate(
        [np.broadcast_to(fg[:, None, :], (g, g, half)),
         np.broadcast_to(fg[None, :, :], (g, g, half))], axis=-1)
    full = full.reshape(g * g, cfg.head_dim)
    return (np.cos(full).astype(np.float32),
            np.sin(full).astype(np.float32))


def vision_rope_tables(cfg: EvaVisionConfig, device=None):
    """fp32 (cos, sin), each [num_patches, head_dim]: row and column
    positions each get head_dim/2 from head_dim/4 frequencies, every one
    used by an interleaved pair."""
    cos, sin = _rope_tables_np(cfg)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(-x2, x1) over INTERLEAVED pairs, not the Llama half split."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _apply_vision_rope(t, cos, sin):
    """t: [B, H, N_patches, D]; cos/sin: [N_patches, D] fp32."""
    return t.float() * cos + _rotate_half_interleaved(t).float() * sin


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_eva_vision(cfg: EvaVisionConfig, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Dict[str, Any]:
    H, L, Fd = cfg.hidden_size, cfg.depth, cfg.ffn_hidden
    std = 0.02

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stacked(d_in, d_out, bias=True):
        p = {"w": normal((L, d_in, d_out))}
        if bias:
            p["b"] = zeros(L, d_out)
        return p

    def lnp(d=H):
        return {"scale": ones(L, d), "bias": zeros(L, d)}

    layers = {"norm1": lnp(), "norm2": lnp(),
              "q": stacked(H, H, bias=cfg.qkv_bias),
              "k": stacked(H, H, bias=False),
              "v": stacked(H, H, bias=cfg.qkv_bias),
              "proj": stacked(H, H)}
    if cfg.swiglu:
        layers.update(w1=stacked(H, Fd), w2=stacked(H, Fd),
                      w3=stacked(Fd, H))
    else:
        layers.update(fc1=stacked(H, Fd), fc2=stacked(Fd, H))
    if cfg.subln:
        layers.update(inner_attn_ln=lnp(), ffn_ln=lnp(Fd))
    return {
        "cls_token": zeros(H),
        "patch_embedding": normal((cfg.patch_size, cfg.patch_size,
                                   cfg.num_channels, H)),  # HWIO
        "patch_bias": zeros(H),
        "position_embedding": normal((cfg.num_patches + 1, H)),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ln(p, x, eps):
    """LayerNorm in the activations' dtype, as the JAX tower's (the CLIP
    towers' ``_ln`` computes in fp32)."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _dense(p, x):
    """The bias, where there is one, added after the cast (the CLIP towers'
    ``_proj`` adds it in fp32)."""
    y = matmul_f32(x, p["w"]).to(x.dtype)
    return y + p["b"] if "b" in p else y


def _attention(cfg: EvaVisionConfig, lp, h, rope):
    B, N, _ = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim

    def heads(t):
        return t.view(B, N, nh, hd).transpose(1, 2)  # [B, nh, N, hd]
    q, k, v = (heads(_dense(lp[n], h)) for n in ("q", "k", "v"))
    if rope is not None:  # the CLS token (index 0) is not rotated
        cos, sin = rope
        q = torch.cat([q[:, :, :1].float(),
                       _apply_vision_rope(q[:, :, 1:], cos, sin)],
                      dim=2).to(v.dtype)
        k = torch.cat([k[:, :, :1].float(),
                       _apply_vision_rope(k[:, :, 1:], cos, sin)],
                      dim=2).to(v.dtype)
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) \
        * hd ** -0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bhmd->bhnd", probs.float(), v.float())
    out = out.to(h.dtype).transpose(1, 2).reshape(B, N, -1)
    if cfg.subln:
        out = _ln(lp["inner_attn_ln"], out, cfg.layer_norm_eps)
    return _dense(lp["proj"], out)


def _ffn(cfg: EvaVisionConfig, lp, h):
    if cfg.swiglu:
        hidden = F.silu(_dense(lp["w1"], h)) * _dense(lp["w2"], h)
        out = "w3"
    else:
        hidden = F.gelu(_dense(lp["fc1"], h))
        out = "fc2"
    if cfg.subln:
        hidden = _ln(lp["ffn_ln"], hidden, cfg.layer_norm_eps)
    return _dense(lp[out], hidden)


def eva_vision_features(params: Dict[str, Any], cfg: EvaVisionConfig,
                        pixels: torch.Tensor, rope=None) -> torch.Tensor:
    """pixels: [B, H_img, W_img, 3] normalized.  Returns the selected
    hidden state [B, num_patches(+1), hidden].  ``rope``: the
    ``vision_rope_tables`` on the pixels' device (built here when None)."""
    B = pixels.shape[0]
    H = cfg.hidden_size
    eps = cfg.layer_norm_eps
    dtype = params["cls_token"].dtype

    weight = params["patch_embedding"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    patches = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2), weight,
                       stride=cfg.patch_size)
    x = patches.permute(0, 2, 3, 1).reshape(B, -1, H) + params["patch_bias"]
    x = torch.cat([params["cls_token"].expand(B, 1, H), x], dim=1)
    x = x + params["position_embedding"]

    if cfg.use_rope and rope is None:
        rope = vision_rope_tables(cfg, x.device)
    elif not cfg.use_rope:
        rope = None
    # hidden state k is the output after k blocks (k = 0: the embeddings);
    # only the blocks up to the tap run
    idx = cfg.select_layer % (cfg.depth + 1)
    for li in range(idx):
        lp = {k: {n: t[li] for n, t in v.items()}
              for k, v in params["layers"].items()}
        if cfg.postnorm:
            x = x + _ln(lp["norm1"], _attention(cfg, lp, x, rope), eps)
            x = x + _ln(lp["norm2"], _ffn(cfg, lp, x), eps)
        else:
            x = x + _attention(cfg, lp, _ln(lp["norm1"], x, eps), rope)
            x = x + _ffn(cfg, lp, _ln(lp["norm2"], x, eps))
    if cfg.select_feature == "patch":
        return x[:, 1:]
    return x


# ---------------------------------------------------------------------------
# Checkpoint conversion (EVA visual.* torch key layout)
# ---------------------------------------------------------------------------

def convert_eva_vision(state: Dict[str, np.ndarray], cfg: EvaVisionConfig,
                       dtype=torch.float32, device=None) -> Dict[str, Any]:
    """An EVA ViT state dict (numpy; keys as in the released towers, with
    or without a ``visual.`` prefix; a fused ``qkv`` split into q/k/v) ->
    the stacked tree, as tensors of ``dtype`` on ``device``."""
    def g(key):
        for k in (key, f"visual.{key}"):
            if k in state:
                return np.asarray(state[k], np.float32)
        raise KeyError(key)

    def has(key):
        return key in state or f"visual.{key}" in state

    L = cfg.depth

    def stack(fmt, transpose=True):
        ws = [g(fmt.format(i=i)) for i in range(L)]
        return np.stack([w.T if transpose else w for w in ws])

    def stacked_dense(name):
        return {"w": stack(f"blocks.{{i}}.{name}.weight"),
                "b": stack(f"blocks.{{i}}.{name}.bias", transpose=False)}

    def stacked_ln(name):
        return {"scale": stack(f"blocks.{{i}}.{name}.weight",
                               transpose=False),
                "bias": stack(f"blocks.{{i}}.{name}.bias", transpose=False)}

    layers: Dict[str, Any] = {"norm1": stacked_ln("norm1"),
                              "norm2": stacked_ln("norm2"),
                              "proj": stacked_dense("attn.proj")}
    if has("blocks.0.attn.qkv.weight"):  # fused (EVA01 family)
        # [3H, H] per layer -> q, k, v of [H, H], transposed to [in, out]
        qkv = [np.split(g(f"blocks.{i}.attn.qkv.weight"), 3, axis=0)
               for i in range(L)]
        for j, name in enumerate("qkv"):
            layers[name] = {"w": np.stack([parts[j].T for parts in qkv])}
    else:  # separate projections (subln / EVA02 family)
        for name in "qkv":
            layers[name] = {"w": stack(f"blocks.{{i}}.attn.{name}_proj"
                                       ".weight")}
    if cfg.qkv_bias:
        layers["q"]["b"] = stack("blocks.{i}.attn.q_bias", transpose=False)
        layers["v"]["b"] = stack("blocks.{i}.attn.v_bias", transpose=False)
    if cfg.swiglu:
        layers.update(w1=stacked_dense("mlp.w1"), w2=stacked_dense("mlp.w2"),
                      w3=stacked_dense("mlp.w3"))
    else:
        layers.update(fc1=stacked_dense("mlp.fc1"),
                      fc2=stacked_dense("mlp.fc2"))
    if cfg.subln:
        layers.update(inner_attn_ln=stacked_ln("attn.inner_attn_ln"),
                      ffn_ln=stacked_ln("mlp.ffn_ln"))
    params = {
        "cls_token": g("cls_token").reshape(-1),
        # torch conv [out, in, kh, kw] -> HWIO
        "patch_embedding": g("patch_embed.proj.weight")
            .transpose(2, 3, 1, 0),
        "patch_bias": g("patch_embed.proj.bias"),
        "position_embedding": g("pos_embed")[0],
        "layers": layers,
    }
    return numpy_to_torch(params, dtype, device)


# ---------------------------------------------------------------------------
# Tower
# ---------------------------------------------------------------------------

class EvaVisionTower:
    """Image tower for specs naming 'eva' (any case).  Output: [B, 576,
    1024] patch features for EVA02-L-14-336 at layer -2.  Spec
    "eva-test:<h>x<l>" builds a tiny tower; a spec that is a local file
    loads it (``.pt`` torch pickle, safetensors, npz)."""

    modality = "vision"

    def __init__(self, spec: str, model_cfg,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        self.cfg = dataclasses.replace(
            self._preset_for(spec),
            select_layer=model_cfg.mm_vision_select_layer,
            select_feature=model_cfg.mm_vision_select_feature)
        if spec.startswith("eva-test:"):
            h, l = spec.split(":")[1].split("x")
            self.cfg = dataclasses.replace(
                self.cfg, hidden_size=int(h), depth=int(l), num_heads=2,
                image_size=28, patch_size=14, mlp_ratio=2.0,
                pt_hw_seq_len=2)
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            if os.path.exists(spec):
                params = self.load_model(dtype, device)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_eva_vision(self.cfg, generator, dtype, device)
        self.params = params
        self._rope = {}  # (cfg, device) -> vision_rope_tables, at first use

    @staticmethod
    def _preset_for(spec: str) -> EvaVisionConfig:
        """The JAX package's rule, as it stands: an EVA02 name, else a 336
        EVA01 name, else an EVA01 or ``eva_clip_g`` name; anything else
        (``eva-vit-g`` among them) falls to the EVA02-L default."""
        if "EVA02_CLIP_L_336_psz14_s6B" in spec or "EVA02" in spec:
            return PRESETS["EVA02-CLIP-L-14-336"]
        if "336" in spec and "EVA01" in spec:
            return PRESETS["EVA01-CLIP-g-14-336"]
        if "EVA01" in spec or "eva_clip_g" in spec.lower():
            return PRESETS["EVA01-CLIP-g-14"]
        return PRESETS["EVA02-CLIP-L-14-336"]

    def load_model(self, dtype=torch.float32, device=None) -> Dict[str, Any]:
        """The EVA checkpoint file at ``spec``, converted."""
        return convert_eva_vision(load_state(self.spec), self.cfg, dtype,
                                  device)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def feature_len(self) -> int:
        n = self.cfg.num_patches
        return n if self.cfg.select_feature == "patch" else n + 1

    @property
    def modal_processor(self):
        from ..data.image_processing import ClipImageProcessor
        return ClipImageProcessor(size=self.cfg.image_size)

    def encode(self, pixels) -> torch.Tensor:
        """pixels: [B, H, W, 3] normalized -> [B, T, hidden]."""
        device = self.params["cls_token"].device
        rope = None
        if self.cfg.use_rope:
            key = (self.cfg, device)
            if key not in self._rope:
                self._rope[key] = vision_rope_tables(self.cfg, device)
            rope = self._rope[key]
        return eva_vision_features(self.params, self.cfg,
                                   torch.as_tensor(pixels, device=device),
                                   rope)
