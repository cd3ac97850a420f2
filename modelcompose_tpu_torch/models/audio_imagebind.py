"""ImageBind audio tower, the alternative audio path taken for specs naming
``VideoLLaMA`` or ``imagebind`` (counterpart of
modelcompose_tpu/models/audio_imagebind.py):

  mel-spectrogram clips [B, S, 1, 128 mels, 204 frames]
    -> Conv2d patch stem (k=16, s=10, no bias) + LayerNorm (eps 1e-5)
    -> cls token + learned position embedding
    -> 12 pre-norm blocks (768 wide, 12 heads, exact GELU, LayerNorm eps
       1e-6; ``add_bias_kv``: one learned key and value position appended
       after the N tokens, so N + 1 keys)
    -> head LayerNorm -> CLS -> projection 768 -> 1024 (no bias)
    -> L2 normalize (floor 1e-12) x logit scale 20
  returns [B, S, 1024], one embedding per clip.

Layers are stacked on a leading axis, as in the JAX package.  Attention is
plain PyTorch (the JAX tower's is an einsum softmax).  The host processor
is a copy of the JAX one (numpy): three 2 s clips starting at
i * (duration - 2) / 3, each mean-centred, a Hanning-window kaldi fbank,
padded or cropped to 204 frames, normalized by ImageBind's constants.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..compose.state_io import load_state
from ..devices import resolve_device
from ..ops.quant import matmul_f32
from ..tree import numpy_to_torch
from .vision_eva import _dense, _ln


@dataclasses.dataclass(frozen=True)
class ImageBindAudioConfig:
    embed_dim: int = 768
    num_blocks: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_mel_bins: int = 128
    target_len: int = 204
    kernel_size: int = 16
    stride: int = 10
    out_embed_dim: int = 1024
    logit_scale: float = 20.0
    stem_ln_eps: float = 1e-5   # the stem's LayerNorm
    block_ln_eps: float = 1e-6  # the blocks' and the head's
    clip_duration: float = 2.0
    clips_per_audio: int = 3
    sample_rate: int = 16000
    norm_mean: float = -4.268
    norm_std: float = 9.138

    @property
    def grid(self):
        gh = (self.num_mel_bins - self.kernel_size) // self.stride + 1
        gw = (self.target_len - self.kernel_size) // self.stride + 1
        return gh, gw

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw


def init_imagebind_audio(cfg: ImageBindAudioConfig,
                         generator: torch.Generator, dtype=torch.float32,
                         device=None) -> Dict[str, Any]:
    E, L, Fd = cfg.embed_dim, cfg.num_blocks, cfg.mlp_ratio * cfg.embed_dim

    def normal(shape, std=0.02):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stacked(d_in, d_out):
        return {"w": normal((L, d_in, d_out)), "b": zeros(L, d_out)}

    def lnp(*lead):
        return {"scale": ones(*lead, E), "bias": zeros(*lead, E)}

    return {
        "patch_embedding": normal((cfg.kernel_size, cfg.kernel_size, 1, E)),
        "stem_ln": lnp(),
        "cls_token": normal((E,), E ** -0.5),
        "position_embedding": normal((cfg.num_patches + 1, E), E ** -0.5),
        "layers": {
            "norm1": lnp(L), "norm2": lnp(L),
            # torch MultiheadAttention's packed in_proj, as [E, 3E]
            "in_proj": stacked(E, 3 * E),
            "bias_k": zeros(L, E),
            "bias_v": zeros(L, E),
            "out_proj": stacked(E, E),
            "fc1": stacked(E, Fd),
            "fc2": stacked(Fd, E),
        },
        "head_ln": lnp(),
        "head_proj": normal((E, cfg.out_embed_dim)),
    }


def _block(cfg: ImageBindAudioConfig, lp, h):
    n, N, E = h.shape
    nh = cfg.num_heads
    hd = E // nh
    y = _ln(lp["norm1"], h, cfg.block_ln_eps)
    q, k, v = _dense(lp["in_proj"], y).split(E, dim=-1)
    # add_bias_kv: one learned key and value position after the N tokens
    k = torch.cat([k, lp["bias_k"].expand(n, 1, E)], dim=1)
    v = torch.cat([v, lp["bias_v"].expand(n, 1, E)], dim=1)
    q = q.reshape(n, N, nh, hd).transpose(1, 2)
    k = k.reshape(n, N + 1, nh, hd).transpose(1, 2)
    v = v.reshape(n, N + 1, nh, hd).transpose(1, 2)
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) \
        * hd ** -0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.einsum("bhnm,bhmd->bhnd", probs.float(), v.float())
    attn = attn.to(h.dtype).transpose(1, 2).reshape(n, N, E)
    h = h + _dense(lp["out_proj"], attn)
    y = _ln(lp["norm2"], h, cfg.block_ln_eps)
    return h + _dense(lp["fc2"], F.gelu(_dense(lp["fc1"], y)))


def imagebind_audio_features(params: Dict[str, Any],
                             cfg: ImageBindAudioConfig,
                             melspec: torch.Tensor) -> torch.Tensor:
    """melspec: [B, S, 1, mels, frames] (clips) or [B, 1, mels, frames].
    Returns [B, S, out_embed_dim] (or [B, out_embed_dim])."""
    clips = melspec.dim() == 5
    x = melspec
    if clips:
        B, S = x.shape[:2]
        x = x.reshape((B * S,) + tuple(x.shape[2:]))
    n = x.shape[0]
    E = cfg.embed_dim
    dtype = params["cls_token"].dtype

    weight = params["patch_embedding"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    patches = F.conv2d(x.to(dtype), weight, stride=cfg.stride)  # NCHW
    tokens = patches.permute(0, 2, 3, 1).reshape(n, -1, E)
    tokens = _ln(params["stem_ln"], tokens, cfg.stem_ln_eps)
    tokens = torch.cat([params["cls_token"].expand(n, 1, E), tokens], dim=1)
    tokens = tokens + params["position_embedding"]

    for li in range(cfg.num_blocks):
        lp = {k: (v[li] if isinstance(v, torch.Tensor)
                  else {m: t[li] for m, t in v.items()})
              for k, v in params["layers"].items()}
        tokens = _block(cfg, lp, tokens)

    # head: LN -> CLS -> projection; then L2 normalize x logit scale
    cls_out = _ln(params["head_ln"], tokens, cfg.block_ln_eps)[:, 0]
    out = matmul_f32(cls_out, params["head_proj"])
    out = out / torch.clamp_min(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)
    out = (cfg.logit_scale * out).to(dtype)
    if clips:
        out = out.reshape(B, S, -1)
    return out


# ---------------------------------------------------------------------------
# Checkpoint conversion (imagebind_huge.pth audio keys)
# ---------------------------------------------------------------------------

def convert_imagebind_audio(state: Dict[str, np.ndarray],
                            cfg: ImageBindAudioConfig, dtype=torch.float32,
                            device=None) -> Dict[str, Any]:
    """The audio keys of an ``imagebind_huge.pth`` state dict (numpy; the
    other modalities' keys are ignored) -> the stacked tree, as tensors of
    ``dtype`` on ``device``."""
    def g(key):
        return np.asarray(state[key], np.float32)

    pre = "modality_preprocessors.audio"
    trunk = "modality_trunks.audio.blocks"
    L = cfg.num_blocks

    def stack(fmt, transpose=True):
        ws = [g(fmt.format(i=i)) for i in range(L)]
        return np.stack([w.T if transpose else w for w in ws])

    def stacked_dense(name):
        return {"w": stack(f"{trunk}.{{i}}.{name}.weight"),
                "b": stack(f"{trunk}.{{i}}.{name}.bias", transpose=False)}

    def stacked_ln(name):
        return {"scale": stack(f"{trunk}.{{i}}.{name}.weight",
                               transpose=False),
                "bias": stack(f"{trunk}.{{i}}.{name}.bias",
                              transpose=False)}

    params = {
        "patch_embedding": g(f"{pre}.rgbt_stem.proj.weight")
            .transpose(2, 3, 1, 0),  # [E, 1, k, k] -> HWIO
        "stem_ln": {"scale": g(f"{pre}.rgbt_stem.norm_layer.weight"),
                    "bias": g(f"{pre}.rgbt_stem.norm_layer.bias")},
        "cls_token": g(f"{pre}.cls_token").reshape(-1),
        "position_embedding":
            g(f"{pre}.pos_embedding_helper.pos_embed")[0],
        "layers": {
            "norm1": stacked_ln("norm_1"),
            "norm2": stacked_ln("norm_2"),
            "in_proj": {"w": stack(f"{trunk}.{{i}}.attn.in_proj_weight"),
                        "b": stack(f"{trunk}.{{i}}.attn.in_proj_bias",
                                   transpose=False)},
            "bias_k": np.stack([g(f"{trunk}.{i}.attn.bias_k").reshape(-1)
                                for i in range(L)]),
            "bias_v": np.stack([g(f"{trunk}.{i}.attn.bias_v").reshape(-1)
                                for i in range(L)]),
            "out_proj": stacked_dense("attn.out_proj"),
            "fc1": stacked_dense("mlp.fc1"),
            "fc2": stacked_dense("mlp.fc2"),
        },
        "head_ln": {"scale": g("modality_heads.audio.0.weight"),
                    "bias": g("modality_heads.audio.0.bias")},
        "head_proj": g("modality_heads.audio.2.weight").T,
    }
    return numpy_to_torch(params, dtype, device)


# ---------------------------------------------------------------------------
# Host processor (a copy of the JAX package's)
# ---------------------------------------------------------------------------

class ImageBindAudioProcessor:
    """waveform -> [clips, 1, mels, target_len] normalized melspec."""

    def __init__(self, cfg: Optional[ImageBindAudioConfig] = None):
        self.cfg = cfg or ImageBindAudioConfig()

    def _clip_starts(self, duration: float):
        """pytorchvideo ConstantClipsPerVideoSampler semantics (the
        reference's sampler, ImageBind data.py:129): start_i =
        i * (duration - clip_duration) / clips_per_video — the divisor is
        clips_per_video, NOT clips-1 (endpoint-inclusive spacing sampled
        different waveform segments: 0/4/8 s instead of 0/2.67/5.33 s on
        a 10 s clip)."""
        c = self.cfg
        span = max(duration - c.clip_duration, 0.0)
        return [span * i / c.clips_per_audio
                for i in range(c.clips_per_audio)]

    def process_one(self, waveform: np.ndarray) -> np.ndarray:
        from ..data.audio_processing import kaldi_fbank
        c = self.cfg
        waveform = np.asarray(waveform, np.float32).reshape(-1)
        duration = len(waveform) / c.sample_rate
        clips = []
        for start in self._clip_starts(duration):
            s = int(start * c.sample_rate)
            e = int((start + c.clip_duration) * c.sample_rate)
            wclip = waveform[s:e]
            wclip = wclip - wclip.mean()  # reference: data.py:29
            fb = kaldi_fbank(wclip * (1 << 15), c.num_mel_bins,
                             c.sample_rate,
                             window_type="hanning")  # [T, mels]
            fb = fb.T  # [mels, T]
            p = c.target_len - fb.shape[1]
            if p > 0:
                fb = np.pad(fb, ((0, 0), (0, p)))
            elif p < 0:
                fb = fb[:, :c.target_len]
            clips.append(fb[None])  # [1, mels, target]
        out = np.stack(clips).astype(np.float32)
        return (out - c.norm_mean) / c.norm_std

    def __call__(self, waveforms) -> np.ndarray:
        if isinstance(waveforms, np.ndarray) and waveforms.ndim == 1:
            waveforms = [waveforms]
        return np.stack([self.process_one(w) for w in waveforms])


# ---------------------------------------------------------------------------
# Tower
# ---------------------------------------------------------------------------

class ImageBindAudioTower:
    """Audio tower for specs naming ``VideoLLaMA`` or ``imagebind``.
    ``encode`` returns [B, clips, 1024], one row per 2 s clip.  Spec
    "imagebind-test:<e>x<l>" builds a tiny tower; a spec that is an
    ``imagebind_huge.pth`` file, or a directory holding one, loads it."""

    modality = "audio"

    def __init__(self, spec: str, model_cfg=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        cfg = ImageBindAudioConfig()
        if spec.startswith("imagebind-test:"):
            e, l = spec.split(":")[1].split("x")
            cfg = dataclasses.replace(cfg, embed_dim=int(e),
                                      num_blocks=int(l), num_heads=2,
                                      num_mel_bins=32, target_len=46,
                                      out_embed_dim=int(e))
        self.cfg = cfg
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            ckpt = os.path.join(spec, "imagebind_huge.pth") \
                if os.path.isdir(spec) else spec
            if os.path.exists(ckpt):
                params = self.load_model(dtype, device, ckpt)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_imagebind_audio(cfg, generator, dtype, device)
        self.params = params

    def load_model(self, dtype=torch.float32, device=None,
                   ckpt_path: Optional[str] = None) -> Dict[str, Any]:
        """The audio weights of an ``imagebind_huge.pth`` (``spec`` when no
        path is given), converted."""
        return convert_imagebind_audio(load_state(ckpt_path or self.spec),
                                       self.cfg, dtype, device)

    @property
    def hidden_size(self) -> int:
        return self.cfg.out_embed_dim

    @property
    def feature_len(self) -> int:
        return self.cfg.clips_per_audio  # one embedding per clip

    @property
    def modal_processor(self):
        return ImageBindAudioProcessor(self.cfg)

    def encode(self, melspec) -> torch.Tensor:
        device = self.params["cls_token"].device
        return imagebind_audio_features(
            self.params, self.cfg, torch.as_tensor(melspec, device=device))
