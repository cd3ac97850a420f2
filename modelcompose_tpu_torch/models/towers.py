"""Modality encoder towers (counterpart of modelcompose_tpu/models/towers.py).

Each tower owns a frozen param tree and an ``encode``; a spec that names a
local checkpoint (a directory for CLIP and LanguageBind, a ``.pt`` file for
BEATs and PointBERT) loads it through the tower's converter, a ``test:``
spec builds a tiny tower, and any other spec gets random weights.
ImageBind audio and EVA vision are not ported yet and raise
``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig
from ..devices import resolve_device
from .audio_beats import BeatsAudioTower
from .point_bert import PointBertTower
from .video_languagebind import LanguageBindVideoTower
from .vision_clip import (ClipVisionConfig, clip_vision_features,
                          convert_hf_clip_vision, init_clip_vision,
                          load_hf_dir_state)


class ClipVisionTower:
    """Image tower.  Output: [B, 576, 1024] patch features for
    ViT-L/14-336 at layer -2.  Spec "test:<h>x<l>" builds a tiny tower."""

    modality = "vision"

    def __init__(self, spec: str, model_cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        select = dict(select_layer=model_cfg.mm_vision_select_layer,
                      select_feature=model_cfg.mm_vision_select_feature)
        if spec.startswith("test:"):
            h, l = spec.split(":")[1].split("x")
            self.cfg = ClipVisionConfig(
                hidden_size=int(h), intermediate_size=2 * int(h),
                num_hidden_layers=int(l), num_attention_heads=4,
                image_size=28, patch_size=14, **select)
        elif "LanguageBind_Image" in spec:
            # LanguageBind image CLIP: ViT-L/14-224, exact-GELU weights
            self.cfg = ClipVisionConfig(image_size=224, hidden_act="gelu",
                                        **select)
        else:
            self.cfg = ClipVisionConfig(**select)
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            if os.path.isdir(spec):
                params = self.load_model(dtype, device)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_clip_vision(self.cfg, generator, dtype, device)
        self.params = params

    def load_model(self, dtype=torch.float32, device=None) -> Dict[str, Any]:
        """HF CLIPVisionModel weights from the ``spec`` directory."""
        return convert_hf_clip_vision(load_hf_dir_state(self.spec), self.cfg,
                                      dtype, device)

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
        device = self.params["class_embedding"].device
        pixels = torch.as_tensor(pixels, device=device)
        return clip_vision_features(self.params, self.cfg, pixels)


def tower_class(modal: str, spec: str):
    """The tower class for one modality's encoder spec (the reference's
    dispatch rules)."""
    if modal == "vision":
        if "eva" in spec.lower():
            raise NotImplementedError(
                f"the EVA vision tower {spec!r} is not ported yet: ROADMAP "
                "Queue 1 item 7 (EVA vision)")
        return ClipVisionTower
    if modal == "audio":
        if "VideoLLaMA" in spec or "imagebind" in spec.lower():
            raise NotImplementedError(
                f"the ImageBind audio tower {spec!r} is not ported yet: "
                "ROADMAP Queue 1 item 8 (ImageBind audio)")
        return BeatsAudioTower
    if modal == "video":
        return LanguageBindVideoTower
    if modal == "point":
        return PointBertTower
    raise ValueError(f"unknown modality {modal!r}")


def build_modal_encoders(cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         device=None, dtype=torch.float32) -> Dict[str, Any]:
    """One tower per configured modality, made on ``device`` (the card when
    None): loaded where the spec names a local checkpoint, random from
    ``generator`` otherwise."""
    device = resolve_device(device)
    encoders: Dict[str, Any] = {}
    for modal in cfg.modalities():
        spec = cfg.encoder_spec(modal)
        cls = tower_class(modal, spec)
        if "test" not in spec and not os.path.exists(spec):
            warnings.warn(
                f"{modal} encoder spec {spec!r} is not a local checkpoint: "
                "tower weights are RANDOM-initialized", stacklevel=2)
        encoders[modal] = cls(spec, cfg, generator=generator, dtype=dtype,
                              device=device)
    return encoders
