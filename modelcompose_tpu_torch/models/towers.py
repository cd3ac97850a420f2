"""Modality encoder towers (counterpart of modelcompose_tpu/models/towers.py).

Each tower owns a frozen param tree and an ``encode``.  This slice ports
the CLIP image tower; the other towers and checkpoint loading are later
ROADMAP items and raise ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import torch

from modelcompose_tpu.config import ModelConfig

from .vision_clip import (ClipVisionConfig, clip_vision_features,
                          init_clip_vision)


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
            if os.path.isdir(spec):
                raise NotImplementedError(
                    "loading tower checkpoints is not ported yet: ROADMAP "
                    "Queue 1, loader + QA-loader CLI")
            if generator is None:
                generator = torch.Generator(device=device or "cpu")
                generator.manual_seed(0)
            params = init_clip_vision(self.cfg, generator, dtype, device)
        self.params = params

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def feature_len(self) -> int:
        n = self.cfg.num_patches
        return n if self.cfg.select_feature == "patch" else n + 1

    def encode(self, pixels) -> torch.Tensor:
        """pixels: [B, H, W, 3] normalized -> [B, T, hidden]."""
        device = self.params["class_embedding"].device
        pixels = torch.as_tensor(pixels, device=device)
        return clip_vision_features(self.params, self.cfg, pixels)


def build_modal_encoders(cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         device=None, dtype=torch.float32) -> Dict[str, Any]:
    """One tower per configured modality, randomly initialized."""
    encoders: Dict[str, Any] = {}
    for modal in cfg.modalities():
        spec = cfg.encoder_spec(modal)
        if modal != "vision" or "eva" in spec.lower():
            item = {"audio": "BEATs / ImageBind audio",
                    "video": "LanguageBind video", "point": "PointBERT",
                    "vision": "EVA"}[modal]
            raise NotImplementedError(
                f"the {modal} tower {spec!r} is not ported yet: ROADMAP "
                f"Queue 1, {item}")
        if "test" not in spec and not os.path.isdir(spec):
            warnings.warn(
                f"{modal} encoder spec {spec!r} is not a local directory: "
                "tower weights are RANDOM-initialized", stacklevel=2)
        encoders[modal] = ClipVisionTower(spec, cfg, generator=generator,
                                          dtype=dtype, device=device)
    return encoders
