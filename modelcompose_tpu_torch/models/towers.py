"""Modality encoder towers (counterpart of modelcompose_tpu/models/towers.py).

Each tower owns a frozen param tree and an ``encode``; a spec that names a
local checkpoint (a directory for CLIP and LanguageBind, a file for EVA,
BEATs and PointBERT, a file or a directory holding ``imagebind_huge.pth``
for ImageBind) loads it through the tower's converter, a ``test:`` spec
(``eva-test:``, ``imagebind-test:``) builds a tiny tower, and any other
spec gets random weights.

``TowerGraphs`` runs a tower's ``encode`` as a captured CUDA graph (the
port's counterpart of each JAX tower's jitted ``_encode``): one
``TowerGraph`` per tower, input shapes and dtypes and grad mode, captured
at its second call (the capture rules of ``core/decode_graph.CapturedStep``)
and replayed after; on a CPU tensor the same encode runs eagerly into the
same buffers.  Inside a capture PointBERT's farthest-point sampling loop is
captured with the rest (models/point_bert).  The projectors and soft tokens
stay eager: they train, and are small.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..core.decode_graph import CapturedStep, GraphLRU, SharedPool
from ..devices import resolve_device
from ..tree import tree_leaves
from .audio_beats import BeatsAudioTower
from .audio_imagebind import ImageBindAudioTower
from .point_bert import PointBertTower
from .video_languagebind import LanguageBindVideoTower
from .vision_eva import EvaVisionTower
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
        return EvaVisionTower if "eva" in spec.lower() else ClipVisionTower
    if modal == "audio":
        if "VideoLLaMA" in spec or "imagebind" in spec.lower():
            return ImageBindAudioTower
        return BeatsAudioTower
    if modal == "video":
        return LanguageBindVideoTower
    if modal == "point":
        return PointBertTower
    raise ValueError(f"unknown modality {modal!r}")


def build_modal_encoders(cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         device=None, dtype=torch.float32,
                         dtype_per_modal: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """One tower per configured modality, made on ``device`` (the card when
    None): loaded where the spec names a local checkpoint, random from
    ``generator`` otherwise.  ``dtype`` is every tower's parameter dtype;
    ``dtype_per_modal`` overrides it for the named modalities (a trained
    tower keeps float32 weights while the frozen towers beside it keep
    ``dtype``)."""
    device = resolve_device(device)
    encoders: Dict[str, Any] = {}
    for modal in cfg.modalities():
        mdt = (dtype_per_modal or {}).get(modal, dtype)
        spec = cfg.encoder_spec(modal)
        cls = tower_class(modal, spec)
        if "test" not in spec and not os.path.exists(spec):
            warnings.warn(
                f"{modal} encoder spec {spec!r} is not a local checkpoint: "
                "tower weights are RANDOM-initialized", stacklevel=2)
        encoders[modal] = cls(spec, cfg, generator=generator, dtype=mdt,
                              device=device)
    return encoders


TOWER_GRAPHS = 8  # the tower graphs a model keeps


def _tower_device(tower) -> torch.device:
    return next(tree_leaves(tower.params))[1].device


def _on_device(x, device):
    """A tower input on ``device``: arrays and tensors moved there, other
    values (None, a flag) as they are."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def _spec(x):
    """What a graph's static buffer fixes of an input."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return x


def _clone(out):
    if isinstance(out, tuple):
        return tuple(None if t is None else t.clone() for t in out)
    return out.clone()


class TowerGraph(CapturedStep):
    """One tower's ``encode`` over static input buffers of fixed shapes;
    captured at its second call on the card.  It keeps the param tree it
    was made with, so the leaf ids in its key stay its own."""

    capture_at = 2
    captures = 0
    replays = 0

    def __init__(self, tower, args, kwargs, shared=None):
        super().__init__(_tower_device(tower), shared)
        self.tower, self.params = tower, tower.params

        def static(x):
            return torch.empty_like(x) if isinstance(x, torch.Tensor) else x
        self.args = tuple(static(a) for a in args)
        self.kwargs = {k: static(v) for k, v in kwargs.items()}

    def __call__(self, args, kwargs):
        """The encode of these inputs, copied out of the static outputs."""
        pairs = list(zip(self.args, args)) + [
            (self.kwargs[k], v) for k, v in kwargs.items()]
        for dst, src in pairs:
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        return _clone(self.run())

    def _step(self):
        return self.tower.encode(*self.args, **self.kwargs)


class TowerGraphs:
    """At most ``limit`` tower graphs, the least recently used dropped
    first, captured into one ``SharedPool``; one caller at a time runs one
    (a lock: the serving engines may encode from two threads)."""

    def __init__(self, limit: int = TOWER_GRAPHS):
        self._graphs = GraphLRU(limit)
        self._lock = threading.Lock()
        self.shared = SharedPool()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()

    def encode(self, tower, *args, **kwargs):
        """``tower.encode(*args, **kwargs)`` through the graph of these
        input shapes (inputs moved to the tower's device first): a fresh
        copy of its output."""
        device = _tower_device(tower)
        args = tuple(_on_device(a, device) for a in args)
        kwargs = {k: _on_device(v, device) for k, v in kwargs.items()}
        key = (id(tower), getattr(tower, "cfg", None),
               tuple(id(leaf) for _, leaf in tree_leaves(tower.params)),
               tuple(_spec(a) for a in args),
               tuple((k, _spec(v)) for k, v in sorted(kwargs.items())),
               torch.is_inference_mode_enabled())
        with self._lock:
            graph = self._graphs.get_or_make(
                key, lambda: TowerGraph(tower, args, kwargs, self.shared))
            return graph(args, kwargs)
