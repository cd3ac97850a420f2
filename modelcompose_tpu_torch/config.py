"""Model configuration (the port's copy of modelcompose_tpu/config.py, held
to it by tests/test_torch_copies.py; a config.json written by either loads
in the other).

A plain dataclass (JSON-serializable, pytree-free) that carries the Llama
backbone dimensions plus all composition hyper-parameters of the reference's
``MultimodalConfig`` (reference: modelcompose/model/language_model/
multimodal_llama.py:33-61).  The TPU rebuild adds *derived* routing data:

- ``adapter_names``: the stacked-adapter axis.  Order is the reference's
  ``infer_modals`` order — ``default`` first, then ``audio``, ``vision``,
  ``video``, ``point`` (reference: modelcompose/model/multimodal_encoder/
  builder.py:121-133) — optionally followed by ``default-{modal}`` rows
  spawned by online-merge checkpoints (reference: multimodal_llama.py:92-107).
- ``routing_table``: a ``[n_route_classes, n_adapters]`` float matrix mapping
  a per-token route class to LoRA-branch weights, with the per-adapter scale
  ``alpha/r`` (times any ``reset_scaling_weights`` coefficient) folded in.
  Runtime routing is then a single gather + masked einsum instead of the
  reference's python dict dispatch (reference: multimodal_llama.py:120-160).

Route classes are a fixed enumeration (so compiled programs are shared across
compositions): 0=default/text, 1=audio, 2=vision, 3=video, 4=point.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .constants import CANONICAL_MODALITIES, DEFAULT_ADAPTER

# Fixed route-class enumeration (token -> adapter-weight row).
ROUTE_CLASSES: Tuple[str, ...] = (DEFAULT_ADAPTER,) + CANONICAL_MODALITIES
ROUTE_CLASS_INDEX: Dict[str, int] = {m: i for i, m in enumerate(ROUTE_CLASSES)}
NUM_ROUTE_CLASSES = len(ROUTE_CLASSES)


def parse_scaling_weights(spec: str) -> Dict[str, float]:
    """Parse ``"default-video=0.333,default-audio=0.333"`` style strings.

    Mirrors ``LocalLoraLinear.extract_params`` (reference:
    multimodal_llama.py:109-118).
    """
    out: Dict[str, float] = {}
    for pair in spec.split(","):
        key, value = pair.split("=")
        out[key.strip()] = float(value)
    return out


@dataclasses.dataclass(eq=False)
class ModelConfig:
    """Hashable so it can be a jit static argument."""
    # --- Llama backbone dims (Vicuna-7B v1.5 defaults) ---
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2

    # --- LoRA / composition hyper-params ---
    lora_strategy: Optional[str] = None  # None|'none'|'same'|'modal'|'modal+language'
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    local_prefix_tokens: int = 0
    local_suffix_tokens: int = 0
    # Optional per-modality overrides, e.g. {'vision': 5}
    local_modal_prefix_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)
    local_modal_suffix_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)

    # --- merge-time behavioral switches (written by the merge CLI) ---
    merge_default_weights: Optional[str] = None  # 'sum' | 'mean' | 'linear-'
    reset_scaling_weights: Optional[str] = None  # coefficient string
    # Per-modal {modal}_lora_{r,alpha} stamps the merge CLI writes into
    # config.json (reference: merge_unimodal_modelcompose.py:131-140).
    # The reference runtime DROPS these and applies the global alpha/r to
    # every adapter, silently mis-scaling heterogeneous-alpha compositions;
    # here the per-modal alpha/r ratio is honored, and a rank different
    # from lora_r raises (stacked adapters share one rank — the reference
    # would silently drop those weights at strict=False overlay).
    modal_lora_params: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    # --- modality encoder specs (presence toggles the modality) ---
    mm_vision_encoder: Optional[str] = None
    mm_audio_encoder: Optional[str] = None
    mm_video_encoder: Optional[str] = None
    mm_point_encoder: Optional[str] = None

    mm_projector_type: str = "linear"
    mm_audio_projector_type: str = "linear"
    mm_video_projector_type: str = "linear"
    mm_point_projector_type: str = "linear"

    mm_hidden_size: Optional[int] = None  # vision encoder output width
    mm_audio_hidden_size: Optional[int] = None
    mm_video_hidden_size: Optional[int] = None
    mm_point_hidden_size: Optional[int] = None

    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_video_select_layer: int = -2
    mm_video_select_feature: str = "patch"

    # --- runtime knobs (TPU rebuild specific) ---
    dtype: str = "bfloat16"
    remat: bool = False  # rematerialize decoder layers in training

    # ------------------------------------------------------------------
    # Derived composition structure
    # ------------------------------------------------------------------
    def modalities(self) -> List[str]:
        """Present modalities in canonical (reference infer_modals) order."""
        present = []
        for m in CANONICAL_MODALITIES:
            if self.encoder_spec(m) is not None:
                present.append(m)
        return present

    def encoder_spec(self, modal: str) -> Optional[str]:
        return {
            "vision": self.mm_vision_encoder,
            "audio": self.mm_audio_encoder,
            "video": self.mm_video_encoder,
            "point": self.mm_point_encoder,
        }[modal]

    def projector_type(self, modal: str) -> str:
        return {
            "vision": self.mm_projector_type,
            "audio": self.mm_audio_projector_type,
            "video": self.mm_video_projector_type,
            "point": self.mm_point_projector_type,
        }[modal]

    def projector_input_size(self, modal: str) -> int:
        size = {
            "vision": self.mm_hidden_size,
            "audio": self.mm_audio_hidden_size,
            "video": self.mm_video_hidden_size,
            "point": self.mm_point_hidden_size,
        }[modal]
        if size is None:
            raise ValueError(f"mm hidden size for modality {modal!r} is unset")
        return size

    def prefix_len(self, modal: str) -> int:
        return self.local_modal_prefix_tokens.get(modal, self.local_prefix_tokens)

    def suffix_len(self, modal: str) -> int:
        return self.local_modal_suffix_tokens.get(modal, self.local_suffix_tokens)

    def reset_scaling(self) -> Dict[str, float]:
        if self.reset_scaling_weights is None:
            return {}
        return parse_scaling_weights(self.reset_scaling_weights)

    def effective_merge_default(self) -> Optional[str]:
        """Online-merge-reset checkpoints imply the 'linear-' merge mode
        (reference: multimodal_llama.py:94-98)."""
        reset = self.reset_scaling()
        if any(k.startswith("default-") for k in reset):
            return "linear-"
        return self.merge_default_weights

    def adapter_names(self) -> List[str]:
        """The stacked-adapter axis, in parameter order."""
        names = [DEFAULT_ADAPTER] + self.modalities()
        if self.effective_merge_default() is not None:
            names += [f"default-{m}" for m in self.modalities()]
        return names

    def modal_scale(self, modal: str) -> float:
        """alpha/r for one modality, honoring merge-CLI stamps (see
        modal_lora_params).  Raises on a stamped rank != lora_r."""
        stamped = self.modal_lora_params.get(modal, {})
        r = stamped.get("r", self.lora_r)
        alpha = stamped.get("alpha", self.lora_alpha)
        if r != self.lora_r:
            raise ValueError(
                f"composed checkpoint stamps {modal}_lora_r={r} but the "
                f"runtime rank is lora_r={self.lora_r}; rank-heterogeneous "
                "compositions are not representable (the reference would "
                "silently drop these adapter weights)")
        return alpha / r

    def adapter_scales(self) -> np.ndarray:
        """Per-adapter LoRA scale alpha/r, with reset coefficients folded in
        (reference: multimodal_llama.py:99-103) and per-modal merge stamps
        honored (modal_scale)."""
        base = self.lora_alpha / self.lora_r
        reset = self.reset_scaling()
        scales = []
        for name in self.adapter_names():
            modal = name[len("default-"):] if name.startswith("default-") \
                else name
            s = self.modal_scale(modal) if modal in self.modalities() \
                else base
            scales.append(s * reset.get(name, 1.0))
        return np.asarray(scales, dtype=np.float32)

    def routing_table(self) -> np.ndarray:
        """``[NUM_ROUTE_CLASSES, n_adapters]`` LoRA-branch weights per route
        class, scales folded in.

        Semantics (reference: multimodal_llama.py:120-160):
        - modality class m -> weight ``scale_m`` on adapter m;
        - default class -> ``scale_default`` on the 'default' adapter, unless
          a merge mode is active, in which case weights land on the
          ``default-{modal}`` rows ('sum'/'linear-': scale_d; 'mean':
          scale_d / n).
        - routing for modalities without a present adapter is zero (base
          output only; reference: multimodal_llama.py:126-128).
        """
        names = self.adapter_names()
        scales = self.adapter_scales()
        index = {n: i for i, n in enumerate(names)}
        table = np.zeros((NUM_ROUTE_CLASSES, len(names)), dtype=np.float32)
        merge_mode = self.effective_merge_default()
        for ci, cls in enumerate(ROUTE_CLASSES):
            if cls == DEFAULT_ADAPTER:
                if merge_mode is None:
                    table[ci, index[DEFAULT_ADAPTER]] = scales[index[DEFAULT_ADAPTER]]
                else:
                    rows = [index[f"default-{m}"] for m in self.modalities()]
                    coef = 1.0 / max(len(rows), 1) if merge_mode == "mean" else 1.0
                    for r in rows:
                        table[ci, r] = coef * scales[r]
            elif cls in index:
                table[ci, index[cls]] = scales[index[cls]]
        return table

    def routing_active(self) -> bool:
        """Per-token modal routing is only live for these strategies
        (reference: multimodal_llama.py:703-704)."""
        return self.lora_strategy in ("modal", "modal+language")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def _key(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, ModelConfig) and self._key() == other._key()

    # ------------------------------------------------------------------
    # Serialization — stays interoperable with the reference config.json
    # key layout (per-modal prefix/suffix flattened to local_{m}_..._tokens).
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for m, v in d.pop("local_modal_prefix_tokens").items():
            d[f"local_{m}_prefix_tokens"] = v
        for m, v in d.pop("local_modal_suffix_tokens").items():
            d[f"local_{m}_suffix_tokens"] = v
        for m, stamped in d.pop("modal_lora_params").items():
            for key, v in stamped.items():
                d[f"{m}_lora_{key}"] = v
        # Only serialize per-modality keys for modalities that are present —
        # the reference's config.json omits attributes that were never set,
        # and the merge CLI's truthy union would otherwise let a default
        # 'linear' from checkpoint A clobber checkpoint B's real projector
        # spec (reference: merge_unimodal_modelcompose.py:117-123).
        per_modal_keys = {
            "vision": ["mm_projector_type", "mm_hidden_size",
                       "mm_vision_select_layer", "mm_vision_select_feature"],
            "audio": ["mm_audio_projector_type", "mm_audio_hidden_size"],
            "video": ["mm_video_projector_type", "mm_video_hidden_size",
                      "mm_video_select_layer", "mm_video_select_feature"],
            "point": ["mm_point_projector_type", "mm_point_hidden_size"],
        }
        for modal, keys in per_modal_keys.items():
            if self.encoder_spec(modal) is None:
                for key in keys:
                    d.pop(key, None)
        d["model_type"] = "multimodal"
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        d = dict(d)
        d.pop("model_type", None)
        known = {f.name for f in dataclasses.fields(cls)}
        prefix_overrides: Dict[str, int] = {}
        suffix_overrides: Dict[str, int] = {}
        modal_lora: Dict[str, Dict[str, int]] = {}
        for key in list(d.keys()):
            m = re.match(r"^(vision|audio|video|point)_lora_(r|alpha)$", key)
            if m:
                v = d.pop(key)
                if v is not None:
                    modal_lora.setdefault(m.group(1), {})[m.group(2)] = v
                continue
            m = re.match(r"^local_(\w+)_prefix_tokens$", key)
            if m and m.group(1) != "modal":
                v = d.pop(key)
                if v is not None:
                    prefix_overrides[m.group(1)] = v
                continue
            m = re.match(r"^local_(\w+)_suffix_tokens$", key)
            if m and m.group(1) != "modal":
                v = d.pop(key)
                if v is not None:
                    suffix_overrides[m.group(1)] = v
                continue
            if key not in known:
                d.pop(key)
        d["local_modal_prefix_tokens"] = prefix_overrides
        d["local_modal_suffix_tokens"] = suffix_overrides
        d["modal_lora_params"] = modal_lora
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def tiny_test_config(**overrides) -> ModelConfig:
    """A minimal config for unit tests (runs on CPU in milliseconds)."""
    defaults = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=4,
        max_position_embeddings=256,
        lora_r=4,
        lora_alpha=8,
        lora_strategy="modal+language",
        dtype="float32",
    )
    defaults.update(overrides)
    return ModelConfig(**defaults)
