"""DAMC training entry: flags, model and batch builders (counterpart of
modelcompose_tpu/train/train_multimodal.py).

The flags are the JAX entry's (the reference's names).  Ported:
``build_arg_parser``, ``build_model_config``, ``build_model`` with
``--random_init_backbone`` and ``--quantize_frozen_base``, and
``make_batch`` (frozen towers without gradient, the static-shape pack plan
with labels, the training buckets).  Not ported yet (ROADMAP Queue 1,
training): ``train()`` itself (dataset, collator, modality-grouped sampler,
step checkpoints, resume, adapter/projector export) and loading HF base or
stage-1 projector weights (ROADMAP Queue 1 item 2, the loader).

The stage-2 step, as the vision DAMC recipe runs it::

    args = build_arg_parser().parse_args([
        "--model_name_or_path", "vicuna-7b", "--data_path", "-",
        "--output_dir", "-", "--random_init_backbone",
        "--mm_vision_encoder", "openai/clip-vit-large-patch14-336",
        "--mm_projector_type", "mlp2x_gelu", "--mm_vision_select_layer", "-2",
        "--lora_strategy", "modal+language", "--lora_r", "128",
        "--lora_alpha", "256", "--local_prefix_tokens", "5",
        "--local_suffix_tokens", "5", "--gradient_checkpointing", "True"])
    cfg = build_model_config(args)
    model = build_model(args, cfg, device="cuda")
    batch, layout = make_batch(model, collated)
    tc = TrainConfig(learning_rate=2e-4, mm_projector_lr=2e-5,
                     mm_language_lr=1e-5, warmup_ratio=0.0)
    tx, _ = make_optimizer(cfg, tc, {"backbone": model.params,
                                     "projectors": model.projectors})
    state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
    state, loss = make_train_step(cfg, tc, tx)(state, batch, layout)
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import MODAL_TOKEN_INDEXES
from ..core.llama import init_params, torch_dtype
from ..core.packing import TRAIN_BUCKETS, pick_bucket, plan_pack
from ..devices import resolve_device
from ..models.model import MultimodalLM
from ..models.projectors import init_projector, output_len
from ..models.towers import build_modal_encoders
from ..ops.quant import quantize_backbone


def _flag(s: str) -> bool:
    return s == "True"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DAMC multimodal training")
    # ModelArguments
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--version", type=str, default="v0")
    p.add_argument("--tune_mm_mlp_adapter", type=_flag, default=False)
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None)
    p.add_argument("--mm_vision_encoder", type=str, default=None)
    p.add_argument("--mm_audio_encoder", type=str, default=None)
    p.add_argument("--mm_video_encoder", type=str, default=None)
    p.add_argument("--mm_point_encoder", type=str, default=None)
    p.add_argument("--mm_projector_type", type=str, default="linear")
    p.add_argument("--mm_audio_projector_type", type=str, default="linear")
    p.add_argument("--mm_video_projector_type", type=str, default="linear")
    p.add_argument("--mm_point_projector_type", type=str, default="linear")
    p.add_argument("--mm_vision_select_layer", type=int, default=-1)
    p.add_argument("--mm_video_select_layer", type=int, default=-1)
    p.add_argument("--mm_vision_select_feature", type=str, default="patch")
    p.add_argument("--local_prefix_tokens", type=int, default=0)
    p.add_argument("--local_suffix_tokens", type=int, default=0)
    # DataArguments
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--image_aspect_ratio", type=str, default="square")
    # TrainingArguments
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--mm_projector_lr", type=float, default=None)
    p.add_argument("--mm_language_lr", type=float, default=None)
    p.add_argument("--mm_vision_tower_lr", type=float, default=None)
    p.add_argument("--mm_vision_tower_layerwise_lr_decay", type=float,
                   default=1.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--lora_strategy", type=str, default=None)
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--group_by_modality_length", type=_flag, default=False)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--bf16", type=_flag, default=True)
    p.add_argument("--gradient_checkpointing", type=_flag, default=False,
                   help="recompute decoder layers in the backward (the "
                        "reference recipes pass True)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_init_backbone", action="store_true",
                   help="random base weights instead of loading them")
    p.add_argument("--quantize_frozen_base", type=_flag, default=False,
                   help="int8-quantize the frozen base weights (requires a "
                        "lora_strategy or stage 1)")
    p.add_argument("--loss_chunk", type=int, default=None,
                   help="compute the CE loss in N-position chunks with "
                        "recomputed logits")
    p.add_argument("--adam_mu_dtype", type=str, default=None,
                   help="dtype of the Adam first moments (e.g. bfloat16)")
    p.add_argument("--tower_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="parameter dtype of FROZEN towers (a trained vision "
                        "tower, --mm_vision_tower_lr, stays float32)")
    return p


def build_model_config(args) -> ModelConfig:
    cfg_kwargs: Dict[str, Any] = dict(
        lora_strategy=args.lora_strategy, lora_r=args.lora_r,
        lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
        local_prefix_tokens=args.local_prefix_tokens,
        local_suffix_tokens=args.local_suffix_tokens,
        mm_vision_encoder=args.mm_vision_encoder,
        mm_audio_encoder=args.mm_audio_encoder,
        mm_video_encoder=args.mm_video_encoder,
        mm_point_encoder=args.mm_point_encoder,
        mm_projector_type=args.mm_projector_type,
        mm_audio_projector_type=args.mm_audio_projector_type,
        mm_video_projector_type=args.mm_video_projector_type,
        mm_point_projector_type=args.mm_point_projector_type,
        mm_vision_select_layer=args.mm_vision_select_layer,
        mm_vision_select_feature=args.mm_vision_select_feature,
        mm_video_select_layer=args.mm_video_select_layer,
        dtype="bfloat16" if args.bf16 else "float32",
        remat=getattr(args, "gradient_checkpointing", False),
    )
    base_cfg_path = os.path.join(args.model_name_or_path, "config.json")
    if os.path.exists(base_cfg_path):
        with open(base_cfg_path) as f:
            base = json.load(f)
        for key in ("vocab_size", "hidden_size", "intermediate_size",
                    "num_hidden_layers", "num_attention_heads",
                    "num_key_value_heads", "max_position_embeddings",
                    "rms_norm_eps", "rope_theta"):
            if key in base:
                cfg_kwargs[key] = base[key]
    return ModelConfig(**cfg_kwargs)


def build_model(args, cfg: ModelConfig, device=None) -> MultimodalLM:
    """Towers, backbone and projectors made on ``device`` from a generator
    seeded with ``--seed``; the towers' hidden sizes are written into
    ``cfg``."""
    if not args.random_init_backbone:
        raise NotImplementedError(
            "loading HF base weights is not ported yet: ROADMAP Queue 1 item "
            "2 (loader); pass --random_init_backbone")
    if args.pretrain_mm_mlp_adapter:
        raise NotImplementedError(
            "loading a stage-1 projector is not ported yet: ROADMAP Queue 1 "
            "item 2 (loader)")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    # a TRAINED tower keeps float32 weights (they join the optimizer)
    tower_dtype = torch.float32 \
        if getattr(args, "mm_vision_tower_lr", None) is not None \
        else torch_dtype(getattr(args, "tower_dtype", "bfloat16"))
    encoders = build_modal_encoders(cfg, gen, device, dtype=tower_dtype)
    for modal, enc in encoders.items():
        setter = {"vision": "mm_hidden_size", "audio": "mm_audio_hidden_size",
                  "video": "mm_video_hidden_size",
                  "point": "mm_point_hidden_size"}[modal]
        setattr(cfg, setter, enc.hidden_size)
    params = init_params(cfg, gen, device)
    if getattr(args, "quantize_frozen_base", False) and (
            cfg.lora_strategy is not None or args.tune_mm_mlp_adapter):
        params = quantize_backbone(params)
    projectors = {
        modal: init_projector(cfg.projector_type(modal), gen,
                              encoders[modal].hidden_size, cfg.hidden_size,
                              dtype=torch_dtype(cfg.dtype), device=device)
        for modal in cfg.modalities()}
    return MultimodalLM(cfg, params, encoders, projectors)


def make_batch(model: MultimodalLM, collated: Dict[str, Any],
               buckets=TRAIN_BUCKETS, tower_train: bool = False):
    """Collator output ({'input_ids', 'labels': lists of 1-D arrays,
    'modal_inputs': {modal: raw}}) -> (batch of tensors on the model's
    device, feat_layout).  The frozen towers run here, without gradient;
    with ``tower_train`` the vision pixels stay raw and the CLIP forward
    runs inside the step."""
    device = model.device
    feats: Dict[str, Any] = {}
    tower_pixels = {}
    for modal, raw in collated.get("modal_inputs", {}).items():
        if modal == "vision" and tower_train:
            tower_pixels[modal] = torch.as_tensor(raw, device=device)
            feats[modal] = None  # span accounting below; not pre-encoded
            continue
        feats[modal] = model.encode_tower(modal, raw)
    spans = {}
    for modal, f in feats.items():
        span = model.feature_span_len(modal)
        n = int(tower_pixels[modal].shape[0]) if f is None else \
            int(f.shape[0])
        spans[modal] = (n, span)
        if f is not None:
            t = int(f.shape[1])
            expect = span - model.cfg.prefix_len(modal) \
                - model.cfg.suffix_len(modal)
            got = output_len(model.cfg.projector_type(modal), t)
            if got != expect:
                raise ValueError(
                    f"{modal} encoder emitted {t} tokens -> projector output "
                    f"{got}, but the packing span expects {expect}")
    # Each placeholder is replaced by its span: span - 1 more positions.
    total = max((len(ids) + sum(
        (spans[m][1] - 1) * int((np.asarray(ids) ==
                                 MODAL_TOKEN_INDEXES[m]).sum())
        for m in spans) for ids in collated["input_ids"]), default=8)
    plan = plan_pack(collated["input_ids"], spans, labels=collated["labels"],
                     bucket_len=pick_bucket(total, buckets))

    def dev(a):
        return torch.as_tensor(a, device=device)

    batch = {
        "encoder_features": {m: f for m, f in feats.items() if f is not None},
        "token_ids": dev(plan.token_ids),
        "feat_idx": dev(plan.feat_idx),
        "is_feat": dev(plan.is_feat),
        "route_ids": dev(plan.route_ids),
        "labels": dev(plan.labels),
        "segment_ids": dev(plan.segment_ids),
    }
    if tower_pixels:
        batch["tower_pixels"] = tower_pixels
    return batch, tuple(plan.feat_layout)
