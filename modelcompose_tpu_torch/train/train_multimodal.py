"""DAMC training entry (counterpart of
modelcompose_tpu/train/train_multimodal.py): stage-1 projector pretrain
(``--tune_mm_mlp_adapter True``) and stage-2 DAMC finetune
(``--lora_strategy modal+language``), with the reference's flag names,
modality-grouped length sampling, the warmup + cosine schedule with
per-group rates, static-shape bucketed packing, step checkpoints with
resume, and the adapter_model / mm_projector exports in the reference key
layout.

One process trains on one device.  Under ``torchrun`` (an initialized
process group, ``parallel.distributed``) the run is data-parallel with
ZeRO-1 moments, as the JAX entry runs on its data mesh: the global batch
is ``--per_device_train_batch_size`` x the data width, every rank draws
the same global order and collates its ``local_batch_slice`` of each
global batch, and the primary rank alone writes checkpoints and exports::

    torchrun --nproc-per-node 4 -m modelcompose_tpu_torch.train.train_multimodal ...

DAMC stage 2 on point clouds, as ``run_finetune_point_damc.sh`` runs it::

    python -m modelcompose_tpu_torch.train.train_multimodal \\
        --model_name_or_path ckpts/vicuna-7b-v1.5 --version v1 \\
        --data_path data/point_train.json --output_dir out/point-multimodal \\
        --mm_point_encoder point_bert_v1.2.pt \\
        --mm_point_projector_type mlp2x_gelu \\
        --pretrain_mm_mlp_adapter out/point-stage1/mm_projector.bin \\
        --lora_strategy modal+language --lora_r 128 --lora_alpha 256 \\
        --local_prefix_tokens 5 --local_suffix_tokens 5 \\
        --learning_rate 2e-4 --mm_projector_lr 2e-5 --mm_language_lr 1e-5 \\
        --per_device_train_batch_size 4 --bf16 True \\
        --gradient_checkpointing True

The CLI runs on the card and loads the base's tokenizer (``transformers``);
``train(args, tokenizer=..., device=...)`` takes both from the caller.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..compose.convert import hf_llama_to_params, projector_from_reference
from ..compose.state_io import load_state
from ..config import ModelConfig
from ..constants import MODAL_TOKEN_INDEXES
from ..core.llama import (init_params, init_soft_tokens, reinit_lora_a,
                          torch_dtype)
from ..core.packing import TRAIN_BUCKETS, pick_bucket, plan_pack
from ..data import conversation as conversation_lib
from ..data.dataset import DataCollatorForSupervisedDataset, MultimodalDataset
from ..data.loader import PrefetchLoader
from ..devices import resolve_device
from ..models.loader import load_hf_llama_dir, load_tokenizer
from ..models.model import MultimodalLM
from ..models.projectors import init_projector, output_len
from ..models.towers import ClipVisionTower, build_modal_encoders
from ..ops.quant import quantize_backbone
from ..parallel import distributed
from ..parallel.mesh import mesh_for_batch
from .checkpoint import (latest_checkpoint, restore_step_checkpoint,
                         save_adapter_checkpoint, save_full_checkpoint,
                         save_projector_checkpoint, save_step_checkpoint)
from .sampler import (get_length_grouped_indices,
                      get_modality_length_grouped_indices)
from .trainer import (TrainConfig, init_train_state, make_grad_and_apply,
                      make_optimizer, make_train_step, scale_grads)


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


def _frozen_base(args, cfg: ModelConfig) -> bool:
    """The base weights stay frozen: a LoRA strategy, or stage 1."""
    return cfg.lora_strategy is not None or args.tune_mm_mlp_adapter


def build_model(args, cfg: ModelConfig, device=None) -> MultimodalLM:
    """Towers, backbone and projectors on ``device`` (the card when None);
    the towers' hidden sizes are written into ``cfg``.  Random weights come
    from one generator seeded with ``--seed``, drawn in this order: towers,
    then backbone (or LoRA A), then projectors.

    The backbone is random with ``--random_init_backbone``; otherwise it is
    the HF Llama base at ``--model_name_or_path`` in ``cfg.dtype``, with
    zero soft tokens for the configured modalities, as a random backbone
    has them (the JAX entry leaves them out of a loaded base) and, where
    the adapters train (a LoRA strategy outside stage 1), fresh kaiming
    LoRA A.  ``--quantize_frozen_base`` int8-quantizes the dense
    base weights where they are frozen.  ``--pretrain_mm_mlp_adapter`` (a
    stage-1 ``mm_projector`` export) replaces the random projector of each
    modality it holds."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    # a TRAINED vision tower keeps float32 weights (they join the
    # optimizer); the frozen towers beside it keep --tower_dtype
    overrides = {"vision": torch.float32} \
        if getattr(args, "mm_vision_tower_lr", None) is not None else None
    encoders = build_modal_encoders(
        cfg, gen, device,
        dtype=torch_dtype(getattr(args, "tower_dtype", "bfloat16")),
        dtype_per_modal=overrides)
    for modal, enc in encoders.items():
        setter = {"vision": "mm_hidden_size", "audio": "mm_audio_hidden_size",
                  "video": "mm_video_hidden_size",
                  "point": "mm_point_hidden_size"}[modal]
        setattr(cfg, setter, enc.hidden_size)
    if args.random_init_backbone:
        params = init_params(cfg, gen, device)
    else:
        params = hf_llama_to_params(load_hf_llama_dir(args.model_name_or_path),
                                    cfg, device=device)
        params.update(init_soft_tokens(cfg, device))
        if cfg.lora_strategy not in (None, "none") \
                and not args.tune_mm_mlp_adapter:
            # the converter's LoRA is zero, and A = B = 0 gets zero
            # gradients forever: peft's kaiming A
            params = reinit_lora_a(params, gen)
    if args.quantize_frozen_base and _frozen_base(args, cfg):
        params = quantize_backbone(params)
    dtype = torch_dtype(cfg.dtype)
    projectors = {
        modal: init_projector(cfg.projector_type(modal), gen,
                              encoders[modal].hidden_size, cfg.hidden_size,
                              dtype=dtype, device=device)
        for modal in cfg.modalities()}
    if args.pretrain_mm_mlp_adapter:
        state = load_state(args.pretrain_mm_mlp_adapter)
        for modal in cfg.modalities():
            prefix = f"model.modal_projectors.{modal}"
            if any(k.startswith(prefix) for k in state):
                projectors[modal] = projector_from_reference(
                    cfg.projector_type(modal), state, prefix, dtype, device)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, tokenizer=None, device=None,
          time_skip: int = 0) -> Dict[str, Any]:
    """Train on one device (the card when ``device`` is None; each rank's
    own under a process group, data-parallel), then export by stage:
    ``mm_projector`` (stage 1), ``adapter_model`` (a LoRA strategy) or the
    full backbone (``lora_strategy`` absent).  A rank the data mesh leaves
    idle returns ``{"idle": True, ...}`` at once.

    ``--max_steps``, ``--save_steps`` and the warmup count optimizer steps
    (HF semantics), each ``--gradient_accumulation_steps`` micro-batches.
    A ``checkpoint-*`` in ``--output_dir`` is resumed from: the run
    regenerates each consumed epoch's order from the same seed and skips
    the trained batches.  Losses stay on the device until logging and the
    end, so the loop never waits for a step to finish.

    Returns the JAX entry's keys: ``losses`` (per micro-batch),
    ``final_loss``, ``steps`` (micro-batches), ``optimizer_steps`` and
    ``train_loop_seconds`` (the loop, synchronized at its end); with
    ``time_skip`` N > 0 also ``steady_seconds``, ``steady_steps`` and
    ``steady_bucket_tokens`` over the micro-batches after the first N,
    between two synchronizations.  And: ``setup_seconds`` (call to the
    loop), ``export_seconds``, ``resumed_from`` and ``start_step`` (the
    optimizer step restored), ``positions`` (per micro-batch, the packed
    positions that are not padding) and ``loop_trace`` (per micro-batch,
    the host seconds of the loader wait, ``make_batch`` and the step's
    dispatch)."""
    t_call = time.perf_counter()
    device = resolve_device(device)
    conversation_lib.default_conversation = \
        conversation_lib.conv_templates[args.version]
    cfg = build_model_config(args)
    if args.quantize_frozen_base and not _frozen_base(args, cfg):
        raise ValueError(
            "--quantize_frozen_base requires frozen base weights "
            "(a lora_strategy, or stage-1 --tune_mm_mlp_adapter)")
    model = build_model(args, cfg, device)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_name_or_path)
    tokenizer.model_max_length = args.model_max_length
    dataset = MultimodalDataset(args.data_path, tokenizer)
    collator = DataCollatorForSupervisedDataset(
        tokenizer, model.modal_processors(),
        {"vision": {"image_aspect_ratio": args.image_aspect_ratio}})

    # HF flag semantics: the global batch is per-device x data width (the
    # reference's bs 16 x 8 GPUs = 128); a dataset smaller than that
    # shrinks the data width (ranks idle, loudly), as the JAX entry does.
    world = distributed.world_size()
    per_dev = args.per_device_train_batch_size
    accum = max(args.gradient_accumulation_steps, 1)
    n = len(dataset)
    data_width = world
    if n < per_dev * data_width:
        data_width = max(n // per_dev, 1)
        if world > 1:
            print(f"[train] WARNING: dataset has {n} samples < {per_dev}/"
                  f"device x {world} processes; shrinking the data-parallel "
                  f"width to {data_width}", flush=True)
    B = per_dev * data_width
    if n < B:
        raise ValueError(f"dataset has {n} samples < the batch {B}: the "
                         "epoch loader would yield zero batches")
    mesh = mesh_for_batch(B, allow_partial=True) \
        if distributed.is_initialized() else None
    if mesh is not None and not mesh.active:
        print(f"[train] rank {distributed.rank()} idle: the data mesh has "
              f"{mesh.data} processes", flush=True)
        return {"idle": True, "losses": [], "steps": 0}
    local = slice(0, B) if mesh is None else \
        distributed.local_batch_slice(B, mesh.data_rank, mesh.data)
    steps_per_epoch = max(n // (B * accum), 1)
    total_steps = args.max_steps if args.max_steps > 0 else \
        int(steps_per_epoch * args.num_train_epochs)
    tc = TrainConfig(
        learning_rate=args.learning_rate,
        mm_projector_lr=args.mm_projector_lr,
        mm_language_lr=args.mm_language_lr,
        mm_vision_tower_lr=args.mm_vision_tower_lr,
        mm_vision_tower_layerwise_lr_decay=(
            args.mm_vision_tower_layerwise_lr_decay),
        warmup_ratio=args.warmup_ratio, total_steps=total_steps,
        weight_decay=args.weight_decay,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        loss_chunk=args.loss_chunk, adam_mu_dtype=args.adam_mu_dtype)

    tower_train = tc.mm_vision_tower_lr is not None \
        and "vision" in model.encoders
    if tower_train and not isinstance(model.encoders["vision"],
                                      ClipVisionTower):
        # the layerwise decay walks the CLIP layout (as the reference walks
        # vision_model.encoder.layers, llava_trainer.py:98-132)
        raise NotImplementedError(
            "--mm_vision_tower_lr supports the CLIP vision tower only "
            f"(got {type(model.encoders['vision']).__name__})")
    tower_params = {"vision": model.encoders["vision"].params} \
        if tower_train else None
    vision_cfg = model.encoders["vision"].cfg if tower_train else None
    train_tree = {"backbone": model.params, "projectors": model.projectors}
    if tower_params is not None:
        train_tree["towers"] = tower_params
    tx, _ = make_optimizer(cfg, tc, train_tree, mesh)
    state = init_train_state(cfg, tc, model.params, model.projectors,
                             tower_params=tower_params, tx=tx)
    if accum > 1:
        grad_fn, apply_fn, _, grad_accum_fn = make_grad_and_apply(
            cfg, tc, tx, vision_tower_cfg=vision_cfg)
        # One running gradient total (the sum so far, added to in place),
        # never a list of per-micro-batch gradients.
        acc: Dict[str, Any] = {"total": None, "n": 0}

        def step_fn(state, batch, layout):
            if acc["total"] is None:
                loss, acc["total"] = grad_fn(state.params, batch, layout)
            else:
                loss, acc["total"] = grad_accum_fn(state.params, acc["total"],
                                                   batch, layout)
            acc["n"] += 1
            if acc["n"] < accum:
                return state, loss  # state unchanged mid-window
            total = scale_grads(acc["total"], 1.0 / accum)
            acc["total"], acc["n"] = None, 0
            return apply_fn(state, total), loss
    else:
        step_fn = make_train_step(cfg, tc, tx, vision_tower_cfg=vision_cfg)

    resume = latest_checkpoint(args.output_dir)
    if resume:
        print(f"[train] resuming from {resume}", flush=True)
        restore_step_checkpoint(resume, state, tx)

    rng = np.random.default_rng(args.seed)
    # state.step counts optimizer steps, the loop micro-batches
    start_opt = state.step
    start_step = step_idx = to_skip = start_opt * accum
    total_micro = total_steps * accum
    losses, positions, trace = [], [], []
    t_steady = None
    steady_tokens = 0  # bucket positions of the steady window
    setup_seconds = time.perf_counter() - t_call
    t0 = time.perf_counter()
    while step_idx < total_micro:
        if args.group_by_modality_length:
            order = get_modality_length_grouped_indices(
                dataset.modality_lengths, B, 1, rng)
        else:
            order = get_length_grouped_indices(
                [abs(l) for l in dataset.modality_lengths], B, 1, rng)
        if to_skip:  # resume: epochs and batches trained before
            epoch_batches = max((len(order) - B) // B + 1, 0)
            if to_skip >= epoch_batches:
                to_skip -= epoch_batches
                continue
            order = order[to_skip * B:]
            to_skip = 0
        # this rank's slice of each whole global batch
        order = [int(i) for b in range(len(order) // B)
                 for i in order[b * B:(b + 1) * B][local]]
        loader = PrefetchLoader(dataset, order, local.stop - local.start,
                                collator,
                                num_workers=args.dataloader_num_workers,
                                prefetch=4)
        t_mark = time.perf_counter()
        for collated in loader:
            if step_idx >= total_micro:
                break
            t_a = time.perf_counter()
            batch, layout = make_batch(model, collated,
                                       tower_train=tower_train)
            t_b = time.perf_counter()
            state, loss = step_fn(state, batch, layout)
            t_c = time.perf_counter()
            trace.append({"loader_wait": t_a - t_mark,
                          "make_batch": t_b - t_a, "dispatch": t_c - t_b})
            t_mark = t_c
            step_idx += 1
            if t_steady is not None:
                steady_tokens += batch["token_ids"].numel()
            losses.append(loss)
            positions.append((batch["segment_ids"] != 0).sum())
            if time_skip and step_idx == start_step + time_skip:
                _sync(device)
                t_steady = time.perf_counter()
            if step_idx % (args.logging_steps * accum) == 0 \
                    and distributed.is_primary():
                avg = np.mean([float(l) for l in
                               losses[-args.logging_steps * accum:]])
                rate = (step_idx - start_step) / (time.perf_counter() - t0)
                print(f"[train] step {step_idx // accum}/{total_steps} "
                      f"loss {avg:.4f} ({rate:.2f} it/s)", flush=True)
            # save on optimizer-step boundaries only: a mid-window save
            # would drop the running gradient total on resume
            if args.save_steps and step_idx % (args.save_steps * accum) == 0:
                save_step_checkpoint(args.output_dir, step_idx // accum,
                                     state, tx)
    _sync(device)
    t_loop_end = time.perf_counter()
    losses = [float(l) for l in losses]

    t_export = time.perf_counter()
    backbone = state.params["backbone"]
    projectors = state.params["projectors"]
    if not distributed.is_primary():
        pass
    elif args.tune_mm_mlp_adapter:
        save_projector_checkpoint(args.output_dir, cfg, projectors)
    elif cfg.lora_strategy is None:
        save_full_checkpoint(args.output_dir, cfg, backbone, projectors)
    else:
        save_adapter_checkpoint(args.output_dir, cfg, backbone, projectors)
    distributed.barrier(None if mesh is None else mesh.data_group)
    result = {"final_loss": losses[-1] if losses else None,
              "steps": step_idx, "optimizer_steps": step_idx // accum,
              "losses": losses, "train_loop_seconds": t_loop_end - t0,
              "setup_seconds": setup_seconds,
              "export_seconds": time.perf_counter() - t_export,
              "resumed_from": resume, "start_step": start_opt,
              "positions": [int(p) for p in positions],
              "loop_trace": trace}
    if t_steady is not None and step_idx > start_step + time_skip:
        result["steady_seconds"] = t_loop_end - t_steady
        result["steady_steps"] = step_idx - start_step - time_skip
        result["steady_bucket_tokens"] = steady_tokens
    return result


def main(argv=None) -> None:
    train(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
