"""Load a composed checkpoint into a runnable MultimodalLM (counterpart of
modelcompose_tpu/models/loader.py).

The merged ``config.json`` from the composition checkpoint, the Vicuna base
weights from ``model_base``, the adapter overlay (``adapter_model.*``, else
``mm_projector.*``, plus ``non_lora_trainables.bin``), then the towers the
config names.  Returns ``(tokenizer, model, modal_processors,
context_len)``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..compose.convert import hf_llama_to_params, load_adapter_into_params
from ..compose.state_io import load_adapter_dir, load_state
from ..config import ModelConfig
from ..core.llama import torch_dtype
from ..devices import resolve_device
from ..ops.quant import quantize_backbone
from ..ops.routed_lora import fold_dense
from ..parallel import distributed
from ..parallel.mesh import apply_tensor_parallel
from .model import MultimodalLM
from .projectors import init_projector
from .towers import build_modal_encoders


def load_hf_llama_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """A flat HF Llama state dict from sharded safetensors or torch bins,
    following the HF shard index when there is one (released Vicuna
    checkpoints: ``pytorch_model-0000x-of-0000y.bin`` plus
    ``pytorch_model.bin.index.json``), else ``*.safetensors``, else
    ``pytorch_model*.bin``, else ``model.npz``.  A ``.safetensors`` file
    without the ``safetensors`` package raises ImportError."""
    state: Dict[str, np.ndarray] = {}
    for index_name in ("model.safetensors.index.json",
                       "pytorch_model.bin.index.json"):
        index_path = os.path.join(model_dir, index_name)
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                state.update(load_state(os.path.join(model_dir, shard)))
            missing = set(weight_map) - set(state)
            if missing:
                raise KeyError(
                    f"shard index {index_name} lists keys absent from its "
                    f"shards: {sorted(missing)[:3]}...")
            return state
    for pattern in ("*.safetensors", "pytorch_model*.bin"):
        files = sorted(glob.glob(os.path.join(model_dir, pattern)))
        if files:
            for path in files:
                state.update(load_state(path))
            return state
    npz = os.path.join(model_dir, "model.npz")
    if os.path.exists(npz):
        return load_state(npz)
    raise FileNotFoundError(f"no base model weights under {model_dir}")


def load_tokenizer(model_base: str):
    """The base model's slow Llama tokenizer (needs ``transformers``)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "the default tokenizer loader needs the transformers package; "
            "pass load_tokenizer_fn to load_pretrained_model instead") from e
    return AutoTokenizer.from_pretrained(model_base, use_fast=False)


def load_pretrained_model(model_path: str, model_base: Optional[str],
                          model_name: Optional[str] = None,
                          load_tokenizer_fn=None, load_8bit: bool = False,
                          fold_decode_dense: bool = False, tp: int = 1,
                          device=None):
    """Load a composed ('multimodal') checkpoint onto ``device``.

    The base is converted straight into ``cfg.dtype`` on the device and the
    adapters are overlaid in place; then, in the JAX loader's order,
    ``load_8bit`` quantizes the backbone weight-only int8 and
    ``fold_decode_dense`` folds the default-route adapter mix into W and
    rebases the routing table (ops/routed_lora.fold_dense), the production
    serving setup.  Projectors the checkpoint lacks are random (seed 0).

    ``tp`` > 1 then shards the backbone Megatron-style over a (1, ``tp``)
    mesh of the process group (``parallel.mesh.apply_tensor_parallel``):
    every rank of the world calls the loader, each keeps its shard, and
    the model holds its model group (``model.tp_group``).  Raises ValueError where the world
    has fewer than ``tp`` processes, as the JAX loader raises for too few
    devices.
    """
    if tp > 1 and distributed.world_size() < tp:
        raise ValueError(f"--tp {tp} needs {tp} processes, have "
                         f"{distributed.world_size()} (launch under "
                         f"torchrun --nproc-per-node {tp})")
    model_name = model_name or os.path.basename(model_path.rstrip("/"))
    if "multimodal" not in model_name.lower():
        raise ValueError(
            f"model name {model_name!r} must contain 'multimodal' "
            "(the reference's rule for composed checkpoints)")
    if model_base is None:
        raise ValueError("composed checkpoints require --model-base "
                         "(the Vicuna base)")
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))

    params = hf_llama_to_params(load_hf_llama_dir(model_base), cfg,
                                device=device)
    projectors: Dict[str, dict] = {}
    leftovers = load_adapter_into_params(params, load_adapter_dir(model_path),
                                         cfg, projectors)
    non_lora = os.path.join(model_path, "non_lora_trainables.bin")
    if os.path.exists(non_lora):
        extra = {k.replace("base_model.model.", "", 1): v
                 for k, v in load_state(non_lora).items()}
        leftovers += load_adapter_into_params(params, extra, cfg, projectors)
    if leftovers:
        print(f"[loader] {len(leftovers)} unconsumed adapter keys "
              f"(first: {leftovers[:3]})")

    encoders = build_modal_encoders(cfg, device=device)
    for modal in cfg.modalities():
        if modal not in projectors:
            projectors[modal] = init_projector(
                cfg.projector_type(modal),
                torch.Generator(device=device).manual_seed(0),
                encoders[modal].hidden_size, cfg.hidden_size,
                dtype=torch_dtype(cfg.dtype), device=device)

    model = MultimodalLM(cfg, params, encoders, projectors)
    del params  # the quantized and folded trees replace it, not join it
    with torch.no_grad():
        if load_8bit:
            model.params = quantize_backbone(model.params)
        if fold_decode_dense:
            model.params, table = fold_dense(model.params,
                                             model.routing_table)
            model.routing_table = table.cpu().numpy()
        if tp > 1:
            apply_tensor_parallel(model, tp)
    if load_tokenizer_fn is None:
        load_tokenizer_fn = load_tokenizer
    tokenizer = load_tokenizer_fn(model_base)
    context_len = 2048  # the reference's
    return tokenizer, model, model.modal_processors(), context_len
