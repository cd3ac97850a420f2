"""Merge peft-era LoRA checkpoints as dense deltas into a base model.

Rebuild of the reference's weight-space NaiveMC merger (reference:
scripts/convert_llava_to_multimodal/merge_image_audio_to_multimodal.py):
each unimodal checkpoint's single-adapter LoRA (``base_model.model.*``
peft keys, ``adapter_config.json`` scale) is materialized as a dense
delta ``B @ A * alpha/r``; deltas sharing a base key are averaged
('avg') or summed and added into the base weights, projector/soft-token
trainables overlay on top, and the result is written as a sharded HF
checkpoint (two shards + index.json) with a union config and
merge_info.json provenance.  (The shipped reference script has two
latent bugs — ``.starts_with`` calls and overlaying the wrong
additional-weights dict — fixed here with the intended behavior.)

Usage:
  python -m modelcompose_tpu_torch.compose.merge_deltas_to_base MODEL_BASE \
      --checkpoint vision=ckpts/llava-vision-lora \
      --checkpoint audio=ckpts/llava-audio-lora \
      --output_path out [--strategy avg]

The port's copy of
``modelcompose_tpu/compose/merge_deltas_to_base.py``, over the
port's ``models/loader.load_hf_llama_dir`` and ``compose/state_io``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from collections import defaultdict
from typing import Dict

import numpy as np

from .state_io import load_adapter_dir, load_state, save_state
from ..models.loader import load_hf_llama_dir

_TOKENIZER_FILES = ("special_tokens_map.json", "tokenizer.model",
                    "tokenizer_config.json")


def _lora_key_to_base_key(lora_key: str) -> str:
    """LoRA keys ONLY (the reference's helper is also applied to non-lora
    overlay keys, which corrupts '.bias' / soft-token names by appending
    '.weight' — overlays here keep their keys and just lose the peft
    prefix, via load_adapter_dir / _strip_peft_prefix)."""
    key = lora_key.replace(".lora_A.weight", "") \
        .replace(".lora_B.weight", "")
    return key if key.endswith(".weight") else key + ".weight"


def _strip_peft_prefix(key: str) -> str:
    return key[len("base_model.model."):] \
        if key.startswith("base_model.model.") else key


def _to_multimodal_key(key: str, modal: str) -> str:
    """mm_projector.* trainables become modal_projectors.{modal}.*
    (the intent of the reference's maybe_convert_to_multimodal)."""
    if "modal_projectors" in key:
        return key
    if "mm_projector" in key:
        return key.replace("mm_projector", f"modal_projectors.{modal}")
    return key


def load_dense_deltas(path: str):
    """One peft checkpoint -> ({base_key: dense delta}, {overlay key:
    tensor}, config) (reference: merge_image_audio_to_multimodal.py:50-76)."""
    config = json.load(open(os.path.join(path, "config.json")))
    adapter_cfg = json.load(open(os.path.join(path, "adapter_config.json")))
    scale = adapter_cfg["lora_alpha"] / adapter_cfg["r"]
    # load_adapter_dir finds .bin OR .safetensors and strips the peft prefix
    lora = load_adapter_dir(path)
    base_keys = sorted({_lora_key_to_base_key(k) for k in lora
                        if ".lora_A." in k or ".lora_B." in k})
    deltas = {}
    for base_key in base_keys:
        stem = base_key[:-len(".weight")]
        a = lora[f"{stem}.lora_A.weight"]
        b = lora[f"{stem}.lora_B.weight"]
        deltas[base_key] = (b @ a) * scale
    extra_path = os.path.join(path, "non_lora_trainables.bin")
    extra = load_state(extra_path) if os.path.exists(extra_path) else {}
    extra = {_strip_peft_prefix(k): v for k, v in extra.items()}
    return deltas, extra, config


def merge_deltas_to_base(model_base: str, checkpoints: Dict[str, str],
                         output_path: str, strategy: str = "avg") -> Dict:
    """checkpoints: {modal: peft checkpoint dir}.  Returns merge stats."""
    base_config = json.load(open(os.path.join(model_base, "config.json")))
    deltas = defaultdict(list)
    overlays: Dict[str, np.ndarray] = {}
    for modal, path in checkpoints.items():
        d, extra, cfg = load_dense_deltas(path)
        for k, v in d.items():
            deltas[k].append(v)
        overlays.update({_to_multimodal_key(k, modal): v
                         for k, v in extra.items()})
        # union the per-modality config stamps (reference: :100-110)
        for key, val in cfg.items():
            if key.startswith(("mm_", "lora_", "local_")) and val \
                    not in (None, ""):
                base_config[key] = val

    weights = load_hf_llama_dir(model_base)
    merged = 0
    for k, stack in deltas.items():
        if k not in weights:
            raise KeyError(f"delta key {k} absent from the base model")
        agg = np.mean(stack, axis=0) if strategy == "avg" \
            else np.sum(stack, axis=0)
        weights[k] = weights[k] + agg
        merged += 1
    weights.update(overlays)

    os.makedirs(output_path, exist_ok=True)
    keys = sorted(weights)
    half = len(keys) // 2
    shards = {"pytorch_model-00001-of-00002.bin": keys[:half],
              "pytorch_model-00002-of-00002.bin": keys[half:]}
    index = {"metadata": {"total_size": int(sum(
        np.asarray(v).nbytes for v in weights.values()))},
        "weight_map": {}}
    for shard, ks in shards.items():
        save_state({k: weights[k] for k in ks},
                   os.path.join(output_path, shard))
        index["weight_map"].update({k: shard for k in ks})
    with open(os.path.join(output_path,
                           "pytorch_model.bin.index.json"), "w") as f:
        json.dump(index, f, indent=4, sort_keys=True)
    with open(os.path.join(output_path, "config.json"), "w") as f:
        json.dump(base_config, f, indent=4, sort_keys=True)
    with open(os.path.join(output_path, "merge_info.json"), "w") as f:
        json.dump(dict(checkpoints), f, indent=4, sort_keys=True)
    for name in _TOKENIZER_FILES:
        src = os.path.join(model_base, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_path, name))
    return {"merged_keys": merged, "overlay_keys": len(overlays)}


def _kv(pair: str):
    name, _, path = pair.partition("=")
    if not path:
        raise argparse.ArgumentTypeError(f"expected modal=path: {pair!r}")
    return name, path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("model_base")
    parser.add_argument("--checkpoint", type=_kv, action="append",
                        required=True, metavar="MODAL=PATH")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--strategy", default="avg",
                        choices=["avg", "sum"])
    args = parser.parse_args()
    stats = merge_deltas_to_base(args.model_base, dict(args.checkpoint),
                                 args.output_path, args.strategy)
    print(f"merged {stats['merged_keys']} weight deltas, "
          f"{stats['overlay_keys']} overlays -> {args.output_path}")


if __name__ == "__main__":
    main()
