"""Merge unimodal DAMC checkpoints into one composed checkpoint
(counterpart of modelcompose_tpu/compose/merge.py; the same strategies and
outputs, on the port's numpy ``ties`` and ``state_io``):

- ``sum`` / ``mean``: elementwise over aligned keys;
- ``ties-{sum,mean,max}``: trim, elect and disjoint-aggregate the shared
  keys; unique keys pass through;
- ``online-merge-*``: unique keys pass through; each shared key (a
  ``default`` adapter) is kept once per checkpoint, renamed
  ``default-{modal}``; ``online-merge-reset-<spec>`` stamps
  ``reset_scaling_weights`` into the config, any other suffix
  ``merge_default_weights``;
- ``convert-<inner>``: upgrade NaiveMC ('same'-strategy) checkpoints by
  copying each 'default' adapter key per modality, then apply <inner>
  (``convert-drop-*`` TIES-merges the shared keys and passes the copies).

Outputs ``adapter_model.bin`` always, and ``adapter_model.safetensors``
too where the ``safetensors`` package imports (the JAX version writes the
``.safetensors`` unconditionally); a union ``config.json`` with per-modal
``{modal}_lora_{r,alpha}`` stamps; ``merge_info.txt``.

    python -m modelcompose_tpu_torch.compose.merge ckptA ckptB -o OUT \\
        --strategy online-merge-reset-default-vision=0.5,default-audio=0.5
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from .state_io import load_adapter_dir, save_state
from .ties import convert_delta_to_ft, do_merging

# Config keys that identify a checkpoint's modality (reference
# merge_unimodal_modelcompose.py:15-21).
MODAL_DICT = {
    "mm_vision_encoder": "vision",
    "mm_vision_tower": "vision",
    "mm_vision2_encoder": "vision2",
    "mm_vision2_tower": "vision2",
    "mm_video_encoder": "video",
    "mm_audio_encoder": "audio",
    "mm_point_encoder": "point",
}


def get_modal_from_config(config: dict) -> str:
    for key, modal in MODAL_DICT.items():
        if isinstance(config.get(key), str) and config[key]:
            return modal
    raise AssertionError("No modality is recognized, please check the config.")


def _merge_weights(weights: Dict[str, List[np.ndarray]], configs: List[dict],
                   strategy: str, K: float):
    """(merged state dict, the strategy name for merge_info.txt)."""
    if strategy.startswith("convert-"):
        strategy = strategy[len("convert-"):]
        for config in configs:
            if "lora_strategy" in config:
                assert config["lora_strategy"] == "same"
                config["lora_strategy"] = "modal+language"
        modal_types = [get_modal_from_config(c) for c in configs]
        converted: Dict[str, List[np.ndarray]] = defaultdict(list)
        for key in weights:
            if ".default" in key:
                for i, modal in enumerate(modal_types):
                    converted[key.replace("default", modal)].append(
                        copy.deepcopy(weights[key][i]))
        if strategy.startswith("drop-"):
            ft_checks, uniques = convert_delta_to_ft(weights)
            merged = do_merging(ft_checks, K=K,
                                merge_func=strategy.replace("drop-", "dis-"))
            merged.update(uniques)
            merged.update({k: v[0] for k, v in converted.items()})
            return merged, strategy
        weights.update(converted)

    if strategy.startswith("ties-"):
        func = strategy[len("ties-"):]
        assert func in ("sum", "mean", "max")
        ft_checks, uniques = convert_delta_to_ft(weights)
        merged = do_merging(ft_checks, K=K, merge_func=f"dis-{func}")
        merged.update(uniques)
        assert sorted(weights) == sorted(merged), "the keys should be the same"
        return merged, f"dis-{func}-{K}"
    if strategy.startswith("online-merge-"):
        modal_names = [get_modal_from_config(c) for c in configs]
        merged = {}
        for key, vals in weights.items():
            if len(vals) == 1:
                merged[key] = vals[0]
                continue
            assert "default" in key, key
            for modal, w in zip(modal_names, vals):
                merged[key.replace("default", f"default-{modal}")] = w
        return merged, strategy
    if strategy == "sum":
        return {k: np.sum(v, axis=0) for k, v in weights.items()}, strategy
    if strategy == "mean":
        return ({k: np.sum(v, axis=0) / len(v) for k, v in weights.items()},
                strategy)
    raise ValueError(f"Merge strategy [{strategy}] not implemented")


def merge_checkpoints(filepaths: List[str], output_path: str,
                      strategy: str = "sum", K: float = 20) -> None:
    configs = []
    weights: Dict[str, List[np.ndarray]] = defaultdict(list)
    for filepath in filepaths:
        with open(os.path.join(filepath, "config.json")) as f:
            configs.append(json.load(f))
        for key, val in load_adapter_dir(filepath).items():
            weights[key].append(val)
    merged, strategy = _merge_weights(weights, configs, strategy, K)

    # Union config; truthy values win on conflicts.  The online-merge stamp
    # goes in after the first config's keys, so the key order (and the
    # file) is the JAX package's.
    merged_config: dict = {}
    for config in configs:
        for key, val in config.items():
            merged_config[key] = (merged_config[key] or val) \
                if key in merged_config else val
        if strategy.startswith("online-merge-"):
            strategy = strategy[len("online-merge-"):]
            if strategy.startswith("reset-"):
                merged_config["reset_scaling_weights"] = \
                    strategy[len("reset-"):]
            else:
                merged_config["merge_default_weights"] = strategy
    for config in configs:
        modal = get_modal_from_config(config)
        merged_config[f"{modal}_lora_alpha"] = config.get("lora_alpha")
        merged_config[f"{modal}_lora_r"] = config.get("lora_r")

    os.makedirs(output_path, exist_ok=True)
    save_state(merged, os.path.join(output_path, "adapter_model.bin"))
    try:
        import safetensors  # noqa: F401
    except ImportError:
        pass
    else:
        save_state(merged,
                   os.path.join(output_path, "adapter_model.safetensors"))
    with open(os.path.join(output_path, "config.json"), "w") as f:
        json.dump(merged_config, f, indent=4)
    with open(os.path.join(output_path, "merge_info.txt"), "w") as f:
        inputs = "\n".join(filepaths)
        f.write(f"Inputs:\n{inputs}\n\nOutput({strategy}):{output_path}")
    print(f"Merged checkpoints saved to {output_path}")


def main():
    parser = argparse.ArgumentParser(
        description="Merge multiple adapter checkpoints")
    parser.add_argument("filepaths", nargs="+")
    parser.add_argument("-o", "--output", default="merged_checkpoint")
    parser.add_argument("--strategy", default="sum")
    parser.add_argument("-K", default=20, type=int)
    args = parser.parse_args()
    merge_checkpoints(args.filepaths, args.output, args.strategy, args.K)


if __name__ == "__main__":
    main()
