"""Upgrade LLaVA-format artifacts to the multimodal (composition) format.

Rebuild of the reference's llava->multimodal converters (reference:
scripts/convert_llava_to_multimodal/{convert_checkpoint.py,
convert_test_data.py}): a LLaVA-LoRA checkpoint's 'default' adapters
become the 'vision' adapter, its mm_projector becomes
modal_projectors.vision, and its prefix/suffix soft tokens get the
.vision suffix — after which the checkpoint composes like any
vision-DAMC checkpoint.  Test-data conversion turns the LLaVA eval
jsonl ({'question_id','image','text'}) into the multimodal json list
({'id','conversations','modal_inputs'}).

Usage:
  python -m modelcompose_tpu_torch.compose.convert_llava_checkpoint \
      checkpoint LLAVA_CKPT --output_path OUT
  python -m modelcompose_tpu_torch.compose.convert_llava_checkpoint \
      test-data \
      --input_path q.jsonl --input_image_path IMAGES --output_path out.json

The port's copy of
``modelcompose_tpu/compose/convert_llava_checkpoint.py``, over the
port's ``models/loader.load_hf_llama_dir`` and ``compose/state_io``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from .state_io import save_state
from ..models.loader import load_hf_llama_dir

_TOKENIZER_FILES = ("special_tokens_map.json", "tokenizer.model",
                    "tokenizer_config.json", "config.json")


def llava_key_to_multimodal_key(llava_key: str) -> Optional[str]:
    """reference: convert_checkpoint.py:48-58."""
    if "lora_A.default" in llava_key or "lora_B.default" in llava_key:
        return llava_key.replace("default", "vision")
    if "mm_projector" in llava_key:
        return llava_key.replace("mm_projector", "modal_projectors.vision")
    if "prefix_tokens" in llava_key:
        return llava_key.replace("prefix_tokens", "prefix_tokens.vision")
    if "suffix_tokens" in llava_key:
        return llava_key.replace("suffix_tokens", "suffix_tokens.vision")
    return None


def convert_checkpoint(llava_checkpoint: str, output_path: str) -> Dict:
    """Split a merged LLaVA checkpoint into adapter_model /
    non_lora_trainables files in the multimodal key layout (reference:
    convert_checkpoint.py:60-88)."""
    weights = load_hf_llama_dir(llava_checkpoint)
    adapter: Dict[str, np.ndarray] = {}
    non_lora: Dict[str, np.ndarray] = {}
    for llava_key, val in weights.items():
        converted = llava_key_to_multimodal_key(llava_key)
        if not converted:
            continue
        (adapter if "lora" in converted else non_lora)[converted] = val
    os.makedirs(output_path, exist_ok=True)
    save_state(adapter, os.path.join(output_path, "adapter_model.bin"))
    save_state(non_lora,
               os.path.join(output_path, "non_lora_trainables.bin"))
    for name in _TOKENIZER_FILES:
        src = os.path.join(llava_checkpoint, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_path, name))
    return {"adapter_keys": len(adapter), "non_lora_keys": len(non_lora)}


def convert_test_data(input_path: str, input_image_path: str,
                      output_path: str) -> list:
    """LLaVA eval jsonl -> multimodal json list (reference:
    convert_test_data.py:24-43; extra keys pass through)."""
    input_image_path = os.path.abspath(input_image_path)
    new_data = []
    with open(input_path) as fin:
        for line in fin:
            if not line.strip():
                continue
            example = json.loads(line)
            new_example = {
                "id": example["question_id"],
                "conversations": [
                    {"from": "human",
                     "value": "<image>\n" + example["text"]},
                    {"from": "gpt", "value": None},
                ],
                "modal_inputs": {
                    "vision": [os.path.join(input_image_path,
                                            example["image"])]
                },
            }
            for k in example:
                if k not in ("question_id", "text", "image"):
                    new_example[k] = example[k]
            new_data.append(new_example)
    with open(output_path, "w") as f:
        json.dump(new_data, f)
    return new_data


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="what", required=True)
    p = sub.add_parser("checkpoint")
    p.add_argument("llava_checkpoint")
    p.add_argument("--output_path", required=True)
    p = sub.add_parser("test-data")
    p.add_argument("--input_path", required=True)
    p.add_argument("--input_image_path", required=True)
    p.add_argument("--output_path", required=True)
    args = parser.parse_args()
    if args.what == "checkpoint":
        stats = convert_checkpoint(args.llava_checkpoint, args.output_path)
        print(f"wrote {stats['adapter_keys']} adapter keys, "
              f"{stats['non_lora_keys']} non-lora keys")
    else:
        data = convert_test_data(args.input_path, args.input_image_path,
                                 args.output_path)
        print(f"wrote {len(data)} examples")


if __name__ == "__main__":
    main()
