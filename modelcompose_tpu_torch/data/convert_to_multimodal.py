"""Dataset format converters: LLaVA-style -> multimodal format.

Rebuild of the reference's converters (reference:
scripts/convert_llava_to_multimodal/convert_test_data.py and
scripts/convert_to_multimodal.py data-side): LLaVA records carry
``{"image": path}`` and ``<image>`` markers; the multimodal format carries
``modal_inputs: {modal: [paths]}``.

Usage:
    python -m modelcompose_tpu_torch.data.convert_to_multimodal \
        --input llava.json --output mm.json --modal vision \
        [--media-root /data/images]

The port's copy of ``modelcompose_tpu/data/convert_to_multimodal.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

from ..constants import MODAL_TOKENS

LLAVA_KEYS = {"vision": "image", "audio": "audio", "video": "video",
              "point": "point"}


def convert_record(rec: dict, modal: str, media_root: str = "") -> dict:
    out = dict(rec)
    key = LLAVA_KEYS[modal]
    media = out.pop(key, None)
    modal_inputs = dict(out.get("modal_inputs", {}))
    if media is not None:
        paths = media if isinstance(media, list) else [media]
        modal_inputs[modal] = [os.path.join(media_root, p) for p in paths]
    if modal_inputs:
        out["modal_inputs"] = modal_inputs
    # LLaVA uses <image> for every modality's marker in some exports;
    # rewrite to the modality's own token.
    token = MODAL_TOKENS[modal]
    if modal != "vision" and "conversations" in out:
        # Rebuild the turn dicts: dict(rec) is shallow, so in-place edits
        # would rewrite the caller's original records too.
        out["conversations"] = [
            {**turn, "value": turn["value"].replace("<image>", token)}
            for turn in out["conversations"]]
    return out


def convert_file(input_path: str, output_path: str, modal: str,
                 media_root: str = "") -> List[dict]:
    with open(input_path) as f:
        data = json.load(f) if input_path.endswith(".json") else \
            [json.loads(line) for line in f]
    converted = [convert_record(r, modal, media_root) for r in data]
    with open(output_path, "w") as f:
        json.dump(converted, f, indent=2)
    print(f"converted {len(converted)} records -> {output_path}")
    return converted


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--modal", default="vision",
                        choices=list(LLAVA_KEYS))
    parser.add_argument("--media-root", default="")
    args = parser.parse_args()
    convert_file(args.input, args.output, args.modal, args.media_root)


if __name__ == "__main__":
    main()


def check_multimodal_exist(input_path: str) -> int:
    """Verify every modal_inputs media path in a multimodal dataset json
    exists; prints offending records, returns the missing-file count
    (reference: convert_llava_to_multimodal/check_multimodal_exist.py)."""
    with open(input_path) as f:
        data = json.load(f)
    cnt = 0
    for rec in data:
        for modal in rec.get("modal_inputs", {}):
            for path in rec["modal_inputs"][modal]:
                if isinstance(path, str) and not os.path.exists(path):
                    print(rec)
                    cnt += 1
    if cnt == 0:
        print("All Clear!")
    return cnt
