"""Cross-modal retrieval by LM scoring (counterpart of
modelcompose_tpu/eval/retrieval.py): for each media record, every
candidate caption is scored by the model's masked CE as the assistant's
answer; the gold caption's rank gives Recall@{1,5,10} and the median rank.

Question file::

  [{"id", "conversations": [...prompt with modal token...],
    "modal_inputs": {...}, "candidates": ["caption a", ...], "gold": 0}]

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.retrieval --model-path ckpt \\
        --model-base vicuna --question-file retrieval.json
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..data import conversation as conversation_lib
from ..data.conversation import conv_templates
from ..data.dataset import DataCollatorForSupervisedDataset, MultimodalDataset
from ..data.preprocess import preprocess
from ..models.loader import load_pretrained_model


def rank_candidates(model, tokenizer, record: dict, modal_processors,
                    batch_size: int = 8) -> List[float]:
    """The CE loss of each candidate caption as the assistant's answer.
    The record's media are loaded once; only the answer text changes per
    candidate."""
    collator = DataCollatorForSupervisedDataset(
        tokenizer, modal_processors,
        {"vision": {"image_aspect_ratio": "pad"}})
    losses = []
    media = MultimodalDataset.get_modal_inputs(
        dict(record.get("modal_inputs", {})))
    for cand in record["candidates"]:
        convs = copy.deepcopy(record["conversations"])
        if len(convs) == 1:
            convs.append({"from": "gpt", "value": cand})
        else:
            convs[-1]["value"] = cand
        data = preprocess([convs], tokenizer, has_image=True)
        batch = collator([{"input_ids": data["input_ids"][0],
                           "labels": data["labels"][0],
                           "modal_inputs": media}])
        with torch.no_grad():
            loss = model.loss(batch["input_ids"], batch["labels"],
                              batch.get("modal_inputs", {}))
        losses.append(float(loss))
    return losses


def recall_metrics(ranks: List[int]) -> Dict[str, float]:
    arr = np.asarray(ranks)
    return {
        "R@1": float((arr < 1).mean()) * 100,
        "R@5": float((arr < 5).mean()) * 100,
        "R@10": float((arr < 10).mean()) * 100,
        "MedR": float(np.median(arr) + 1) if len(arr) else float("nan"),
    }


def eval_retrieval(args, loaded=None, *, load_tokenizer_fn=None,
                   device=None) -> Dict[str, float]:
    """Recall@{1,5,10} and MedR over ``args.question_file`` (printed and
    returned)."""
    if loaded is None:
        model_path = os.path.expanduser(args.model_path)
        loaded = load_pretrained_model(
            model_path, args.model_base,
            os.path.basename(model_path.rstrip("/")),
            load_tokenizer_fn=load_tokenizer_fn, device=device)
    tokenizer, model, modal_processors, _ = loaded
    conversation_lib.default_conversation = conv_templates[args.conv_mode]
    tokenizer.pad_token_id = tokenizer.eos_token_id

    with open(args.question_file) as f:
        records = json.load(f)
    ranks = []
    for rec in records:
        losses = rank_candidates(model, tokenizer, rec, modal_processors)
        order = np.argsort(losses)  # lower loss = better match
        ranks.append(int(np.where(order == rec.get("gold", 0))[0][0]))
    metrics = recall_metrics(ranks)
    for k, v in metrics.items():
        print(f"{k}: {v:.2f}")
    return metrics


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--conv-mode", default="vicuna_v1")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_retrieval(args, device=args.device)


if __name__ == "__main__":
    main()
