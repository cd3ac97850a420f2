"""Mean-loss evaluation (counterpart of
modelcompose_tpu/eval/model_multimodal_loss.py): the mean masked CE of the
gold answers of a (chunked) question file under the model, over every
modality, through ``MultimodalLM.loss``.  Each batch's loss is weighted by
its number of samples.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_multimodal_loss \\
        --model-path ckpt --model-base vicuna --question-file qa.json
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data import conversation as conversation_lib
from ..data.conversation import conv_templates
from ..data.dataset import (ChunkedMultimodalDataset,
                            DataCollatorForSupervisedDataset)
from ..models.loader import load_pretrained_model


def eval_loss(args, loaded=None, *, load_tokenizer_fn=None,
              device=None) -> float:
    """The mean loss over ``args.question_file`` (printed and returned)."""
    if loaded is None:
        model_path = os.path.expanduser(args.model_path)
        loaded = load_pretrained_model(
            model_path, args.model_base,
            os.path.basename(model_path.rstrip("/")),
            load_tokenizer_fn=load_tokenizer_fn, device=device)
    tokenizer, model, modal_processors, _ = loaded
    conversation_lib.default_conversation = conv_templates[args.conv_mode]
    tokenizer.pad_token_id = tokenizer.eos_token_id

    dataset = ChunkedMultimodalDataset(
        args.question_file, tokenizer, None, modal_processors,
        num_chunks=args.num_chunks, chunk_idx=args.chunk_idx)
    collator = DataCollatorForSupervisedDataset(
        tokenizer, modal_processors,
        {"vision": {"image_aspect_ratio": "pad"}})

    total, count = 0.0, 0
    B = args.batch_size
    for start in range(0, len(dataset), B):
        batch = collator([dataset[i] for i in
                          range(start, min(start + B, len(dataset)))])
        with torch.no_grad():
            loss = model.loss(batch["input_ids"], batch["labels"],
                              batch.get("modal_inputs", {}))
        total += float(loss) * len(batch["input_ids"])
        count += len(batch["input_ids"])
    mean = total / max(count, 1)
    print(mean)
    return mean


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="vicuna_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_loss(args, device=args.device)


if __name__ == "__main__":
    main()
