"""Batched-loader VQA answers: media decode overlapped with generation
(counterpart of modelcompose_tpu/eval/model_vqa_loader.py).

``data.loader.PrefetchLoader`` threads read and tokenize the next rows
while the current one generates.  Unlike ``model_vqa``, a row may carry a
LIST of images, and ``--no_add_image_token`` serves rows whose prompt
already holds the image tokens.  Images are read by
``data.image_io.load_image`` (PNG without PIL).  Sampled draws come from
one ``torch.Generator`` seeded 0 on the model's device (the JAX entry
splits a PRNG key per question): greedy answers equal the JAX entry's.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_vqa_loader \\
        --model-path ckpt --model-base vicuna --question-file q.jsonl \\
        --image-folder imgs --answers-file out.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import numpy as np
import torch

from ..data import conversation as conversation_lib
from ..data.conversation import conv_templates
from ..data.dataset import get_chunk
from ..data.image_io import load_image
from ..data.image_processing import process_images
from ..data.loader import PrefetchLoader
from ..data.tokenization import tokenizer_modal_token
from .generation_utils import stop_str_for
from .model_vqa import add_common_args, load_model


class _QuestionDataset:
    """(input_ids, image_batch) per question row (reference:
    model_vqa_loader.py:30-67)."""

    def __init__(self, questions, image_folder, tokenizer, processor,
                 conv_mode, add_image_token=True):
        self.questions = questions
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.processor = processor
        self.conv_mode = conv_mode
        self.add_image_token = add_image_token

    def __len__(self):
        return len(self.questions)

    def __getitem__(self, index):
        line = self.questions[index]
        qs = line["text"]
        image_file = line["image"]
        files = image_file if isinstance(image_file, list) else [image_file]
        if self.add_image_token:
            qs = "<image>\n" * len(files) + qs
        conv = conv_templates[self.conv_mode].copy()
        conv.append_message(conv.roles[0], qs)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_modal_token(conv.get_prompt(),
                                               self.tokenizer), np.int64)
        imgs = [load_image(os.path.join(self.image_folder, fn))
                for fn in files]
        pixels = process_images(imgs, self.processor,
                                image_aspect_ratio="pad")
        return ids, pixels


def eval_model(args, loaded=None, *, load_tokenizer_fn=None, device=None):
    """Answer ``args.question_file`` into ``args.answers_file``."""
    tokenizer, model, processors, _ = load_model(args, loaded,
                                                 load_tokenizer_fn, device)
    conversation_lib.default_conversation = conv_templates[args.conv_mode]
    model_id = os.path.basename(args.model_path.rstrip("/"))

    with open(args.question_file) as f:
        questions = [json.loads(line) for line in f]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(args.answers_file) or ".", exist_ok=True)
    stop_str = stop_str_for(conv_templates[args.conv_mode])

    dataset = _QuestionDataset(questions, args.image_folder, tokenizer,
                               processors["vision"], args.conv_mode,
                               add_image_token=not args.no_add_image_token)
    loader = PrefetchLoader(dataset, range(len(dataset)), batch_size=1,
                            collate=lambda xs: xs[0],
                            num_workers=args.num_workers)
    generator = torch.Generator(device=model.device).manual_seed(0)
    with open(args.answers_file, "w") as ans_file:
        for (ids, pixels), line in zip(loader, questions):
            tokens = model.generate(
                [ids], {"vision": pixels},
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature
                if args.temperature > 1e-4 else 0.0,
                num_beams=args.num_beams, top_p=args.top_p,
                generator=generator)[0]
            text = tokenizer.decode(tokens, skip_special_tokens=True).strip()
            if stop_str and text.endswith(stop_str):
                text = text[:-len(stop_str)]
            ans_file.write(json.dumps({
                "question_id": line["question_id"],
                "prompt": line["text"],
                "text": text.strip(),
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_id,
                "metadata": {},
            }) + "\n")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = add_common_args(argparse.ArgumentParser(), "llava_v1", 128)
    parser.add_argument("--image-folder", default="")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--no_add_image_token", action="store_true")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_model(args, device=args.device)


if __name__ == "__main__":
    main()
