"""LLaVA-legacy VQA answers: question jsonl + image folder (counterpart of
modelcompose_tpu/eval/model_vqa.py).

Question rows ``{"question_id", "image", "text"}``; ``<image>`` is put in
front of a question that lacks it, and a row without an image is answered
as text.  Images are read by ``data.image_io.load_image`` (PNG without
PIL).  The answer jsonl has the JAX entry's keys: ``question_id``,
``prompt``, ``text``, ``answer_id``, ``model_id``, ``metadata``.  Used by
the LLaVA-suite evals (POPE, TextVQA, ...).

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_vqa --model-path ckpt \\
        --model-base vicuna --question-file q.jsonl --image-folder imgs \\
        --answers-file out.jsonl

Sampling: the JAX entry splits ``PRNGKey(0)`` per question; this one draws
every question from one ``torch.Generator`` seeded 0 on the model's
device, so sampled answers differ between the packages and greedy ones
(``--temperature 0``) do not.
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import torch

from ..data import conversation as conversation_lib
from ..data.conversation import conv_templates
from ..data.dataset import get_chunk
from ..data.image_io import load_image
from ..data.image_processing import process_images
from .generation_utils import generate_text, stop_str_for


def load_model(args, loaded=None, load_tokenizer_fn=None, device=None):
    """``loaded``, or the checkpoint ``args.model_path`` names loaded onto
    ``device``: (tokenizer, model, processors, context_len)."""
    if loaded is not None:
        return loaded
    from ..models.loader import load_pretrained_model
    model_path = os.path.expanduser(args.model_path)
    return load_pretrained_model(
        model_path, args.model_base, os.path.basename(model_path.rstrip("/")),
        load_tokenizer_fn=load_tokenizer_fn, device=device)


def eval_model(args, loaded=None, *, load_tokenizer_fn=None, device=None):
    """Answer ``args.question_file`` into ``args.answers_file``."""
    tokenizer, model, processors, _ = load_model(args, loaded,
                                                 load_tokenizer_fn, device)
    conversation_lib.default_conversation = conv_templates[args.conv_mode]

    with open(args.question_file) as f:
        questions = [json.loads(line) for line in f]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(args.answers_file) or ".", exist_ok=True)

    conv_template = conv_templates[args.conv_mode]
    stop_str = stop_str_for(conv_template)
    generator = torch.Generator(device=model.device).manual_seed(0)
    with open(args.answers_file, "w") as ans_file:
        for q in questions:
            qs = q["text"]
            modal_inputs = {}
            if q.get("image"):
                img = load_image(os.path.join(args.image_folder, q["image"]))
                modal_inputs["vision"] = process_images(
                    [img], processors["vision"], image_aspect_ratio="pad")
                if "<image>" not in qs:
                    qs = "<image>\n" + qs
            conv = conv_template.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            text = generate_text(model, tokenizer, conv.get_prompt(),
                                 modal_inputs,
                                 temperature=args.temperature,
                                 max_new_tokens=args.max_new_tokens,
                                 generator=generator, stop_str=stop_str,
                                 num_beams=args.num_beams, top_p=args.top_p)
            ans_file.write(json.dumps({
                "question_id": q["question_id"],
                "prompt": q["text"],
                "text": text,
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": os.path.basename(args.model_path.rstrip("/")),
                "metadata": {},
            }) + "\n")
            ans_file.flush()


def add_common_args(parser: argparse.ArgumentParser, conv_mode: str,
                    max_new_tokens: int) -> argparse.ArgumentParser:
    """The flags the four LLaVA-suite entries share, with the JAX
    defaults, plus ``--device``."""
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--answers-file", default="answer.jsonl")
    parser.add_argument("--conv-mode", default=conv_mode)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--num-beams", "--num_beams",
                        dest="num_beams", type=int, default=1)
    parser.add_argument("--top-p", "--top_p", dest="top_p",
                        type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=max_new_tokens)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def build_arg_parser() -> argparse.ArgumentParser:
    parser = add_common_args(argparse.ArgumentParser(), "llava_v1", 128)
    parser.add_argument("--image-folder", default="")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_model(args, device=args.device)


if __name__ == "__main__":
    main()
