"""Text-only QA answers (counterpart of modelcompose_tpu/eval/model_qa.py).

jsonl questions ``{question_id, text, category}`` are answered in the
default conversation template, sampled at temperature 0.7 by default, and
each answer is cut at the first separator after the prompt.  The answer
jsonl has the JAX entry's keys: ``question_id``, ``text``, ``answer_id``,
``model_id``, ``metadata``.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_qa --model-path ckpt \\
        --model-base vicuna --question-file q.jsonl --answers-file out.jsonl

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

import numpy as np
import torch

from ..data import conversation as conversation_lib
from ..data.tokenization import tokenizer_modal_token
from ..models.loader import load_pretrained_model


def eval_model(args, loaded=None, *, load_tokenizer_fn=None, device=None):
    """Answer ``args.question_file`` into ``args.answers_file``, on
    ``loaded`` or on the checkpoint ``args`` names."""
    if loaded is None:
        model_path = os.path.expanduser(args.model_path)
        loaded = load_pretrained_model(
            model_path, args.model_base,
            os.path.basename(model_path.rstrip("/")),
            load_tokenizer_fn=load_tokenizer_fn, device=device)
    tokenizer, model, _, _ = loaded
    model_id = os.path.basename(args.model_path.rstrip("/"))
    os.makedirs(os.path.dirname(args.answers_file) or ".", exist_ok=True)

    generator = torch.Generator(device=model.device).manual_seed(0)
    with open(args.question_file) as ques_file, \
            open(args.answers_file, "w") as ans_file:
        for line in ques_file:
            q = json.loads(line)
            conv = conversation_lib.default_conversation.copy()
            conv.append_message(conv.roles[0], q["text"])
            conv.append_message(conv.roles[1], None)
            ids = np.asarray(tokenizer_modal_token(conv.get_prompt(),
                                                   tokenizer), np.int64)
            tokens = model.generate(
                [ids], {}, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, generator=generator)[0]
            text = tokenizer.decode(tokens, skip_special_tokens=True)
            # cut at the first separator, the reference's keyword stop
            if conv.sep and conv.sep in text:
                text = text[:text.index(conv.sep)]
            ans_file.write(json.dumps({
                "question_id": q["question_id"],
                "text": text.strip(),
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_id,
                "metadata": {},
            }) + "\n")
            ans_file.flush()


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", "--model-name", required=True,
                        dest="model_path")
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--answers-file", default="answer.jsonl")
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_model(args, device=args.device)


if __name__ == "__main__":
    main()
