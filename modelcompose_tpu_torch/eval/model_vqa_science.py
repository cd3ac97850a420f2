"""ScienceQA answers with the chain-of-thought re-query (counterpart of
modelcompose_tpu/eval/model_vqa_science.py).

Questions are a json list of ``{id, conversations, image?}``; each answers
once, and with ``--answer-prompter`` the model is asked again with
``prompt + reasoning + " ###\\nANSWER:"`` for 64 tokens, the text becoming
``reasoning + "\\n The answer is " + letter`` (the two-turn protocol the
SQA-GPT4 scorers read).  Images are read by ``data.image_io.load_image``
(PNG without PIL).  Sampled draws come from one ``torch.Generator`` seeded
0 on the model's device (the JAX entry splits a PRNG key per turn): greedy
answers equal the JAX entry's.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_vqa_science \\
        --model-path ckpt --model-base vicuna --question-file problems.json \\
        --image-folder imgs --answers-file out.jsonl --single-pred-prompt
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
from .model_vqa import add_common_args, load_model

SINGLE_PRED_PROMPT = ("\nAnswer with the option's letter from the given "
                      "choices directly.")


def eval_model(args, loaded=None, *, load_tokenizer_fn=None, device=None):
    """Answer ``args.question_file`` into ``args.answers_file``."""
    tokenizer, model, processors, _ = load_model(args, loaded,
                                                 load_tokenizer_fn, device)
    conversation_lib.default_conversation = conv_templates[args.conv_mode]
    model_id = os.path.basename(args.model_path.rstrip("/"))

    with open(args.question_file) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(args.answers_file) or ".", exist_ok=True)

    conv_template = conv_templates[args.conv_mode]
    stop_str = stop_str_for(conv_template)
    generator = torch.Generator(device=model.device).manual_seed(0)
    with open(args.answers_file, "w") as ans_file:
        for line in questions:
            idx = line["id"]
            question = line["conversations"][0]
            qs = question["value"].replace("<image>", "").strip()
            cur_prompt = qs

            modal_inputs = {}
            if "image" in line:
                img = load_image(os.path.join(args.image_folder,
                                              line["image"]))
                modal_inputs["vision"] = process_images(
                    [img], processors["vision"], image_aspect_ratio="pad")
                qs = "<image>\n" + qs
                cur_prompt = "<image>\n" + cur_prompt

            if args.single_pred_prompt:
                qs = qs + SINGLE_PRED_PROMPT
                cur_prompt = cur_prompt + SINGLE_PRED_PROMPT

            conv = conv_template.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            outputs = generate_text(model, tokenizer, prompt, modal_inputs,
                                    temperature=args.temperature,
                                    max_new_tokens=args.max_new_tokens,
                                    generator=generator, stop_str=stop_str,
                                    num_beams=args.num_beams,
                                    top_p=args.top_p)

            if args.answer_prompter:
                # second turn: re-query for the bare option letter
                # (reference: model_vqa_science.py:99-121)
                outputs_reasoning = outputs
                answer = generate_text(
                    model, tokenizer,
                    prompt + outputs_reasoning + " ###\nANSWER:",
                    modal_inputs, temperature=args.temperature,
                    max_new_tokens=64, generator=generator,
                    stop_str=stop_str)
                outputs = outputs_reasoning + "\n The answer is " + answer

            ans_file.write(json.dumps({
                "question_id": idx,
                "prompt": cur_prompt,
                "text": outputs,
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_id,
                "metadata": {},
            }) + "\n")
            ans_file.flush()


def build_arg_parser() -> argparse.ArgumentParser:
    parser = add_common_args(argparse.ArgumentParser(), "llava_v0", 1024)
    parser.add_argument("--image-folder", default="")
    parser.add_argument("--answer-prompter", action="store_true")
    parser.add_argument("--single-pred-prompt", action="store_true")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    eval_model(args, device=args.device)


if __name__ == "__main__":
    main()
