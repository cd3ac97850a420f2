"""Batched multimodal QA generation — the eval entry point (counterpart of
modelcompose_tpu/eval/model_multimodal_qa_loader.py).

Load a composed checkpoint, answer a (chunked) question file, and write the
same answer jsonl as the reference's chunked QA loader (reference:
modelcompose/eval/model_multimodal_qa_loader.py:55-144) for the same
scorers: ``question_id``, ``prompt``, ``text``, ``answer_id``, ``model_id``,
``metadata``.  The flags and defaults are the JAX CLI's.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.model_multimodal_qa_loader \\
        --model-path ckpts/merged-multimodal --model-base vicuna-7b-v1.5 \\
        --question-file q.json --answers-file out.jsonl --protocol benchmark

``eval_model`` loads the model (``models.loader.load_pretrained_model``,
onto ``device``, the card when None; the tokenizer through
``load_tokenizer_fn``, by default the base's HF tokenizer, which needs
``transformers``) and hands it to ``run_questions``, which runs the
question loop on a model that is already loaded.

Sampling: the JAX CLI seeds ``PRNGKey(0)`` and splits it per batch; this
one seeds one ``torch.Generator`` with 0 on the model's device and draws
every batch from it.  The two streams cannot match across frameworks, so
sampled answers differ between the packages; greedy and beam-search
answers do not.
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

import torch

from ..data import conversation as conversation_lib
from ..data.conversation import conv_templates
from ..data.dataset import (ChunkedMultimodalDataset,
                            DataCollatorForSupervisedDataset, get_chunk)
from ..models.loader import load_pretrained_model
from .generation_utils import stop_str_for


def eval_model(args, *, load_tokenizer_fn=None, device=None) -> None:
    """Load ``args.model_path`` on ``args.model_base`` and answer
    ``args.question_file`` into ``args.answers_file``."""
    model_path = os.path.expanduser(args.model_path)
    model_name = os.path.basename(model_path.rstrip("/"))
    tokenizer, model, modal_processors, _ = load_pretrained_model(
        model_path, args.model_base, model_name,
        load_tokenizer_fn=load_tokenizer_fn, device=device)
    run_questions(args, tokenizer, model, modal_processors, model_name)


def run_questions(args, tokenizer, model, modal_processors,
                  model_name: str) -> None:
    """The question loop of ``eval_model`` on a loaded model: one jsonl
    line per question, in question order.  A question whose media cannot
    be loaded raises (the eval dataset never resamples)."""
    conversation_lib.default_conversation = conv_templates[args.conv_mode]
    tokenizer.pad_token_id = tokenizer.eos_token_id

    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)

    dataset = ChunkedMultimodalDataset(
        args.question_file, tokenizer, None, modal_processors,
        num_chunks=args.num_chunks, chunk_idx=args.chunk_idx)
    collator = DataCollatorForSupervisedDataset(
        tokenizer, modal_processors,
        {"vision": {"image_aspect_ratio": "pad"}})
    with open(args.question_file) as f:
        questions = get_chunk(json.load(f), args.num_chunks, args.chunk_idx)

    # Prompt protocol note: like the reference, the dataset tokenizes the
    # FULL conversation through the training preprocess — benchmark
    # question files carry a None/empty gpt turn (gold lives in the
    # separate ANN file, see avqa.sh), which renders a prompt ending in
    # 'ASSISTANT:'; a question file that DID embed gold would leak it in
    # both stacks identically.
    stop_str = stop_str_for(conv_templates[args.conv_mode])

    num_beams = getattr(args, "num_beams", 1)
    generator = torch.Generator(device=model.device).manual_seed(0)
    with open(answers_file, "w") as ans_file:
        B = args.batch_size if num_beams <= 1 else 1
        for start in range(0, len(dataset), B):
            batch = collator([dataset[i] for i in
                              range(start, min(start + B, len(dataset)))])
            outputs = model.generate(
                batch["input_ids"], batch.get("modal_inputs", {}),
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, num_beams=num_beams,
                top_p=getattr(args, "top_p", 1.0),
                compact_adapters=getattr(args, "compact_adapters", False),
                generator=generator)
            for j, token_ids in enumerate(outputs):
                text = tokenizer.decode(token_ids,
                                        skip_special_tokens=True).strip()
                if text.endswith(stop_str):
                    text = text[:-len(stop_str)]
                text = text.strip()
                q = questions[start + j]
                ans_file.write(json.dumps({
                    "question_id": q["id"],
                    "prompt": q["conversations"][0]["value"],
                    "text": text,
                    "answer_id": uuid.uuid4().hex[:22],
                    "model_id": model_name,
                    "metadata": {},
                }) + "\n")
                ans_file.flush()


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--num-beams", "--num_beams",
                        dest="num_beams", type=int, default=1)
    parser.add_argument("--top-p", "--top_p", dest="top_p",
                        type=float, default=1.0)
    parser.add_argument("--compact-adapters", action="store_true",
                        help="gather adapter stacks to the batch-active "
                             "columns before prefill (token-identical)")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument(
        "--protocol", type=str, default=None, choices=["benchmark"],
        help="'benchmark' pins the shell-harness eval protocol — "
             "--conv-mode vicuna_v1 --temperature 0 (greedy), exactly what "
             "avqa.sh/MCUB-*.sh/music_avqa_*.sh pass (reference: "
             "scripts/model_composition/test/avqa.sh:49-50); a bare CLI "
             "run with argparse defaults would NOT reproduce the paper "
             "protocol")
    return parser


def parse_args(argv=None):
    """The CLI's arguments, with ``--protocol benchmark`` applied."""
    args = build_arg_parser().parse_args(argv)
    if args.protocol == "benchmark":
        args.conv_mode = "vicuna_v1"
        args.temperature = 0.0
    if args.model_base in ("", "None"):
        args.model_base = None
    return args


def main(argv=None):
    eval_model(parse_args(argv))


if __name__ == "__main__":
    main()
