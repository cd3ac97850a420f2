"""Terminal chat client (counterpart of modelcompose_tpu/serve/cli.py;
reference: modelcompose/serve/cli.py): loads a composed checkpoint onto
the card (or ``--device``) and chats, with optional media for the
conversation.

Sampling draws from one ``torch.Generator`` seeded 0 on the model's device
(the JAX CLI passes ``PRNGKey(0)``); greedy answers (temperature at or
below 1e-4) are the same in both packages.

Usage: python -m modelcompose_tpu_torch.serve.cli --model-path ckpt \\
    --model-base vicuna --audio-file clip.wav
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import conversation as conversation_lib
from ..data.conversation import SeparatorStyle, conv_templates
from ..data.tokenization import tokenizer_modal_token


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--conv-mode", type=str, default="vicuna_v1")
    parser.add_argument("--image-file", type=str, default=None)
    parser.add_argument("--audio-file", type=str, default=None)
    parser.add_argument("--video-file", type=str, default=None)
    parser.add_argument("--point-file", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top-p", "--top_p", dest="top_p",
                        type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None, *, load_tokenizer_fn=None):
    """Read turns from stdin until an empty line or EOF, printing each
    answer.  ``load_tokenizer_fn`` (base dir -> tokenizer) replaces the
    base's HF tokenizer, which needs ``transformers``."""
    args = build_arg_parser().parse_args(argv)

    from ..models.loader import load_pretrained_model
    model_name = args.model_path.rstrip("/").split("/")[-1]
    tokenizer, model, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, model_name,
        load_tokenizer_fn=load_tokenizer_fn, device=args.device)

    conv = conv_templates[args.conv_mode].copy()
    conversation_lib.default_conversation = conv

    modal_inputs = {}
    media_prefix = ""
    if args.image_file:
        from ..data.image_io import load_image
        from ..data.image_processing import process_images
        img = load_image(args.image_file)
        modal_inputs["vision"] = process_images([img], processors["vision"],
                                                image_aspect_ratio="pad")
        media_prefix += "<image>\n"
    if args.audio_file:
        from ..data.audio_processing import collate_audio_inputs
        modal_inputs["audio"] = collate_audio_inputs(
            processors["audio"], [args.audio_file])
        media_prefix += "<audio>\n"
    if args.video_file:
        modal_inputs["video"] = processors["video"](args.video_file)
        media_prefix += "<video>\n"
    if args.point_file:
        modal_inputs["point"] = processors["point"]([args.point_file])
        media_prefix += "<point>\n"

    generator = torch.Generator(device=model.device).manual_seed(0)
    first_turn = True
    while True:
        try:
            inp = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if not inp:
            break
        if first_turn and media_prefix:
            inp = media_prefix + inp
            first_turn = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids = np.asarray(tokenizer_modal_token(prompt, tokenizer), np.int64)
        # the media go in every turn: the history keeps the modal token,
        # so each re-packed prompt needs the features
        tokens = model.generate(
            [ids], modal_inputs,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature if args.temperature > 1e-4 else 0.0,
            top_p=args.top_p,
            generator=generator)[0]
        text = tokenizer.decode(tokens, skip_special_tokens=True).strip()
        stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        if stop and text.endswith(stop):
            text = text[:-len(stop)].strip()
        conv.messages[-1][-1] = text
        print(f"{conv.roles[1]}: {text}")


if __name__ == "__main__":
    main()
