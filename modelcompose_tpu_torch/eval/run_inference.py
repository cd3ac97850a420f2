"""Single-shot multimodal inference (counterpart of
modelcompose_tpu/eval/run_inference.py): load a composed checkpoint,
answer one prompt over optional media, print the text.

Usage (on the card)::

    python -m modelcompose_tpu_torch.eval.run_inference --model-path ckpt \\
        --model-base vicuna --audio-file clip.wav --query "what is this?"

``--image-file`` is read by ``data.image_io`` (PNG without PIL, which the
card's machine lacks; other formats through PIL); audio (``.wav``), video
and point (``.npy``) files go through the model's processors.
``--temperature`` above 0 draws from a ``torch.Generator`` seeded 0 on the
model's device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import conversation as conversation_lib
from ..data import image_io
from ..data.conversation import SeparatorStyle, conv_templates
from ..data.tokenization import tokenizer_modal_token
from ..models.loader import load_pretrained_model


def infer_conv_mode(model_name: str) -> str:
    """Auto conv-mode from the model name (the run_llava.py behavior,
    reference: modelcompose/eval/run_llava.py:40-52)."""
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "v1" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"


def load_image(image_file: str) -> np.ndarray:
    """Local path or http(s) URL (reference: run_llava.py:17-23) ->
    uint8 [H, W, 3] through ``data.image_io.load_image``."""
    if image_file.startswith(("http://", "https://")):
        import urllib.request
        with urllib.request.urlopen(image_file) as resp:
            return image_io.load_image(resp.read())
    return image_io.load_image(image_file)


def run(args, loaded=None, *, load_tokenizer_fn=None, device=None) -> str:
    """Answer ``args.query`` over the media ``args`` names; prints and
    returns the text."""
    if loaded is None:
        model_path = os.path.expanduser(args.model_path)
        loaded = load_pretrained_model(
            model_path, args.model_base,
            os.path.basename(model_path.rstrip("/")),
            load_tokenizer_fn=load_tokenizer_fn, device=device)
    tokenizer, model, processors, _ = loaded
    if args.conv_mode == "auto":
        name = args.model_path.rstrip("/").split("/")[-1]
        args.conv_mode = infer_conv_mode(name)
    conversation_lib.default_conversation = conv_templates[args.conv_mode]

    modal_inputs = {}
    prefix = ""
    if args.image_file:
        from ..data.image_processing import process_images
        img = load_image(args.image_file)
        modal_inputs["vision"] = process_images(
            [img], processors["vision"], image_aspect_ratio="pad")
        prefix += "<image>\n"
    if args.audio_file:
        from ..data.audio_processing import collate_audio_inputs
        modal_inputs["audio"] = collate_audio_inputs(
            processors["audio"], [args.audio_file])
        prefix += "<audio>\n"
    if args.video_file:
        modal_inputs["video"] = processors["video"](args.video_file)
        prefix += "<video>\n"
    if args.point_file:
        modal_inputs["point"] = processors["point"]([args.point_file])
        prefix += "<point>\n"

    conv = conv_templates[args.conv_mode].copy()
    conv.append_message(conv.roles[0], prefix + args.query)
    conv.append_message(conv.roles[1], None)
    ids = np.asarray(tokenizer_modal_token(conv.get_prompt(), tokenizer),
                     np.int64)
    generator = torch.Generator(device=model.device).manual_seed(0)
    tokens = model.generate([ids], modal_inputs,
                            max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature,
                            generator=generator)[0]
    text = tokenizer.decode(tokens, skip_special_tokens=True).strip()
    stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    if stop and text.endswith(stop):
        text = text[:-len(stop)].strip()
    print(text)
    return text


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--query", required=True)
    # 'auto' infers the template from the model name; a name overrides
    parser.add_argument("--conv-mode", default="auto")
    parser.add_argument("--image-file", default=None)
    parser.add_argument("--audio-file", default=None)
    parser.add_argument("--video-file", default=None)
    parser.add_argument("--point-file", default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    run(args, device=args.device)


if __name__ == "__main__":
    main()
