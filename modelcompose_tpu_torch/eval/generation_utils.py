"""Shared per-question generation helper for the eval loaders (the port's
copy of modelcompose_tpu/eval/generation_utils.py; ``generate_text`` takes
a ``torch.Generator`` where the JAX version takes a PRNG key).

The legacy loaders (model_vqa, model_vqa_loader, model_vqa_mmbench,
model_vqa_science) run the same tokenize -> generate -> decode ->
strip-stop sequence against a conversation template; keeping it in one
place stops the copies from drifting (e.g. a stop-matching fix landing
in only one loader)."""

from __future__ import annotations

import numpy as np

from ..data.conversation import SeparatorStyle
from ..data.tokenization import tokenizer_modal_token


def stop_str_for(conv_template) -> str:
    """The per-template stop separator (reference:
    model_vqa.py-era ``conv.sep if sep_style != TWO else conv.sep2``)."""
    return conv_template.sep \
        if conv_template.sep_style != SeparatorStyle.TWO \
        else conv_template.sep2


def generate_text(model, tokenizer, prompt: str, modal_inputs, *,
                  temperature: float, max_new_tokens: int, generator,
                  stop_str, num_beams: int = 1,
                  top_p: float = 1.0) -> str:
    """One greedy/sampled/beam generation, decoded and stop-stripped
    (num_beams>1 runs beam search, reference: model_vqa.py:72,109)."""
    ids = np.asarray(tokenizer_modal_token(prompt, tokenizer), np.int64)
    tokens = model.generate(
        [ids], modal_inputs, max_new_tokens=max_new_tokens,
        temperature=temperature if temperature > 1e-4 else 0.0,
        top_p=top_p, num_beams=num_beams, generator=generator)[0]
    text = tokenizer.decode(tokens, skip_special_tokens=True).strip()
    if stop_str and text.endswith(stop_str):
        text = text[:-len(stop_str)]
    return text.strip()
