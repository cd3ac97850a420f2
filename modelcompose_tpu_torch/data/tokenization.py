"""Prompt tokenization with modal placeholder injection (the port's copy of
modelcompose_tpu/data/tokenization.py).

Rebuild of the reference's ``tokenizer_modal_token`` /
``tokenizer_image_token`` (reference: modelcompose/mm_utils.py:43-101): split
the prompt on modal token strings, tokenize each chunk, and join with the
negative placeholder ids, deduplicating the BOS token that sentencepiece
prepends to every chunk.  Output is a plain numpy int array — the negative
ids are resolved by core/packing at batch time.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..constants import IMAGE_TOKEN_INDEX, MODAL_TOKEN_MAPPING


def split_string_by_list(text: str, separators: List[str]
                         ) -> List[Tuple[str, Optional[str]]]:
    """Split text into (chunk, separator) pairs at each separator occurrence
    (reference: mm_utils.py:65-80)."""
    splits: List[Tuple[str, Optional[str]]] = []
    current = ""
    for char in text:
        current += char
        # `current` is reset after every hit, so a new occurrence can only
        # appear as a suffix — endswith is equivalent to the reference's
        # `in` scan but linear instead of O(len(current)) per char.
        hit = next((s for s in separators if current.endswith(s)), None)
        if hit is not None:
            splits.append((current[:-len(hit)], hit))
            current = ""
    if current:
        splits.append((current, None))
    return splits


def _join_chunks(chunk_ids: List[List[int]], seps: List[Optional[int]],
                 bos_token_id: Optional[int]) -> List[int]:
    input_ids: List[int] = []
    offset = 0
    if chunk_ids and chunk_ids[0] and bos_token_id is not None and \
            chunk_ids[0][0] == bos_token_id:
        offset = 1
        input_ids.append(chunk_ids[0][0])
    for ids, sep in zip(chunk_ids, seps):
        input_ids.extend(ids[offset:])
        if sep is not None:
            input_ids.append(sep)
    return input_ids


def tokenizer_modal_token(prompt: str, tokenizer,
                          return_tensors: Optional[str] = None):
    """Tokenize a prompt containing <image>/<audio>/<video>/<point> markers
    into ids with negative modal placeholders (reference:
    mm_utils.py:81-101)."""
    chunks = split_string_by_list(prompt, list(MODAL_TOKEN_MAPPING.keys()))
    chunk_ids = [tokenizer(chunk).input_ids for chunk, _ in chunks]
    seps = [MODAL_TOKEN_MAPPING[s] if s is not None else None
            for _, s in chunks]
    input_ids = _join_chunks(chunk_ids, seps,
                             getattr(tokenizer, "bos_token_id", None))
    if return_tensors == "np":
        return np.asarray(input_ids, np.int64)
    if return_tensors == "pt":
        import torch
        return torch.tensor(input_ids, dtype=torch.long)
    if return_tensors is not None:
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX,
                          return_tensors: Optional[str] = None):
    """Image-only variant (reference: mm_utils.py:43-62)."""
    chunks = prompt.split("<image>")
    chunk_ids = [tokenizer(c).input_ids for c in chunks]
    seps: List[Optional[int]] = [image_token_index] * (len(chunks) - 1) + [None]
    input_ids = _join_chunks(chunk_ids, seps,
                             getattr(tokenizer, "bos_token_id", None))
    if return_tensors == "np":
        return np.asarray(input_ids, np.int64)
    if return_tensors == "pt":
        import torch
        return torch.tensor(input_ids, dtype=torch.long)
    if return_tensors is not None:
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
