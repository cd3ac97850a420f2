"""Conversation -> (input_ids, labels) preprocessing (the port's copy of
modelcompose_tpu/data/preprocess.py).

Rebuild of the reference's prompt builders (reference: modelcompose/data/
utils.py:74-345): render the conversation through the active template,
tokenize with modal placeholder injection, and mask human turns with
IGNORE_INDEX.  Variants: plain (stage-1 pretrain), v1 (vicuna), llama_2,
mpt.  Output is numpy; the active template is
``data.conversation.default_conversation`` exactly like the reference's
module global.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from ..constants import IGNORE_INDEX
from . import conversation as conversation_lib
from .conversation import SeparatorStyle
from .tokenization import tokenizer_modal_token


def _render_conversations(sources, conv):
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]  # skip a leading non-human turn
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _tokenize_batch(conversations, tokenizer, has_image):
    if has_image:
        return [np.asarray(tokenizer_modal_token(p, tokenizer), np.int64)
                for p in conversations]
    return [np.asarray(tokenizer(p).input_ids, np.int64)
            for p in conversations]


def _mask_rounds(conversations, input_ids, tokenizer, conv, sep, has_image,
                 model_max_length):
    """Shared v1/llama_2 masking: IGNORE everything except assistant spans
    (reference: data/utils.py:115-143, 193-230)."""
    targets = [ids.copy() for ids in input_ids]

    def tok_len(text):
        if has_image:
            return len(tokenizer_modal_token(text, tokenizer))
        return len(tokenizer(text).input_ids)

    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum()) \
            if tokenizer.pad_token_id is not None else len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = tok_len(rou)
            instruction_len = tok_len(parts[0]) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX  # tokenization mismatch -> drop sample
    return targets


def preprocess_v1(sources, tokenizer, has_image: bool = False) -> Dict:
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = _tokenize_batch(conversations, tokenizer, has_image)
    assert conv.sep_style == SeparatorStyle.TWO
    sep = conv.sep + conv.roles[1] + ": "
    targets = _mask_rounds(conversations, input_ids, tokenizer, conv, sep,
                           has_image,
                           getattr(tokenizer, "model_max_length", 1 << 30))
    return dict(input_ids=input_ids, labels=targets)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False) -> Dict:
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = _tokenize_batch(conversations, tokenizer, has_image)
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    targets = _mask_rounds(conversations, input_ids, tokenizer, conv,
                           "[/INST] ", has_image,
                           getattr(tokenizer, "model_max_length", 1 << 30))
    return dict(input_ids=input_ids, labels=targets)


def preprocess_mpt(sources, tokenizer) -> Dict:
    """MPT chat-ml masking (reference: data/utils.py:238-301): rounds split
    on '<|im_end|>' and regrouped as [system+user+gpt], then [user+gpt]
    pairs; only assistant spans keep labels."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [np.asarray(tokenizer_modal_token(p, tokenizer), np.int64)
                 for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    assert conv.sep_style == SeparatorStyle.MPT

    def tok_len(text):
        return len(tokenizer_modal_token(text, tokenizer))

    sep = conv.sep + conv.roles[1]
    model_max_length = getattr(tokenizer, "model_max_length", 1 << 30)
    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum()) \
            if tokenizer.pad_token_id is not None else len(target)
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]  # system + user + gpt
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx:conv_idx + 2]))
        cur_len = 0
        target[:cur_len] = IGNORE_INDEX
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = tok_len(rou) + tok_len(conv.sep)
            instruction_len = tok_len(parts[0])
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX  # tokenization mismatch -> drop sample
    return dict(input_ids=input_ids, labels=targets)


def preprocess_plain(sources, tokenizer) -> Dict:
    """Stage-1: '<modal>caption' concat, media span + prompt masked
    (reference: data/utils.py:305-324)."""
    conversations = []
    for source in sources:
        assert len(source) == 2
        conversations.append(source[0]["value"] + source[1]["value"] +
                             conversation_lib.default_conversation.sep)
    input_ids = [np.asarray(tokenizer_modal_token(p, tokenizer), np.int64)
                 for p in conversations]
    targets = copy.deepcopy(input_ids)
    for target, source in zip(targets, sources):
        tokenized_len = len(tokenizer_modal_token(source[0]["value"],
                                                  tokenizer))
        target[:tokenized_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=targets)


def preprocess_default(sources, tokenizer, has_image: bool = False) -> Dict:
    """The v0 '### ' signal fallback (reference: data/utils.py:17-45,
    346-371): header + '### {role}: {text}\\n' per round + trailing '### ';
    header masked, human rounds masked from offset +2."""
    conv = conversation_lib.default_conversation
    begin, end = "### ", "\n"
    conversations, rendered = [], []
    for source in sources:
        header = f"{conv.system}\n\n"
        conversation = header
        vals = []
        for sentence in source:
            frm = sentence["from"].lower()
            from_str = conv.roles[0] if frm == "human" else \
                (conv.roles[1] if frm == "gpt" else "unknown")
            val = begin + from_str + ": " + sentence["value"] + end
            vals.append(val)
            conversation += val
        conversations.append(conversation + begin)
        rendered.append((header, vals))

    def tok_len(text):
        if has_image:
            return len(tokenizer_modal_token(text, tokenizer))
        ids = np.asarray(tokenizer(text).input_ids)
        if tokenizer.pad_token_id is not None:
            return int((ids != tokenizer.pad_token_id).sum())
        return len(ids)

    input_ids = _tokenize_batch(conversations, tokenizer, has_image)
    targets = [ids.copy() for ids in input_ids]
    for target, (header, vals), source in zip(targets, rendered, sources):
        lens = [tok_len(t) for t in [header] + vals]
        cur = lens[0]
        target[:cur] = IGNORE_INDEX
        for tl, sentence in zip(lens[1:], source):
            if sentence["from"] == "human":
                target[cur + 2:cur + tl] = IGNORE_INDEX
            cur += tl
    return dict(input_ids=input_ids, labels=targets)


def preprocess(sources: Sequence[List[dict]], tokenizer,
               has_image: bool = False) -> Dict:
    conv = conversation_lib.default_conversation
    if conv.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer)
    # v0 / default templates fall through to the '### ' signal path
    # exactly like the reference (data/utils.py:346-371)
    return preprocess_default(sources, tokenizer, has_image=has_image)
