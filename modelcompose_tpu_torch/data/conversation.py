"""Conversation prompt templates (the port's copy of
modelcompose_tpu/data/conversation.py).

Functionally identical prompt strings to the reference's template registry
(reference: modelcompose/conversation.py:15-378) — the byte-exact prompts are
required for eval-answer parity.  Implementation is a small functional
renderer over a template dataclass rather than the reference's stateful
class, but ``copy()/append_message()/get_prompt()`` keep their surface so
eval/serving code ports 1:1.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], \
                        "first message should come from user"
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        if style == SeparatorStyle.PLAIN:
            # conv_llava_plain has sep2=None; the reference crashes with a
            # TypeError when a second turn renders (conversation.py:91-97)
            # — treat a missing sep2 as '' instead.
            seps = [self.sep, self.sep2 if self.sep2 is not None else ""]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[x, y] for x, y in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version)

    def dict(self) -> dict:
        return {"system": self.system, "roles": self.roles,
                "messages": self.messages, "offset": self.offset,
                "sep": self.sep, "sep2": self.sep2}


# The v0 template carries a two-message few-shot example (offset=2 skips it
# when collecting user turns); required verbatim for prompt byte-parity.
_V0_EXAMPLE = [
    ["Human", "What are the key differences between renewable and "
              "non-renewable energy sources?"],
    ["Assistant",
     "Renewable energy sources are those that can be replenished naturally "
     "in a relatively short amount of time, such as solar, wind, hydro, "
     "geothermal, and biomass. Non-renewable energy sources, on the other "
     "hand, are finite and will eventually be depleted, such as coal, oil, "
     "and natural gas. Here are some key differences between renewable and "
     "non-renewable energy sources:\n"
     "1. Availability: Renewable energy sources are virtually "
     "inexhaustible, while non-renewable energy sources are finite and "
     "will eventually run out.\n"
     "2. Environmental impact: Renewable energy sources have a much lower "
     "environmental impact than non-renewable sources, which can lead to "
     "air and water pollution, greenhouse gas emissions, and other "
     "negative effects.\n"
     "3. Cost: Renewable energy sources can be more expensive to initially "
     "set up, but they typically have lower operational costs than "
     "non-renewable sources.\n"
     "4. Reliability: Renewable energy sources are often more reliable and "
     "can be used in more remote locations than non-renewable sources.\n"
     "5. Flexibility: Renewable energy sources are often more flexible and "
     "can be adapted to different situations and needs, while non-renewable "
     "sources are more rigid and inflexible.\n"
     "6. Sustainability: Renewable energy sources are more sustainable "
     "over the long term, while non-renewable sources are not, and their "
     "depletion can lead to economic and social instability.\n"],
]

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[list(m) for m in _V0_EXAMPLE],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user "
           "provides, and assist the user with a variety of tasks using "
           "natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant is able to understand the visual "
           "content that the user provides, and assist the user with a "
           "variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant is able to understand the visual "
           "content that the user provides, and assist the user with a "
           "variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

default_conversation = conv_vicuna_v0
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
