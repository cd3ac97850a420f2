"""The smoke's kernel-against-plain answer check (``chip_smoke.
_kernel_vs_plain``, phase 13) on a tiny int8 model on the CPU, where the
"kernel" path runs the kernels' plain versions: its logits are within
LOGIT_TOL of the plain path's.

A follow-up call (ScienceQA's answer prompter puts the first answer into
the second prompt) whose prompt differs between the paths is held to the
plain path teacher-forced on the kernel path's prompt, not to the plain
path's answer to another prompt."""

import numpy as np
import pytest
import torch

import chip_smoke
from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
from modelcompose_tpu_torch.ops.quant import quantize_backbone
from modelcompose_tpu_torch.ops.routed_lora import fold_dense

IMG = MODAL_TOKEN_INDEXES["vision"]
TOKENS = 4


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           local_prefix_tokens=2, local_suffix_tokens=2,
                           dtype="bfloat16")
    m = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    m.params = quantize_backbone(m.params)
    m.params, table = fold_dense(m.params, m.routing_table)
    m.routing_table = table.numpy()
    return m


def _call(model, prompt):
    """(prompt, media, greedy answer) as ``_GenerateLog`` records a call."""
    ids = [np.array(prompt)]
    inputs = {"vision": np.random.default_rng(0).normal(
        size=(1, 28, 28, 3)).astype(np.float32)}
    with torch.no_grad():
        out = model.generate(ids, inputs, max_new_tokens=TOKENS,
                             kv_quant=False, attn_impl="reference")
    return ids, inputs, out


def _other(token, vocab):
    return (token + 1) % vocab


def _diverged_pair(model):
    """A first call whose plain answer differs from the kernel path's at
    its last token (checked as a near tie on the CPU, where both paths
    give the same logits, only when the plain top-2 gap is small: the
    call is picked so), then its follow-up on each path's answer."""
    for first in range(3, 60):
        k = _call(model, [1, first, IMG, 9])
        got = k[2][0]
        tokens = torch.tensor([got])
        with torch.no_grad():
            p = chip_smoke._teacher_forced(model, k[0], k[1], tokens,
                                           "reference", kv_quant=False)[0]
        top2 = p[-1].topk(2)
        if (top2.values[0] - top2.values[1]) / p[-1].abs().max() \
                < chip_smoke.LOGIT_TOL:
            break
    else:
        pytest.fail("no first call with a near tie at its last token")
    want = got[:-1] + [int(top2.indices[1])]
    plain = (k[0], k[1], [want])
    follow_k = _call(model, [1, IMG] + got + [9])
    follow_p = _call(model, [1, IMG] + want + [9])
    return k, plain, follow_k, follow_p


def test_follow_up_prompt_is_held_to_the_plain_path_on_its_prompt(model):
    """The follow-up's answers are to different prompts: the kernel path's
    answer passes as the plain path's greedy pick on its own prompt,
    whatever the plain path answered to the other prompt."""
    k, plain, follow_k, follow_p = _diverged_pair(model)
    follow_p = (follow_p[0], follow_p[1],
                [[_other(t, model.cfg.vocab_size) for t in follow_p[2][0]]])
    res = chip_smoke._kernel_vs_plain(model, [k, follow_k],
                                      [plain, follow_p])
    assert res[0]["equal"] is False and "diverge_step" in res[0]
    assert res[1]["follow_up"] and res[1]["tokens"] == len(follow_k[2][0])
    assert res[1]["rel"] <= chip_smoke.LOGIT_TOL
    assert res[1]["gap_to_plain_pick_rel"] == 0.0  # the greedy pick itself


def test_follow_up_answer_off_the_plain_pick_raises(model):
    """A kernel-path follow-up answer with a token far under the plain
    path's pick on that prompt raises."""
    k, plain, follow_k, follow_p = _diverged_pair(model)
    ids, inputs, out = follow_k
    with torch.no_grad():
        p = chip_smoke._teacher_forced(model, ids, inputs,
                                       torch.tensor(out), "reference",
                                       kv_quant=False)[0, 0]
    bad = [int(p.argmin())] + out[0][1:]
    with pytest.raises(AssertionError, match="follow-up"):
        chip_smoke._kernel_vs_plain(model, [k, (ids, inputs, [bad])],
                                    [plain, follow_p])


def test_prompts_differing_before_any_divergence_raise(model):
    """Prompts that differ with no earlier answer apart are a fault of the
    run, not a follow-up."""
    a = _call(model, [1, 5, IMG, 9])
    b = _call(model, [1, 6, IMG, 9])
    with pytest.raises(AssertionError, match="prompts differ"):
        chip_smoke._kernel_vs_plain(model, [a], [b])
