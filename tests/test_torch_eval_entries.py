"""The port's single-device eval entries beyond the QA loader
(``eval/model_qa``, ``eval/run_inference``, ``eval/model_multimodal_loss``,
``eval/retrieval``) against the JAX entries.

A tiny MCUB-4-shaped JAX model (four ``test:`` towers with every leaf
randomized, nonzero LoRA B and soft tokens) is carried across by
``model_from_jax``, and each entry runs on its own package's model through
``loaded=``, in fp32 on the CPU with the same tokenizer, over ``.png``,
``.jpg`` (a one-frame video), ``.wav`` and ``.npy`` media.  Answer lines
must be equal but for the random ``answer_id``, the ``run_inference``
text equal, the losses within 1e-5 (relative), and the retrieval ranks and
metrics equal.  Both packages' BEATs processors window the fbank in 64
frames and run the numpy fbank (see tests/test_torch_eval.py).

The loss and retrieval entries set ``pad_token_id = eos_token_id`` before
the v1 label mask, which then drops every sample in both packages (a
defect of the JAX entries the port keeps: ROADMAP Queue 3); the parity
tests score under the ``plain`` template, which masks without the pad id,
and one test pins the defect.
"""

import argparse
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

import modelcompose_tpu_torch.data.conversation as tconv
from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.eval import model_multimodal_loss as tloss
from modelcompose_tpu_torch.eval import model_qa as tqa
from modelcompose_tpu_torch.eval import retrieval as tret
from modelcompose_tpu_torch.eval import run_inference as trun
from tests.fake_tokenizer import FakeLlamaTokenizer
from tests.test_torch_compose import MODALS
from tests.test_torch_eval import (FRAMES, _short_audio_windows,  # noqa: F401
                                   _write_media)
from tests.test_torch_generate import _numpy_model, _perturb
from tests.test_torch_towers import _randomize

jconv = importlib.import_module("modelcompose_tpu.data.conversation")
jaudio = importlib.import_module("modelcompose_tpu.data.audio_processing")
jqa = importlib.import_module("modelcompose_tpu.eval.model_qa")
jrun = importlib.import_module("modelcompose_tpu.eval.run_inference")
jloss = importlib.import_module("modelcompose_tpu.eval.model_multimodal_loss")
jret = importlib.import_module("modelcompose_tpu.eval.retrieval")
KEYS = ["question_id", "text", "answer_id", "model_id", "metadata"]
MODEL_PATH = "ckpts/mcub4-multimodal"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_template(monkeypatch, name):
    """Both packages' module-global default template, restored after the
    test (the entries set it)."""
    monkeypatch.setattr(jconv, "default_conversation",
                        jconv.conv_templates[name])
    monkeypatch.setattr(tconv, "default_conversation",
                        tconv.conv_templates[name])


@pytest.fixture(autouse=True)
def _same_default_conversation(monkeypatch):
    _set_template(monkeypatch, "vicuna_v1")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(media root, JAX model, port model)."""
    kw = {}
    for towers in MODALS.values():
        kw.update(towers)
    cfg = tiny_test_config(local_prefix_tokens=1, local_suffix_tokens=2,
                           **kw)
    jm = _perturb(JaxLM.random_init(cfg, jax.random.PRNGKey(8)), 8)
    for i, enc in enumerate(jm.encoders.values()):
        enc.params = _randomize(enc.params, 9 + i)
    root = str(tmp_path_factory.mktemp("entries"))
    _write_media(root)
    return root, jm, model_from_jax(_numpy_model(jm), device="cpu")


@pytest.fixture
def loaded(models, monkeypatch):
    """(JAX loaded tuple, port loaded tuple), processors made inside the
    test (the 64-frame windows)."""
    root, jm, tm = models
    monkeypatch.chdir(root)
    numpy_fbank = jaudio.kaldi_fbank
    monkeypatch.setattr(jaudio, "kaldi_fbank", lambda *a, **k: numpy_fbank(
        *a, **dict(k, use_native=False)))
    jprocs = dict(jm.modal_processors(), audio=jaudio.BeatsAudioProcessor(
        frame_length=FRAMES,
        num_mel_bins=jm.encoders["audio"].cfg.fbank_bins))
    return ((FakeLlamaTokenizer(), jm, jprocs, 2048),
            (FakeLlamaTokenizer(), tm, tm.modal_processors(), 2048))


def _media(root):
    return {name: os.path.join(root, name)
            for name in ("img.png", "clip.jpg", "a.wav", "pc.npy")}


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# model_qa
# ---------------------------------------------------------------------------

def test_model_qa_answers_match_jax(loaded, tmp_path):
    qfile = tmp_path / "qa.jsonl"
    qfile.write_text("".join(json.dumps(q) + "\n" for q in [
        {"question_id": 1, "text": "What is the capital of France?",
         "category": "generic"},
        {"question_id": "q2", "text": "Name three primary colors.",
         "category": "knowledge"}]))
    answers = {}
    for name, mod, model in (("jax", jqa, loaded[0]),
                             ("port", tqa, loaded[1])):
        args = tqa.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--question-file", str(qfile),
            "--answers-file", str(tmp_path / f"{name}.jsonl"),
            "--temperature", "0", "--max-new-tokens", "6"])
        mod.eval_model(args, loaded=model)
        answers[name] = _read(args.answers_file)
    assert len(answers["port"]) == len(answers["jax"]) == 2
    for g, w in zip(answers["port"], answers["jax"]):
        assert list(g) == list(w) == KEYS
        assert {k: g[k] for k in KEYS if k != "answer_id"} \
            == {k: w[k] for k in KEYS if k != "answer_id"}
        assert len(g["answer_id"]) == 22
        assert g["model_id"] == "mcub4-multimodal"
    assert [g["question_id"] for g in answers["port"]] == [1, "q2"]
    assert sum(len(g["text"].split()) for g in answers["port"]) >= 2


def test_model_qa_sampled_follows_its_generator(loaded, tmp_path):
    qfile = tmp_path / "qa.jsonl"
    qfile.write_text(json.dumps({"question_id": 0, "text": "Why?"}) + "\n")
    texts = []
    for i in range(2):
        args = tqa.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--question-file", str(qfile),
            "--answers-file", str(tmp_path / f"s{i}.jsonl"),
            "--max-new-tokens", "6"])
        assert args.temperature == 0.7  # the JAX entry's default
        tqa.eval_model(args, loaded=loaded[1])
        texts.append(_read(args.answers_file)[0]["text"])
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# run_inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,media,conv_mode", [
    ("wav+npy", {"audio_file": "a.wav", "point_file": "pc.npy"}, "auto"),
    ("png", {"image_file": "img.png"}, "vicuna_v1"),
    ("jpg-video", {"video_file": "clip.jpg"}, "llava_v1")])
def test_run_inference_text_matches_jax(models, loaded, capsys, case,
                                        media, conv_mode):
    root = models[0]
    paths = _media(root)
    flags = []
    for key, name in media.items():
        flags += ["--" + key.replace("_", "-"), paths[name]]
    texts = {}
    for name, mod, model in (("jax", jrun, loaded[0]),
                             ("port", trun, loaded[1])):
        args = trun.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--query", "What is this?",
            "--conv-mode", conv_mode, "--max-new-tokens", "6"] + flags)
        texts[name] = mod.run(args, loaded=model)
        if conv_mode == "auto":  # 'mcub4-multimodal' names no family
            assert args.conv_mode == "llava_v0"
    assert texts["port"] == texts["jax"] and texts["port"]
    assert capsys.readouterr().out.splitlines()[-1] == texts["port"]


@pytest.mark.parametrize("name", ["llava-v1.5-7b", "Llama-2-7b-chat",
                                  "mpt-7b", "vicuna-7b", "MODEL-V1-x"])
def test_infer_conv_mode_matches_jax(name):
    assert trun.infer_conv_mode(name) == jrun.infer_conv_mode(name)


# ---------------------------------------------------------------------------
# model_multimodal_loss
# ---------------------------------------------------------------------------

def _gold_file(root, tmp_path):
    p = _media(root)

    def row(i, text, answer, **media):
        return {"id": f"r{i}", "conversations": [
            {"from": "human", "value": text}, {"from": "gpt", "value": answer}],
            "modal_inputs": {m: [p[f]] for m, f in media.items()}}
    rows = [row(0, "<audio>\nWhat makes this sound?", "A dog barking.",
                audio="a.wav"),
            row(1, "<point>\nWhat is this object?", "A wooden chair.",
                point="pc.npy"),
            row(2, "Which planet is largest?", "Jupiter is the largest."),
            row(3, "<image>\nDescribe the picture.", "Random colored noise.",
                vision="img.png")]
    path = tmp_path / "gold.json"
    path.write_text(json.dumps(rows))
    return str(path)


@pytest.mark.parametrize("batch,chunks", [(2, 1), (1, 2)])
def test_multimodal_loss_matches_jax(models, loaded, tmp_path, batch,
                                     chunks):
    root = models[0]
    qfile = _gold_file(root, tmp_path)
    losses = {}
    for name, mod, model in (("jax", jloss, loaded[0]),
                             ("port", tloss, loaded[1])):
        args = tloss.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--question-file", qfile,
            "--batch-size", str(batch), "--num-chunks", str(chunks),
            "--chunk-idx", "0", "--conv-mode", "plain"])
        losses[name] = mod.eval_loss(args, loaded=model)
    assert isinstance(losses["port"], float) and losses["port"] > 1.0
    assert abs(losses["port"] - losses["jax"]) <= 1e-5 * abs(losses["jax"])


def test_v1_label_mask_drops_every_sample_in_both_packages(models, loaded,
                                                           tmp_path):
    """The pinned defect: with ``pad_token_id = eos_token_id`` the v1 mask
    counts fewer tokens than its rounds hold, so every sample's labels are
    dropped; the mean loss is 0.0 and retrieval ranks each record's gold
    at its own index (every candidate ties at 0)."""
    root = models[0]
    qfile = _gold_file(root, tmp_path)
    rfile, records = _retrieval_file(root, tmp_path)
    for mod, ret, model in ((jloss, jret, loaded[0]),
                            (tloss, tret, loaded[1])):
        args = tloss.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--question-file", qfile,
            "--batch-size", "2"])
        assert args.conv_mode == "vicuna_v1"
        assert mod.eval_loss(args, loaded=model) == 0.0
        args = tret.build_arg_parser().parse_args([
            "--model-path", MODEL_PATH, "--question-file", rfile])
        assert ret.eval_retrieval(args, loaded=model) == ret.recall_metrics(
            [rec["gold"] for rec in records])
        assert ret.rank_candidates(model[1], model[0], records[0],
                                   model[2]) == [0.0] * len(CANDIDATES)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

CANDIDATES = ["a dog barking loudly", "rain on a tin roof",
              "a violin playing a scale", "people talking in a cafe"]


def _retrieval_file(root, tmp_path):
    p = _media(root)
    records = [
        {"id": 0, "conversations": [{"from": "human",
                                     "value": "<audio>\nDescribe the sound."}],
         "modal_inputs": {"audio": [p["a.wav"]]},
         "candidates": CANDIDATES, "gold": 2},
        {"id": 1, "conversations": [
            {"from": "human", "value": "<point>\nWhat is this?"},
            {"from": "gpt", "value": "placeholder"}],
         "modal_inputs": {"point": [p["pc.npy"]]},
         "candidates": ["a chair", "a lamp", "a table", "a mug"],
         "gold": 0}]
    path = tmp_path / "retrieval.json"
    path.write_text(json.dumps(records))
    return str(path), records


def test_retrieval_ranks_and_metrics_match_jax(models, loaded, tmp_path,
                                               monkeypatch, capsys):
    root = models[0]
    qfile, records = _retrieval_file(root, tmp_path)
    args = tret.build_arg_parser().parse_args([
        "--model-path", MODEL_PATH, "--question-file", qfile,
        "--conv-mode", "plain"])
    _set_template(monkeypatch, "plain")
    for rec in records:
        want = jret.rank_candidates(loaded[0][1], loaded[0][0], rec,
                                    loaded[0][2])
        got = tret.rank_candidates(loaded[1][1], loaded[1][0], rec,
                                   loaded[1][2])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert list(np.argsort(got)) == list(np.argsort(want))
        assert len(set(np.round(got, 4))) == len(got)  # no near-ties
    want = jret.eval_retrieval(args, loaded=loaded[0])
    got = tret.eval_retrieval(args, loaded=loaded[1])
    assert got == want and set(got) == {"R@1", "R@5", "R@10", "MedR"}
    out = capsys.readouterr().out.splitlines()
    assert out[-4:] == out[-8:-4]  # the same printed lines


@pytest.mark.parametrize("ranks", [[0, 0, 4, 12], [3], [0, 1, 2, 9, 10]])
def test_recall_metrics_match_jax(ranks):
    assert tret.recall_metrics(ranks) == jret.recall_metrics(ranks)


def test_entries_keep_the_jax_flags_and_add_device():
    """Every JAX flag with its default, plus ``--device``."""
    for name, jmod_name, argv in (
            ("model_qa", "model_qa", ["--model-path", "m", "--question-file",
                                      "q"]),
            ("run_inference", "run_inference", ["--model-path", "m",
                                                "--query", "q"]),
            ("model_multimodal_loss", "model_multimodal_loss",
             ["--model-path", "m", "--question-file", "q"]),
            ("retrieval", "retrieval", ["--model-path", "m",
                                        "--question-file", "q"])):
        tmod = importlib.import_module(f"modelcompose_tpu_torch.eval.{name}")
        args = vars(tmod.build_arg_parser().parse_args(argv))
        assert args.pop("device") is None
        jargs = _jax_cli_args(jmod_name, argv)
        assert args == jargs, name


def _jax_cli_args(name, argv):
    """The namespace the JAX entry's ``main`` parses from ``argv``."""
    jmod = importlib.import_module(f"modelcompose_tpu.eval.{name}")
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        ns = parse(self, argv, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jmod.main()
    finally:
        argparse.ArgumentParser.parse_args = parse
    return seen
