"""The port's eval entry (``eval/model_multimodal_qa_loader``) against the JAX
CLI on the same question file.

A tiny MCUB-4-shaped composition (four unimodal checkpoints written by the
JAX exporter, merged by the port's merge, the towers' checkpoints and a
sharded base beside them: tests/test_torch_compose.py's helpers) answers
image, audio, video (a ``.jpg`` as a one-frame clip), point and mixed
questions.  Both packages read the same files with the same tokenizer
(tests/fake_tokenizer.py), in fp32 on the CPU.  Every answer line must be
the JAX one, the random ``answer_id`` excepted.  Sampled answers draw from
different RNGs in the two frameworks, so the sampled CLI run is held to
its schema and to its own generator.

The tiny BEATs tower emits 8 tokens per fbank frame, so both packages'
audio processors window the fbank in 64 frames instead of 512 here, which
keeps a clip inside the Q-Former's 1,024 positions.
"""

import functools
import importlib
import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from modelcompose_tpu.config import ModelConfig

import modelcompose_tpu_torch.data.audio_processing as taudio
from modelcompose_tpu_torch.compose.merge import merge_checkpoints
from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as tqa
from tests.fake_tokenizer import FakeLlamaTokenizer
from tests.test_torch_compose import (MODALS, RESET, _write_base,
                                      _write_towers, _write_unimodal)

jqa = importlib.import_module("modelcompose_tpu.eval.model_multimodal_qa_loader")
jloader = importlib.import_module("modelcompose_tpu.models.loader")
jaudio = importlib.import_module("modelcompose_tpu.data.audio_processing")
FRAMES = 64  # fbank frames per BEATs window (see the module docstring)
KEYS = ["question_id", "prompt", "text", "answer_id", "model_id", "metadata"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _short_audio_windows(monkeypatch):
    monkeypatch.setattr(taudio, "BeatsAudioProcessor", functools.partial(
        taudio.BeatsAudioProcessor, frame_length=FRAMES))


def _write_media(root):
    from PIL import Image
    rng = np.random.default_rng(3)
    paths = {}
    for name, size in (("img.png", (40, 30)), ("clip.jpg", (36, 36))):
        paths[name] = os.path.join(root, name)
        Image.fromarray(rng.integers(0, 256, size[::-1] + (3,),
                                     dtype=np.uint8)).save(paths[name])
    paths["a.wav"] = os.path.join(root, "a.wav")
    with wave.open(paths["a.wav"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.normal(size=16000) * 3000).astype(
            np.int16).tobytes())
    paths["pc.npy"] = os.path.join(root, "pc.npy")
    np.save(paths["pc.npy"], rng.normal(size=(64, 6)).astype(np.float32))
    return paths


def _questions(paths, missing=False):
    def q(i, text, **media):
        return {"id": f"q{i}", "conversations": [
            {"from": "human", "value": text}, {"from": "gpt", "value": None}],
            "modal_inputs": {m: [paths[f]] for m, f in media.items()}}
    out = [q(0, "<image>\nWhat is in the picture?", vision="img.png"),
           q(1, "<audio>\nWhat makes this sound?", audio="a.wav"),
           q(2, "<video>\nWhat happens?", video="clip.jpg"),
           q(3, "<point>\nWhat is this object?", point="pc.npy"),
           q(4, "<image>\n<audio>\nDo they match?", vision="img.png",
             audio="a.wav")]
    if missing:
        out[1]["modal_inputs"] = {"vision": [paths["img.png"] + ".gone"]}
        out[1]["conversations"][0]["value"] = "<image>\nAnd this?"
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(root, merged checkpoint, base, question file, JAX loader output)."""
    root = str(tmp_path_factory.mktemp("qa"))
    paths = [_write_unimodal(root, m, 10 * i) for i, m in enumerate(MODALS)]
    merged = os.path.join(root, "mcub4-multimodal")
    merge_checkpoints(paths, merged, RESET)
    _write_towers(root)
    base, _ = _write_base(root, ModelConfig.load(
        os.path.join(merged, "config.json")), seed=20)
    qfile = os.path.join(root, "questions.json")
    with open(qfile, "w") as f:
        json.dump(_questions(_write_media(root)), f)
    cwd = os.getcwd()
    os.chdir(root)  # the towers' ``test:`` specs name files here
    try:
        jm = jloader.load_pretrained_model(
            merged, base, load_tokenizer_fn=lambda _: FakeLlamaTokenizer())
    finally:
        os.chdir(cwd)
    return root, merged, base, qfile, jm


def _argv(root, merged, base, qfile, name, *extra):
    return ["--model-path", merged, "--model-base", base, "--question-file",
            qfile, "--answers-file", os.path.join(root, name),
            "--max-new-tokens", "6", *extra]


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_jax(ckpt, argv, monkeypatch):
    """The JAX CLI's main() on ``argv``, its loader's output reused; the
    JAX BEATs processor on its numpy fbank, which the port copies (the
    native library agrees only to 2e-3)."""
    root, merged, *_, jm = ckpt
    numpy_fbank = jaudio.kaldi_fbank
    monkeypatch.setattr(jaudio, "kaldi_fbank", lambda *a, **k: numpy_fbank(
        *a, **dict(k, use_native=False)))
    procs = dict(jm[2], audio=jaudio.BeatsAudioProcessor(
        frame_length=FRAMES, num_mel_bins=jm[2]["audio"].num_mel_bins))
    monkeypatch.setattr(jqa, "load_pretrained_model",
                        lambda mp, mb, mn: (FakeLlamaTokenizer(), jm[1],
                                            procs, jm[3]))
    monkeypatch.setattr(sys, "argv", ["qa"] + argv)
    jqa.main()


@pytest.mark.parametrize("case,extra,n_lines", [
    ("benchmark", ["--protocol", "benchmark"], 5),
    ("beams", ["--protocol", "benchmark", "--num-beams", "2",
               "--batch-size", "4"], 5),
    ("compact", ["--protocol", "benchmark", "--compact-adapters",
                 "--batch-size", "2"], 5),
    ("chunks", ["--protocol", "benchmark", "--num-chunks", "3",
                "--chunk-idx", "1"], 2),
])
def test_answers_match_jax(ckpt, monkeypatch, case, extra, n_lines):
    root, merged, base, qfile, _ = ckpt
    monkeypatch.chdir(root)
    _run_jax(ckpt, _argv(root, merged, base, qfile, f"jax-{case}.jsonl",
                         *extra), monkeypatch)
    args = tqa.parse_args(_argv(root, merged, base, qfile,
                                f"port-{case}.jsonl", *extra))
    assert args.conv_mode == "vicuna_v1" and args.temperature == 0.0
    tqa.eval_model(args, load_tokenizer_fn=lambda _: FakeLlamaTokenizer(),
                   device="cpu")
    want = _read(os.path.join(root, f"jax-{case}.jsonl"))
    got = _read(os.path.join(root, f"port-{case}.jsonl"))
    assert len(got) == len(want) == n_lines
    for g, w in zip(got, want):
        assert list(g) == list(w) == KEYS
        assert {k: g[k] for k in KEYS if k != "answer_id"} \
            == {k: w[k] for k in KEYS if k != "answer_id"}
        assert len(g["answer_id"]) == 22 and g["model_id"] == \
            "mcub4-multimodal"
    if case == "chunks":
        assert [g["question_id"] for g in got] == ["q2", "q3"]
    # the answers are real generations, not empty strings
    assert sum(len(g["text"].split()) for g in got) >= n_lines


def test_sampled_cli_follows_its_generator(ckpt, monkeypatch):
    """--temperature 0.2 --top-p 0.7 (the CLI's default conversation mode):
    one line per question, the same texts from the same seed."""
    root, merged, base, qfile, _ = ckpt
    monkeypatch.chdir(root)
    texts = []
    for i in range(2):
        args = tqa.parse_args(_argv(root, merged, base, qfile,
                                    f"sampled-{i}.jsonl", "--temperature",
                                    "0.2", "--top-p", "0.7"))
        assert args.conv_mode == "llava_v1" and args.top_p == 0.7
        tqa.eval_model(args, load_tokenizer_fn=lambda _: FakeLlamaTokenizer(),
                       device="cpu")
        lines = _read(args.answers_file)
        assert [l["question_id"] for l in lines] == [f"q{i}" for i in
                                                      range(5)]
        texts.append([l["text"] for l in lines])
    assert texts[0] == texts[1]


def test_missing_media_raises(ckpt, monkeypatch, tmp_path):
    """A question whose image cannot be read stops the run: it is never
    skipped or answered from another sample."""
    root, merged, base, _, _ = ckpt
    monkeypatch.chdir(root)
    qfile = str(tmp_path / "q.json")
    with open(qfile, "w") as f:
        json.dump(_questions(_write_media(str(tmp_path)), missing=True), f)
    args = tqa.parse_args(_argv(str(tmp_path), merged, base, qfile,
                                "ans.jsonl", "--protocol", "benchmark"))
    with pytest.raises(FileNotFoundError):
        tqa.eval_model(args, load_tokenizer_fn=lambda _: FakeLlamaTokenizer(),
                       device="cpu")
    assert len(_read(args.answers_file)) == 1  # q0 only, then the raise


def test_cli_defaults_match_jax(monkeypatch):
    argv = ["--model-path", "m", "--question-file", "q"]
    monkeypatch.setattr(sys, "argv", ["qa"] + argv)
    seen = {}
    monkeypatch.setattr(jqa, "eval_model", lambda a: seen.update(vars(a)))
    jqa.main()
    got = vars(tqa.parse_args(argv))
    assert got == seen
    assert (got["temperature"], got["conv_mode"], got["max_new_tokens"]) \
        == (0.2, "llava_v1", 128)
