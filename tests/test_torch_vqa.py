"""The port's LLaVA-suite VQA entries (``eval/model_vqa``,
``model_vqa_loader``, ``model_vqa_science``, ``model_vqa_mmbench``) against
the JAX entries.

A tiny vision model (a ``test:`` CLIP tower with every leaf randomized,
nonzero LoRA B and soft tokens) is carried across by ``model_from_jax``;
each entry runs on its own package's model through ``loaded=``, greedy, in
fp32 on the CPU with the same tokenizer, over PNG files (the port decodes
them itself, the JAX entries through PIL) and base64 PNGs in an MMBench
TSV.  The answer files must be equal key for key and text for text but for
the random ``answer_id``, and the JAX package's own scorers (POPE,
ScienceQA, the MMBench upload table; none imports JAX) must score the
port's files as they score the JAX entries'.
"""

import base64
import importlib
import io
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

import modelcompose_tpu_torch.data.conversation as tconv
from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.eval import model_vqa as tvqa
from modelcompose_tpu_torch.eval import model_vqa_loader as tloader
from modelcompose_tpu_torch.eval import model_vqa_mmbench as tmmbench
from modelcompose_tpu_torch.eval import model_vqa_science as tscience
from tests import fake_tokenizer
from tests.fake_tokenizer import FakeLlamaTokenizer
from tests.test_torch_generate import _numpy_model, _perturb
from tests.test_torch_towers import _randomize

jconv = importlib.import_module("modelcompose_tpu.data.conversation")
jvqa = importlib.import_module("modelcompose_tpu.eval.model_vqa")
jloader = importlib.import_module("modelcompose_tpu.eval.model_vqa_loader")
jscience = importlib.import_module("modelcompose_tpu.eval.model_vqa_science")
jmmbench = importlib.import_module("modelcompose_tpu.eval.model_vqa_mmbench")
jpope = importlib.import_module("modelcompose_tpu.eval.eval_pope")
jsqa = importlib.import_module("modelcompose_tpu.eval.eval_science_qa")
jsubmit = importlib.import_module(
    "modelcompose_tpu.eval.convert_for_submission")
MODEL_PATH = "ckpts/llava-vision-multimodal"
SIZES = {"a.png": (40, 30), "b.png": (23, 51), "c.png": (28, 28)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fixed_token_ids(monkeypatch):
    """The fake tokenizer's builtin hash is salted per process: crc32 fixes
    the ids, so every run asks the same prompts."""
    monkeypatch.setattr(fake_tokenizer, "hash",
                        lambda w: zlib.crc32(w.encode()), raising=False)


@pytest.fixture(autouse=True)
def _default_conversation(monkeypatch):
    """Both packages' module-global default template, restored after the
    test (the entries set it)."""
    monkeypatch.setattr(jconv, "default_conversation",
                        jconv.default_conversation)
    monkeypatch.setattr(tconv, "default_conversation",
                        tconv.default_conversation)


def _png(path_or_buf, size, seed):
    """A smooth image with noise, so PIL's encoder uses every row filter."""
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.default_rng(seed).integers(0, 40, (h, w, 3))
    arr = (np.stack([xx * 5, yy * 7, xx * 3 + yy * 2], -1) + noise) % 256
    Image.fromarray(arr.astype(np.uint8)).save(path_or_buf, format="PNG")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(image folder, JAX loaded tuple, port loaded tuple)."""
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           local_prefix_tokens=2, local_suffix_tokens=2)
    jm = _perturb(JaxLM.random_init(cfg, jax.random.PRNGKey(5)), 5)
    for enc in jm.encoders.values():
        enc.params = _randomize(enc.params, 6)
    tm = model_from_jax(_numpy_model(jm), device="cpu")
    root = tmp_path_factory.mktemp("vqa")
    for i, (name, size) in enumerate(SIZES.items()):
        _png(str(root / name), size, i)
    return (str(root),
            (FakeLlamaTokenizer(), jm, jm.modal_processors(), 2048),
            (FakeLlamaTokenizer(), tm, tm.modal_processors(), 2048))


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(models, tmp_path, jmod, tmod, argv):
    """Each package's entry on its own model -> (JAX lines, port lines),
    held equal but for ``answer_id``."""
    out = {}
    for name, mod, loaded in (("jax", jmod, models[1]),
                              ("port", tmod, models[2])):
        answers = str(tmp_path / f"{name}.jsonl")
        args = tmod.build_arg_parser().parse_args(
            ["--model-path", MODEL_PATH, "--answers-file", answers,
             "--temperature", "0", "--max-new-tokens", "4"] + argv)
        mod.eval_model(args, loaded=loaded)
        out[name] = _read(answers)
    for j, t in zip(out["jax"], out["port"]):
        assert list(t) == list(j)
        assert {k: v for k, v in t.items() if k != "answer_id"} \
            == {k: v for k, v in j.items() if k != "answer_id"}
        assert len(t["answer_id"]) == 22
    assert len(out["port"]) == len(out["jax"])
    assert any(line["text"] for line in out["port"])
    return out["jax"], out["port"]


def test_model_vqa_matches_jax_and_pope_scores(models, tmp_path):
    root = models[0]
    qfile = tmp_path / "q.jsonl"
    rows = [{"question_id": 0, "image": "a.png",
             "text": "Is there a cat in the image?"},
            {"question_id": "q1", "image": "b.png",
             "text": "<image>\nIs the sky blue?"},
            {"question_id": 2, "text": "Is water wet?"}]
    qfile.write_text("".join(json.dumps(r) + "\n" for r in rows))
    jax_lines, port_lines = _run_both(models, tmp_path, jvqa, tvqa, [
        "--question-file", str(qfile), "--image-folder", root])
    assert [line["prompt"] for line in port_lines] == [r["text"]
                                                       for r in rows]
    labels = tmp_path / "labels.jsonl"
    labels.write_text("".join(json.dumps({"label": v}) + "\n"
                              for v in ("yes", "no", "yes")))
    assert jpope.eval_pope(port_lines, str(labels), verbose=False) \
        == jpope.eval_pope(jax_lines, str(labels), verbose=False)


@pytest.mark.parametrize("add_token", [True, False])
def test_model_vqa_loader_matches_jax(models, tmp_path, add_token):
    """One image and a list of two per row, with and without
    ``--no_add_image_token``, through the prefetch threads."""
    root = models[0]
    prefix = "" if add_token else "<image>\n"
    qfile = tmp_path / "q.jsonl"
    qfile.write_text("".join(json.dumps(r) + "\n" for r in [
        {"question_id": 0, "image": "a.png",
         "text": prefix + "What is shown?"},
        {"question_id": 1, "image": ["b.png", "c.png"],
         "text": prefix * 2 + "Which image is larger?"}]))
    flags = [] if add_token else ["--no_add_image_token"]
    _run_both(models, tmp_path, jloader, tloader, [
        "--question-file", str(qfile), "--image-folder", root,
        "--num-workers", "2"] + flags)


def test_model_vqa_science_matches_jax_and_scores(models, tmp_path):
    """``--answer-prompter`` and ``--single-pred-prompt`` over an image row
    and a text row; eval_science_qa scores both files alike."""
    root = models[0]
    qfile = tmp_path / "problems.json"
    qfile.write_text(json.dumps([
        {"id": "p0", "image": "a.png", "conversations": [
            {"from": "human",
             "value": "<image>\nWhich animal?\nA. cat\nB. dog"}]},
        {"id": "p1", "conversations": [
            {"from": "human", "value": "Which is hot?\nA. ice\nB. fire"}]}]))
    jax_lines, port_lines = _run_both(models, tmp_path, jscience, tscience, [
        "--question-file", str(qfile), "--image-folder", root,
        "--answer-prompter", "--single-pred-prompt"])
    for line in port_lines:
        assert "\n The answer is " in line["text"]
    problems = {"p0": {"choices": ["cat", "dog"], "answer": 0},
                "p1": {"choices": ["ice", "fire"], "answer": 1}}

    def score(lines):
        return jsq_eval(problems, {line["question_id"]: line
                                   for line in lines})
    assert score(port_lines) == score(jax_lines)


def jsq_eval(problems, predictions):
    results, sqa = jsqa.evaluate(problems, list(problems), predictions)
    return ({k: [r["parsed_ans"] for r in v] for k, v in results.items()},
            sqa)


def _mmbench_tsv(path, root):
    def b64(name):
        with open(os.path.join(root, name), "rb") as f:
            return base64.b64encode(f.read()).decode()
    rows = ["index\tquestion\thint\tA\tB\tC\tD\timage\tcategory",
            f"12\tWhat color?\tLook closely.\tred\tgreen\tblue\tgray\t"
            f"{b64('a.png')}\tcolor",
            f"q7\tHow many?\tnan\tone\ttwo\tthree\t\t{b64('b.png')}\tcount"]
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("lang", ["en", "cn"])
def test_model_vqa_mmbench_matches_jax_and_upload_table(models, tmp_path,
                                                        lang):
    """``--all-rounds`` (4 and 3 rotations), the hint, 'nan', the int join
    key, ``--lang cn``; the MMBench upload table is the same file."""
    tsv = tmp_path / "mmbench.tsv"
    _mmbench_tsv(tsv, models[0])
    jax_lines, port_lines = _run_both(models, tmp_path, jmmbench, tmmbench, [
        "--question-file", str(tsv), "--all-rounds", "--single-pred-prompt",
        "--lang", lang])
    assert [(line["question_id"], line["round_id"]) for line in port_lines] \
        == [(12, 0), (12, 1), (12, 2), (12, 3), ("q7", 0), ("q7", 1),
            ("q7", 2)]
    assert port_lines[1]["option_char"] == ["B", "C", "D", "A"]
    tables = []
    for name in ("jax", "port"):
        result_dir = tmp_path / f"results-{name}"
        result_dir.mkdir()
        (result_dir / "exp.jsonl").write_text(
            (tmp_path / f"{name}.jsonl").read_text())
        out = jsubmit.convert_mmbench(str(tsv), str(result_dir),
                                      str(tmp_path / f"upload-{name}"), "exp")
        with open(out) as f:
            tables.append(f.read())
    assert tables[0] == tables[1]


def test_mmbench_helpers_match_jax():
    for value in (None, float("nan"), "nan", "None", "", "x", 0.5, "0"):
        assert tmmbench.is_none(value) == jmmbench.is_none(value)
    row = {"A": "a", "B": "nan", "C": "c"}
    assert tmmbench.get_options(row, tmmbench.all_options) \
        == jmmbench.get_options(row, jmmbench.all_options) == ["a"]


@pytest.mark.parametrize("mod", [tvqa, tloader, tscience, tmmbench])
def test_entry_flags_are_the_jax_flags(mod, monkeypatch):
    """Each parser takes the JAX entry's flags with its defaults, plus
    ``--device``."""
    jmod = {tvqa: jvqa, tloader: jloader, tscience: jscience,
            tmmbench: jmmbench}[mod]
    seen = {}

    def capture(args, **_):
        seen["args"] = vars(args)
    monkeypatch.setattr(jmod, "eval_model", capture)
    monkeypatch.setattr("sys.argv", ["x", "--model-path", "m",
                                     "--question-file", "q"])
    jmod.main()
    port = vars(mod.build_arg_parser().parse_args(
        ["--model-path", "m", "--question-file", "q"]))
    assert port.pop("device") is None
    assert port == seen["args"]


def test_pil_images_and_arrays_give_the_same_pixels(models, tmp_path):
    """A PIL image handed to the port's processor (callers that hold
    them) gives the pixels of the array ``load_image`` reads."""
    from modelcompose_tpu_torch.data.image_io import load_image
    from modelcompose_tpu_torch.data.image_processing import process_images
    path = os.path.join(models[0], "b.png")
    proc = models[2][2]["vision"]
    buf = io.BytesIO()
    _png(buf, SIZES["b.png"], 1)
    np.testing.assert_array_equal(
        process_images([Image.open(path)], proc, "pad"),
        process_images([load_image(buf.getvalue())], proc, "pad"))
