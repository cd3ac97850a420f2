"""The port never imports JAX nor the JAX package: its package runs the tiny
slices end to end (greedy generation, a train step, then four unimodal
checkpoints merged, loaded and answering a 4-modality prompt, then the eval
entry answering a question file greedily, sampled and by beam search, then
the train entry training, checkpointing and resuming) in a
process where ``import jax`` and ``import modelcompose_tpu`` fail, and no
file of it (nor ``chip_smoke.py``) imports either.  Its entry points put a model on the
card unless asked for the CPU, and raise where there is no card."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import modelcompose_tpu_torch

PKG = pathlib.Path(modelcompose_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent

SLICE = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
sys.modules["modelcompose_tpu"] = None  # and so does the JAX package
import numpy as np
import torch
from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
from modelcompose_tpu_torch.ops.quant import quantize_backbone
from modelcompose_tpu_torch.ops.routed_lora import fold_dense

cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                       local_prefix_tokens=2, local_suffix_tokens=2,
                       dtype="bfloat16")
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(0), "cpu")
model.params = quantize_backbone(model.params)
model.params, table = fold_dense(model.params, model.routing_table)
model.routing_table = table.numpy()
img = MODAL_TOKEN_INDEXES["vision"]
pixels = np.random.default_rng(0).normal(size=(2, 28, 28, 3)).astype(np.float32)
out = model.generate([np.array([1, 5, img, 9]), np.array([1, img])],
                     {"vision": pixels}, max_new_tokens=4, kv_quant=True)
assert len(out) == 2 and all(len(o) <= 4 for o in out), out

# one stage-2 train step of a fresh model, through the flash path
from modelcompose_tpu_torch.train.train_multimodal import make_batch
from modelcompose_tpu_torch.train.trainer import (
    TrainConfig, init_train_state, make_optimizer, make_train_step)
cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                       local_prefix_tokens=2, local_suffix_tokens=2,
                       mm_projector_type="mlp2x_gelu", remat=True)
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(1), "cpu")
batch, layout = make_batch(model, {
    "input_ids": [np.array([1, img, 9, 10]), np.array([1, 5, img, 11])],
    "labels": [np.array([-100, -100, 9, 10]), np.array([-100, -100, -100, 11])],
    "modal_inputs": {"vision": pixels}}, buckets=(16,))
tc = TrainConfig(warmup_ratio=0.0, max_grad_norm=1.0, weight_decay=0.1)
tx, _ = make_optimizer(cfg, tc, {"backbone": model.params,
                                 "projectors": model.projectors})
state = init_train_state(cfg, tc, model.params, model.projectors, tx=tx)
state, loss = make_train_step(cfg, tc, tx)(state, batch, layout)
assert state.step == 1 and torch.isfinite(loss), loss

# four unimodal checkpoints -> the port's merge -> the port's loader ->
# one 4-modality greedy answer
import os, tempfile
from modelcompose_tpu_torch.compose.state_io import save_state
from modelcompose_tpu_torch.compose.convert import (params_to_adapter,
                                                    params_to_hf_llama)
from modelcompose_tpu_torch.compose.merge import merge_checkpoints
from modelcompose_tpu_torch.models.loader import load_pretrained_model
towers = {"vision": dict(mm_vision_encoder="test:32x2", mm_hidden_size=32),
          "audio": dict(mm_audio_encoder="test:16x2", mm_audio_hidden_size=16,
                        mm_audio_projector_type="qformer_4N_2L"),
          "video": dict(mm_video_encoder="test:32x3", mm_video_hidden_size=32,
                        mm_video_projector_type="mlp2x_gelu"),
          "point": dict(mm_point_encoder="test:16x2", mm_point_hidden_size=16)}
root = tempfile.mkdtemp()
paths = []
for i, (modal, kw) in enumerate(towers.items()):
    cfg = tiny_test_config(local_prefix_tokens=1, local_suffix_tokens=1, **kw)
    uni = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(i),
                                   "cpu")
    paths.append(os.path.join(root, modal))
    os.makedirs(paths[-1])
    cfg.save(os.path.join(paths[-1], "config.json"))
    save_state(params_to_adapter(uni.params, cfg, uni.projectors),
               os.path.join(paths[-1], "adapter_model.bin"))
os.makedirs(os.path.join(root, "base"))
save_state(params_to_hf_llama(uni.params, cfg),
           os.path.join(root, "base", "pytorch_model.bin"))
merged = os.path.join(root, "mcub4-multimodal")
merge_checkpoints(paths, merged, "online-merge-reset-" + ",".join(
    f"default-{m}=0.25" for m in towers))
_, model, procs, _ = load_pretrained_model(
    merged, os.path.join(root, "base"), load_tokenizer_fn=lambda b: None,
    load_8bit=True, fold_decode_dense=True, device="cpu")
assert sorted(procs) == sorted(towers)
rng = np.random.default_rng(1)
ids = [np.array([1, img, 5, MODAL_TOKEN_INDEXES["audio"], 7,
                 MODAL_TOKEN_INDEXES["video"], 9,
                 MODAL_TOKEN_INDEXES["point"], 11])]
inputs = {"vision": rng.normal(size=(1, 28, 28, 3)).astype(np.float32),
          "audio": procs["audio"](rng.normal(size=16000).astype(np.float32)),
          "video": rng.normal(size=(1, 2, 28, 28, 3)).astype(np.float32),
          "point": rng.normal(size=(1, 64, 6)).astype(np.float32)}
out4 = model.generate(ids, inputs, max_new_tokens=4, compact_adapters=True,
                      kv_quant=True)
assert len(out4) == 1 and len(out4[0]) <= 4, out4

# the eval entry on the merged checkpoint: audio, point and text-only
# questions, answered greedily, sampled and by beam search
import json, wave
from modelcompose_tpu_torch.eval.model_multimodal_qa_loader import (
    eval_model, parse_args)
from tests.fake_tokenizer import FakeLlamaTokenizer
with wave.open(os.path.join(root, "a.wav"), "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
    w.writeframes((rng.normal(size=16000) * 3000).astype(np.int16).tobytes())
np.save(os.path.join(root, "p.npy"), rng.normal(size=(64, 6)).astype(np.float32))
qfile = os.path.join(root, "q.json")
with open(qfile, "w") as f:
    json.dump([{"id": i, "conversations": [{"from": "human", "value": v},
                                           {"from": "gpt", "value": None}],
                "modal_inputs": m} for i, (v, m) in enumerate([
        ("<audio>\nWhat?", {"audio": [os.path.join(root, "a.wav")]}),
        ("<point>\nWhat?", {"point": [os.path.join(root, "p.npy")]}),
        ("Why?", {})])], f)
for mode in (["--protocol", "benchmark"], ["--temperature", "0.7", "--top-p",
             "0.9"], ["--protocol", "benchmark", "--num-beams", "2"]):
    args = parse_args(["--model-path", merged, "--model-base",
                       os.path.join(root, "base"), "--question-file", qfile,
                       "--answers-file", os.path.join(root, "ans.jsonl"),
                       "--max-new-tokens", "3"] + mode)
    eval_model(args, load_tokenizer_fn=lambda b: FakeLlamaTokenizer(),
               device="cpu")
    with open(args.answers_file) as f:
        assert [json.loads(l)["question_id"] for l in f] == [0, 1, 2]

# the train entry: two stage-2 steps from a random tiny base, then resume
# to three from the step checkpoint
from modelcompose_tpu_torch.train.train_multimodal import (build_arg_parser,
                                                            train)
data = os.path.join(root, "train.json")
with open(data, "w") as f:
    json.dump([{"id": i, "conversations": [
        {"from": "human", "value": "<point>\nWhat?"},
        {"from": "gpt", "value": f"thing {i}"}],
        "modal_inputs": {"point": [os.path.join(root, "p.npy")]}}
        for i in range(4)], f)
with open(os.path.join(root, "base", "config.json"), "w") as f:
    json.dump({k: getattr(cfg, k) for k in ("vocab_size", "hidden_size",
               "intermediate_size", "num_hidden_layers",
               "num_attention_heads", "num_key_value_heads")}, f)
argv = ["--model_name_or_path", os.path.join(root, "base"), "--version", "v1",
        "--data_path", data, "--output_dir", os.path.join(root, "point-out"),
        "--mm_point_encoder", "test:16x2", "--lora_strategy", "modal+language",
        "--lora_r", "4", "--lora_alpha", "8", "--bf16", "False",
        "--per_device_train_batch_size", "2", "--save_steps", "2",
        "--gradient_checkpointing", "True"]
res = train(build_arg_parser().parse_args(argv + ["--max_steps", "2"]),
            tokenizer=FakeLlamaTokenizer(), device="cpu")
res2 = train(build_arg_parser().parse_args(argv + ["--max_steps", "3"]),
             tokenizer=FakeLlamaTokenizer(), device="cpu")
assert res["steps"] == 2 and res2["start_step"] == 2 and res2["steps"] == 3
assert os.path.exists(os.path.join(root, "point-out", "adapter_model.bin"))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "modelcompose_tpu")]
assert all(sys.modules[m] is None for m in loaded), loaded
print("SLICE_OK", out)
"""


def test_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "SLICE_OK" in proc.stdout


PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("what,pattern", [
    ("jax", r"^\s*(import jax|from jax)\b"),
    # the JAX package by any spelling: import modelcompose_tpu(.x), from
    # modelcompose_tpu(.x) import, importlib of "modelcompose_tpu(.x)"
    ("the JAX package", r"(^\s*(import|from)\s+modelcompose_tpu(\.|\s|$))"
                        r"|import_module\(\s*[\"']modelcompose_tpu(\.|[\"'])"),
])
def test_no_file_of_the_port_imports(what, pattern):
    regex = re.compile(pattern, re.M)
    offenders = [str(f) for f in PORT_FILES if regex.search(f.read_text())]
    assert not offenders, f"import {what}: {offenders}"
    assert len(PORT_FILES) > 15
    names = {str(f.relative_to(PKG)) for f in PORT_FILES if PKG in f.parents}
    assert {"core/sampling.py", "core/beam.py", "data/conversation.py",
            "data/tokenization.py", "data/preprocess.py", "data/dataset.py",
            "eval/generation_utils.py", "eval/model_multimodal_qa_loader.py",
            "data/loader.py", "train/sampler.py", "train/checkpoint.py",
            "train/train_multimodal.py"} <= names


@pytest.mark.parametrize("entry", [
    "random_init", "load_pretrained_model", "build_model", "model_from_jax",
    "build_modal_encoders", "ClipVisionTower", "BeatsAudioTower",
    "LanguageBindVideoTower", "PointBertTower", "eval_model", "train"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """No device means the card; without one each entry point raises before
    it builds anything on the CPU."""
    from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
    from modelcompose_tpu_torch.convert import model_from_jax
    from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as qa
    from modelcompose_tpu_torch.models import towers
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    from modelcompose_tpu_torch.train import train_multimodal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    (tmp_path / "c-multimodal").mkdir()
    cfg.save(str(tmp_path / "c-multimodal" / "config.json"))
    args = train_multimodal.build_arg_parser().parse_args([
        "--model_name_or_path", "-", "--data_path", "-", "--output_dir", "-",
        "--random_init_backbone"])
    call = {
        "random_init": lambda: MultimodalLM.random_init(cfg),
        "load_pretrained_model": lambda: load_pretrained_model(
            str(tmp_path / "c-multimodal"), str(tmp_path)),
        "build_model": lambda: train_multimodal.build_model(args, cfg),
        "model_from_jax": lambda: model_from_jax(None),
        "build_modal_encoders": lambda: towers.build_modal_encoders(
            tiny_test_config(mm_vision_encoder="test:32x2")),
        "ClipVisionTower": lambda: towers.ClipVisionTower("test:32x2", cfg),
        "BeatsAudioTower": lambda: towers.BeatsAudioTower("test:16x2"),
        "LanguageBindVideoTower": lambda: towers.LanguageBindVideoTower(
            "test:32x3"),
        "PointBertTower": lambda: towers.PointBertTower("test:16x2"),
        "eval_model": lambda: qa.eval_model(qa.parse_args([
            "--model-path", str(tmp_path / "c-multimodal"), "--model-base",
            str(tmp_path), "--question-file", "-"])),
        "train": lambda: train_multimodal.train(args),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_resolve_device():
    from modelcompose_tpu_torch.devices import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
