"""The port never imports JAX nor the JAX package: its package runs the tiny
slices end to end (greedy generation through a decode graph and eagerly,
PointBERT's sampling loop, a train step, then four unimodal
checkpoints merged, loaded and answering a 4-modality prompt, then the eval
entry answering a question file greedily, sampled and by beam search, then
the train entry training, checkpointing and resuming, then a chunked
admission into the slot pool and two slot ticks) in a
process where ``import jax`` and ``import modelcompose_tpu`` fail, and no
file of it (nor ``chip_smoke.py``) imports either.  Its entry points put a model on the
card unless asked for the CPU, and raise where there is no card."""

import functools
import json
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
# that decode ran through the model's decode graph (core/decode_graph),
# the eager loop gives the same ids, and PointBERT's sampling loop runs
from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
from modelcompose_tpu_torch.models.point_bert import farthest_point_sample
assert len(model.decode_graphs) == 1
assert isinstance(next(iter(model.decode_graphs._graphs.values())), DecodeGraph)
# and the prefill through that graph's prefill graph (core/prefill_graph)
assert len(model.decode_graphs.values()[0].prefills) == 1
assert out == model.generate([np.array([1, 5, img, 9]), np.array([1, img])],
                             {"vision": pixels}, max_new_tokens=4,
                             kv_quant=True, device_loop=False)
assert farthest_point_sample(torch.randn(1, 64, 3), 8).shape == (1, 8)

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
# a chunked admission into the int8 slot pool and two slot ticks
from modelcompose_tpu_torch.serve.slot_engine import SlotDecoder
cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32)
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(2), "cpu")
dec = SlotDecoder(model, max_slots=2, cache_len=32, kv_quant=True,
                  prefill_chunk=8, device="cpu")
ticks = []
dec.admit(0, np.array([1, img, 5]), {"vision": pixels[:1]})
dec.admit(1, np.array([1, 7, 8]), {},
          tick_cb=lambda: ticks.append(dec.step(dec.host_logits().argmax(-1))))
dec.step(dec.host_logits().argmax(-1))
dec.step(dec.host_logits().argmax(-1))
assert len(ticks) == 4 and dec.kv_lens.tolist()[1] == 3 + 2, dec.kv_lens
# the EVA + ImageBind towers answering an image + 3 s waveform prompt, and
# the text CLIP encoder
from modelcompose_tpu_torch.models.text_clip import (ClipTextConfig,
                                                     ClipTextEncoder)
cfg = tiny_test_config(mm_vision_encoder="eva-test:32x2", mm_hidden_size=32,
                       mm_audio_encoder="imagebind-test:16x2",
                       mm_audio_hidden_size=16,
                       mm_audio_projector_type="qformer_4N_2L")
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(3), "cpu")
mel = model.modal_processors()["audio"](rng.normal(size=48000).astype(np.float32))
out = model.generate([np.array([1, img, 5, MODAL_TOKEN_INDEXES["audio"], 7])],
                     {"vision": pixels[:1], "audio": mel}, max_new_tokens=3)
assert len(out[0]) <= 3, out
text = ClipTextEncoder(ClipTextConfig(hidden_size=16, intermediate_size=32,
                                      num_hidden_layers=1,
                                      num_attention_heads=2, vocab_size=50,
                                      max_position_embeddings=8,
                                      projection_dim=8), device="cpu")
assert text.encode(np.array([[3, 4, 49]])).shape == (1, 1, 8)
# PNG questions through the four LLaVA-suite entries with PIL blocked as
# well (a PNG needs none), written by the smoke's own writer, then the
# lifecycle tools on the merged checkpoint and a trace
sys.modules["PIL"] = None
import base64
import chip_smoke
from modelcompose_tpu_torch.compose import lifecycle
from modelcompose_tpu_torch.data.image_io import load_image
from modelcompose_tpu_torch.eval import (model_vqa, model_vqa_loader,
                                         model_vqa_mmbench, model_vqa_science)
from modelcompose_tpu_torch.utils.profiling import annotate, trace
imgs = os.path.join(root, "imgs")
os.makedirs(imgs)
px = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
chip_smoke.write_png(os.path.join(imgs, "a.png"), px)
chip_smoke.write_png(os.path.join(imgs, "b.png"), px[:, :, 0], depth=8)
assert (load_image(os.path.join(imgs, "a.png")) == px).all()
cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32)
vis = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(4), "cpu")
vqa_loaded = (FakeLlamaTokenizer(), vis, vis.modal_processors(), 2048)
with open(os.path.join(root, "vqa.jsonl"), "w") as f:
    f.write(json.dumps({"question_id": 0, "image": "a.png", "text": "Cat?"})
            + "\n" + json.dumps({"question_id": 1, "text": "Why?"}) + "\n")
with open(os.path.join(root, "loader.jsonl"), "w") as f:
    f.write(json.dumps({"question_id": 0, "image": ["a.png", "b.png"],
                        "text": "Same?"}) + "\n")
with open(os.path.join(root, "sqa.json"), "w") as f:
    json.dump([{"id": "p0", "image": "a.png", "conversations": [
        {"from": "human", "value": "<image>\nWhich?\nA. x\nB. y"}]}], f)
with open(os.path.join(imgs, "a.png"), "rb") as f:
    b64 = base64.b64encode(f.read()).decode()
with open(os.path.join(root, "mmbench.tsv"), "w") as f:
    f.write("index\tquestion\thint\tA\tB\tC\tD\timage\n"
            f"3\tWhat?\tnan\tred\tblue\t\t\t{b64}\n")
for mod, qfile, extra in (
        (model_vqa, "vqa.jsonl", ["--image-folder", imgs]),
        (model_vqa_loader, "loader.jsonl", ["--image-folder", imgs]),
        (model_vqa_science, "sqa.json", ["--image-folder", imgs,
                                         "--answer-prompter"]),
        (model_vqa_mmbench, "mmbench.tsv", ["--all-rounds"])):
    ans = os.path.join(root, "vqa-answers.jsonl")
    mod.eval_model(mod.build_arg_parser().parse_args([
        "--model-path", "vis-multimodal", "--question-file",
        os.path.join(root, qfile), "--answers-file", ans, "--temperature",
        "0", "--max-new-tokens", "2"] + extra), loaded=vqa_loaded)
    with open(ans) as f:
        assert len([json.loads(l) for l in f]) >= 1
lifecycle.main(["merge-lora", "--model-path", merged, "--model-base",
                os.path.join(root, "base"), "--save-model-path",
                os.path.join(root, "dense"), "--device", "cpu"])
lifecycle.main(["extract-projector", "--model-path",
                os.path.join(merged, "adapter_model.bin"), "--output",
                os.path.join(root, "dense", "mm_projector.bin")])
with trace(os.path.join(root, "trace")):
    with annotate("slice"):
        vis.generate([np.array([1, 5, 6])], {}, max_new_tokens=2)
assert os.path.exists(os.path.join(root, "trace", "trace.json"))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "modelcompose_tpu")]
assert all(sys.modules[m] is None for m in loaded), loaded
print("SLICE_OK", out)
"""


@pytest.mark.parametrize("module", [
    "serve.model_worker", "serve.cli", "eval.model_qa", "eval.run_inference",
    "eval.model_multimodal_loss", "eval.retrieval", "eval.model_vqa",
    "eval.model_vqa_loader", "eval.model_vqa_science",
    "eval.model_vqa_mmbench"])
def test_serving_entry_help_runs_with_jax_blocked(module):
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['modelcompose_tpu'] = None\n"
            f"runpy.run_module('modelcompose_tpu_torch.{module}', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code, "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "--model-path" in proc.stdout and "--device" in proc.stdout


@pytest.mark.parametrize("module", [
    "compose.lifecycle", "compose.convert_llava_checkpoint",
    "compose.merge_deltas_to_base", "compose.delta", "compose.metrics",
    "compose.compare", "data.convert_sqa", "data.convert_to_multimodal"])
def test_checkpoint_and_data_tools_help_runs_with_jax_blocked(module):
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['modelcompose_tpu'] = None\n"
            f"runpy.run_module('modelcompose_tpu_torch.{module}', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code, "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout


SHARED = ["eval_avqa", "eval_captioning", "eval_msrvtt_qa", "eval_music_avqa",
          "eval_point_tasks_gpt", "eval_pope", "eval_science_qa",
          "eval_science_qa_gpt4", "eval_science_qa_gpt4_requery",
          "eval_textvqa", "m4c_evaluator", "convert_for_submission",
          "convert_outputs", "collect_scores", "compare_answers",
          "gpt_review", "summarize_gpt_review", "qa_baseline_gpt35",
          "webpage"]


def test_shared_scorers_import_without_jax():
    """The JAX package's jsonl scorers, kept shared rather than ported,
    import with JAX blocked: they run on the card's machine as they are."""
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for name in {SHARED!r}:\n"
            "    importlib.import_module('modelcompose_tpu.eval.' + name)\n"
            "print('SHARED_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "SHARED_OK" in proc.stdout


def test_parallel_and_dryrun_run_with_jax_blocked(tmp_path):
    """``parallel/*`` imported, and the multi-process dryrun (a DP x TP
    train step, a TP decode, the audit) run in 2 gloo processes, every
    process with ``jax`` and ``modelcompose_tpu`` blocked: a
    ``sitecustomize`` on the path blocks them at each interpreter's start,
    the launcher's and its ranks'."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\n"
        "sys.modules['modelcompose_tpu'] = None\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    code = ("import sys\n"
            "assert sys.modules['jax'] is None\n"
            "from modelcompose_tpu_torch.parallel import (distributed, mesh,"
            " serving, tp)\n"
            "print('PARALLEL_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "PARALLEL_OK" in proc.stdout
    proc = subprocess.run([sys.executable, str(DRYRUN), "--world", "2",
                           "--out", str(tmp_path / "out"), "--timeout", "60"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=90)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["world"] == 2, result
    for log in (tmp_path / "out").glob("*.log"):
        assert "jax" not in log.read_text().lower(), log


def test_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "SLICE_OK" in proc.stdout


DRYRUN = ROOT / "scripts" / "torch_dryrun_multirank.py"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", DRYRUN]


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
            "train/train_multimodal.py", "utils/logging.py",
            "serve/slot_engine.py", "serve/model_worker.py", "serve/cli.py",
            "serve/controller.py", "serve/web_server.py",
            "serve/register_worker.py", "serve/test_message.py",
            "serve/demo_app.py", "models/vision_eva.py",
            "models/audio_imagebind.py", "models/text_clip.py",
            "eval/model_qa.py", "eval/run_inference.py",
            "eval/model_multimodal_loss.py", "eval/retrieval.py",
            "data/image_io.py", "data/image_processing.py",
            "eval/model_vqa.py", "eval/model_vqa_loader.py",
            "eval/model_vqa_science.py", "eval/model_vqa_mmbench.py",
            "compose/lifecycle.py", "compose/convert_llava_checkpoint.py",
            "compose/merge_deltas_to_base.py", "compose/delta.py",
            "compose/metrics.py", "compose/compare.py",
            "utils/profiling.py", "data/convert_sqa.py",
            "data/convert_to_multimodal.py", "parallel/distributed.py",
            "parallel/mesh.py", "parallel/tp.py",
            "parallel/serving.py", "core/decode_graph.py",
            "core/prefill_graph.py"} <= names


@pytest.mark.parametrize("entry", [
    "random_init", "load_pretrained_model", "build_model", "model_from_jax",
    "build_modal_encoders", "ClipVisionTower", "BeatsAudioTower",
    "LanguageBindVideoTower", "PointBertTower", "EvaVisionTower",
    "ImageBindAudioTower", "ClipTextEncoder", "eval_model", "model_qa",
    "run_inference", "eval_loss", "eval_retrieval", "train", "SlotDecoder",
    "ModelWorker", "cli", "model_vqa", "model_vqa_loader",
    "model_vqa_science", "model_vqa_mmbench", "merge_lora"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """No device means the card; without one each entry point raises before
    it builds anything on the CPU."""
    from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
    from modelcompose_tpu_torch.convert import model_from_jax
    from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as qa
    from modelcompose_tpu_torch.compose import lifecycle
    from modelcompose_tpu_torch.eval import (model_multimodal_loss, model_qa,
                                             model_vqa, model_vqa_loader,
                                             model_vqa_mmbench,
                                             model_vqa_science, retrieval,
                                             run_inference)
    from modelcompose_tpu_torch.models import text_clip, towers
    from modelcompose_tpu_torch.models.loader import load_pretrained_model
    from modelcompose_tpu_torch.serve import cli, model_worker, slot_engine
    from modelcompose_tpu_torch.train import train_multimodal
    cpu_model = MultimodalLM.random_init(tiny_test_config(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    (tmp_path / "c-multimodal").mkdir()
    cfg.save(str(tmp_path / "c-multimodal" / "config.json"))
    args = train_multimodal.build_arg_parser().parse_args([
        "--model_name_or_path", "-", "--data_path", "-", "--output_dir", "-",
        "--random_init_backbone"])
    entry_argv = ["--model-path", str(tmp_path / "c-multimodal"),
                  "--model-base", str(tmp_path), "--question-file", "-"]
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
        "EvaVisionTower": lambda: towers.EvaVisionTower("eva-test:32x2",
                                                        cfg),
        "ImageBindAudioTower": lambda: towers.ImageBindAudioTower(
            "imagebind-test:16x2"),
        "ClipTextEncoder": lambda: text_clip.ClipTextEncoder(),
        "model_qa": lambda: model_qa.eval_model(
            model_qa.build_arg_parser().parse_args(entry_argv)),
        "run_inference": lambda: run_inference.run(
            run_inference.build_arg_parser().parse_args(
                entry_argv[:4] + ["--query", "q"])),
        "eval_loss": lambda: model_multimodal_loss.eval_loss(
            model_multimodal_loss.build_arg_parser().parse_args(entry_argv)),
        "eval_retrieval": lambda: retrieval.eval_retrieval(
            retrieval.build_arg_parser().parse_args(entry_argv)),
        "eval_model": lambda: qa.eval_model(qa.parse_args([
            "--model-path", str(tmp_path / "c-multimodal"), "--model-base",
            str(tmp_path), "--question-file", "-"])),
        "train": lambda: train_multimodal.train(args),
        "SlotDecoder": lambda: slot_engine.SlotDecoder(cpu_model),
        "ModelWorker": lambda: model_worker.ModelWorker(
            "http://c", "http://w", str(tmp_path / "c-multimodal"),
            str(tmp_path), no_register=True),
        "cli": lambda: cli.main([
            "--model-path", str(tmp_path / "c-multimodal"), "--model-base",
            str(tmp_path)]),
        "merge_lora": lambda: lifecycle.main([
            "merge-lora", "--model-path", str(tmp_path / "c-multimodal"),
            "--model-base", str(tmp_path), "--save-model-path",
            str(tmp_path / "dense")]),
        **{mod.__name__.rsplit(".", 1)[1]: functools.partial(
            mod.main, entry_argv) for mod in (model_vqa, model_vqa_loader,
                                              model_vqa_science,
                                              model_vqa_mmbench)},
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_resolve_device():
    from modelcompose_tpu_torch.devices import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
