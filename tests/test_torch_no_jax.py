"""The port never imports JAX: its package runs the tiny slice end to end
(greedy generation, then a train step) in a process where ``import jax``
fails."""

import os
import pathlib
import re
import subprocess
import sys

import modelcompose_tpu_torch

PKG = pathlib.Path(modelcompose_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent

SLICE = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import numpy as np
import torch
from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
from modelcompose_tpu_torch.core.packing import MODAL_TOKEN_INDEXES
from modelcompose_tpu_torch.ops.quant import quantize_backbone
from modelcompose_tpu_torch.ops.routed_lora import fold_dense

cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                       local_prefix_tokens=2, local_suffix_tokens=2,
                       dtype="bfloat16")
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(0))
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
model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(1))
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
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert all(sys.modules[m] is None for m in loaded), loaded
print("SLICE_OK", out)
"""


def test_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "SLICE_OK" in proc.stdout


def test_no_file_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
    assert len(files) > 15
