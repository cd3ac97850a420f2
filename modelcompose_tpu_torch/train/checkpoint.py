"""Training checkpoints: step checkpoints with resume, and the
reference-format exports (counterpart of modelcompose_tpu/train/checkpoint.py,
which imports JAX; the same functions, rewritten).

- **Step checkpoints** under ``{output_dir}/checkpoint-{step}/``, resumed
  from the newest one.  A step checkpoint holds what the run cannot
  rebuild: the trainable leaves, their Adam moments and optimizer labels,
  the Adam count and the step.  The frozen leaves (the base, the towers)
  are not in it: resume rebuilds them from ``--model_name_or_path`` and
  the seed, as the JAX resume rebuilds the model before restoring.  (The
  JAX version saves the whole params tree, 13.5 GB of unchanged base at
  7B.)  A full finetune trains every backbone leaf, so it saves them all.
  Every entry is keyed by its parameter path (``backbone/layers/attn/q/
  lora_a``); ``restore_step_checkpoint`` holds keys, shapes, dtypes and
  labels to the freshly built state and raises on any difference.  Files:
  ``train_params.pt`` and ``opt_state.pt`` (``torch.save`` of flat
  ``{path: tensor}`` dicts) and ``trainer_state.json``.
- **Exports** in the reference key layout (``compose.convert``):
  ``adapter_model.bin`` (stage 2) or ``mm_projector.bin`` (stage 1), plus
  the ``.safetensors`` beside it where the ``safetensors`` package imports,
  and ``config.json``; a full finetune also writes the base as HF
  ``pytorch_model.bin`` (the JAX version writes ``model.safetensors``).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..compose.convert import (params_to_adapter, params_to_hf_llama,
                               projector_to_reference)
from ..compose.state_io import save_state
from ..config import ModelConfig
from ..parallel import distributed
from ..tree import Path, tree_leaves

PARAMS_FILE = "train_params.pt"
OPT_FILE = "opt_state.pt"
STATE_FILE = "trainer_state.json"


def path_key(path: Path) -> str:
    return "/".join(str(k) for k in path)


def _trained(state, tx) -> Dict[str, torch.Tensor]:
    """{key: leaf} of the leaves the optimizer trains, in tree order."""
    return {path_key(p): t for p, t in tree_leaves(state.params)
            if tx.trains(p)}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------

def save_step_checkpoint(output_dir: str, step: int, state, tx) -> str:
    """Write ``checkpoint-{step}`` for ``state`` trained by ``tx`` (the
    run's ``trainer.Optimizer``).  The files go to a ``.tmp`` directory
    that is renamed when complete, so a run cut off mid-write leaves no
    checkpoint that resume would pick.

    Under ZeRO-1 every rank of the data group calls it: the moments' parts
    are gathered, and the primary rank alone writes the whole moments (so
    any world size resumes the checkpoint) while the others wait."""
    mesh = tx.mesh
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(
            "step checkpoints hold a data-parallel state: a tensor-parallel "
            "rank's split leaves are its shard")
    group = None if mesh is None else mesh.data_group
    ckpt_dir = os.path.join(output_dir, f"checkpoint-{step}")
    opt = state.opt_state
    moments = {m: {path_key(p): _host(tx.gather_part(p, t))
                   for p, t in opt[m].items()} for m in ("mu", "nu")}
    if not distributed.is_primary():
        distributed.barrier(group)
        return ckpt_dir
    tmp = ckpt_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    trained = _trained(state, tx)
    torch.save({k: _host(t) for k, t in trained.items()},
               os.path.join(tmp, PARAMS_FILE))
    torch.save(moments, os.path.join(tmp, OPT_FILE))
    with open(os.path.join(tmp, STATE_FILE), "w") as f:
        json.dump({"step": int(state.step), "count": int(opt["count"]),
                   "labels": {path_key(p): tx.labels[p]
                              for p, _ in tree_leaves(state.params)
                              if tx.trains(p)}}, f, indent=1)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.replace(tmp, ckpt_dir)
    distributed.barrier(group)
    return ckpt_dir


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The ``checkpoint-*`` directory of the highest step, if any
    (reference: train_multimodal.py:497-500, auto-resume)."""
    steps = []
    for c in glob.glob(os.path.join(output_dir, "checkpoint-*")):
        m = re.match(r".*checkpoint-(\d+)$", c)
        if m:
            steps.append((int(m.group(1)), c))
    return max(steps)[1] if steps else None


def restore_step_checkpoint(ckpt_dir: str, state, tx):
    """Copy a step checkpoint into ``state`` in place (trainable leaves,
    moments, count, step) and return it.  Raises ValueError, naming the
    first differences, when the checkpoint's keys, shapes, dtypes or labels
    are not those of ``state`` and ``tx``.  The saved moments are whole:
    under ZeRO-1 each rank copies in its part, whatever world size wrote
    them."""
    with open(os.path.join(ckpt_dir, STATE_FILE)) as f:
        meta = json.load(f)
    saved = torch.load(os.path.join(ckpt_dir, PARAMS_FILE),
                       map_location="cpu", weights_only=True)
    opt = torch.load(os.path.join(ckpt_dir, OPT_FILE), map_location="cpu",
                     weights_only=True)
    trained = _trained(state, tx)
    paths = {path_key(p): p for p, _ in tree_leaves(state.params)}
    moments = {m: {path_key(p): t for p, t in state.opt_state[m].items()}
               for m in ("mu", "nu")}
    # a moment's whole shape is its leaf's
    whole = {m: {k: torch.empty(trained[k].shape, dtype=t.dtype,
                                device="meta")
                 for k, t in moments[m].items()} for m in moments}
    problems = [f"{k}: {'missing from' if k in trained else 'not trained in'}"
                f" this run" for k in sorted(set(trained) ^ set(saved))]
    for k in sorted(set(trained) & set(saved)):
        label = tx.labels[paths[k]]
        if meta["labels"].get(k) != label:
            problems.append(f"{k}: label {meta['labels'].get(k)!r}, this "
                            f"run {label!r}")
        for name, got, want in (("param", saved[k], trained[k]),
                                ("mu", opt["mu"].get(k), whole["mu"][k]),
                                ("nu", opt["nu"].get(k), whole["nu"][k])):
            if got is None or got.shape != want.shape \
                    or got.dtype != want.dtype:
                was = None if got is None else (tuple(got.shape), got.dtype)
                problems.append(f"{k} ({name}): {was}, this run "
                                f"{(tuple(want.shape), want.dtype)}")
    if problems:
        raise ValueError(
            f"step checkpoint {ckpt_dir} does not match this run's trainable "
            f"state ({len(problems)} differences): " + "; ".join(problems[:5]))
    with torch.no_grad():
        for k, t in trained.items():
            t.copy_(saved[k])
            for m in ("mu", "nu"):
                moments[m][k].copy_(tx.local_part(paths[k], opt[m][k]))
    state.opt_state["count"] = meta["count"]
    state.step = meta["step"]
    return state


# ---------------------------------------------------------------------------
# Final exports (reference formats)
# ---------------------------------------------------------------------------

def _save_flat(flat: Dict[str, np.ndarray], output_dir: str, stem: str,
               safetensors: bool = True) -> None:
    """``{stem}.bin`` always; ``{stem}.safetensors`` too where the package
    imports and ``safetensors`` is set (compose.merge's rule)."""
    save_state(flat, os.path.join(output_dir, f"{stem}.bin"))
    if not safetensors:
        return
    try:
        import safetensors as _  # noqa: F401
    except ImportError:
        return
    save_state(flat, os.path.join(output_dir, f"{stem}.safetensors"))


def save_adapter_checkpoint(output_dir: str, cfg: ModelConfig,
                            backbone_params, projector_params,
                            safetensors: bool = True) -> None:
    """Stage-2 DAMC export (reference: train_multimodal.py:516-521): every
    adapter's LoRA A/B, the projectors and the soft tokens, fp32."""
    os.makedirs(output_dir, exist_ok=True)
    _save_flat(params_to_adapter(backbone_params, cfg,
                                 projector_params=projector_params),
               output_dir, "adapter_model", safetensors)
    cfg.save(os.path.join(output_dir, "config.json"))


def save_full_checkpoint(output_dir: str, cfg: ModelConfig,
                         backbone_params, projector_params) -> None:
    """Full-finetune export (lora_strategy absent, every backbone weight
    trains): the base weights as HF ``pytorch_model.bin`` (fp32; loadable
    as a ``--model_name_or_path`` or model base), beside the adapter and
    projector file.  That file is ``.bin`` only: a ``.safetensors`` in the
    directory would shadow the base in ``load_hf_llama_dir``, which takes
    ``*.safetensors`` before ``pytorch_model*.bin``."""
    os.makedirs(output_dir, exist_ok=True)
    save_state(params_to_hf_llama(backbone_params, cfg),
               os.path.join(output_dir, "pytorch_model.bin"))
    save_adapter_checkpoint(output_dir, cfg, backbone_params,
                            projector_params, safetensors=False)


def save_projector_checkpoint(output_dir: str, cfg: ModelConfig,
                              projector_params) -> None:
    """Stage-1 projector-only export (reference:
    train_multimodal.py:212-234 / llava_trainer.py:331-350): keys
    ``model.modal_projectors.{modal}.*``."""
    os.makedirs(output_dir, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    for modal, tree in projector_params.items():
        flat.update(projector_to_reference(
            cfg.projector_type(modal), tree,
            f"model.modal_projectors.{modal}"))
    _save_flat(flat, output_dir, "mm_projector")
    cfg.save(os.path.join(output_dir, "config.json"))
