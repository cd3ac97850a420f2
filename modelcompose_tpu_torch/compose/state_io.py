"""Flat state-dict IO for adapter checkpoints (the port's copy of
modelcompose_tpu/compose/state_io.py).

The reference stores adapters as torch-pickled flat dicts
(``adapter_model.bin`` / ``mm_projector.bin``, reference:
modelcompose/train/train_multimodal.py:516-521, scripts/model_composition/
merge_unimodal_modelcompose.py:31-40).  The TPU rebuild's native format is
safetensors (``adapter_model.safetensors``) with identical *logical keys*,
so reference checkpoints convert 1:1 and either format can feed the merge
CLI.  Arrays are numpy end-to-end — composition is checkpoint arithmetic and
never needs a device.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ADAPTER_BASENAMES = ("adapter_model.safetensors", "adapter_model.bin",
                     "mm_projector.safetensors", "mm_projector.bin")


def _torch_to_numpy(d) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in d.items():
        arr = v.detach().cpu()
        if arr.dtype.is_floating_point:
            arr = arr.float()
        out[k] = arr.numpy()
    return out


def load_state(path: str) -> Dict[str, np.ndarray]:
    """Load a flat state dict from a .safetensors / .npz / torch .bin file."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return dict(load_file(path))
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    # torch pickle
    import torch
    return _torch_to_numpy(torch.load(path, map_location="cpu",
                                      weights_only=True))


def save_state(state: Dict[str, np.ndarray], path: str) -> None:
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file
        save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)
    elif path.endswith(".npz"):
        np.savez(path, **state)
    elif path.endswith(".bin"):
        import torch
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in state.items()}, path)
    else:
        raise ValueError(f"unknown checkpoint format: {path}")


def find_adapter_file(ckpt_dir: str) -> str:
    """Locate the adapter file in a checkpoint directory, preferring
    safetensors (reference fallback order: merge_unimodal_modelcompose.py:
    32-34)."""
    for name in ADAPTER_BASENAMES:
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no adapter checkpoint found in {ckpt_dir} "
                            f"(tried {ADAPTER_BASENAMES})")


def load_adapter_dir(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """Load the adapter state dict, stripping peft's 'base_model.model.'
    wrapper prefix (present on converted LLaVA-LoRA checkpoints, absent on
    DAMC ones) so every consumer — loader overlay, merge CLI, metrics,
    delta analysis — matches on reference 'model.layers.*' keys."""
    state = load_state(find_adapter_file(ckpt_dir))
    return {(k[len("base_model.model."):]
             if k.startswith("base_model.model.") else k): v
            for k, v in state.items()}
