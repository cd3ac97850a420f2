"""Move weights from the JAX package into the port.

Both packages keep the same parameter trees (dicts and lists of arrays:
weights ``[N, d_in, d_out]``, adapters ``[N, A, d_in, r]`` and
``[N, A, r, d_out]``, int8 leaves ``{"q", "scale"}``), so a tree crosses
by a dtype cast.  These functions take numpy leaves only; the caller turns
JAX arrays into numpy (``np.asarray``), so this module never needs JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .config import ModelConfig
from .devices import resolve_device
from .models.model import MultimodalLM
from .models.towers import tower_class
from .tree import tree_map_with_path


def _leaf(a: np.ndarray, device, dtype, keep_fp32: bool) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"params_from_jax takes numpy leaves, got {type(a)}")
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through fp32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point() and not keep_fp32:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device=None, dtype=None) -> Any:
    """A JAX param tree with numpy leaves -> the same tree of tensors.

    ``dtype`` casts every floating leaf except the fp32 scales of int8
    ``{"q", "scale"}`` leaves; None keeps each leaf's own dtype."""
    def walk(node, in_int8: bool):
        if isinstance(node, dict):
            int8 = "q" in node and "scale" in node
            return {k: walk(v, int8 and k == "scale") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, False) for v in node)
        return _leaf(node, device, dtype, in_int8)
    return walk(tree, False)


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors -> the same tree of numpy arrays on the host.
    numpy has no bf16, so a bf16 leaf becomes fp32 (exact); every other
    leaf keeps its dtype."""
    def leaf(_, t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map_with_path(leaf, tree)


def model_from_jax(jax_model, device=None) -> MultimodalLM:
    """The port's MultimodalLM on the weights of a JAX MultimodalLM.

    ``jax_model`` needs ``cfg``, ``params``, ``projectors`` and
    ``encoders[modal].spec`` / ``.params`` (and optionally ``.cfg``), all
    with numpy leaves.  The weights go to ``device`` (the card when None);
    the config is rebuilt as the port's from the JAX config's dict."""
    device = resolve_device(device)
    cfg = ModelConfig.from_dict(jax_model.cfg.to_dict())
    encoders: Dict[str, Any] = {}
    for modal, enc in jax_model.encoders.items():
        tower = tower_class(modal, enc.spec)(
            enc.spec, cfg, params=params_from_jax(enc.params, device))
        if getattr(enc, "cfg", None) is not None:
            # the tower's own config (a loaded BEATs tower reads its
            # checkpoint's), as the port's config class
            tower.cfg = type(tower.cfg)(**dataclasses.asdict(enc.cfg))
        encoders[modal] = tower
    return MultimodalLM(cfg, params_from_jax(jax_model.params, device),
                        encoders, params_from_jax(jax_model.projectors, device))
