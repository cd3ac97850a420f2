"""The (data, model) process mesh and the split rules (counterpart of
modelcompose_tpu/parallel/mesh.py).

The JAX package lays one ``jax.sharding.Mesh`` over its devices, a
``data`` axis (batch and optimizer moments: the ZeRO role) and a
``model`` axis (Megatron tensor parallelism), and lets GSPMD insert the
collectives.  The port lays the processes out the same way, row-major as
``np.reshape(data, model)``, gives each rank its data group (the ranks of
its column) and its model group (the ranks of its row), holds each rank's
shard of the split leaves, and runs the collectives itself
(``parallel/tp.py``, ``train/trainer.py``).

The split table (``param_pspecs``) is the JAX one, leaf for leaf:
q/k/v/gate/up split their output columns (and LoRA B with them), o/down
their input rows, embed and lm_head the vocabulary; LoRA A, a row-split
layer's LoRA B, the norms and the soft tokens are replicated.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) mesh.  ``data_rank`` and
    ``model_rank`` are None on a rank the mesh leaves idle.  The groups are
    None without a process group (one process, world 1): then no
    collective runs."""
    data: int
    model: int
    data_rank: Optional[int]
    model_rank: Optional[int]
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def active(self) -> bool:
        return self.data_rank is not None


def _group(ranks: Sequence[int]):
    ranks = [int(r) for r in ranks]
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Every rank calls this with the same arguments (it creates the
    groups, a collective step).  Ranks [0, data * model) form the mesh,
    row-major; the rest are idle.  Each rank then runs one collective on
    its data group and one on its model group (``distributed.warm``), so
    their NCCL communicators exist before a captured step runs their
    collectives.  Raises ValueError when the world has fewer processes
    than the mesh needs."""
    need = data * model
    world = distributed.world_size()
    if world < need:
        raise ValueError(f"need {need} processes, have {world}")
    if not distributed.is_initialized():
        return Mesh(data, model, 0, 0)
    grid = np.arange(need).reshape(data, model)
    data_groups = [_group(grid[:, j]) for j in range(model)]
    model_groups = [_group(grid[i, :]) for i in range(data)]
    rank = dist.get_rank()
    if rank >= need:
        return Mesh(data, model, None, None)
    i, j = divmod(rank, model)
    # every rank warms its data group, then its model group: the members
    # of each group reach its collective at the same point
    distributed.warm(data_groups[j])
    distributed.warm(model_groups[i])
    return Mesh(data, model, i, j, data_groups[j], model_groups[i])


def data_width_for_batch(batch_size: int, n_ranks: int, model: int = 1,
                         allow_partial: bool = False) -> int:
    """The data width ``mesh_for_batch`` picks over ``n_ranks`` processes:
    the JAX rule.  The batch must use every rank unless ``allow_partial``,
    which takes the largest divisor instead."""
    n = n_ranks // model
    if batch_size % n != 0 and not allow_partial:
        raise ValueError(
            f"global batch {batch_size} does not divide the data axis "
            f"({n} processes / model={model}); pick a divisible batch size "
            "or pass allow_partial=True")
    data = 1
    for d in range(1, n + 1):
        if batch_size % d == 0:
            data = d
    return data


def mesh_for_batch(batch_size: int, model: int = 1,
                   allow_partial: bool = False) -> Mesh:
    """A pure-DP mesh whose data axis divides the global batch, over the
    world's processes (``data_width_for_batch``).  The ranks it leaves idle
    are named in a warning."""
    world = distributed.world_size()
    data = data_width_for_batch(batch_size, world, model, allow_partial)
    idle = list(range(data * model, world))
    if idle:
        warnings.warn(
            f"global batch {batch_size} does not divide {world} processes "
            f"(model={model}); using a {data * model}-process mesh, ranks "
            f"{idle} idle")
    return make_mesh(data=data, model=model)


# ---------------------------------------------------------------------------
# Split rules
# ---------------------------------------------------------------------------

_COL = {"w": (None, None, "model"), "lora_a": (),
        "lora_b": (None, None, None, "model")}
_ROW = {"w": (None, "model", None), "lora_a": (), "lora_b": ()}


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The split of each leaf of a core/llama.py tree, as the JAX
    ``PartitionSpec`` tuples (``()`` replicated; ``"model"`` marks the
    split axis; layer-stacked leaves keep their leading layer axis
    whole)::

      q/k/v/gate/up  w [N, in, out]          (None, None, 'model')
      their lora_b   [N, A, r, out]          (None, None, None, 'model')
      o/down         w [N, in, out]          (None, 'model', None)
      lora_a, a row-split layer's lora_b     ()
      embed_tokens   [V, H]                  ('model', None)
      lm_head        [H, V]                  (None, 'model')
      norms, soft tokens                     ()
    """
    specs: Dict[str, Any] = {
        "embed_tokens": ("model", None),
        "layers": {
            "input_layernorm": (),
            "post_attention_layernorm": (),
            "attn": {"q": dict(_COL), "k": dict(_COL), "v": dict(_COL),
                     "o": dict(_ROW)},
            "mlp": {"gate": dict(_COL), "up": dict(_COL),
                    "down": dict(_ROW)},
        },
        "norm": (),
        "lm_head": (None, "model"),
    }
    for extra in ("prefix_tokens", "suffix_tokens"):
        if extra in params:
            specs[extra] = {m: () for m in params[extra]}
    return specs


def split_axis(spec: Spec) -> Optional[int]:
    """The axis a spec splits over the model group, or None."""
    return spec.index("model") if "model" in spec else None


def _is_int8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _take(x: torch.Tensor, axis: int, rank: int, parts: int,
          what: str) -> torch.Tensor:
    if parts == 1:
        return x
    if x.shape[axis] % parts:
        raise ValueError(f"{what}: axis {axis} of {tuple(x.shape)} does not "
                         f"split into {parts}")
    n = x.shape[axis] // parts
    return x.narrow(axis, rank * n, n).contiguous()


def shard_params(params: Dict[str, Any], rank: int, tp: int
                 ) -> Dict[str, Any]:
    """This model rank's shard of a full core/llama.py tree.  An int8
    leaf's ``q`` splits like its dense counterpart; its per-output-channel
    ``scale`` splits along ``out`` with a column-split leaf and stays whole
    with a row-split one (the JAX package replicates it and lets GSPMD
    slice it in the product).  At ``tp`` 1 every leaf is the caller's
    tensor."""
    specs = param_pspecs(params)

    def walk(x, s, path):
        if isinstance(s, dict):
            return {k: walk(x[k], s[k], path + (k,)) if k in s else x[k]
                    for k in x}
        axis = split_axis(s)
        what = "/".join(path)
        if axis is None:
            return x
        if _is_int8(x):
            last = axis == len(s) - 1
            return {"q": _take(x["q"], axis, rank, tp, what),
                    "scale": _take(x["scale"], axis, rank, tp, what)
                    if last else x["scale"]}
        return _take(x, axis, rank, tp, what)

    return walk(params, specs, ())


def leaf_specs(params: Dict[str, Any]) -> Dict[Tuple, Spec]:
    """{path within the backbone tree: spec} for every leaf the specs
    name (an int8 leaf's ``q`` and ``scale`` both under its path)."""
    out: Dict[Tuple, Spec] = {}

    def walk(x, s, path):
        if isinstance(s, dict):
            for k in s:
                if k in x:
                    walk(x[k], s[k], path + (k,))
        elif _is_int8(x):
            out[path + ("q",)] = s
            out[path + ("scale",)] = s if split_axis(s) == len(s) - 1 \
                else ()
        else:
            out[path] = s

    walk(params, param_pspecs(params), ())
    return out


def zero_axis(shape: Sequence[int], spec: Spec, data: int) -> Optional[int]:
    """ZeRO-1: the axis a moment leaf of ``shape`` splits over the data
    group, the JAX ``shard_opt_state`` rule: the first axis the leaf's
    tensor-parallel spec leaves free whose size is at least ``data`` and
    divisible by it; None (the moment stays whole) where there is none or
    ``data`` is 1."""
    cur = list(spec) + [None] * (len(shape) - len(spec))
    if len(shape) >= 1 and data > 1:
        for axis, dim in enumerate(shape):
            if cur[axis] is None and dim >= data and dim % data == 0:
                return axis
    return None


def shard_opt_state(moments: Dict[Any, torch.Tensor],
                    specs: Dict[Any, Spec], mesh: Mesh
                    ) -> Tuple[Dict[Any, torch.Tensor], Dict[Any, int]]:
    """ZeRO-1 over ``{path: moment}``: each leaf with a ``zero_axis`` keeps
    this data rank's contiguous part along it.  Returns (the moments, {path:
    axis} of the split ones)."""
    out, axes = {}, {}
    for path, m in moments.items():
        axis = zero_axis(m.shape, specs.get(path, ()), mesh.data)
        if axis is None:
            out[path] = m
        else:
            axes[path] = axis
            out[path] = _take(m, axis, mesh.data_rank, mesh.data,
                              str(path))
    return out, axes


def shard_encoder_features(feats: Dict[str, torch.Tensor], mesh: Mesh
                           ) -> Dict[str, torch.Tensor]:
    """This data rank's rows of each modality's feature table where its
    instance count divides the data width; the whole table otherwise."""
    out = {}
    for modal, f in feats.items():
        if f.shape[0] % mesh.data == 0:
            out[modal] = _take(f, 0, mesh.data_rank, mesh.data, modal)
        else:
            out[modal] = f
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def check_tp_divides(cfg, tp_size: int) -> None:
    """Raise ValueError unless every split axis of ``cfg`` divides into
    ``tp_size``: each rank holds whole heads (GQA groups included)."""
    for name in ("num_attention_heads", "num_key_value_heads",
                 "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp_size:
            raise ValueError(f"{name} {getattr(cfg, name)} does not divide "
                             f"into tp {tp_size}")


def apply_tensor_parallel(model, tp_size: int) -> Mesh:
    """Shard ``model`` (a ``MultimodalLM``) over a (1, ``tp_size``) mesh in
    place and give it its model group (``model.tp_group``; its serving
    backbone is made anew over that group): the loader's ``tp`` step.
    Every rank of the world calls it.  Raises ValueError when the world
    has fewer than ``tp_size`` processes, when this rank is outside the
    mesh, or when a split axis does not divide."""
    world = distributed.world_size()
    if world < tp_size:
        raise ValueError(f"--tp {tp_size} needs {tp_size} processes, have "
                         f"{world}")
    check_tp_divides(model.cfg, tp_size)
    mesh = make_mesh(data=1, model=tp_size)
    if not mesh.active:
        raise ValueError(f"rank {distributed.rank()} is outside the "
                         f"(1, {tp_size}) mesh: run {tp_size} processes")
    model.params = shard_params(model.params, mesh.model_rank, tp_size)
    model.tp_group = mesh.model_group
    model._serving = None
    return mesh

