"""The train steps as captured CUDA graphs: the fused step (the port's
counterpart of the JAX package's jitted ``train_step``), the accumulation
micro-step (``grad_fn`` and ``grad_accum_fn``) and the optimizer update
(``scale_grads`` and ``apply_fn``), each one replay a call, with K1, K3 and
K4 inside.

Launched from Python, a 7B train step is thousands of launches: per layer,
and twice under remat, the GEMMs, norms, RoPE, the routed LoRA and K1;
autograd's backward with K3 and K4; then the optimizer's per-leaf update.
Captured once per key and replayed, the card sets the pace.

What a graph reads and writes by address:

- its own static inputs, the batch's tensors (``token_ids``, ``feat_idx``,
  ``is_feat``, ``route_ids``, ``labels``, ``segment_ids``, each modality's
  ``encoder_features`` and, when the vision tower trains,
  ``tower_pixels``), which each call copies in (a tower graph's static
  output included);
- the caller's parameters and Adam moments, updated in place (where the
  JAX step donates them), and the optimizer's device scalars, which
  ``Optimizer.prepare`` rewrites before every call with the step's bias
  corrections and schedule multiplier;
- its static outputs: the loss, and for a grad graph the running gradient
  total it writes or adds into.

A graph is keyed, as the JAX jit retraces, by the batch's shapes and
dtypes (B, the ``TRAIN_BUCKETS`` bucket, each modality's feature shape),
``feat_layout``, the identity of every parameter and moment leaf (and of
the gradient tensors it reads or adds into), which leaves train, and the
optimizer's mesh: its data group and model group (``mesh_key``).  A
key's first call runs eagerly, its second captures
(``core/decode_graph.CapturedStep``: the step runs once on the capture
stream as the warm-up, and that run is the call's; then the capture),
later calls replay.  The backward runs on autograd's device thread, into
the capture stream, where K3 and K4 (and K1 again, in a layer's remat
recompute) find the capture's record by that stream.  The graphs of one
optimizer replay one at a time and capture into its one ``SharedPool``
(``Optimizer.graph_pool``): they hold the transients of their largest step
once.  A capture releases the allocator's cached blocks before its warm-up
and before the capture itself (``CapturedStep.release_cached``): a step's
transients would otherwise be held three times, cached for the caller's
stream, for the capture stream and in the pool (the 7B stage-1 step at
B=16 x 1,024 ran an 80 GB H100 out of memory so, with 32.9 GiB cached for
the caller's stream).

Under a mesh (``torchrun``: data parallelism with ZeRO-1, and tensor
parallelism where the mesh has a model axis) a graph captures the step's
collectives with it, as the JAX jit compiles GSPMD's: the valid-target
count's sum, one all-reduce per trainable gradient over the data group
(in the backward, the model group's all-reduces of ``parallel/tp``), the
loss's sum, the clip's sum of squares over the model group and ZeRO-1's
all-gather of each updated part, in the eager step's order.  Every rank
makes the same calls, so every rank captures at the same call of a key.
The batch a graph copies in is this rank's rows (``train()`` slices each
global batch by ``local_batch_slice``).  On a CPU tensor a graph runs its
step eagerly through the same static buffers, collectives included (the
gloo tests).  A capture that fails raises; nothing falls back to the
eager step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.decode_graph import CapturedStep, group_key
from ..tree import tree_leaves

TRAIN_GRAPHS = 8  # graphs a step function keeps (buckets x feature shapes)

BATCH_TENSORS = ("token_ids", "feat_idx", "is_feat", "route_ids", "labels",
                 "segment_ids")


def use_graphs(graphs: Optional[bool], device, tx) -> bool:
    """Whether a step runs through a graph: as ``graphs`` says, or by
    default on a CUDA device, under a process group or none."""
    if graphs is None:
        return torch.device(device).type == "cuda"
    return bool(graphs)


def _batch_tensors(batch: Dict[str, Any]):
    """[(name, tensor)] of a batch's tensors in a fixed order; a modality's
    tensor is named (group, modal)."""
    out = [(k, batch[k]) for k in BATCH_TENSORS if k in batch]
    for group in ("encoder_features", "tower_pixels"):
        for modal in sorted(batch.get(group) or {}):
            out.append(((group, modal), batch[group][modal]))
    return out


def batch_key(batch: Dict[str, Any], feat_layout) -> tuple:
    """The static shapes of a batch and its ``feat_layout``."""
    return (tuple((name, tuple(t.shape), t.dtype)
                  for name, t in _batch_tensors(batch)),
            tuple(tuple(x) for x in feat_layout))


def held(*trees) -> tuple:
    """Every tensor of ``trees`` (nested dicts), in order: a graph's
    ``keep``, so that no id in its key is reused while it lives, even if
    a leaf is replaced in its dict."""
    return tuple(t for tree in trees for _, t in tree_leaves(tree))


def tensor_ids(*trees) -> tuple:
    """The identity of every tensor of ``trees`` (nested dicts), in
    order."""
    return tuple(id(t) for t in held(*trees))


def mesh_key(mesh) -> tuple:
    """The groups whose collectives a step runs: the mesh's data group and
    model group by identity (``core.decode_graph.group_key``; the step
    holds the mesh through its optimizer), or Nones without a mesh."""
    if mesh is None:
        return (None, None)
    return (group_key(mesh.data_group), group_key(mesh.model_group))


def leaves_key(params, mesh=None) -> tuple:
    """Every parameter leaf by identity, whether it trains (a graph keeps
    the leaves themselves, ``held``), and the groups of ``mesh``
    (``mesh_key``)."""
    leaves = list(tree_leaves(params))
    return (tuple(id(p) for _, p in leaves),
            tuple(bool(p.requires_grad) for _, p in leaves)) \
        + mesh_key(mesh)


def params_key(params, opt_state, mesh=None) -> tuple:
    """What a step reads of its state: ``leaves_key`` and every moment by
    identity."""
    return leaves_key(params, mesh) + (
        tuple(id(t) for t in opt_state["mu"].values()),
        tuple(id(t) for t in opt_state["nu"].values()))


class _StaticBatch:
    """A graph's own copy of a batch's tensors, written by ``load``."""

    def __init__(self, batch: Dict[str, Any], device):
        self.tensors = {name: torch.empty(t.shape, dtype=t.dtype,
                                          device=device)
                        for name, t in _batch_tensors(batch)}
        self.groups = [g for g in ("encoder_features", "tower_pixels")
                       if g in batch]

    def load(self, batch: Dict[str, Any]) -> None:
        for name, t in _batch_tensors(batch):
            self.tensors[name].copy_(t)

    def batch(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {g: {} for g in self.groups}
        for name, t in self.tensors.items():
            if isinstance(name, tuple):
                out.setdefault(name[0], {})[name[1]] = t
            else:
                out[name] = t
        return out


class _TrainGraph(CapturedStep):
    """``body(batch, feat_layout)`` (or ``body()`` with no batch) over a
    static batch, captured at its second call on the card.  ``keep`` holds
    the tensors the graph reads by address (its key names them by
    identity; ``held``) for the graph's life.  The step runs in the
    caller's grad mode: the backward is captured with the forward.  Its
    products run at B x L rows, far above ``quant.K5_MAX_ROWS``, so an
    int8 base (``--quantize_frozen_base``) runs their forward through K6
    and their backward through x through K7 (both recorded in the capture's
    ``quant`` record, which a layer's remat recompute and the backward on
    autograd's thread find by the capturing stream)."""

    capture_at = 2
    release_cached = True

    def __init__(self, device, shared, body: Callable, batch=None,
                 feat_layout=(), keep=()):
        super().__init__(device, shared)
        self.body, self.keep = body, keep
        self.feat_layout = list(feat_layout)
        self.batch = None if batch is None else _StaticBatch(batch,
                                                             self.device)

    def __call__(self, batch: Optional[Dict[str, Any]] = None):
        """The step on ``batch`` (copied into the static one): its static
        outputs, rewritten by the next call."""
        if batch is not None:
            self.batch.load(batch)
        return self.run()

    def _compute(self):
        return self._step()

    def _step(self):
        if self.batch is None:
            return self.body()
        return self.body(self.batch.batch(), self.feat_layout)


class TrainStepGraph(_TrainGraph):
    """The fused step: forward, ``torch.autograd.grad``, clip, Adam and the
    update, in place (JAX ``train_step``).  Its output is the loss."""

    captures = 0
    replays = 0


class GradGraph(_TrainGraph):
    """A micro-batch's loss and gradients, written into the running total
    (JAX ``grad_fn``, a window's first micro-batch) or added into it in
    place (``grad_accum_fn``).  Its output is the loss."""

    captures = 0
    replays = 0


class ApplyGraph(_TrainGraph):
    """The gradients scaled in place (``scale_grads``, the accumulation
    average), then the optimizer's update (JAX ``apply_fn``).  No
    output."""

    captures = 0
    replays = 0


GRAPH_KINDS = {"train_step": TrainStepGraph, "grad": GradGraph,
               "apply": ApplyGraph}
