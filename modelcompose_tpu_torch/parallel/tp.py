"""Megatron tensor parallelism: the collectives GSPMD inserts for the JAX
package, written out as ``torch.autograd.Function``\\ s over the model
group.

- ``copy_to_model``: identity forward, all-reduce backward (the input of a
  column-split product, and of the replicated LoRA bottleneck's B);
- ``reduce_from_model``: all-reduce forward, identity backward (the output
  of a row-split product);
- ``gather_vocab``: all-gather of vocab-split logits along the last axis,
  the rank's slice of the cotangent backward;
- ``slice_rows``: this rank's rows of a replicated tensor, the rows'
  gradients all-gathered backward (a row-split layer's LoRA A);
- ``vocab_embedding``: the lookup in a vocab-split table, summed over the
  group.

The model group belongs to the sharded model (``MultimodalLM.tp_group``,
set by ``mesh.apply_tensor_parallel``) or to the optimizer's mesh
(``Mesh.model_group``).  Their calls into the backbone run inside
``scope(group)``, which makes it the group of this thread's collectives
until the block ends; each autograd function keeps its group for its
backward, which may run on another thread.  Outside every scope the group
is None and each function is the single-process operation.  Inside one,
every rank of the group must make the same calls in the same order: a rank
that skips one hangs the group until the process group's timeout.

Each function is safe inside a CUDA graph capture (core/decode_graph,
train/step_graph), which holds its collective as GSPMD's are held in the
JAX package's program: it reads nothing on the host but the group's size
and this rank's place in it, and allocates only the capture's tensors (the
all-reduce's clone, the all-gather's parts), in the capture's pool.  The
rank and size come from the group the call runs over: the scope's, or the
group an autograd function kept for its backward.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_LOCAL = threading.local()


@contextlib.contextmanager
def scope(group):
    """Run the block's tensor-parallel collectives over ``group`` (a
    ``torch.distributed`` group, or None for none); the scope outside is
    restored after it."""
    outer = model_group()
    _LOCAL.group = group
    try:
        yield
    finally:
        _LOCAL.group = outer


def model_group():
    """The model group of the innermost ``scope`` on this thread."""
    return getattr(_LOCAL, "group", None)


def model_size(group=None) -> int:
    g = model_group() if group is None else group
    return 1 if g is None else dist.get_world_size(g)


def model_rank(group=None) -> int:
    g = model_group() if group is None else group
    return 0 if g is None else dist.get_rank(g)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // model_size(ctx.group)
        own = g.narrow(-1, model_rank(ctx.group) * n, n).contiguous()
        return own, None


class _SliceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, rows, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, model_rank(group) * rows, rows)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    g = model_group()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    g = model_group()
    return x if g is None else _ReduceFromModel.apply(x, g)


def gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """[..., V / tp] logits of this rank -> [..., V] on every rank."""
    g = model_group()
    return x if g is None else _GatherVocab.apply(x, g)


def slice_rows(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """Rows [rank * rows, (rank + 1) * rows) of ``x`` along ``dim``: the
    rank's part of a replicated tensor that multiplies a row-split input.
    ``x`` itself where it has just ``rows``."""
    g = model_group()
    if g is None or x.shape[dim] == rows:
        return x
    return _SliceRows.apply(x, dim % x.dim(), rows, g)


def vocab_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table split over the vocabulary: each rank
    looks up the ids in its range [rank * V_r, (rank + 1) * V_r), zeros the
    others and the group sums the rows."""
    if model_group() is None:
        return table[ids]
    local = table.shape[0]
    off = model_rank() * local
    inside = (ids >= off) & (ids < off + local)
    rows = table[torch.where(inside, ids - off, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` as a new tensor, outside autograd; ``x``
    itself where ``group`` is None (one process)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out
