"""Training: DAMC stage-2 finetune and stage-1 projector pretrain
(counterpart of modelcompose_tpu/train/trainer.py).

- **Trainable policy** by ``lora_strategy``, as in the JAX package:
  projectors and prefix/suffix soft tokens always train; 'same' trains the
  'default' adapter, 'modal' the per-modality adapters, 'modal+language'
  both; base weights and towers stay frozen.  ``tune_mm_mlp_adapter``
  (stage 1) trains the projectors only; ``lora_strategy`` absent (None)
  trains everything (full finetune).
- **The optimizer** is the JAX package's optax chain written out over dicts
  of tensors (``Optimizer``): a masked global-norm clip, then per label
  Adam (bias correction with count + 1, eps outside the square root),
  decoupled weight decay, the warmup + cosine multiplier and the group's
  learning rate, with the per-adapter-row rates of a stacked LoRA leaf and
  the tower's layerwise decay.  Frozen leaves hold no moments and get
  ``requires_grad=False``.
- **No jit, no donation**: the step runs eagerly, and where the JAX package
  donates the old state to XLA, the port updates parameters, moments and
  accumulated gradients in place under ``torch.no_grad()``.
- **Data parallelism with ZeRO-1** over a ``parallel.mesh.Mesh``: each data
  rank computes its micro-batch's loss sum over the global count of valid
  targets, so the group's summed gradients are those of the global token
  mean; only the trainable leaves' gradients cross ranks (one all-reduce
  each over the data group); each rank keeps and steps its part of every
  moment leaf with a ``zero_axis`` (the JAX ``shard_opt_state`` rule), then
  the group all-gathers the updated parts.  Under tensor parallelism the
  split leaves' gradients are this rank's shard, and the clip's norm sums
  them over the model group.

Parameters are keyed by their tree paths (``modelcompose_tpu_torch.tree``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..constants import IGNORE_INDEX
from ..core.llama import (forward, forward_hidden_routed, logits_from_hidden,
                          torch_dtype)
from ..core.packing import assemble_embeds
from ..models.model import attach_soft_tokens, causal_lm_loss
from ..models.projectors import apply_projector
from ..parallel import tp
from ..parallel.mesh import leaf_specs, split_axis, zero_axis
from ..tree import Path, tree_leaves, tree_map_with_path


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2e-4
    mm_projector_lr: Optional[float] = None   # default: learning_rate
    mm_language_lr: Optional[float] = None    # default: learning_rate
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: Optional[float] = None
    tune_mm_mlp_adapter: bool = False  # stage 1: projectors only
    # Vision-tower training with layerwise lr decay: the top encoder layer
    # trains at mm_vision_tower_lr, each deeper one at lr * decay^depth.
    mm_vision_tower_lr: Optional[float] = None
    mm_vision_tower_layerwise_lr_decay: float = 1.0
    # CE loss in sequence chunks with recomputed logits; None = whole
    # sequence at once
    loss_chunk: Optional[int] = None
    adam_mu_dtype: Optional[str] = None  # e.g. 'bfloat16'

    def proj_lr(self) -> float:
        return self.mm_projector_lr if self.mm_projector_lr is not None \
            else self.learning_rate

    def lang_lr(self) -> float:
        return self.mm_language_lr if self.mm_language_lr is not None \
            else self.learning_rate


# ---------------------------------------------------------------------------
# Schedule, rates and labels
# ---------------------------------------------------------------------------

def normalized_warmup_cosine(warmup_steps: int, total_steps: int
                             ) -> Callable[[int], np.float32]:
    """Multiplier schedule in [0, 1] (HF cosine with warmup; warmup_steps
    == 0 goes straight to the cosine, multiplier 1.0 at step 0).  Every
    operation rounds to float32 as the JAX schedule does; the cosine is
    correctly rounded, where XLA's may differ in the last place."""
    f32 = np.float32
    warmup_div = f32(max(warmup_steps, 1))
    denom = f32(max(total_steps - warmup_steps, 1))

    def sched(step: int) -> np.float32:
        step = f32(step)
        if step < warmup_steps:
            return step / warmup_div
        progress = min(max((step - f32(warmup_steps)) / denom, f32(0)),
                       f32(1))
        return f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * progress)))

    return sched


def adapter_row_lrs(cfg: ModelConfig, tc: TrainConfig) -> np.ndarray:
    """Absolute lr per stacked-adapter row (0 = frozen): the reference's
    strategy table."""
    names = cfg.adapter_names()
    lrs = np.zeros(len(names), np.float32)
    if tc.tune_mm_mlp_adapter or cfg.lora_strategy in (None, "none"):
        return lrs
    for i, name in enumerate(names):
        if name == "default":
            if cfg.lora_strategy in ("same", "modal+language"):
                lrs[i] = tc.lang_lr() if cfg.lora_strategy == \
                    "modal+language" else tc.learning_rate
        elif name.startswith("default-"):
            lrs[i] = 0.0  # merge-spawned rows never train
        elif cfg.lora_strategy in ("modal", "modal+language"):
            lrs[i] = tc.learning_rate
    return lrs


def trainable_labels(train_params: Dict[str, Any], cfg: ModelConfig,
                     tc: TrainConfig) -> Dict[str, Any]:
    """Label tree over {'backbone', 'projectors'[, 'towers']}: 'frozen',
    'base' (full finetune), 'lora', 'soft', 'proj' or 'tower'.  The string
    'none' freezes the LLM; lora_strategy None (absent) is the full
    finetune."""
    full_finetune = cfg.lora_strategy is None and not tc.tune_mm_mlp_adapter
    lora_on = not tc.tune_mm_mlp_adapter and \
        cfg.lora_strategy not in (None, "none")

    def label(path: Path, _leaf) -> str:
        if path[0] == "projectors":
            return "proj"
        if path[0] == "towers":
            return "tower"
        if path[1] in ("prefix_tokens", "suffix_tokens") \
                and not tc.tune_mm_mlp_adapter:
            return "soft"
        if lora_on and path[1] == "layers" and len(path) == 5 \
                and path[-1] in ("lora_a", "lora_b"):
            return "lora"
        return "base" if full_finetune else "frozen"

    return tree_map_with_path(label, train_params)


# The norm scales of the trees (Llama RMSNorms, CLIP LayerNorms) and the
# bias leaves: HF's AdamW grouping decays neither.  An explicit set, not a
# substring match (the JAX package's '"norm" in key' misses the tower's
# ln1/ln2 scales, which HF does not decay).
NODECAY_KEYS = frozenset({"input_layernorm", "post_attention_layernorm",
                          "norm", "pre_layernorm", "ln1", "ln2", "b",
                          "bias"})


def _is_nodecay_path(path: Path) -> bool:
    return any(k in NODECAY_KEYS for k in path if isinstance(k, str))


def split_nodecay_labels(labels, splittable) -> Dict[str, Any]:
    """Retag norm-scale and bias leaves of decayed groups
    '<label>:nodecay'."""
    return tree_map_with_path(
        lambda path, lbl: (lbl + ":nodecay"
                           if lbl in splittable and _is_nodecay_path(path)
                           else lbl), labels)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _weak(x, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX types it next to an array: in the array's
    dtype (bf16 rounds the constant before the product, as XLA does)."""
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


def _ema(decay: float, g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(1 - decay) * g + decay * m in the promoted dtype of g and m, each
    constant rounded to its operand's dtype: a bf16 moment next to an fp32
    gradient is read in fp32, as XLA fuses it."""
    dt = torch.promote_types(g.dtype, m.dtype)
    return _weak(1 - decay, g).to(dt) * g.to(dt) \
        + _weak(decay, m).to(dt) * m.to(dt)


class Optimizer:
    """The optax chain of the JAX ``make_optimizer``, over flat dicts of
    tensors keyed by parameter path.

    Per step: ``optax.masked(clip_by_global_norm)`` over the trainable
    leaves, then for each leaf by its label ``scale_by_adam`` (mu in
    ``adam_mu_dtype`` or the parameter dtype, nu in the parameter dtype),
    ``add_decayed_weights`` (decayed groups only), ``scale_by_schedule``
    and the group's ``scale(-lr)``, or for 'lora' the per-adapter-row
    scale, or for 'tower' the layerwise scale.  'frozen' (and 'tower' when
    the tower does not train) is ``set_to_zero``: no moments, no update.
    """

    def __init__(self, tc: TrainConfig, labels: Dict[str, Any],
                 row_lrs: np.ndarray, tower_layers: Optional[int],
                 mesh=None):
        self.tc = tc
        self.mesh = mesh
        self.zero_axes: Dict[Path, int] = {}
        self.tp_split: Dict[Path, bool] = {}
        self.labels: Dict[Path, str] = dict(tree_leaves(labels))
        self.sched = normalized_warmup_cosine(
            int(tc.warmup_ratio * tc.total_steps), tc.total_steps)
        self.row_lrs = torch.from_numpy(np.asarray(row_lrs, np.float32))
        self.tower_trains = tower_layers is not None
        self.discarded = {"frozen"} | (set() if self.tower_trains
                                       else {"tower"})
        self.lr = {"base": tc.learning_rate, "proj": tc.proj_lr(),
                   "soft": tc.learning_rate}
        if self.tower_trains:
            lr, decay = (tc.mm_vision_tower_lr,
                         tc.mm_vision_tower_layerwise_lr_decay)
            # numpy float32 as the JAX transform computes it
            self.tower_layer_lrs = torch.from_numpy(np.asarray(
                lr * decay ** (tower_layers - np.arange(tower_layers,
                                                        dtype=np.float32))))
            self.tower_pre_lr = lr * decay ** (tower_layers + 1)
            self.tower_emb_lr = lr * decay ** (tower_layers + 2)
        self.mu_dtype = torch_dtype(tc.adam_mu_dtype) \
            if tc.adam_mu_dtype else None

    def trains(self, path: Path) -> bool:
        return self.labels[path] not in self.discarded

    def init(self, params) -> Dict[str, Any]:
        """Zero moments of the trainable leaves: with a mesh, this data
        rank's part of each leaf with a ``zero_axis`` (ZeRO-1)."""
        specs = {("backbone",) + k: v
                 for k, v in leaf_specs(params["backbone"]).items()} \
            if "backbone" in params else {}
        data = self.mesh.data if self.mesh is not None else 1
        model = self.mesh.model if self.mesh is not None else 1
        mu, nu = {}, {}
        for path, p in tree_leaves(params):
            if not self.trains(path):
                continue
            spec = specs.get(path, ())
            self.tp_split[path] = model > 1 and split_axis(spec) is not None
            axis = zero_axis(p.shape, spec, data)
            if axis is not None:
                self.zero_axes[path] = axis
            part = self.local_part(path, p)
            mu[path] = torch.zeros_like(part, dtype=self.mu_dtype or p.dtype)
            nu[path] = torch.zeros_like(part)
        return {"count": 0, "mu": mu, "nu": nu}

    def _part(self, path: Path):
        """(axis, data rank, data width) of this rank's part of a leaf, or
        None where the leaf's moments are whole."""
        axis = self.zero_axes.get(path)
        if axis is None:
            return None
        return axis, self.mesh.data_rank, self.mesh.data

    def local_part(self, path: Path, t: torch.Tensor) -> torch.Tensor:
        """This data rank's part of a full-shape tensor of leaf ``path``
        (a view; ``t`` itself where the leaf's moments are whole)."""
        part = self._part(path)
        if part is None:
            return t
        axis, rank, data = part
        n = t.shape[axis] // data
        return t.narrow(axis, rank * n, n)

    def gather_part(self, path: Path, t: torch.Tensor) -> torch.Tensor:
        """The full-shape tensor of leaf ``path`` from each data rank's part
        ``t`` (an all-gather over the data group; every rank calls it)."""
        axis = self.zero_axes.get(path)
        if axis is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.data)]
        torch.distributed.all_gather(parts, t, group=self.mesh.data_group)
        return torch.cat(parts, dim=axis)

    def _clip(self, grads: Dict[Path, torch.Tensor]):
        max_norm = self.tc.max_grad_norm
        if any(self.tp_split.get(p, False) for p in grads):
            # a split leaf's gradient is this rank's shard: its squares sum
            # over the model group, a replicated leaf's count once
            split = [g for p, g in grads.items() if self.tp_split[p]]
            whole = [g for p, g in grads.items() if not self.tp_split[p]]
            sq = tp.group_sum(sum(g.float().square().sum() for g in split),
                              self.mesh.model_group)
            norm = torch.sqrt(sq + sum(g.float().square().sum()
                                       for g in whole))
        else:
            norm = torch.sqrt(sum(g.float().square().sum()
                                  for g in grads.values()))
        if bool(norm < max_norm):
            return grads
        return {path: (g / norm.to(g.dtype)) * _weak(max_norm, g)
                for path, g in grads.items()}

    def _final_scale(self, path: Path, label: str, u: torch.Tensor):
        part = self._part(path)

        def rows(scale, axis):  # this rank's rows of a per-row scale
            if part is None or part[0] != axis:
                return scale
            n = scale.shape[0] // part[2]
            return scale[part[1] * n:(part[1] + 1) * n]
        if label == "lora":  # [N, A, d1, d2]: adapter axis 1
            scale = rows(-self.row_lrs.to(u.device), 1)
            return u * scale.view(1, -1, 1, 1)
        if label.startswith("tower"):
            if "layers" in path:
                scale = rows(-self.tower_layer_lrs.to(u.device), 0)
                return u * scale.view((-1,) + (1,) * (u.dim() - 1))
            lr = self.tower_pre_lr if "pre_layernorm" in path \
                else self.tower_emb_lr
            return _weak(-lr, u) * u
        return _weak(-self.lr[label.split(":")[0]], u) * u

    @torch.no_grad()
    def step(self, params, grads: Dict[Path, torch.Tensor],
             state: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step over the trainable leaves (``grads`` holds
        exactly those): params += updates in place, each cast to its
        parameter's dtype (``optax.apply_updates``).  Returns the new
        state; the old moments are replaced, not modified.  Under ZeRO-1
        each data rank updates its part of a split leaf and the group
        all-gathers the parts into the leaf."""
        tc = self.tc
        f32 = np.float32
        if tc.max_grad_norm:
            grads = self._clip(grads)
        count = state["count"] + 1
        bc1 = f32(1) - f32(tc.adam_b1) ** f32(count)
        bc2 = f32(1) - f32(tc.adam_b2) ** f32(count)
        step_size = self.sched(state["count"])
        flat = dict(tree_leaves(params))
        mus, nus = {}, {}
        for path, g in grads.items():
            label = self.labels[path]
            g = self.local_part(path, g)
            mu = _ema(tc.adam_b1, g, state["mu"][path])
            nu = _ema(tc.adam_b2, g.square(), state["nu"][path])
            mu_hat = mu / _weak(bc1, mu)
            nu_hat = nu / _weak(bc2, nu)
            u = mu_hat / (nu_hat.sqrt() + _weak(tc.adam_eps, nu_hat))
            p = self.local_part(path, flat[path])
            if tc.weight_decay and not label.endswith(":nodecay"):
                u = u + _weak(tc.weight_decay, p) * p
            u = _weak(step_size, u) * u
            p.add_(self._final_scale(path, label, u))
            if path in self.zero_axes:
                flat[path].copy_(self.gather_part(path, p))
            mus[path] = mu.to(self.mu_dtype) if self.mu_dtype else mu
            nus[path] = nu
        return {"count": count, "mu": mus, "nu": nus}


def make_optimizer(cfg: ModelConfig, tc: TrainConfig,
                   train_params: Dict[str, Any], mesh=None):
    """(Optimizer, labels) for ``train_params`` = {'backbone',
    'projectors'[, 'towers']}; with ``mesh`` (a ``parallel.mesh.Mesh``) the
    optimizer keeps ZeRO-1 moments and the steps reduce gradients over its
    data group."""
    tower_layers = None
    if "towers" in train_params and tc.mm_vision_tower_lr is not None:
        tower = train_params["towers"]["vision"]
        tower_layers = int(tower["layers"]["q"]["w"].shape[0])
    labels = trainable_labels(train_params, cfg, tc)
    if tc.weight_decay:
        splittable = {"base", "proj", "soft"} | (
            {"tower"} if tower_layers is not None else set())
        labels = split_nodecay_labels(labels, splittable)
    return Optimizer(tc, labels, adapter_row_lrs(cfg, tc), tower_layers,
                     mesh), labels


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: Any          # {'backbone', 'projectors'[, 'towers']}
    opt_state: Any
    step: int


def init_train_state(cfg: ModelConfig, tc: TrainConfig, backbone_params,
                     projector_params, tower_params=None,
                     tx: Optional[Optimizer] = None) -> TrainState:
    """Trainable leaves get ``requires_grad=True``, frozen ones False; the
    trees are the caller's tensors, not copies, so a train step updates
    them in place.  The moments are ``tx.init``'s: this data rank's part
    of each leaf where ``tx`` was made with a mesh (``make_optimizer``)."""
    train_params = {"backbone": backbone_params,
                    "projectors": projector_params}
    if tower_params is not None:
        train_params["towers"] = tower_params
    if tx is None:
        tx, _ = make_optimizer(cfg, tc, train_params)
    for path, p in tree_leaves(train_params):
        if p.is_floating_point():
            p.requires_grad_(tx.trains(path))
    return TrainState(params=train_params, opt_state=tx.init(train_params),
                      step=0)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_causal_lm_loss(backbone, hidden, labels, chunk: int,
                           denom=None):
    """Shifted CE computed ``chunk`` positions at a time, each chunk
    checkpointed: the forward keeps only the scalar sums, the backward
    recomputes each chunk's fp32 logits.  The same value as
    ``causal_lm_loss`` (same shift, IGNORE_INDEX, mean over valid
    targets, or the sum over ``denom`` where given)."""
    B, L, _ = hidden.shape
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of "
                         f"loss_chunk {chunk}")
    targets = torch.cat([labels[:, 1:].long(),
                         torch.full((B, 1), IGNORE_INDEX, dtype=torch.long,
                                    device=labels.device)], dim=1)

    def piece(h, t):
        logits = logits_from_hidden(backbone, h).float()
        valid = t != IGNORE_INDEX
        safe = torch.where(valid, t, 0)
        nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
        return (nll * valid).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, L, chunk):
        total = total + checkpoint(piece, hidden[:, i:i + chunk],
                                   targets[:, i:i + chunk],
                                   use_reentrant=False)
    if denom is None:
        denom = (targets != IGNORE_INDEX).sum().clamp_min(1)
    return total / denom


def multimodal_loss_from_features(train_params, cfg: ModelConfig,
                                  routing_table, batch,
                                  attn_impl: str = "auto",
                                  vision_tower_cfg=None,
                                  loss_chunk: Optional[int] = None,
                                  denom=None):
    """Loss over a pre-encoded batch (``make_batch``, with its
    'feat_layout' added): the projector runs here, so its gradient flows;
    with 'tower_pixels' in the batch (vision tower training) the CLIP
    forward runs here too.  The mean over the valid targets, or their sum
    over ``denom`` (a data-parallel group's global count)."""
    backbone = train_params["backbone"]
    encoder_features = dict(batch["encoder_features"])
    if "towers" in train_params and "tower_pixels" in batch:
        from ..models.vision_clip import clip_vision_features
        encoder_features["vision"] = clip_vision_features(
            train_params["towers"]["vision"], vision_tower_cfg,
            batch["tower_pixels"]["vision"])
    feats = {modal: attach_soft_tokens(
        backbone, modal, apply_projector(cfg.projector_type(modal),
                                         train_params["projectors"][modal], x))
        for modal, x in encoder_features.items()}

    class _Plan:  # the PackPlan fields assemble_embeds reads
        token_ids = batch["token_ids"]
        feat_idx = batch["feat_idx"]
        is_feat = batch["is_feat"]
        segment_ids = batch["segment_ids"]
        feat_layout = batch["feat_layout"]

    embeds = assemble_embeds(backbone["embed_tokens"], _Plan, feats)
    route_ids = batch.get("route_ids") if cfg.routing_active() else None
    kw = dict(route_ids=route_ids, routing_table=routing_table,
              segment_ids=batch["segment_ids"], attn_impl=attn_impl)
    if loss_chunk:
        hidden, _ = forward_hidden_routed(backbone, cfg, embeds, **kw)
        return chunked_causal_lm_loss(backbone, hidden, batch["labels"],
                                      loss_chunk, denom)
    logits, _ = forward(backbone, cfg, embeds, **kw)
    return causal_lm_loss(logits, batch["labels"], denom)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg, tc, routing_table, train_params, batch,
                    feat_layout, attn_impl, vision_tower_cfg, mesh=None):
    """(loss, {path: grad}) over the leaves that require grad; a trainable
    leaf the loss does not reach gets zeros (the JAX gradient).

    With a mesh each data rank divides its loss sum by the group's count of
    valid targets (the global token mean: ranks hold different numbers of
    them), and the loss and each gradient are summed over the data group:
    the trainable leaves' gradients are all that crosses ranks.  Under
    tensor parallelism (a mesh with ``model > 1``) the forward and backward
    run in its model group's ``tp.scope``."""
    leaves = [(path, p) for path, p in tree_leaves(train_params)
              if p.requires_grad]
    group = None if mesh is None else mesh.data_group
    denom = None
    if mesh is not None:
        labels = batch["labels"]
        denom = tp.group_sum((labels[:, 1:] != IGNORE_INDEX).sum(),
                             group).clamp_min(1)
    tp_group = mesh.model_group if mesh is not None and mesh.model > 1 \
        else None
    with tp.scope(tp_group):
        loss = multimodal_loss_from_features(
            train_params, cfg, routing_table,
            {**batch, "feat_layout": list(feat_layout)}, attn_impl,
            vision_tower_cfg, loss_chunk=tc.loss_chunk, denom=denom)
        grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                    allow_unused=True)
    grads = {path: g if g is not None else torch.zeros_like(p)
             for (path, p), g in zip(leaves, grads)}
    if group is not None:
        with torch.no_grad():
            for g in grads.values():
                torch.distributed.all_reduce(g, group=group)
        return tp.group_sum(loss.detach(), group), grads
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, tx: Optimizer,
                    attn_impl: str = "auto", vision_tower_cfg=None):
    """``train_step(state, batch, feat_layout) -> (state, loss)``.

    Where the JAX step donates the old state, this one updates it in place
    under ``torch.no_grad()`` (parameters, moments, step) and returns the
    same object."""
    routing_table = cfg.routing_table()

    def train_step(state: TrainState, batch: Dict[str, Any], feat_layout):
        loss, grads = _loss_and_grads(cfg, tc, routing_table, state.params,
                                      batch, feat_layout, attn_impl,
                                      vision_tower_cfg, tx.mesh)
        state.opt_state = tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, loss

    return train_step


@torch.no_grad()
def scale_grads(grads: Dict[Path, torch.Tensor], c: float):
    """grads * c in place (the accumulation average); returns grads."""
    for g in grads.values():
        g.mul_(c)
    return grads


def make_grad_and_apply(cfg: ModelConfig, tc: TrainConfig, tx: Optimizer,
                        attn_impl: str = "auto", vision_tower_cfg=None):
    """Gradient accumulation: ``(grad_fn, apply_fn, accumulate,
    grad_accum_fn)``, the JAX package's four functions.

    - ``grad_fn(train_params, batch, feat_layout) -> (loss, grads)``;
    - ``grad_accum_fn(train_params, acc, batch, feat_layout) -> (loss,
      acc)`` adds this micro-batch's grads into ``acc`` in place;
    - ``accumulate(acc, grads, weight) -> acc``, acc += grads * weight in
      place;
    - ``apply_fn(state, grads) -> state``, the optimizer step in place.

    In place stands for the JAX package's donation: peak gradient memory
    is the running total plus one micro-batch's grads."""
    routing_table = cfg.routing_table()

    def grad_fn(train_params, batch, feat_layout):
        return _loss_and_grads(cfg, tc, routing_table, train_params, batch,
                               feat_layout, attn_impl, vision_tower_cfg,
                               tx.mesh)

    @torch.no_grad()
    def accumulate(acc, grads, weight):
        for path, g in grads.items():
            acc[path].add_(g * weight)
        return acc

    def grad_accum_fn(train_params, acc, batch, feat_layout):
        loss, grads = grad_fn(train_params, batch, feat_layout)
        with torch.no_grad():
            for path, g in grads.items():
                acc[path].add_(g)
        return loss, acc

    def apply_fn(state: TrainState, grads):
        state.opt_state = tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state

    return grad_fn, apply_fn, accumulate, grad_accum_fn
