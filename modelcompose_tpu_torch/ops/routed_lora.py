"""Routed multi-adapter LoRA linear — the composition primitive
(counterpart of modelcompose_tpu/ops/routed_lora.py).

    y[t] = x[t] @ W + sum_a route[t, a] * (x[t] @ A_a) @ B_a

with the adapters stacked, ``A: [n_adapters, in, r]``, ``B: [n_adapters, r,
out]``, and ``route[t]`` the token's row of the routing table.  Plain
PyTorch: the stacked adapters are contracted as one ``[in, A*r]`` and one
``[A*r, out]`` product, with no data-dependent control flow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import tp
from . import decode_fused
from .quant import (dequant_matmul, dequant_matmul_group, is_quantized,
                    k5_groups, matmul_f32, quantize_int8)


def routed_lora_matmul(x, w, lora_a, lora_b, route, parallel=None,
                       impl="auto", rounded=False):
    """y = x @ w + sum_a route[..., a] * (x @ A_a) @ B_a.

    Args:
      x:      [..., L, d_in] activations.
      w:      [d_in, d_out] base weight, or an int8 ``{"q", "scale"}`` dict.
      lora_a: [A, d_in, r]; lora_b: [A, r, d_out].
      route:  [..., L, A] per-token adapter weights (scales folded in), or
              None to skip the adapter branch.
      parallel: None, or under tensor parallelism (a model group set in
              ``parallel.tp``) the layer's split: ``"column"`` (w and B
              hold this rank's output columns, A is whole) or ``"row"``
              (x and w hold this rank's input rows, A and B are whole).
      impl:   an int8 ``w``'s product: "auto" (kernel K5 or K6 on the
              card, see ``quant.dequant_matmul``) or "reference" (its
              plain version).
      rounded: the decode step's products: an int8 base product with
              nothing after it in fp32 (no adapter branch, no row-split
              sum over a model group of more than one) writes x.dtype
              itself (K5 rounds in its epilogue the fp32 value the cast
              would round), so no cast pass follows it.

    A column-split product's input and its ``[*, r]`` bottleneck pass
    through ``copy_to_model``, whose backward sums their cotangents over
    the group, so the replicated A's gradient is the whole one on every
    rank.  A row-split product multiplies its rows of x by its rows of A,
    then by the whole B: ``(sum_r x_r A_r) B = sum_r x_r A_r B``, so the
    LoRA term rides in the one fp32 all-reduce of the base product, and B
    passes through ``copy_to_model`` so its gradient is summed too.

    Returns [..., L, d_out] in x.dtype.  The base product stays fp32 until
    after the adapter add (and the row-split sum), as in the JAX package.
    """
    column = parallel == "column"
    x_base = tp.copy_to_model(x) if column else x
    if is_quantized(w):
        y = dequant_matmul(x_base, w, impl=impl,
                           out_dtype=_base_dtype(x, route, parallel, rounded))
    else:
        y = matmul_f32(x_base, w)
    return _adapter_add(x, y, lora_a, lora_b, route, parallel)


def _base_dtype(x, route, parallel, rounded):
    """The int8 base product's output type: x.dtype for a ``rounded``
    product that nothing follows in fp32 (no adapter branch, no row-split
    sum), else fp32."""
    if rounded and route is None and (parallel != "row"
                                      or tp.model_size() == 1):
        return x.dtype
    return torch.float32


def routed_lora_matmul_group(x, ps, route, parallel=None, impl="auto",
                             rounded=False):
    """``[routed_lora_matmul(x, p["w"], p["lora_a"], p["lora_b"], route,
    parallel, impl, rounded) for p in ps]`` for products that share x (a
    layer's q/k/v, its gate/up), whose int8 base products run as one K5
    launch where ``quant.k5_groups`` says so (1-2 rows on the card): the
    members then share one ``copy_to_model(x)`` under a column split, and
    each keeps its own adapter branch.  Anywhere else, or with a float base
    or a row split, each member runs as ``routed_lora_matmul`` runs it."""
    ws = [p["w"] for p in ps]
    if impl != "auto" or parallel == "row" or not k5_groups(x, len(ps)) \
            or not all(is_quantized(w) for w in ws):
        return [routed_lora_matmul(x, p["w"], p["lora_a"], p["lora_b"],
                                   route, parallel=parallel, impl=impl,
                                   rounded=rounded)
                for p in ps]
    x_base = tp.copy_to_model(x) if parallel == "column" else x
    ys = dequant_matmul_group(x_base, ws, out_dtype=_base_dtype(
        x, route, parallel, rounded))
    return [_adapter_add(x, y, p["lora_a"], p["lora_b"], route, parallel)
            for y, p in zip(ys, ps)]


def routed_lora_norm_group(x, res, norm_weight, eps: float, ps, route,
                           parallel=None, rope=None):
    """The decode layer's residual add and RMSNorm and the products of its
    output h that share it (q/k/v, or gate/up): ``s, h =
    decode_fused.add_rms_norm(x, res, norm_weight, eps)``, then
    ``routed_lora_matmul_group(h, ps, route, parallel, rounded=True)``, and
    with ``rope`` (a ``decode_fused.RopeWrite``, for q/k/v)
    ``decode_fused.rope_kv_write`` on the three outputs.  Returns (s, the
    outputs): with ``rope`` [the rotated q [B, 1, H, D]].

    Where ``decode_fused.norm_fuses`` says so (1-2 rows on the card, int8
    weights that share one K5 launch; column-split or unsplit members),
    that launch runs K8 in its prologue (``norm_matmul_group``), and h
    reaches device memory only where an adapter branch reads it; where
    besides no adapter branch follows (``route`` None: the products round
    to x's type) and the heads fit (``decode_fused.rope_fuses``), K9 runs
    in its epilogue too (``norm_qkv_rope``).  Anywhere else (3-8 rows, the
    CPU, a float base) K8, the products and K9 are launches of their
    own."""
    ws = [p["w"] for p in ps]
    if parallel == "row" or not decode_fused.norm_fuses(x, ws):
        s, h = decode_fused.add_rms_norm(x, res, norm_weight, eps)
        outs = routed_lora_matmul_group(h, ps, route, parallel=parallel,
                                        rounded=True)
    elif rope is not None and route is None \
            and decode_fused.rope_fuses(ws, rope.cos.shape[-1]):
        s, q = decode_fused.norm_qkv_rope(x, res, norm_weight, eps, ws,
                                          rope)
        return s, [q]
    else:
        s, h, ys = decode_fused.norm_matmul_group(
            x, res, norm_weight, eps, ws,
            out_dtype=_base_dtype(x, route, parallel, True),
            keep_h=route is not None)
        outs = ys if route is None else [
            _adapter_add(h, y, p["lora_a"], p["lora_b"], route, parallel)
            for y, p in zip(ys, ps)]
    if rope is not None:
        outs = [decode_fused.rotate_and_write(outs, rope,
                                              decode_fused.rope_kv_write)]
    return s, outs


def routed_lora_silu(gate, up, p, route, parallel=None):
    """The decode layer's SiLU product and the down product of its output
    h: ``routed_lora_matmul(decode_fused.silu_mul(gate, up), p["w"],
    p["lora_a"], p["lora_b"], route, parallel, rounded=True)``.

    Where ``decode_fused.silu_fuses`` says so (on the card, an int8
    weight, unsplit or row-split, at the rows where K5 streams it: one,
    and two but for the tp 4 shard), one K5 launch runs K10 in its
    prologue (``silu_matmul``), and h reaches device memory only where an
    adapter branch reads it.  Anywhere else (3-8 rows, the CPU, a float
    base) K10 and the product are launches of their own."""
    if not decode_fused.silu_fuses(gate, p["w"]):
        return routed_lora_matmul(decode_fused.silu_mul(gate, up), p["w"],
                                  p["lora_a"], p["lora_b"], route,
                                  parallel=parallel, rounded=True)
    h, y = decode_fused.silu_matmul(
        gate, up, p["w"], out_dtype=_base_dtype(gate, route, parallel, True),
        keep_h=route is not None)
    return _adapter_add(gate if h is None else h, y, p["lora_a"],
                        p["lora_b"], route, parallel)


def _adapter_add(x, y, lora_a, lora_b, route, parallel):
    """The base product y (fp32, or x.dtype where nothing follows it) plus
    the routed adapter branch of x, the row split's sum over the group, in
    x.dtype."""
    column = parallel == "column"
    if route is not None:
        if parallel == "row":
            lora_a = tp.slice_rows(lora_a, -2, x.shape[-1])
            lora_b = tp.copy_to_model(lora_b)
        n_a, d_in, r = lora_a.shape
        a_cat = lora_a.permute(1, 0, 2).reshape(d_in, n_a * r)
        u = matmul_f32(x, a_cat).view(*x.shape[:-1], n_a, r)
        u = u * route[..., None].float()
        u = u.to(lora_b.dtype).reshape(*x.shape[:-1], n_a * r)
        if column:
            u = tp.copy_to_model(u)
        y = y + matmul_f32(u, lora_b.reshape(n_a * r, lora_b.shape[-1]))
    if parallel == "row":
        y = tp.reduce_from_model(y)
    return y.to(x.dtype)


def route_weights(route_ids, routing_table):
    """[..., L] route-class ids -> [..., L, n_adapters] adapter weights."""
    return routing_table[route_ids.long()]


def as_table(routing_table, device) -> torch.Tensor:
    """A routing table (numpy or tensor) as an fp32 tensor on ``device``."""
    if isinstance(routing_table, torch.Tensor):
        return routing_table.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(routing_table), dtype=torch.float32,
                           device=device)


def _map_linears(params, fn):
    out = dict(params)
    layers = dict(params["layers"])
    for grp in ("attn", "mlp"):
        layers[grp] = {name: fn(p) for name, p in params["layers"][grp].items()}
    out["layers"] = layers
    return out


def fold_decode_adapters(params, default_route):
    """Compact the stacked adapters to the decode-time 'default' mix.

    Every decode token takes the default route, whose row is static for a
    generation: only its nonzero columns are ever read.  They are
    concatenated into one low-rank pair ``[N, 1, d_in, R]`` x
    ``[N, 1, R, d_out]`` with the coefficients scaled into B (rounded to
    B's dtype first, as the JAX package's weakly typed scalar is), so a
    step reads only the active adapters and no routing gather.  int8
    ``w`` dicts pass through; the copies sit beside the full stacks.

    default_route: [n_adapters] routing-table row 0 (numpy or tensor).
    Returns (decode_params, decode_routing_table [1, 1] fp32 ones).
    """
    row = default_route.cpu().numpy() if isinstance(
        default_route, torch.Tensor) else np.asarray(default_route)
    support = [int(i) for i in np.nonzero(row)[0]]

    def fold_linear(p):
        la, lb = p["lora_a"], p["lora_b"]
        if not support:  # routing inactive: keep a zeroed rank-r branch
            a, b = la[:, :1] * 0, lb[:, :1] * 0
        else:
            a = torch.cat([la[:, i] for i in support], dim=2)[:, None]
            b = torch.cat([lb[:, i] * torch.tensor(float(row[i]),
                                                   dtype=lb.dtype)
                           for i in support], dim=1)[:, None]
        return {"w": p["w"], "lora_a": a, "lora_b": b}

    table = torch.ones((1, 1), dtype=torch.float32,
                       device=params["embed_tokens"].device)
    return _map_linears(params, fold_linear), table


def fold_dense(params, routing_table):
    """Fold the default-route adapter mix densely into every base weight
    and rebase the routing table so prefill stays numerically identical.

    With c = routing_table[0]:  W' = W + sum_a c_a A_a @ B_a  and
    table' = table - c, so row 0 becomes all-zero and decode can skip the
    adapter branch (``routing_table=None``).  int8 bases are dequantized,
    folded and requantized.

    Returns (params', routing_table' [n_classes, n_adapters] fp32).
    """
    table = as_table(routing_table, params["embed_tokens"].device)
    c = table[0]

    def fold_linear(p):
        w = p["w"]
        rows = (w["q"] if is_quantized(w) else w).shape[-2]
        # a row-split rank folds its rows of the whole A
        a = tp.slice_rows(p["lora_a"], -2, rows)
        if is_quantized(w):
            new_w = quantize_int8(fold_default_adapter(
                w["q"].float() * w["scale"], a, p["lora_b"], c), axis=-2)
        else:
            new_w = fold_default_adapter(w, a, p["lora_b"], c)
        return {"w": new_w, "lora_a": p["lora_a"], "lora_b": p["lora_b"]}

    return _map_linears(params, fold_linear), table - c[None, :]


def fold_default_adapter(w, lora_a, lora_b, default_route):
    """Fold the decode-time ('default' class) adapter mix densely into w:
    W' = W + sum_a c_a * A_a @ B_a, in fp32.

    Args:
      w: [..., d_in, d_out]; lora_a: [..., A, d_in, r];
      lora_b: [..., A, r, d_out] (leading axes: stacked layers, or none);
      default_route: [A] the routing-table row of the default class
        (numpy or tensor).

    Returns [..., d_in, d_out] in w.dtype.
    """
    c = torch.as_tensor(default_route, dtype=torch.float32, device=w.device)
    delta = torch.einsum("a,...air,...aro->...io", c, lora_a.float(),
                         lora_b.float())
    return (w.float() + delta).to(w.dtype)


def active_adapter_set(routing_table, route_classes=None):
    """Sorted tuple of the adapter columns reachable from ``route_classes``
    (None = all classes)."""
    table = routing_table.cpu().numpy() if isinstance(
        routing_table, torch.Tensor) else np.asarray(routing_table)
    if route_classes is not None:
        rows = table[sorted({int(c) for c in route_classes})]
    else:
        rows = table
    return tuple(int(a) for a in np.nonzero(np.any(rows != 0, axis=0))[0])


def compact_active_adapters(params, routing_table, active):
    """Gather the stacked adapters (and the table's columns) down to the
    active columns, so prefill contracts only the adapters the batch's
    route classes can reach.

    A contiguous run of columns (an online-merge composition drops only
    'default', column 0) is a view of the stacks, so compaction holds no
    second adapter tree; any other set is gathered into new stacks.

    Returns (params', routing_table' [n_classes, len(active)])."""
    if not active:  # routing degenerate: keep one (zero-weighted) column
        active = (0,)
    device = params["embed_tokens"].device
    idx = torch.tensor(list(active), device=device)
    lo, n = active[0], len(active)
    contiguous = tuple(active) == tuple(range(lo, lo + n))

    def take(t):
        return t.narrow(1, lo, n) if contiguous else t.index_select(1, idx)

    def slice_linear(p):
        return {"w": p["w"], "lora_a": take(p["lora_a"]),
                "lora_b": take(p["lora_b"])}

    table = as_table(routing_table, device).index_select(1, idx)
    return _map_linears(params, slice_linear), table
