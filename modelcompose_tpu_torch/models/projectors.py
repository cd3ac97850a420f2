"""Modality projectors: linear / mlpNx_gelu / identity (counterpart of
modelcompose_tpu/models/projectors.py).  Each projector is a pair of plain
functions: ``init_projector(spec, ...)`` returns a param tree and
``apply_projector(spec, params, x)`` applies it.  The Q-Former projector is
not ported yet (ROADMAP Queue 1, Q-Former)."""

from __future__ import annotations

import re
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.quant import matmul_f32


def parse_spec(spec: str) -> Dict[str, Any]:
    if spec == "linear":
        return {"kind": "linear"}
    if spec == "identity":
        return {"kind": "identity"}
    m = re.match(r"^mlp(\d+)x_gelu$", spec)
    if m:
        return {"kind": "mlp", "depth": int(m.group(1))}
    m = re.match(r"^qformer_(\d+)N_(\d+)L$", spec)
    if m:
        return {"kind": "qformer", "n_query": int(m.group(1)),
                "n_layers": int(m.group(2))}
    raise ValueError(f"Unknown projector type: {spec}")


def _check_ported(kind):
    if kind["kind"] == "qformer":
        raise NotImplementedError(
            "the Q-Former projector is not ported yet: ROADMAP Queue 1, "
            "Q-Former")


def _dense(p, x):
    return matmul_f32(x, p["w"]).to(x.dtype) + p["b"]


def init_projector(spec: str, generator: torch.Generator, d_in: int,
                   d_out: int, dtype=torch.float32, device=None
                   ) -> Dict[str, Any]:
    kind = parse_spec(spec)
    _check_ported(kind)
    if kind["kind"] == "identity":
        return {}

    def dense(i, o):
        w = torch.randn((i, o), generator=generator, dtype=torch.float32,
                        device=device) * 0.02
        return {"w": w.to(dtype),
                "b": torch.zeros((o,), dtype=dtype, device=device)}

    depth = kind.get("depth", 1)
    return {"layers": [dense(d_in, d_out)]
            + [dense(d_out, d_out) for _ in range(1, depth)]}


def apply_projector(spec: str, params: Dict[str, Any], x) -> torch.Tensor:
    """x: [B, T, d_in] -> [B, T, d_out]."""
    kind = parse_spec(spec)
    _check_ported(kind)
    if kind["kind"] == "identity":
        return x
    y = _dense(params["layers"][0], x)
    for layer in params["layers"][1:]:
        # exact-erf GELU (nn.GELU()), not the tanh approximation
        y = _dense(layer, F.gelu(y))
    return y


def output_len(spec: str, input_len: int) -> int:
    """Number of feature tokens the projector emits for T input tokens."""
    kind = parse_spec(spec)
    if kind["kind"] == "qformer":
        return kind["n_query"]
    return input_len
