"""Modality projectors: linear / mlpNx_gelu / qformer_{N}N_{L}L / identity
(counterpart of modelcompose_tpu/models/projectors.py).  Each projector is
a pair of plain functions: ``init_projector(spec, ...)`` returns a param
tree and ``apply_projector(spec, params, x)`` applies it.

The Q-Former is the BLIP-2-style query transformer of the audio DAMC recipe
(``qformer_32N_2L``): BERT-base width (768, 12 heads, post-LN, exact-erf
GELU, LayerNorm eps 1e-12), learned query tokens, a learned position table
of 1,024 rows added to the encoder features, self-attention then
cross-attention to the features in every layer, a query-only FFN and a
final Linear to the LLM width."""

from __future__ import annotations

import re
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.quant import matmul_f32
from .vision_clip import _ln

QFORMER_HIDDEN = 768
QFORMER_HEADS = 12
QFORMER_INTERMEDIATE = 3072
QFORMER_LN_EPS = 1e-12
QFORMER_NUM_POSITIONS = 1024


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


def _dense(p, x):
    return matmul_f32(x, p["w"]).to(x.dtype) + p["b"]


def init_projector(spec: str, generator: torch.Generator, d_in: int,
                   d_out: int, dtype=torch.float32, device=None
                   ) -> Dict[str, Any]:
    kind = parse_spec(spec)
    if kind["kind"] == "identity":
        return {}

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def dense(i, o):
        return {"w": normal((i, o)),
                "b": torch.zeros((o,), dtype=dtype, device=device)}

    if kind["kind"] != "qformer":
        depth = kind.get("depth", 1)
        return {"layers": [dense(d_in, d_out)]
                + [dense(d_out, d_out) for _ in range(1, depth)]}

    H = QFORMER_HIDDEN

    def ln():
        return {"scale": torch.ones((H,), dtype=dtype, device=device),
                "bias": torch.zeros((H,), dtype=dtype, device=device)}

    def attention(d_kv):
        return {"q": dense(H, H), "k": dense(d_kv, H), "v": dense(d_kv, H),
                "o": dense(H, H), "ln": ln()}
    return {
        "query_tokens": normal((kind["n_query"], H)),
        "position_embedding": normal((QFORMER_NUM_POSITIONS, d_in)),
        "embeddings_ln": ln(),
        "llama_proj": dense(H, d_out),
        "layers": [{"self": attention(H), "cross": attention(d_in),
                    "ffn": {"w1": dense(H, QFORMER_INTERMEDIATE),
                            "w2": dense(QFORMER_INTERMEDIATE, H),
                            "ln": ln()}}
                   for _ in range(kind["n_layers"])],
    }


def _mha(att, q_in, kv_in, n_heads=QFORMER_HEADS):
    """Post-LN BERT attention block: LN(dense(attention) + q_in), softmax
    in fp32."""
    B, Q, H = q_in.shape
    S = kv_in.shape[1]
    hd = H // n_heads
    q = _dense(att["q"], q_in).view(B, Q, n_heads, hd)
    k = _dense(att["k"], kv_in).view(B, S, n_heads, hd)
    v = _dense(att["v"], kv_in).view(B, S, n_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / hd ** 0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    ctx = ctx.reshape(B, Q, H).to(q_in.dtype)
    return _ln(att["ln"], _dense(att["o"], ctx) + q_in, QFORMER_LN_EPS)


def apply_projector(spec: str, params: Dict[str, Any], x) -> torch.Tensor:
    """x: [B, T, d_in] -> [B, T_out, d_out]."""
    kind = parse_spec(spec)
    if kind["kind"] == "identity":
        return x
    if kind["kind"] != "qformer":
        y = _dense(params["layers"][0], x)
        for layer in params["layers"][1:]:
            # exact-erf GELU (nn.GELU()), not the tanh approximation
            y = _dense(layer, F.gelu(y))
        return y
    B, T, _ = x.shape
    n_pos = params["position_embedding"].shape[0]
    if T > n_pos:
        # the reference's nn.Embedding(num_positions) fails at the same
        # point: more than 1,024 tokens (over 20.5 s of BEATs audio)
        raise ValueError(
            f"qformer input has {T} tokens but the position table holds "
            f"{n_pos} (reference VideoLlamaAudioQformer limit); clip the "
            "input")
    x = x + params["position_embedding"][:T][None]
    q = params["query_tokens"].expand(B, *params["query_tokens"].shape)
    q = _ln(params["embeddings_ln"], q, QFORMER_LN_EPS)
    for layer in params["layers"]:
        q = _mha(layer["self"], q, q)
        q = _mha(layer["cross"], q, x)
        ff = _dense(layer["ffn"]["w2"], F.gelu(_dense(layer["ffn"]["w1"], q)))
        q = _ln(layer["ffn"]["ln"], ff + q, QFORMER_LN_EPS)
    return _dense(params["llama_proj"], q)


def output_len(spec: str, input_len: int) -> int:
    """Number of feature tokens the projector emits for T input tokens."""
    kind = parse_spec(spec)
    if kind["kind"] == "qformer":
        return kind["n_query"]
    return input_len
