"""Checkpoint conversion: reference torch key layout -> the port's stacked
trees (counterpart of modelcompose_tpu/compose/convert.py, which calls
``jax.numpy``; the key mapping is the same).

The reference stores the Vicuna base as HF Llama shards and the trainables
as a flat ``adapter_model.bin`` keyed by ``named_parameters()``:

    model.layers.{i}.self_attn.{q,k,v,o}_proj.lora_{A,B}.{adapter}.weight
    model.layers.{i}.mlp.{gate,up,down}_proj.lora_{A,B}.{adapter}.weight
    model.modal_projectors.{modal}.<projector-local keys>
    prefix_tokens.{modal} / suffix_tokens.{modal}        [1, P, H]

torch ``nn.Linear`` stores [out, in]; the trees hold [in, out], LoRA A as
[in, r] and B as [r, out], with the layer axis stacked in front and the
adapter axis in ``cfg.adapter_names()`` order.  Every function returns
tensors of an explicit dtype on an explicit device.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..core.llama import torch_dtype
from ..models.projectors import parse_spec
from ..tree import numpy_to_torch

ATTN_MAP = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o"}
MLP_MAP = {"gate_proj": "gate", "up_proj": "up", "down_proj": "down"}

_LORA_RE = re.compile(
    r"^model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+_proj)"
    r"\.lora_(A|B)\.([\w.\-]+)\.weight$")


def _t(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` as a ``dtype`` tensor on ``device``, made without
    first copying ``a`` on the host (for a 7B base in fp32 that copy would
    be 27 GB of host memory traffic on every load)."""
    a = np.asarray(a, np.float32)
    if not a.flags.writeable:  # torch.from_numpy warns on read-only memory
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype, copy=True)


def hf_llama_to_params(state: Dict[str, np.ndarray], cfg: ModelConfig,
                       dtype=None, device=None) -> Dict[str, Any]:
    """A flat HF Llama state dict (numpy, torch [out, in] layout) -> the
    stacked tree of core/llama.py in ``dtype`` (default ``cfg.dtype``) on
    ``device``.  LoRA stacks are zero (load_adapter_into_params overlays
    them).  Each stacked leaf is filled on the device one layer at a time,
    so the host never holds a stacked copy (a 7B MLP stack is 5.8 GB in
    fp32)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    N, A, r = cfg.num_hidden_layers, len(cfg.adapter_names()), cfg.lora_r
    H, I = cfg.hidden_size, cfg.intermediate_size
    kv_out = cfg.num_key_value_heads * cfg.head_dim

    def stack(fmt, transpose=True):
        out = None
        for i in range(N):
            w = _t(state[fmt.format(i=i)], dtype, device)
            w = w.T if transpose else w
            if out is None:
                out = torch.empty((N, *w.shape), dtype=dtype, device=device)
            out[i] = w
        return out

    def linear(name, d_in, d_out):
        return {
            "w": stack(f"model.layers.{{i}}.{name}.weight"),
            "lora_a": torch.zeros((N, A, d_in, r), dtype=dtype,
                                  device=device),
            "lora_b": torch.zeros((N, A, r, d_out), dtype=dtype,
                                  device=device),
        }

    return {
        "embed_tokens": _t(state["model.embed_tokens.weight"], dtype, device),
        "layers": {
            "input_layernorm": stack(
                "model.layers.{i}.input_layernorm.weight", transpose=False),
            "post_attention_layernorm": stack(
                "model.layers.{i}.post_attention_layernorm.weight",
                transpose=False),
            "attn": {"q": linear("self_attn.q_proj", H, H),
                     "k": linear("self_attn.k_proj", H, kv_out),
                     "v": linear("self_attn.v_proj", H, kv_out),
                     "o": linear("self_attn.o_proj", H, H)},
            "mlp": {"gate": linear("mlp.gate_proj", H, I),
                    "up": linear("mlp.up_proj", H, I),
                    "down": linear("mlp.down_proj", I, H)},
        },
        "norm": _t(state["model.norm.weight"], dtype, device),
        "lm_head": _t(np.asarray(state["lm_head.weight"], np.float32).T,
                      dtype, device),
    }


def _dense_from(state, prefix):
    return {"w": np.asarray(state[f"{prefix}.weight"], np.float32).T,
            "b": np.asarray(state[f"{prefix}.bias"], np.float32)}


def _ln_from(state, prefix):
    return {"scale": np.asarray(state[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(state[f"{prefix}.bias"], np.float32)}


def projector_from_reference(spec: str, state: Dict[str, np.ndarray],
                             prefix: str, dtype=torch.float32,
                             device=None) -> Dict[str, Any]:
    """One projector's params from reference-layout keys rooted at
    ``prefix`` (e.g. ``model.modal_projectors.vision``)."""
    kind = parse_spec(spec)
    if kind["kind"] == "identity":
        return {}
    if kind["kind"] == "linear":
        tree = {"layers": [_dense_from(state, prefix)]}
    elif kind["kind"] == "mlp":
        # nn.Sequential: Linears at even indices, GELUs between
        tree = {"layers": [_dense_from(state, f"{prefix}.{2 * d}")
                           for d in range(kind["depth"])]}
    else:
        # VideoLlamaAudioQformer: a BERT module tree under audio_Qformer
        qf = f"{prefix}.audio_Qformer.bert"

        def attention(pre):
            return {"q": _dense_from(state, f"{pre}.self.query"),
                    "k": _dense_from(state, f"{pre}.self.key"),
                    "v": _dense_from(state, f"{pre}.self.value"),
                    "o": _dense_from(state, f"{pre}.output.dense"),
                    "ln": _ln_from(state, f"{pre}.output.LayerNorm")}
        tree = {
            "query_tokens": np.asarray(
                state[f"{prefix}.audio_query_tokens"], np.float32)[0],
            "position_embedding": np.asarray(
                state[f"{prefix}.audio_position_embedding.weight"],
                np.float32),
            "embeddings_ln": _ln_from(state, f"{qf}.embeddings.LayerNorm"),
            "llama_proj": _dense_from(state, f"{prefix}.audio_llama_proj"),
            "layers": [{
                "self": attention(f"{qf}.encoder.layer.{l}.attention"),
                "cross": attention(f"{qf}.encoder.layer.{l}.crossattention"),
                "ffn": {"w1": _dense_from(
                            state, f"{qf}.encoder.layer.{l}"
                                   ".intermediate_query.dense"),
                        "w2": _dense_from(
                            state, f"{qf}.encoder.layer.{l}"
                                   ".output_query.dense"),
                        "ln": _ln_from(
                            state, f"{qf}.encoder.layer.{l}"
                                   ".output_query.LayerNorm")},
            } for l in range(kind["n_layers"])],
        }
    return numpy_to_torch(tree, dtype, device)


def load_adapter_into_params(params: Dict[str, Any],
                             adapter: Dict[str, np.ndarray],
                             cfg: ModelConfig,
                             projector_params: Optional[Dict[str, Any]] = None,
                             strict: bool = False) -> List[str]:
    """Overlay a reference-layout adapter state dict onto the stacked tree
    in place: each LoRA matrix lands in its layer and adapter row (the
    ``default-{modal}`` rows of a composed checkpoint included), the soft
    tokens become ``params[prefix_tokens|suffix_tokens][modal]``, and each
    ``model.modal_projectors.{modal}`` tree goes into ``projector_params``.
    Everything lands in ``cfg.dtype``, on the device of
    ``params["embed_tokens"]``.  With ``strict=False`` (the reference's
    overlay) unknown LoRA keys are returned, not raised; every other
    unconsumed key is returned too."""
    adapter_index = {n: i for i, n in enumerate(cfg.adapter_names())}
    dtype = torch_dtype(cfg.dtype)
    device = params["embed_tokens"].device
    leftovers: List[str] = []
    projector_modals = set()
    for key, val in adapter.items():
        if key.startswith("base_model.model."):  # peft wrapper prefix
            key = key[len("base_model.model."):]
        m = _LORA_RE.match(key)
        if m:
            layer, grp, proj, ab, adapter_name = m.groups()
            group = "attn" if grp == "self_attn" else "mlp"
            name = (ATTN_MAP if group == "attn" else MLP_MAP).get(proj)
            if name is None or adapter_name not in adapter_index:
                if strict:
                    raise KeyError(key)
                leftovers.append(key)
                continue
            which = "lora_a" if ab == "A" else "lora_b"
            # torch lora_A.weight [r, in], lora_B.weight [out, r]
            params["layers"][group][name][which][
                int(layer), adapter_index[adapter_name]] = _t(
                    np.asarray(val, np.float32).T, dtype, device)
            continue
        pm = re.match(r"^model\.modal_projectors\.(\w+)\.", key)
        if pm and projector_params is not None:
            projector_modals.add(pm.group(1))
            continue
        tm = re.match(r"^(prefix|suffix)_tokens\.([\w\-]+)$", key)
        if tm:
            kind, modal = tm.groups()
            params.setdefault(f"{kind}_tokens", {})[modal] = _t(
                np.asarray(val, np.float32)[0], dtype, device)
            continue
        leftovers.append(key)
    for modal in projector_modals:
        projector_params[modal] = projector_from_reference(
            cfg.projector_type(modal), adapter,
            f"model.modal_projectors.{modal}", dtype, device)
    return leftovers


# ---------------------------------------------------------------------------
# Export: the port's trees -> reference layout (numpy, fp32)
# ---------------------------------------------------------------------------

def _np32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_hf_llama(params: Dict[str, Any], cfg: ModelConfig
                       ) -> Dict[str, np.ndarray]:
    """Inverse of hf_llama_to_params for the base weights (bf16 tensors
    and dense ``w`` leaves only)."""
    lp = params["layers"]
    out = {"model.embed_tokens.weight": _np32(params["embed_tokens"]),
           "model.norm.weight": _np32(params["norm"]),
           "lm_head.weight": _np32(params["lm_head"]).T}
    names = {("attn", v): f"self_attn.{k}" for k, v in ATTN_MAP.items()}
    names.update({("mlp", v): f"mlp.{k}" for k, v in MLP_MAP.items()})
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = _np32(lp["input_layernorm"][i])
        out[pre + "post_attention_layernorm.weight"] = _np32(
            lp["post_attention_layernorm"][i])
        for (grp, name), hf in names.items():
            out[pre + hf + ".weight"] = _np32(lp[grp][name]["w"][i]).T
    return out


def projector_to_reference(spec: str, params: Dict[str, Any],
                           prefix: str) -> Dict[str, np.ndarray]:
    """Inverse of projector_from_reference."""
    kind = parse_spec(spec)
    out: Dict[str, np.ndarray] = {}

    def put_dense(p, pre):
        out[f"{pre}.weight"] = _np32(p["w"]).T
        out[f"{pre}.bias"] = _np32(p["b"])

    def put_ln(p, pre):
        out[f"{pre}.weight"] = _np32(p["scale"])
        out[f"{pre}.bias"] = _np32(p["bias"])

    if kind["kind"] == "linear":
        put_dense(params["layers"][0], prefix)
    elif kind["kind"] == "mlp":
        for d, layer in enumerate(params["layers"]):
            put_dense(layer, f"{prefix}.{2 * d}")
    elif kind["kind"] == "qformer":
        qf = f"{prefix}.audio_Qformer.bert"
        out[f"{prefix}.audio_query_tokens"] = _np32(
            params["query_tokens"])[None]
        out[f"{prefix}.audio_position_embedding.weight"] = _np32(
            params["position_embedding"])
        put_ln(params["embeddings_ln"], f"{qf}.embeddings.LayerNorm")
        put_dense(params["llama_proj"], f"{prefix}.audio_llama_proj")
        for l, layer in enumerate(params["layers"]):
            pre = f"{qf}.encoder.layer.{l}"
            for part, name in (("self", "attention"),
                               ("cross", "crossattention")):
                att = layer[part]
                for ours, theirs in (("q", "self.query"), ("k", "self.key"),
                                     ("v", "self.value"),
                                     ("o", "output.dense")):
                    put_dense(att[ours], f"{pre}.{name}.{theirs}")
                put_ln(att["ln"], f"{pre}.{name}.output.LayerNorm")
            put_dense(layer["ffn"]["w1"], f"{pre}.intermediate_query.dense")
            put_dense(layer["ffn"]["w2"], f"{pre}.output_query.dense")
            put_ln(layer["ffn"]["ln"], f"{pre}.output_query.LayerNorm")
    return out


def params_to_adapter(params: Dict[str, Any], cfg: ModelConfig,
                      projector_params: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, np.ndarray]:
    """The trainables in the reference ``adapter_model`` layout (inverse of
    load_adapter_into_params): every adapter's LoRA A/B, the projectors and
    the soft tokens."""
    out: Dict[str, np.ndarray] = {}
    names = cfg.adapter_names()
    for group, mapping in (("attn", ATTN_MAP), ("mlp", MLP_MAP)):
        grp_name = "self_attn" if group == "attn" else "mlp"
        for torch_name, ours in mapping.items():
            la = _np32(params["layers"][group][ours]["lora_a"])
            lb = _np32(params["layers"][group][ours]["lora_b"])
            for i in range(la.shape[0]):
                base = f"model.layers.{i}.{grp_name}.{torch_name}"
                for a_idx, adapter_name in enumerate(names):
                    out[f"{base}.lora_A.{adapter_name}.weight"] = \
                        la[i, a_idx].T
                    out[f"{base}.lora_B.{adapter_name}.weight"] = \
                        lb[i, a_idx].T
    for kind in ("prefix_tokens", "suffix_tokens"):
        for modal, tok in (params.get(kind) or {}).items():
            out[f"{kind}.{modal}"] = _np32(tok)[None]
    for modal, tree in (projector_params or {}).items():
        out.update(projector_to_reference(
            cfg.projector_type(modal), tree,
            f"model.modal_projectors.{modal}"))
    return out
