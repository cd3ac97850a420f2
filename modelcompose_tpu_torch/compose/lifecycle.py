"""Model lifecycle utilities: delta weights, consolidation, projector tools.

Rebuilds the reference's small checkpoint CLIs (reference:
modelcompose/model/{apply_delta,make_delta,consolidate}.py and
scripts/{merge_mm_projectors,extract_mm_projector,merge_lora_weights}.py)
as one module with subcommands (the port's counterpart of
modelcompose_tpu/compose/lifecycle.py: the numpy subcommands are its code;
``merge-lora`` loads and folds on the card unless ``--device`` says
otherwise):

    python -m modelcompose_tpu_torch.compose.lifecycle apply-delta \
        --base B --delta D --target T
    python -m modelcompose_tpu_torch.compose.lifecycle make-delta \
        --base B --target T --delta D
    python -m modelcompose_tpu_torch.compose.lifecycle consolidate \
        --src dir --dst out.safetensors
    python -m modelcompose_tpu_torch.compose.lifecycle merge-projectors \
        a b -o out
    python -m modelcompose_tpu_torch.compose.lifecycle extract-projector \
        --model-path dir --output out.safetensors
    python -m modelcompose_tpu_torch.compose.lifecycle merge-lora \
        --model-path ckpt-multimodal --model-base vicuna \
        --save-model-path dense [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict

import numpy as np

from .state_io import load_state, save_state


def _load_dir_or_file(path: str) -> Dict[str, np.ndarray]:
    if os.path.isfile(path):
        return load_state(path)
    state: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors"))) or \
        sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))) or \
        sorted(glob.glob(os.path.join(path, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no weight files under {path}")
    for f in files:
        state.update(load_state(f))
    return state


def apply_delta(base_path: str, delta_path: str, target_path: str) -> None:
    """target = base + delta per tensor (reference: model/apply_delta.py);
    keys only in the delta pass through (e.g. projector weights)."""
    base = _load_dir_or_file(base_path)
    delta = _load_dir_or_file(delta_path)
    out = {}
    for k, v in delta.items():
        if k not in base and "mm_projector" not in k \
                and "modal_projectors" not in k:
            # reference asserts unknown delta-only keys are projector
            # weights (apply_delta.py:25) — anything else means the delta
            # does not belong to this base
            raise KeyError(f"delta key {k!r} not in the base model")
        out[k] = v + base[k] if k in base else v
    save_state(out, target_path)
    print(f"applied delta -> {target_path} ({len(out)} tensors)")


def make_delta(base_path: str, target_path: str, delta_path: str) -> None:
    """delta = target - base (reference: model/make_delta.py)."""
    base = _load_dir_or_file(base_path)
    target = _load_dir_or_file(target_path)
    out = {}
    for k, v in target.items():
        out[k] = v - base[k] if k in base else v
    save_state(out, delta_path)
    print(f"made delta -> {delta_path} ({len(out)} tensors)")


def consolidate(src: str, dst: str) -> None:
    """Shards -> one file (reference: model/consolidate.py)."""
    save_state(_load_dir_or_file(src), dst)
    print(f"consolidated {src} -> {dst}")


def merge_projectors(paths, output: str) -> None:
    """State-dict union, later files win (reference:
    scripts/merge_mm_projectors.py:7-15)."""
    merged: Dict[str, np.ndarray] = {}
    for p in paths:
        merged.update(_load_dir_or_file(p))
    save_state(merged, output)
    print(f"Merged checkpoints saved to {output}")


def extract_projector(model_path: str, output: str) -> None:
    """Filter projector keys out of a full checkpoint (reference:
    scripts/extract_mm_projector.py)."""
    state = _load_dir_or_file(model_path)
    keys_to_match = ("mm_projector", "modal_projectors")
    out = {k: v for k, v in state.items()
           if any(m in k for m in keys_to_match)}
    save_state(out, output)
    print(f"extracted {len(out)} projector tensors -> {output}")



def merge_lora_to_dense(model_path: str, model_base: str,
                        save_path: str, device=None) -> None:
    """Materialize a composed checkpoint as a DENSE standalone model:
    base weights + the decode-time default-adapter deltas folded in
    (the reference's scripts/merge_lora_weights.py role — it re-saves the
    lora-loaded model as plain weights).  The model is loaded onto
    ``device`` (default: the CUDA card) and folded there; the export is
    fp32 ``model.safetensors`` + ``config.json``."""
    import torch

    from ..models.loader import load_pretrained_model
    from ..ops.routed_lora import fold_default_adapter

    _, model, _, _ = load_pretrained_model(
        model_path, model_base, "merge-multimodal",
        load_tokenizer_fn=lambda mb: None, device=device)
    cfg = model.cfg
    params = model.params

    def host(t):
        return t.float().cpu().numpy()
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(params["embed_tokens"]),
        "model.norm.weight": host(params["norm"]),
        "lm_head.weight": host(params["lm_head"]).T,
    }
    layer_map = {"self_attn.q_proj": ("attn", "q"),
                 "self_attn.k_proj": ("attn", "k"),
                 "self_attn.v_proj": ("attn", "v"),
                 "self_attn.o_proj": ("attn", "o"),
                 "mlp.gate_proj": ("mlp", "gate"),
                 "mlp.up_proj": ("mlp", "up"),
                 "mlp.down_proj": ("mlp", "down")}
    default_row = cfg.routing_table()[0]
    with torch.no_grad():
        for i in range(cfg.num_hidden_layers):
            for tname, (grp, ours) in layer_map.items():
                p = params["layers"][grp][ours]
                dense = fold_default_adapter(p["w"][i], p["lora_a"][i],
                                             p["lora_b"][i], default_row)
                out[f"model.layers.{i}.{tname}.weight"] = host(dense).T
            out[f"model.layers.{i}.input_layernorm.weight"] = \
                host(params["layers"]["input_layernorm"][i])
            out[f"model.layers.{i}.post_attention_layernorm.weight"] = \
                host(params["layers"]["post_attention_layernorm"][i])
    os.makedirs(save_path, exist_ok=True)
    save_state(out, os.path.join(save_path, "model.safetensors"))
    cfg.save(os.path.join(save_path, "config.json"))
    print(f"dense merged model saved to {save_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("apply-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--delta", required=True)
    p.add_argument("--target", required=True)

    p = sub.add_parser("make-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--delta", required=True)

    p = sub.add_parser("consolidate")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)

    p = sub.add_parser("merge-projectors")
    p.add_argument("paths", nargs="+")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("extract-projector")
    p.add_argument("--model-path", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("merge-lora")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", required=True)
    p.add_argument("--save-model-path", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")

    args = parser.parse_args(argv)
    if args.cmd == "apply-delta":
        apply_delta(args.base, args.delta, args.target)
    elif args.cmd == "make-delta":
        make_delta(args.base, args.target, args.delta)
    elif args.cmd == "consolidate":
        consolidate(args.src, args.dst)
    elif args.cmd == "merge-projectors":
        merge_projectors(args.paths, args.output)
    elif args.cmd == "extract-projector":
        extract_projector(args.model_path, args.output)
    elif args.cmd == "merge-lora":
        merge_lora_to_dense(args.model_path, args.model_base,
                            args.save_model_path, device=args.device)


if __name__ == "__main__":
    main()
