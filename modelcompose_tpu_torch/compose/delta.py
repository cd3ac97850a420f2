"""Dense LoRA delta materialization for analysis.

Numpy rebuild of the reference's ``scripts/evaluate_delta_weights.py``
(reference: :8-58): materialize ``B @ A * scale`` per modality from an
adapter checkpoint, keyed by the base weight name.

The port's copy of ``modelcompose_tpu/compose/delta.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .state_io import load_adapter_dir


def get_delta_weight(lora_a: np.ndarray, lora_b: np.ndarray,
                     scale: float) -> np.ndarray:
    """lora_a: [r, d_in]; lora_b: [d_out, r] (torch Linear layout) ->
    [d_out, d_in] dense delta (reference: evaluate_delta_weights.py:8-15)."""
    return (np.asarray(lora_b, np.float32) @ np.asarray(lora_a, np.float32)
            ) * scale


def lora_key_to_base_key(lora_key: str, modal: str) -> str:
    return (lora_key.replace(f".lora_A.{modal}.weight", "")
            .replace(f".lora_B.{modal}.weight", "") + ".weight")


def base_key_to_lora_key(base_key: str, modal: str):
    a = base_key.replace(".weight", f".lora_A.{modal}.weight")
    b = base_key.replace(".weight", f".lora_B.{modal}.weight")
    return a, b


def _modal_scale(config: dict, modal: str) -> float:
    """alpha/r for one modality, honoring the ``{modal}_lora_alpha`` /
    ``{modal}_lora_r`` stamps the merge CLI writes (compose/merge.py:152)
    — the runtime (config.ModelConfig.modal_scale) applies these, so the
    analyzed deltas must use the same scale."""
    alpha = config.get(f"{modal}_lora_alpha") or config["lora_alpha"]
    r = config.get(f"{modal}_lora_r") or config["lora_r"]
    return alpha / r


def load_delta_weights(path: str, modals: Optional[Sequence[str]] = None
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    lora = load_adapter_dir(path)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key in lora:
        if "lora_B" in key:
            modal = key.split("lora_B.")[1].split(".")[0]
            if modals is not None and modal not in modals:
                continue
            base = lora_key_to_base_key(key, modal)
            a_key, b_key = base_key_to_lora_key(base, modal)
            out.setdefault(modal, {})[base] = get_delta_weight(
                lora[a_key], lora[b_key], _modal_scale(config, modal))
    return out


def main():
    """CLI mirroring the reference's evaluate_delta_weights entry
    (reference: scripts/evaluate_delta_weights.py)."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Materialize dense LoRA deltas for analysis")
    parser.add_argument("checkpoint")
    parser.add_argument("--modals", nargs="*", default=None)
    parser.add_argument("--output", default=None,
                        help="optional .safetensors to save deltas")
    args = parser.parse_args()
    deltas = load_delta_weights(args.checkpoint, args.modals)
    for modal, keys in deltas.items():
        norms = [float(np.linalg.norm(v)) for v in keys.values()]
        print(f"{modal}: {len(keys)} deltas, "
              f"mean ||delta||={np.mean(norms):.4f}")
    if args.output:
        from .state_io import save_state
        flat = {f"{m}.{k}": v for m, keys in deltas.items()
                for k, v in keys.items()}
        save_state(flat, args.output)
        print(f"saved {len(flat)} deltas -> {args.output}")


if __name__ == "__main__":
    main()
