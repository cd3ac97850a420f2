"""Delta-weight comparison between adapter checkpoints.

Rebuild of the reference's ``delta_weights_compare.py`` analysis tool
(reference: scripts/model_composition/delta_weights_compare.py): materialize
dense per-modality LoRA deltas from two checkpoints and report pairwise
interference metrics (L2, cosine dissimilarity, soft-sign dissimilarity),
overall and per base weight.

Usage: python -m modelcompose_tpu_torch.compose.compare ckptA ckptB [--per-key]

The port's copy of ``modelcompose_tpu/compose/compare.py``.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from .delta import load_delta_weights
from .metrics import (cosine_dissimilarity, l2_distance,
                      soft_sign_dissimilarity)


def soft_sign_dissimilarity_pair(x: np.ndarray, y: np.ndarray) -> float:
    """Two-vector form (reference: delta_weights_compare.py:17-23)."""
    abs_sum = np.abs(x) + np.abs(y)
    s = x + y
    mask = abs_sum != 0
    return float(1 - np.abs(s[mask] / abs_sum[mask]).mean())


def compare_checkpoints(path_a: str, path_b: str,
                        per_key: bool = False) -> Dict[str, float]:
    deltas_a = load_delta_weights(path_a)
    deltas_b = load_delta_weights(path_b)
    # flatten each checkpoint's deltas (all modalities) into one vector over
    # the shared base-key set
    flat_a, flat_b = [], []
    shared = []
    # pair MATCHED modalities when the two checkpoints share any modality
    # names (comparing two multi-modal checkpoints); the full cross
    # product would enter every delta multiple times and let
    # mismatched-modality pairs dominate the aggregate.  Disjoint
    # modality sets (the reference's vision-ckpt-vs-audio-ckpt use,
    # delta_weights_compare.py) keep the cross pairing.
    common_modals = set(deltas_a) & set(deltas_b)
    for modal_a, keys_a in deltas_a.items():
        for modal_b, keys_b in deltas_b.items():
            if common_modals and modal_a != modal_b:
                continue
            for base in sorted(set(keys_a) & set(keys_b)):
                shared.append((modal_a, modal_b, base))
                flat_a.append(keys_a[base].ravel())
                flat_b.append(keys_b[base].ravel())
    if not shared:
        raise ValueError("no shared base weights between the checkpoints")
    va = np.concatenate(flat_a).astype(np.float32)
    vb = np.concatenate(flat_b).astype(np.float32)
    xy = np.stack([va, vb])
    results = {
        "L2": l2_distance(xy),
        "Cosine": cosine_dissimilarity(xy),
        "SSD": soft_sign_dissimilarity(xy),
    }
    for k, v in results.items():
        print(f"{k}: {v}")
    if per_key:
        for (ma, mb, base), a, b in zip(shared, flat_a, flat_b):
            print(f"  {base} [{ma} vs {mb}]: "
                  f"ssd={soft_sign_dissimilarity_pair(a, b):.4f}")
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoints", nargs=2)
    parser.add_argument("--per-key", action="store_true")
    args = parser.parse_args()
    compare_checkpoints(args.checkpoints[0], args.checkpoints[1],
                        args.per_key)


if __name__ == "__main__":
    main()
