"""Merge-interference diagnostics (L2 / cosine / soft-sign dissimilarity).

Numpy rebuild of the reference's ``calculate_metrics.py`` (reference:
scripts/model_composition/calculate_metrics.py:28-77); reads the
``merge_info.txt`` provenance written by the merge CLI and writes
``merge_metrics.txt`` next to the merged checkpoint.

The port's copy of ``modelcompose_tpu/compose/metrics.py``.
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

from .state_io import load_adapter_dir
from .ties import convert_delta_to_ft, state_dict_to_vector, topk_values_mask


def parse_merge_info(file):
    pattern = r"Inputs:\n(.*?)\n\nOutput\((.*?)\):(.*?)$"
    match = re.search(pattern, open(file).read().strip(), re.DOTALL)
    if match:
        return match.group(1).split("\n"), match.group(2), match.group(3)
    return None, None, None


def l2_distance(xy: np.ndarray) -> float:
    """Mean pairwise L2.  With two inputs this is exactly the reference's
    L2(xy[0], xy[1]) (calculate_metrics.py:26-27, which hard-codes the
    first pair and silently ignores rows 2+ of a 3+-way merge)."""
    n = xy.shape[0]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return float(np.mean([np.sqrt(((xy[i] - xy[j]) ** 2).sum())
                          for i, j in pairs]))


def cosine_dissimilarity(xy: np.ndarray) -> float:
    """Mean pairwise cosine dissimilarity (reference parity at 2 inputs,
    see l2_distance)."""
    def one(a, b):
        return 1 - (a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b),
                                 1e-30)
    n = xy.shape[0]
    return float(np.mean([one(xy[i], xy[j])
                          for i in range(n) for j in range(i + 1, n)]))


def soft_sign_dissimilarity(xy: np.ndarray) -> float:
    abs_sum = np.abs(xy).sum(axis=0)
    xy_sum = xy.sum(axis=0)
    mask = abs_sum != 0
    return float(1 - np.abs(xy_sum[mask] / abs_sum[mask]).mean())


def calculate_metrics(merged_ckpt: str, reset_thresh: float = 50):
    info = Path(merged_ckpt) / "merge_info.txt"
    filepaths, _, _ = parse_merge_info(info)
    if filepaths is None:
        raise ValueError(
            f"malformed merge_info.txt at {info}: expected the merge CLI's "
            "'Inputs:\\n...\\n\\nOutput(strategy):path' format")
    weights = defaultdict(list)
    for fp in filepaths:
        for k, v in load_adapter_dir(fp).items():
            weights[k].append(np.asarray(v, np.float32))
    ft_checks, _ = convert_delta_to_ft(weights)
    flat = np.stack([state_dict_to_vector(c) for c in ft_checks])
    trimmed = topk_values_mask(flat, K=reset_thresh)

    results = {
        "L2": l2_distance(flat),
        "Cosine": cosine_dissimilarity(flat),
        "SSD": soft_sign_dissimilarity(flat),
        "TSSD": soft_sign_dissimilarity(trimmed),
    }
    with open(Path(merged_ckpt) / "merge_metrics.txt", "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
            print(f"{k}: {v}\n")
    return results


def main():
    parser = argparse.ArgumentParser(
        description="Calculate parameter interference metrics")
    parser.add_argument("merged_ckpt")
    parser.add_argument("--reset-thresh", type=float, default=50)
    args = parser.parse_args()
    calculate_metrics(args.merged_ckpt, args.reset_thresh)


if __name__ == "__main__":
    main()
