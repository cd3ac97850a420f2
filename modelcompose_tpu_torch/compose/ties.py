"""TIES merging (trim / elect sign / disjoint aggregate) in pure numpy (the
port's copy of modelcompose_tpu/compose/ties.py).

Same algorithm as the reference's vendored copy of the public TIES-Merging
code (reference: scripts/model_composition/ties_merging.py:88-221; upstream
NeurIPS'23 "Resolving Interference When Merging Models").  Operates on flat
dicts of numpy arrays; no torch, no device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def state_dict_to_vector(state: Dict[str, np.ndarray]) -> np.ndarray:
    """Flatten in sorted-key order (reference: ties_merging.py:22-30)."""
    return np.concatenate(
        [np.asarray(state[k], np.float32).reshape(-1)
         for k in sorted(state)]) if state else np.zeros(0, np.float32)


def vector_to_state_dict(vec: np.ndarray,
                         like: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    off = 0
    for k in sorted(like):
        n = int(np.prod(like[k].shape)) if like[k].shape else 1
        out[k] = vec[off:off + n].reshape(like[k].shape).astype(
            like[k].dtype, copy=False)
        off += n
    return out


def topk_values_mask(m: np.ndarray, K: float = 0.7) -> np.ndarray:
    """Keep the top-K%% magnitude entries per row, zero the rest
    (reference: ties_merging.py:88-108)."""
    if K >= 1:
        K /= 100
    squeeze = m.ndim == 1
    if squeeze:
        m = m[None]
    n, d = m.shape
    k = d - int(d * K)  # index (1-based) of the k-th smallest |.|
    if k <= 0:
        out = m.copy()
    else:
        kth = np.partition(np.abs(m), k - 1, axis=1)[:, k - 1:k]
        out = np.where(np.abs(m) >= kth, m, 0.0)
    return out[0] if squeeze else out


def resolve_sign(mat: np.ndarray) -> np.ndarray:
    """Per-column elected sign; zero columns take the majority sign
    (reference: ties_merging.py:111-124)."""
    signs = np.sign(mat.sum(axis=0))
    majority = np.sign(signs.sum())
    return np.where(signs == 0, majority, signs)


def disjoint_merge(mat: np.ndarray, merge_func: str,
                   signs: np.ndarray) -> np.ndarray:
    """Aggregate only the entries agreeing with the elected sign
    (reference: ties_merging.py:127-155)."""
    merge_func = merge_func.split("-")[-1]
    keep = np.where(signs[None, :] > 0, mat > 0, mat < 0)
    selected = mat * keep
    if merge_func == "mean":
        counts = (selected != 0).sum(axis=0).astype(np.float32)
        return selected.sum(axis=0) / np.maximum(counts, 1.0)
    if merge_func == "sum":
        return selected.sum(axis=0)
    if merge_func == "max":
        return np.abs(selected).max(axis=0) * signs
    raise ValueError(f"Merge method {merge_func} is not defined.")


def ties_merge_vectors(flat_checks: np.ndarray, K: float = 20,
                       merge_func: str = "dis-mean") -> np.ndarray:
    trimmed = topk_values_mask(flat_checks, K=K)
    signs = resolve_sign(trimmed)
    return disjoint_merge(trimmed, merge_func, signs)


def do_merging(ft_checks: List[Dict[str, np.ndarray]], K: float = 20,
               merge_func: str = "dis-mean",
               lamda: float = 1.0) -> Dict[str, np.ndarray]:
    """Merge a list of flat state dicts with TIES (reference:
    ties_merging.py:178-221).  Inputs are LoRA deltas, so no pretrained-model
    vector is subtracted or re-added."""
    mat = np.stack([state_dict_to_vector(c) for c in ft_checks])
    merged = lamda * ties_merge_vectors(mat, K=K, merge_func=merge_func)
    return vector_to_state_dict(merged, ft_checks[0])


def convert_delta_to_ft(
    delta_weights: Dict[str, List[np.ndarray]],
) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """Split {key: [tensor per model]} into N aligned state dicts (shared
    keys) + uniques (keys appearing once) (reference: ties_merging.py:224-250)."""
    n = max((len(v) for v in delta_weights.values()), default=0)
    assert n > 0
    ft_checks: List[Dict[str, np.ndarray]] = [{} for _ in range(n)]
    uniques: Dict[str, np.ndarray] = {}
    for key, vals in delta_weights.items():
        if len(vals) == n:
            for i in range(n):
                ft_checks[i][key] = vals[i]
        else:
            assert len(vals) == 1, (key, len(vals))
            uniques[key] = vals[0]
    return ft_checks, uniques
