"""Static-shape multimodal token packing (counterpart of
modelcompose_tpu/core/packing.py).

The splice is planned on the host in numpy (``plan_pack``: where every text
token and every feature row lands in a fixed ``[B, L_bucket]`` buffer) and
assembled on the device in torch (``assemble_embeds``: one embedding
gather, one feature gather, a select).  The planning code is the JAX
package's, copied: that module imports ``jax.numpy`` at module level, so the
port cannot import it.  Layout semantics (they decide answer parity):

- modal placeholder tokens are consumed left to right, with each
  modality's instance counter shared across the whole batch in sample
  order;
- each placeholder expands to [prefix soft tokens | features | suffix soft
  tokens];
- labels over feature spans are IGNORE_INDEX;
- feature positions get their modality's route class where the feature's
  own mask is True, every other position the 'default' class;
- right padding to the bucket is segment 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ROUTE_CLASS_INDEX
from ..constants import IGNORE_INDEX, MODAL_TOKEN_INDEXES

_INDEX_TO_MODAL = {v: k for k, v in MODAL_TOKEN_INDEXES.items()}

# Power-of-two up to 2048, then 256-steps to 4096: multimodal prompts land
# in [2048, 4096] (a 4-modal MCUB prompt is ~3.3k positions) and coarse
# buckets there waste up to 2x the executed positions on padding — at the
# round-3 operating point the 3,287-position prompt padded to 4096 spent
# ~25% of its prefill FLOPs on padding; the 256-step ladder caps the waste
# at <8%.  Above 4096 (beyond the reference's own 2048-ctx training but
# reachable with multi-video prompts) 1024-steps to 8192 keep long prompts
# generating instead of raising (reference behavior: positions beyond the
# trained context simply run, modelcompose/data/multimodal_dataset.py:158
# truncates text only).
DEFAULT_BUCKETS = (512, 1024, 2048, 2304, 2560, 2816, 3072, 3328, 3584,
                   3840, 4096, 5120, 6144, 7168, 8192)

# Training keeps the coarse power-of-two set (train/train_multimodal
# .make_batch), as the JAX package does.
TRAIN_BUCKETS = (512, 1024, 2048, 4096, 8192)


def pick_bucket(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"sequence of length {length} exceeds the largest bucket "
        f"{buckets[-1]}; pass bucket_len explicitly or shorten the prompt")


@dataclasses.dataclass
class PackPlan:
    """Host-side packing plan; all arrays are numpy, shape [B, L] unless noted.

    token_ids:   vocabulary ids at text positions, 0 elsewhere.
    feat_idx:    row index into the flattened feature table at feature
                 positions, 0 elsewhere.
    is_feat:     True at feature positions.
    route_ids:   per-token route class (see config.ROUTE_CLASSES).
    labels:      CE targets, IGNORE_INDEX over features/padding.
    segment_ids: 1 for valid positions, 0 for right padding.
    lengths:     [B] spliced sequence lengths.
    feat_layout: [(modal, n_instances, span_len)] in table order — the
                 device-side flatten must follow this order.
    """
    token_ids: np.ndarray
    feat_idx: np.ndarray
    is_feat: np.ndarray
    route_ids: np.ndarray
    labels: np.ndarray
    segment_ids: np.ndarray
    lengths: np.ndarray
    feat_layout: List[Tuple[str, int, int]]


def plan_pack(
    input_ids: Sequence[np.ndarray],
    feat_spans: Dict[str, Tuple[int, int]],
    labels: Optional[Sequence[np.ndarray]] = None,
    feat_masks: Optional[Dict[str, np.ndarray]] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    bucket_len: Optional[int] = None,
) -> PackPlan:
    """Plan the static-shape splice for one batch.

    Args:
      input_ids: per-sample 1-D int arrays (unpadded), with negative modal
        placeholder ids.
      feat_spans: {modal: (n_instances, span_len)} — span_len includes any
        prefix/suffix soft tokens already concatenated onto the features.
      labels: per-sample 1-D arrays aligned with input_ids, or None.
      feat_masks: optional {modal: [n_instances, span_len] bool}; False
        positions are routed 'default' instead of the modality class
        (audio Q-former padding).
      buckets / bucket_len: pad target; bucket_len overrides bucket choice.

    Returns: PackPlan.
    """
    B = len(input_ids)
    # Flattened-feature-table layout: canonical dict order = the order the
    # caller concatenates features (must match assemble_embeds input order).
    feat_layout = [(m, n, t) for m, (n, t) in feat_spans.items()]
    offsets: Dict[str, int] = {}
    off = 0
    for m, n, t in feat_layout:
        offsets[m] = off
        off += n * t

    # Pass 1: spliced lengths.
    spliced: List[List[Tuple[str, np.ndarray]]] = []
    lengths = np.zeros(B, np.int64)
    inst_counter = {m: 0 for m in feat_spans}
    pieces_per_sample = []
    for b in range(B):
        ids = np.asarray(input_ids[b])
        lab = np.asarray(labels[b]) if labels is not None else None
        pieces = []  # list of ('text', ids, labels) | ('feat', modal, inst)
        cur = 0
        for pos in np.nonzero(ids < 0)[0]:
            modal = _INDEX_TO_MODAL.get(int(ids[pos]))
            if modal is None or modal not in feat_spans:
                raise ValueError(
                    f"modal token {int(ids[pos])} at sample {b} has no "
                    f"features (available: {sorted(feat_spans)})")
            if pos > cur:
                pieces.append(("text", ids[cur:pos],
                               lab[cur:pos] if lab is not None else None))
            pieces.append(("feat", modal, inst_counter[modal]))
            inst_counter[modal] += 1
            cur = pos + 1
        if cur < len(ids):
            pieces.append(("text", ids[cur:],
                           lab[cur:] if lab is not None else None))
        pieces_per_sample.append(pieces)
        total = sum(len(p[1]) if p[0] == "text" else feat_spans[p[1]][1]
                    for p in pieces)
        lengths[b] = total
    for m, (n, t) in feat_spans.items():
        if inst_counter[m] != n:
            raise ValueError(
                f"modality {m!r}: {n} feature instances provided but "
                f"{inst_counter[m]} placeholder tokens found in the batch")

    L = bucket_len if bucket_len is not None else pick_bucket(
        int(lengths.max()) if B else buckets[0], buckets)

    token_ids = np.zeros((B, L), np.int32)
    feat_idx = np.zeros((B, L), np.int32)
    is_feat = np.zeros((B, L), bool)
    route_ids = np.zeros((B, L), np.int32)
    out_labels = np.full((B, L), IGNORE_INDEX, np.int32)
    segment_ids = np.zeros((B, L), np.int32)

    for b in range(B):
        pos = 0
        for p in pieces_per_sample[b]:
            if p[0] == "text":
                _, ids, lab = p
                n = len(ids)
                token_ids[b, pos:pos + n] = ids
                if lab is not None:
                    out_labels[b, pos:pos + n] = lab
                pos += n
            else:
                _, modal, inst = p
                t = feat_spans[modal][1]
                feat_idx[b, pos:pos + t] = offsets[modal] + inst * t + np.arange(t)
                is_feat[b, pos:pos + t] = True
                cls = ROUTE_CLASS_INDEX.get(modal, 0)
                if feat_masks is not None and modal in feat_masks:
                    fm = np.asarray(feat_masks[modal][inst], bool)
                    route_ids[b, pos:pos + t] = np.where(fm, cls, 0)
                else:
                    route_ids[b, pos:pos + t] = cls
                pos += t
        segment_ids[b, :pos] = 1

    return PackPlan(token_ids=token_ids, feat_idx=feat_idx, is_feat=is_feat,
                    route_ids=route_ids, labels=out_labels,
                    segment_ids=segment_ids,
                    lengths=lengths.astype(np.int32),
                    feat_layout=feat_layout)


def assemble_embeds(embed_table: torch.Tensor, plan: PackPlan,
                    feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Device-side assembly: [B, L, H] packed input embeddings.

    embed_table: [V, H]; feats: {modal: [n_instances, span_len, H]}
    projected features with prefix/suffix attached, covering
    plan.feat_layout."""
    H = embed_table.shape[-1]
    device = embed_table.device

    def dev(a):
        return torch.as_tensor(a, device=device)

    tables = []
    for modal, n, t in plan.feat_layout:
        f = feats[modal]
        if tuple(f.shape[:2]) != (n, t):
            raise ValueError(f"{modal} features {tuple(f.shape)} != plan "
                             f"({n}, {t})")
        tables.append(f.reshape(n * t, H))
    text = embed_table[dev(plan.token_ids).long()]
    if tables:
        flat = torch.cat(tables, dim=0).to(embed_table.dtype)
        gathered = flat[dev(plan.feat_idx).long()]
        text = torch.where(dev(plan.is_feat)[..., None], gathered, text)
    # Zero right-padding, matching the reference's zeros-pad.
    valid = dev(plan.segment_ids != 0)[..., None]
    return torch.where(valid, text, torch.zeros_like(text))
