"""Batch samplers: length-grouped and modality-grouped index orders (the
port's copy of modelcompose_tpu/train/sampler.py).

Numpy rebuild of the reference's sampler logic (reference:
modelcompose/train/llava_trainer.py:38-96): megabatches sorted by length and
split into per-replica chunks of roughly equal token mass; the modality
variant keeps multimodal and text-only samples in separate megabatches
(lengths are signed — negative = text-only, see
data/dataset.py modality_lengths).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lengths.index(min(chunk_lengths))
        chunks[shortest].append(index)
        chunk_lengths[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None
                               ) -> List[int]:
    rng = rng or np.random.default_rng(0)
    indices = rng.permutation(len(lengths))
    mega = world_size * batch_size
    megabatches = [indices[i:i + mega].tolist()
                   for i in range(0, len(lengths), mega)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
        lengths: Sequence[int], batch_size: int, world_size: int,
        rng: Optional[np.random.Generator] = None) -> List[int]:
    """reference: llava_trainer.py:60-86."""
    rng = rng or np.random.default_rng(0)
    assert all(l != 0 for l in lengths), "Should not have zero length."
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    if not mm or not lang:
        # The vendored reference ASSERTS both modality groups are
        # non-empty (llava_trainer.py:66-67); upstream LLaVA's fallback
        # passes the SIGNED lengths unchanged — do the same so all-text
        # batches sort/balance exactly as upstream, instead of crashing.
        return get_length_grouped_indices(
            list(lengths), batch_size, world_size, rng)
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)
    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, rng)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, rng)]
    mega = world_size * batch_size
    mm_megabatches = [mm_shuffle[i:i + mega]
                      for i in range(0, len(mm_shuffle), mega)]
    lang_megabatches = [lang_shuffle[i:i + mega]
                        for i in range(0, len(lang_shuffle), mega)]
    additional = mm_megabatches[-1] + lang_megabatches[-1]
    megabatches = mm_megabatches[:-1] + lang_megabatches[:-1]
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]
