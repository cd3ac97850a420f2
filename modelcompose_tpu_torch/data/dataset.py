"""Multimodal dataset + collator (host side, torch-free; the port's copy of
modelcompose_tpu/data/dataset.py).

Rebuild of the reference's ``MultimodalDataset`` /
``DataCollatorForSupervisedDataset`` (reference: modelcompose/data/
multimodal_dataset.py:49-214): JSON list of
``{id, conversations, modal_inputs: {modal: [paths]}}``; media decode on
the host, corrupted-sample retry with random resample, modality-grouped
length hints, and a collator that batches per-modality raw inputs ready for
the towers.  Output tensors are numpy; the device-side packing happens in
models/model.py.
"""

from __future__ import annotations

import copy
import json
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX
from .image_io import load_image
from .image_processing import process_images
from .preprocess import preprocess


class MultimodalDataset:
    def __init__(self, data_path: str, tokenizer, data_args=None,
                 modal_processors: Optional[Dict[str, Any]] = None):
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.modal_processors = modal_processors or {}
        with open(data_path) as f:
            self.data = json.load(f)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def modality_lengths(self) -> List[int]:
        """Length heuristic for the modality-grouped sampler (reference:
        multimodal_dataset.py:72-88): text words + per-modality token
        inflation; text-only samples negative."""
        lengths = []
        for sample in self.data:
            cur = sum(len(c["value"].split())
                      for c in sample["conversations"])
            if len(sample.get("modal_inputs", {})) == 0:
                cur = -cur
            if "vision" in sample.get("modal_inputs", {}):
                cur += 256
            if "video" in sample.get("modal_inputs", {}):
                first = sample["modal_inputs"]["video"][0]
                cur += 257 if str(first).endswith(".jpg") else 257 * 8
            lengths.append(cur)
        return lengths

    @staticmethod
    def get_modal_inputs(modal_inputs: Dict[str, list]
                         ) -> Dict[str, list]:
        """Load media from paths (reference: :91-111).  Vision loads
        uint8 RGB arrays (``image_io.load_image``); audio/video/point keep
        paths for the collator's
        processors.  Static: self-free so standalone callers
        (eval/retrieval) can use it without a constructed dataset."""
        out = {}
        for modal, items in modal_inputs.items():
            if modal == "vision":
                out[modal] = [load_image(p) for p in items]
            else:
                out[modal] = list(items)
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        example = copy.deepcopy(self.data[index])
        sources = [example["conversations"]]
        try:
            modal_inputs = self.get_modal_inputs(
                example.get("modal_inputs", {}))
        except Exception:
            # corrupted-media retry with random resample (reference:
            # multimodal_dataset.py:114-120)
            new_index = random.randint(0, len(self.data) - 1)
            print(f"Corrupted: {index}, try {new_index}")
            return self[new_index]
        data_dict = preprocess(sources, self.tokenizer,
                               has_image=len(modal_inputs) != 0)
        return dict(input_ids=data_dict["input_ids"][0],
                    labels=data_dict["labels"][0],
                    modal_inputs=modal_inputs)


class ChunkedMultimodalDataset(MultimodalDataset):
    """File-level sharding for distributed eval (reference:
    eval/model_multimodal_qa_loader.py:25-46).

    Unlike the training dataset, media-load failures RAISE here: the eval
    loaders match answers to questions by index, so the training-time
    random-resample fallback would silently grade a random other sample's
    generation against this question's gold (the reference inherits the
    resample into eval unchanged — a footgun this rebuild does not keep).
    """

    def __init__(self, data_path, tokenizer, data_args=None,
                 modal_processors=None, num_chunks: int = 1,
                 chunk_idx: int = 0):
        super().__init__(data_path, tokenizer, data_args, modal_processors)
        self.data = get_chunk(self.data, num_chunks, chunk_idx)

    def __getitem__(self, index: int):
        example = copy.deepcopy(self.data[index])
        modal_inputs = self.get_modal_inputs(
            example.get("modal_inputs", {}))  # raises on corrupt media
        data_dict = preprocess([example["conversations"]], self.tokenizer,
                               has_image=len(modal_inputs) != 0)
        return dict(input_ids=data_dict["input_ids"][0],
                    labels=data_dict["labels"][0],
                    modal_inputs=modal_inputs)


def split_list(lst, n):
    """Ceil-chunking like the reference eval loaders, but padded with empty
    chunks so every chunk_idx < n is valid (ceil-chunking can otherwise
    yield fewer than n chunks, e.g. len 10 / n 8 -> 5 chunks, and a
    distributed launcher iterating all n indices would IndexError)."""
    import math
    chunk_size = math.ceil(len(lst) / n) if lst else 0
    chunks = ([lst[i:i + chunk_size]
               for i in range(0, len(lst), chunk_size)]
              if chunk_size else [])
    chunks += [[] for _ in range(n - len(chunks))]
    return chunks


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


class DataCollatorForSupervisedDataset:
    """Pad ids/labels, batch raw media per modality through each modality's
    processor (reference: multimodal_dataset.py:140-214)."""

    def __init__(self, tokenizer, modal_processors: Dict[str, Any],
                 modal_configs: Optional[Dict[str, dict]] = None):
        self.tokenizer = tokenizer
        self.modal_processors = modal_processors
        self.modal_configs = modal_configs or {}

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, Any]:
        input_ids = [np.asarray(i["input_ids"]) for i in instances]
        labels = [np.asarray(i["labels"]) for i in instances]
        max_len = getattr(self.tokenizer, "model_max_length", 1 << 30)
        input_ids = [ids[:max_len] for ids in input_ids]
        labels = [lab[:max_len] for lab in labels]

        batch: Dict[str, Any] = {"input_ids": input_ids, "labels": labels}
        modal_inputs = defaultdict(list)
        for inst in instances:
            for modal, items in inst.get("modal_inputs", {}).items():
                modal_inputs[modal].extend(items)
        if modal_inputs:
            batch["modal_inputs"] = self.process_modal_inputs(modal_inputs)
        return batch

    def process_modal_inputs(self, modal_inputs: Dict[str, list]
                             ) -> Dict[str, Any]:
        results: Dict[str, Any] = {}
        for modal, items in modal_inputs.items():
            proc = self.modal_processors[modal]
            if modal == "vision":
                cfg = self.modal_configs.get("vision", {})
                results[modal] = process_images(
                    items, proc,
                    image_aspect_ratio=cfg.get("image_aspect_ratio"))
            elif modal == "audio":
                from .audio_processing import collate_audio_inputs
                results[modal] = collate_audio_inputs(proc, items)
            elif modal == "video":
                clips = [np.asarray(proc(p) if isinstance(p, str) else p)
                         for p in items]
                # Mixed batches of single-frame "videos" (.jpg) and real
                # clips: tile 1-frame entries to the batch's max frame
                # count, mirroring the reference's expand-then-stack HACK
                # (reference: multimodal_dataset.py:203-210).
                T = max(c.shape[1] for c in clips)
                clips = [np.broadcast_to(c, c.shape[:1] + (T,) + c.shape[2:])
                         if c.shape[1] == 1 and T > 1 else c for c in clips]
                results[modal] = np.concatenate(clips, axis=0)
            elif modal == "point":
                results[modal] = proc(items)
            else:
                raise ValueError(f"unknown modality {modal!r}")
        return results


def pad_batch_ids(seqs: Sequence[np.ndarray], pad_value: int
                  ) -> np.ndarray:
    max_len = max(len(s) for s in seqs)
    out = np.full((len(seqs), max_len), pad_value, seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


_ = IGNORE_INDEX
