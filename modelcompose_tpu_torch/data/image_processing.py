"""Host-side CLIP image preprocessing (counterpart of
modelcompose_tpu/data/image_processing.py, whose module imports PIL and the
JAX CLIP tower; PIL is imported here only when an image is processed).

HF CLIPImageProcessor semantics for the openai CLIP checkpoints: resize
the shortest side (bicubic, long side truncated), center crop, rescale
1/255, normalize.  Output: [B, size, size, 3] float32 (NHWC).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipImageProcessor:
    def __init__(self, size: int = 336,
                 mean: Sequence[float] = CLIP_IMAGE_MEAN,
                 std: Sequence[float] = CLIP_IMAGE_STD):
        self.size = size
        self.image_mean = tuple(mean)
        self.image_std = tuple(std)

    def _resize_shortest(self, img):
        from PIL import Image
        w, h = img.size
        short, long = (w, h) if w <= h else (h, w)
        # HF truncates the long side: int(), not round()
        new_long = int(long * self.size / short)
        nw, nh = (self.size, new_long) if w <= h else (new_long, self.size)
        return img.resize((nw, nh), Image.BICUBIC)

    def _center_crop(self, img):
        w, h = img.size
        left = (w - self.size) // 2
        top = (h - self.size) // 2
        return img.crop((left, top, left + self.size, top + self.size))

    def __call__(self, images) -> np.ndarray:
        """A PIL image or an iterable of them -> [B, size, size, 3]."""
        if hasattr(images, "convert"):
            images = [images]
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        out = []
        for img in images:
            if img.mode != "RGB":
                img = img.convert("RGB")
            img = self._center_crop(self._resize_shortest(img))
            out.append((np.asarray(img, np.float32) / 255.0 - mean) / std)
        return np.stack(out)
