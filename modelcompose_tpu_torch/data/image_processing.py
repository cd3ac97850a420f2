"""Host-side CLIP image preprocessing on uint8 arrays (counterpart of
modelcompose_tpu/data/image_processing.py, which works on PIL images).

HF CLIPImageProcessor semantics for the openai CLIP checkpoints: resize
the shortest side (bicubic, long side truncated), center crop, rescale
1/255, normalize.  Input: ``np.uint8 [H, W, 3]`` arrays (``data.image_io.
load_image``), or PIL images, read through ``np.asarray``.  Output:
[B, size, size, 3] float32 (NHWC).

The resize is Pillow's 8-bit bicubic resample (``Image.resize(...,
BICUBIC)``, libImaging/Resample.c) in numpy, pixel for pixel: per output
pixel cubic weights (a = -0.5) over a support of 2 x max(scale, 1) input
pixels, normalised, rounded to 22-bit fixed point; a horizontal then a
vertical pass, each rounded and clipped to uint8.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _rgb(img) -> np.ndarray:
    """A uint8 [H, W, 3] array, or a PIL image converted to one."""
    if hasattr(img, "convert"):
        img = np.asarray(img if img.mode == "RGB" else img.convert("RGB"))
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 [H, W, 3] image, got "
                         f"{img.dtype} {img.shape}")
    return img


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``:
    (first input index [out], fixed-point weights [out, taps])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                    in_size)
    j = np.arange(taps)
    valid = j[None, :] < (hi - lo)[:, None]
    w = _bicubic(((j[None, :] + lo[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(valid, w, 0.0)
    total = np.zeros(out_size)
    for t in range(taps):  # summed in Pillow's order, tap by tap
        total += w[:, t]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
    return lo, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (1 = horizontal, 0 = vertical) of uint8
    [H, W, 3]: one index gather, one int64 einsum, Pillow's rounding."""
    in_size = img.shape[axis]
    lo, k = _coefficients(in_size, out_size)
    idx = np.minimum(lo[:, None] + np.arange(k.shape[1])[None, :],
                     in_size - 1)  # taps past the edge weigh 0
    # the resampled axis first (a view), its taps gathered beside it
    src = np.take(np.swapaxes(img, 0, axis), idx, axis=0)
    acc = np.einsum("otzc,ot->ozc", src, k)
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.swapaxes(out, 0, axis))


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BICUBIC)`` of a
    uint8 [H, W, 3] array, bit for bit; a pass whose size is unchanged is
    skipped, as Pillow skips it."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


class ClipImageProcessor:
    def __init__(self, size: int = 336,
                 mean: Sequence[float] = CLIP_IMAGE_MEAN,
                 std: Sequence[float] = CLIP_IMAGE_STD):
        self.size = size
        self.image_mean = tuple(mean)
        self.image_std = tuple(std)

    def _resize_shortest(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        short, long = (w, h) if w <= h else (h, w)
        # HF truncates the long side: int(), not round()
        new_long = int(long * self.size / short)
        nw, nh = (self.size, new_long) if w <= h else (new_long, self.size)
        return resize_bicubic(img, nw, nh)

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        left = (w - self.size) // 2
        top = (h - self.size) // 2
        return img[top:top + self.size, left:left + self.size]

    def __call__(self, images) -> np.ndarray:
        """An image or a list of them -> [B, size, size, 3]."""
        if hasattr(images, "convert") or (isinstance(images, np.ndarray)
                                          and images.ndim == 3):
            images = [images]
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        out = []
        for img in images:
            img = self._center_crop(self._resize_shortest(_rgb(img)))
            out.append((np.asarray(img, np.float32) / 255.0 - mean) / std)
        return np.stack(out)


def expand2square(img, background_color: Tuple[int, ...]) -> np.ndarray:
    """Pad an image to a square of ``background_color`` (the dataset image
    mean), centred on its short axis (reference: mm_utils.py:14-25)."""
    img = _rgb(img)
    h, w = img.shape[:2]
    if w == h:
        return img
    side = max(w, h)
    result = np.empty((side, side, 3), np.uint8)
    result[:] = np.asarray(background_color, np.uint8)
    top, left = ((side - h) // 2, 0) if w > h else (0, (side - w) // 2)
    result[top:top + h, left:left + w] = img
    return result


def process_images(images: Iterable, image_processor: ClipImageProcessor,
                   image_aspect_ratio: Optional[str] = None) -> np.ndarray:
    """Images -> [B, size, size, 3], padded to squares first with
    ``image_aspect_ratio='pad'`` (reference: mm_utils.py:28-40)."""
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in image_processor.image_mean)
        images = [expand2square(img, bg) for img in images]
    return image_processor(list(images))
