"""Host-side video preprocessing: uniform frame sampling + CLIP transform
(the port's copy of modelcompose_tpu/data/video_processing.py).

Rebuild of the reference's LanguageBind video processor (reference:
modelcompose/model/multimodal_encoder/languagebind/video/
processing_video.py:82-135): sample ``num_frames`` indices with
``np.linspace(0, duration-1, num_frames)``, decode via OpenCV, then
rescale 1/255, normalize with the OpenAI CLIP stats, short-side scale to
224 (bilinear) and center crop.  Eval path — the training-time random
horizontal flip is intentionally omitted (eval determinism).  A still
image is a one-frame clip read by ``data/image_io.load_image`` (a PNG
without PIL); without ``cv2`` the resize is ``resize_bilinear``, a numpy
copy of cv2's ``INTER_LINEAR`` arithmetic (a video file still needs
``cv2``).

Output layout is [1, T, H, W, 3] float32 (NHWC frames — TPU conv layout),
vs the reference's [1, 3, T, H, W].
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def uniform_frame_indices(duration: int, num_frames: int) -> np.ndarray:
    """reference: processing_video.py:118 — linspace over the full clip."""
    return np.linspace(0, duration - 1, num_frames, dtype=int)


def _short_side_scale(frame: np.ndarray, size: int) -> np.ndarray:
    h, w = frame.shape[:2]
    if h <= w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    try:
        import cv2
    except ImportError:  # the numpy bilinear, cv2's arithmetic
        return resize_bilinear(frame, nh, nw)
    return cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)


def _linear_taps(n_out: int, n_in: int):
    """cv2's INTER_LINEAR taps along one axis: (first source index, second,
    their float32 weights), the source position (dst + 0.5) * scale - 0.5
    rounded to float32 and clamped at both borders."""
    scale = 1.0 / (n_out / n_in)  # cv2's 1 / inv_scale, in double
    pos = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo.astype(np.float32)
    clamp = (lo < 0) | (lo >= n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    frac[clamp] = 0
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, np.float32(1) - frac, frac


def resize_bilinear(frame: np.ndarray, height: int,
                    width: int) -> np.ndarray:
    """``cv2.resize(frame, (width, height), interpolation=INTER_LINEAR)``
    of a float32 [H, W, C] frame in numpy: the horizontal pass, then the
    vertical, each a two-tap float32 sum (no area averaging on a
    downscale, as cv2's linear mode has none)."""
    frame = np.asarray(frame, np.float32)
    x0, x1, ax0, ax1 = _linear_taps(width, frame.shape[1])
    y0, y1, ay0, ay1 = _linear_taps(height, frame.shape[0])
    rows = frame[:, x0] * ax0[None, :, None] + frame[:, x1] * ax1[None, :, None]
    return rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]


def _center_crop(frame: np.ndarray, size: int) -> np.ndarray:
    h, w = frame.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return frame[top:top + size, left:left + size]


class LanguageBindVideoProcessor:
    def __init__(self, num_frames: int = 8, size: int = 224):
        self.num_frames = num_frames
        self.size = size
        self.mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)
        self.std = np.asarray(OPENAI_DATASET_STD, np.float32)

    def _transform(self, frames: List[np.ndarray]) -> np.ndarray:
        out = []
        for f in frames:
            f = f.astype(np.float32) / 255.0
            f = (f - self.mean) / self.std
            f = _short_side_scale(f, self.size)
            f = _center_crop(f, self.size)
            out.append(f)
        return np.stack(out)  # [T, size, size, 3]

    def _decode(self, path: str) -> List[np.ndarray]:
        if str(path).endswith((".jpg", ".jpeg", ".png")):
            # single image as 1-frame video (reference:
            # processing_video.py:89-96); a PNG needs neither PIL nor cv2
            from .image_io import load_image
            return [load_image(path)]
        import cv2
        cap = cv2.VideoCapture(str(path))
        duration = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if duration <= 0:
            cap.release()
            raise ValueError(f"cannot decode video {path!r}")
        frames = []
        for idx in uniform_frame_indices(duration, self.num_frames):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = cap.read()
            if not ok:
                cap.release()
                raise ValueError(f"failed reading frame {idx} of {path!r}")
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        return frames

    def __call__(self, video: Union[str, np.ndarray, List]) -> np.ndarray:
        """path / [T, H, W, 3] uint8 array -> [1, T', size, size, 3]."""
        if isinstance(video, (list, tuple)):
            return np.concatenate([self(v) for v in video], axis=0)
        if isinstance(video, np.ndarray):
            duration = video.shape[0]
            idx = uniform_frame_indices(duration, self.num_frames) \
                if duration != self.num_frames else np.arange(duration)
            frames = [video[i] for i in idx]
        else:
            frames = self._decode(video)
        return self._transform(frames)[None]
