"""Host-side video preprocessing: uniform frame sampling + CLIP transform
(the port's copy of modelcompose_tpu/data/video_processing.py).

Rebuild of the reference's LanguageBind video processor (reference:
modelcompose/model/multimodal_encoder/languagebind/video/
processing_video.py:82-135): sample ``num_frames`` indices with
``np.linspace(0, duration-1, num_frames)``, decode via OpenCV, then
rescale 1/255, normalize with the OpenAI CLIP stats, short-side scale to
224 (bilinear) and center crop.  Eval path — the training-time random
horizontal flip is intentionally omitted (eval determinism).

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
    import cv2
    h, w = frame.shape[:2]
    if h <= w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)


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
        import cv2
        if str(path).endswith((".jpg", ".jpeg", ".png")):
            # single image as 1-frame video (reference:
            # processing_video.py:89-96)
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB"))
            return [img]
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
