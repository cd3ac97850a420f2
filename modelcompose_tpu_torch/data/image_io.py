"""Image files to uint8 RGB arrays without PIL for PNG.

``load_image`` decodes PNG itself (``zlib`` + numpy), giving the pixels
``PIL.Image.open(f).convert("RGB")`` gives: grey is replicated, alpha and
``tRNS`` are dropped (not composited), a palette image goes through its
``PLTE``.  Non-interlaced 8-bit images of colour types 0 (L), 2 (RGB), 3
(P), 4 (LA) and 6 (RGBA) are read, and grey or palette images at 1, 2 or
4 bits.  An Adam7-interlaced or 16-bit PNG goes to PIL, as every other
format (JPEG, ...) does: PIL is imported when such a file is read.
Without PIL a PNG of those kinds raises ``ValueError`` naming its kind,
any other format ``ImportError`` naming the format.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _format_of(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def load_image(source: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A path or the file's bytes -> ``np.uint8 [H, W, 3]``."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    png_kind = _png_kind_for_pil(data)
    if data.startswith(PNG_SIGNATURE) and png_kind is None:
        return decode_png(data)
    fmt = _format_of(data)
    try:
        from PIL import Image
    except ImportError as e:
        if png_kind is not None:
            raise ValueError(f"{png_kind} PNG is read through PIL, which is "
                             "not installed") from e
        raise ImportError(
            f"reading a {fmt} image needs PIL, which is not installed "
            "(PNG files are read without it)") from e
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _png_kind_for_pil(data: bytes):
    """"Adam7-interlaced" or "16-bit" for a PNG the decoder leaves to PIL
    (read from its IHDR, the first chunk), else None."""
    if not data.startswith(PNG_SIGNATURE) or data[12:16] != b"IHDR" \
            or len(data) < 29:
        return None
    depth, interlace = data[24], data[28]
    if interlace:
        return "Adam7-interlaced"
    if depth == 16:
        return "16-bit"
    return None


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(raw: np.ndarray, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the five row filters -> [height, row_bytes] uint8.

    A byte depends on the one ``bpp`` to its left, the one above and the
    one above-left, so every filter unit on an anti-diagonal (unit index +
    row) is decoded at once: ``units + height - 1`` vectorised steps."""
    rows = raw.reshape(height, row_bytes + 1)
    filters = rows[:, 0].astype(np.int64)
    if filters.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(filters.max())}")
    units = row_bytes // bpp
    filt = rows[:, 1:].reshape(height, units, bpp).astype(np.int16)
    if not filters.any():
        return rows[:, 1:].copy()
    # decoded units, flat, with a zero row above and a zero unit to the left
    stride = units + 1
    out = np.zeros(((height + 1) * stride, bpp), np.int16)
    filt = filt.reshape(height * units, bpp)
    for t in range(units + height - 1):
        y = np.arange(max(0, t - units + 1), min(height, t + 1))
        i = (y + 1) * stride + (t - y) + 1
        a, b, c = out[i - 1], out[i - stride], out[i - stride - 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(filters[y][:, None], (0, a, b, (a + b) >> 1, paeth))
        out[i] = (filt[y * units + t - y] + pred) & 0xFF
    out = out.reshape(height + 1, stride, bpp)
    return out[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``np.uint8 [H, W, 3]`` as PIL's ``convert("RGB")``."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    if depth == 16:
        raise ValueError("16-bit PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    if depth != 8 and ctype not in (0, 3):
        raise ValueError(f"{depth}-bit PNG of colour type {ctype} is not "
                         "supported")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = _CHANNELS[ctype]
    row_bytes = (width * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = _unfilter(raw[:height * (row_bytes + 1)], height, row_bytes,
                     max(1, channels * depth // 8))
    if depth < 8:  # 1, 2 or 4 bits a sample, packed high bits first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        pix = samples.reshape(height, -1)[:, :width]
        if ctype == 0:  # grey scaled to 0..255 (PIL's "1", "L;2", "L;4")
            pix = pix * np.uint8(255 // ((1 << depth) - 1))
        pix = pix[:, :, None]
    else:
        pix = rows.reshape(height, width, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[pix[:, :, 0]]
    if channels in (1, 2):  # L, LA: grey replicated, alpha dropped
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])
