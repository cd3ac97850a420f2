"""The port's image path without PIL (``data/image_io``,
``data/image_processing``) against PIL and the JAX package.

``load_image`` must give ``PIL.Image.open(f).convert("RGB")``'s pixels bit
for bit on PNGs that PIL writes (L, LA, RGB, RGBA, P; 1- and 4-bit
palettes; ``optimize``) and on PNGs written row filter by row filter
(``chip_smoke.write_png``, the smoke's own writer), and the port's
``process_images(..., "pad")`` the JAX package's float32 arrays exactly
over a sweep of sizes and aspect ratios at 224 and 336.  Other formats go
through PIL; what the decoder does not read raises.
"""

import importlib
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from modelcompose_tpu_torch.data import image_io
from modelcompose_tpu_torch.data import image_processing as timage

jimage = importlib.import_module("modelcompose_tpu.data.image_processing")


def _photo(h, w, seed):
    """Gradients plus noise: PIL's adaptive encoder picks varied filters."""
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.default_rng(seed).integers(0, 48, (h, w, 3))
    return ((np.stack([xx * 3, yy * 5, xx + yy], -1) + noise) % 256
            ).astype(np.uint8)


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format=kw.pop("format", "PNG"), **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_pil_written_png_bit_for_bit(mode, optimize):
    img = Image.fromarray(_photo(57, 83, 1))
    if mode == "P":
        img = img.quantize(64)
    else:
        img = img.convert(mode)
    data = _pil_bytes(img, optimize=optimize)
    got = image_io.load_image(data)
    assert got.dtype == np.uint8 and got.shape == (57, 83, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_bit_palette_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    img = Image.fromarray(rng.integers(0, 2 ** bits, (19, 31),
                                       dtype=np.uint8), "P")
    img.putpalette(rng.integers(0, 256, 3 * 2 ** bits).tolist())
    data = _pil_bytes(img, bits=bits)
    assert data[24] == bits  # IHDR bit depth: PIL packed the indices
    np.testing.assert_array_equal(image_io.load_image(data), _pil_rgb(data))


def test_one_bit_grey_bit_for_bit():
    bw = np.random.default_rng(3).integers(0, 2, (21, 37)).astype(bool)
    data = _pil_bytes(Image.fromarray(bw))
    np.testing.assert_array_equal(image_io.load_image(data), _pil_rgb(data))


_LAYOUTS = {  # name -> (pixel shape, palette entries or 0, bit depth)
    "rgb": ((23, 29, 3), 0, 8), "rgba": ((23, 29, 4), 0, 8),
    "grey": ((23, 29), 0, 8), "grey_alpha": ((23, 29, 2), 0, 8),
    "grey4": ((23, 29), 0, 4), "grey2": ((23, 29), 0, 2),
    "palette": ((23, 29), 200, 8), "palette4": ((23, 29), 16, 4)}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "cycle"])
def test_every_row_filter(tmp_path, layout, filt):
    """Each of the five filters alone on every row, and all five in turn,
    in every layout the decoder reads (by path, as the entries read)."""
    shape, n_colours, depth = _LAYOUTS[layout]
    rng = np.random.default_rng(len(layout))
    top = n_colours or 2 ** depth
    pixels = rng.integers(0, top, shape, dtype=np.uint8)
    palette = (rng.integers(0, 256, (n_colours, 3), dtype=np.uint8)
               if n_colours else None)
    filters = chip_smoke.PNG_FILTERS if filt == "cycle" else (filt,)
    path = chip_smoke.write_png(str(tmp_path / "x.png"), pixels,
                                palette=palette, depth=depth,
                                filters=filters)
    with open(path, "rb") as f:
        want = _pil_rgb(f.read())
    np.testing.assert_array_equal(image_io.load_image(path), want)


def test_written_pixels_read_back_exactly(tmp_path):
    rgb = np.random.default_rng(5).integers(0, 256, (31, 17, 3),
                                            dtype=np.uint8)
    path = chip_smoke.write_png(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(image_io.load_image(path), rgb)
    grey = rgb[:, :, 0]
    path = chip_smoke.write_png(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(image_io.load_image(path),
                                  np.repeat(grey[:, :, None], 3, 2))


@settings(max_examples=30, deadline=None, database=None)
@given(w=st.integers(1, 700), h=st.integers(1, 700),
       size=st.sampled_from([224, 336]), seed=st.integers(0, 2 ** 16))
def test_process_images_pad_matches_jax(w, h, size, seed):
    """Upscale and downscale, square and long, padded then resized: the
    JAX package (PIL's resize) and the port (numpy) give equal floats."""
    arr = _photo(h, w, seed)
    got = timage.process_images([arr], timage.ClipImageProcessor(size),
                                "pad")
    want = jimage.process_images([Image.fromarray(arr)],
                                 jimage.ClipImageProcessor(size), "pad")
    assert got.dtype == np.float32 and got.shape == (1, size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((640, 480), (448, 336)),
                                     ((200, 150), (448, 336)),
                                     ((1000, 700), (480, 336)),
                                     ((336, 300), (376, 336)),
                                     ((37, 53), (336, 480))])
def test_resize_bicubic_equals_pillow(src, dst):
    arr = _photo(src[1], src[0], 9)
    want = np.asarray(Image.fromarray(arr).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(timage.resize_bicubic(arr, *dst), want)


def test_unpadded_processor_and_expand2square_match_jax():
    arr = _photo(40, 57, 2)
    np.testing.assert_array_equal(
        timage.ClipImageProcessor(28)(arr),
        jimage.ClipImageProcessor(28)(Image.fromarray(arr)))
    for shape in ((40, 57, 3), (57, 40, 3), (33, 33, 3)):
        a = _photo(*shape[:2], 4)
        np.testing.assert_array_equal(
            timage.expand2square(a, (122, 116, 104)),
            np.asarray(jimage.expand2square(Image.fromarray(a),
                                            (122, 116, 104))))


def test_jpeg_goes_through_pil_and_matches_jax(tmp_path):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_photo(61, 45, 7)).save(path, quality=85)
    got = image_io.load_image(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)
                                                  .convert("RGB")))
    np.testing.assert_array_equal(
        timage.process_images([got], timage.ClipImageProcessor(224), "pad"),
        jimage.process_images([Image.open(path).convert("RGB")],
                              jimage.ClipImageProcessor(224), "pad"))


def test_jpeg_without_pil_names_the_format(tmp_path, monkeypatch):
    data = _pil_bytes(Image.fromarray(_photo(8, 8, 0)), format="JPEG")
    png = _pil_bytes(Image.fromarray(_photo(8, 8, 0)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG"):
        image_io.load_image(data)
    assert image_io.load_image(png).shape == (8, 8, 3)  # no PIL needed


def _with_header(data, **fields):
    """``data`` with IHDR fields replaced (its CRC recomputed)."""
    keys = ("width", "height", "depth", "ctype", "compression", "filter",
            "interlace")
    values = dict(zip(keys, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[k] for k in keys))
    return (data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
            + data[33:])


def test_unsupported_pngs_raise_value_error(monkeypatch):
    """Adam7 and 16-bit PNGs go to PIL; without PIL they raise, naming the
    kind; a bad CRC raises whatever is installed."""
    rgb = _pil_bytes(Image.fromarray(_photo(9, 9, 0)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="Adam7"):
        image_io.load_image(_with_header(rgb, interlace=1))
    with pytest.raises(ValueError, match="16-bit"):
        image_io.load_image(_with_header(rgb, depth=16))
    monkeypatch.delitem(sys.modules, "PIL")
    with pytest.raises(ValueError, match="CRC"):
        image_io.load_image(rgb[:30] + bytes([rgb[30] ^ 1]) + rgb[31:])
    with pytest.raises(FileNotFoundError):
        image_io.load_image("no-such-image.png")


# ---------------------------------------------------------------------------
# 16-bit and Adam7 PNGs: PIL's pixels
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # x0, y0, dx, dy


def _png(pixels, ctype, depth, interlace=False):
    """A PNG of ``pixels`` [H, W, C] (uint8 or uint16), every row filter 0,
    Adam7-interlaced on request (the passes' sub-images in order)."""
    h, w = pixels.shape[:2]
    dtype = ">u2" if depth == 16 else np.uint8
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = pixels[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub.astype(dtype):
            raw += b"\x00" + row.tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
def test_sixteen_bit_png_is_pils(ctype, channels):
    """16-bit L, RGB and RGBA: the pixels PIL's ``convert("RGB")`` gives."""
    rng = np.random.default_rng(ctype)
    pixels = rng.integers(0, 65536, (13, 17, channels)).astype(np.uint16)
    data = _png(pixels, ctype, 16)
    got = image_io.load_image(data)
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
def test_adam7_png_is_pils(ctype, channels):
    """An Adam7-interlaced PNG the test builds (7 passes over 19 x 21
    pixels): PIL's pixels, which are the written ones."""
    pixels = _photo(19, 21, 3)[:, :, :1].repeat(channels, 2) \
        if channels != 3 else _photo(19, 21, 3)
    data = _png(pixels.astype(np.uint8), ctype, 8, interlace=True)
    got = image_io.load_image(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(got, np.repeat(pixels[:, :, :1], 3, 2)
                                  if channels != 3 else pixels)


# ---------------------------------------------------------------------------
# A PNG as a one-frame video clip without cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((48, 80), (224, 373)),
                                     ((480, 640), (224, 299)),
                                     ((333, 250), (298, 224)),
                                     ((224, 224), (224, 224)),
                                     ((7, 5), (13, 9))])
def test_numpy_bilinear_equals_cv2_inter_linear(src, dst):
    """``resize_bilinear`` against ``cv2.resize(..., INTER_LINEAR)`` on
    float32 frames, up and down: within float32 rounding (1e-6) of cv2's
    own arithmetic (``setUseOptimized(False)``), and within 5e-4 of its
    default path, whose IPP kernels use coefficients of their own (up to
    1.7e-4 apart on N(0, 1) frames)."""
    import cv2
    from modelcompose_tpu_torch.data import video_processing as tvideo
    frame = np.random.default_rng(sum(src)).normal(
        size=src + (3,)).astype(np.float32)
    got = tvideo.resize_bilinear(frame, *dst)
    default = cv2.resize(frame, dst[::-1], interpolation=cv2.INTER_LINEAR)
    cv2.setUseOptimized(False)
    try:
        plain = cv2.resize(frame, dst[::-1], interpolation=cv2.INTER_LINEAR)
    finally:
        cv2.setUseOptimized(True)
    assert got.dtype == np.float32 and got.shape == plain.shape
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, default, rtol=0, atol=5e-4)


def test_png_clip_without_cv2_or_pil(tmp_path, monkeypatch):
    """A ``.png`` video question: with ``cv2`` (and PIL) blocked, the frame
    is read by ``load_image`` and resized by the numpy bilinear, within
    1e-5 of the processor with ``cv2`` (its unoptimized arithmetic)."""
    import cv2
    from modelcompose_tpu_torch.data import video_processing as tvideo
    path = str(tmp_path / "frame.png")
    chip_smoke.write_png(path, _photo(120, 160, 5))
    proc = tvideo.LanguageBindVideoProcessor(num_frames=8, size=224)
    cv2.setUseOptimized(False)
    try:
        want = proc(path)
    finally:
        cv2.setUseOptimized(True)
    for name in ("cv2", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    got = proc(path)
    assert got.shape == want.shape == (1, 1, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ImportError):
        proc(str(tmp_path / "clip.mp4"))
