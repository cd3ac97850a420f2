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


def test_unsupported_pngs_raise_value_error():
    rgb = _pil_bytes(Image.fromarray(_photo(9, 9, 0)))
    with pytest.raises(ValueError, match="Adam7"):
        image_io.load_image(_with_header(rgb, interlace=1))
    with pytest.raises(ValueError, match="16-bit"):
        image_io.load_image(_with_header(rgb, depth=16))
    with pytest.raises(ValueError, match="CRC"):
        image_io.load_image(rgb[:30] + bytes([rgb[30] ^ 1]) + rgb[31:])
    with pytest.raises(FileNotFoundError):
        image_io.load_image("no-such-image.png")
