"""Frame formats that the JAX package reads through PIL, in the port's own
readers (``utils/image_io.py``): ``read_image`` equals
``np.asarray(PIL.Image.open(p))`` in dtype, shape and value, ``read_rgb``
equals ``np.asarray(Image.open(p).convert("RGB"), np.float32) / 255``, and
the port's ``data/provider.py:_load_image`` equals the JAX package's, bit
for bit, on files written here:

- progressive JPEG (Pillow's, libjpeg's simple progression: DC first and
  refinement scans, AC spectral selection with successive approximation,
  end-of-band runs) at 4:4:4, 4:2:2, 4:2:0 and gray, with and without
  restart intervals, at sizes that are not multiples of 16;
- 16-bit PNG of each colour type (gray stays uint16, I;16; gray + alpha
  comes out RGBA and RGB / RGBA keep the high byte, as PIL opens them);
- palette PNG (indices; ``read_rgb`` applies PLTE), with tRNS;
- Adam7-interlaced PNG of every type, put together here with zlib (every
  filter type in turn).

The progressive fixture that chip_smoke.py's phase 4i loads on the card
(tests/fixtures/progressive_room.jpg) decodes to the pixels whose sha256
its .json records, which are PIL's.  Out of scope and raising ValueError:
PNG at 1, 2 and 4 bits, and progressive files whose scans leave
coefficients unrefined (libjpeg then smooths the blocks).  (Arithmetic,
lossless, 12-bit and CMYK JPEG: tests/test_torch_jpeg.py.)
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import warnings
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_tpu.data.provider import _load_image as j_load_image
from mirres_restir_nerf_mesh_torch.data.provider import _load_image as t_load_image
from mirres_restir_nerf_mesh_torch.utils.image_io import read_image, read_rgb

from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}          # PNG colour type -> samples a pixel
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def picture(H, W, channels=3, seed=0):
    """Smooth structure plus noise, uint8 [H, W, channels]."""
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                       for c in range(channels)], -1)
    noise = np.random.RandomState(seed).randn(H, W, channels) * 20
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


def assert_same_as_pil(path):
    """read_image, read_rgb and _load_image against PIL and the reference."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # PIL on palette images with tRNS
        ref = np.asarray(Image.open(path))
        ref_rgb = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255
    got = read_image(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    got_rgb = read_rgb(path)
    assert got_rgb.dtype == ref_rgb.dtype
    np.testing.assert_array_equal(got_rgb, ref_rgb)
    got_l, ref_l = t_load_image(path), j_load_image(path)
    assert got_l.dtype == ref_l.dtype and got_l.shape == ref_l.shape
    np.testing.assert_array_equal(got_l, ref_l)


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("restart", [None, "blocks", "rows"])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_progressive_jpeg_reads_as_pil(tmp_path, sampling, restart):
    path = str(tmp_path / "p.jpg")
    kw = dict(progressive=True, quality=90)
    kw.update({None: {}, "blocks": {"restart_marker_blocks": 3},
               "rows": {"restart_marker_rows": 1}}[restart])
    for k, (H, W) in enumerate(((37, 53), (61, 45), (9, 23))):
        if sampling == "gray":
            Image.fromarray(picture(H, W, 1, k)[..., 0]).save(path, "JPEG", **kw)
        else:
            Image.fromarray(picture(H, W, 3, k)).save(
                path, "JPEG", subsampling={"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling], **kw)
        with open(path, "rb") as f:
            assert b"\xff\xc2" in f.read()
        assert_same_as_pil(path)


def test_progressive_fixture_is_pil_s(tmp_path):
    path = os.path.join(FIXTURES, "progressive_room.jpg")
    with open(os.path.join(FIXTURES, "progressive_room.json")) as f:
        meta = json.load(f)
    ref = np.asarray(Image.open(path))
    assert list(ref.shape) == meta["shape"] and str(ref.dtype) == meta["dtype"]
    assert hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest() == \
        meta["sha256_of_pil_pixels"]
    np.testing.assert_array_equal(read_image(path), ref)
    assert os.path.getsize(path) <= 200_000


def test_unrefined_progressive_jpeg_raises(tmp_path):
    """A progressive file cut after its first three scans (DC and the
    first AC bands at Al > 0): libjpeg would smooth its blocks."""
    full = str(tmp_path / "full.jpg")
    Image.fromarray(picture(40, 48)).save(full, "JPEG", progressive=True, quality=90)
    with open(full, "rb") as f:
        data = f.read()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    cut = str(tmp_path / "cut.jpg")
    with open(cut, "wb") as f:
        f.write(data[:sos[3]] + b"\xff\xd9")
    with pytest.raises(ValueError, match="unrefined.*cut.jpg"):
        read_image(cut)


# ------------------------------------------------------------------- PNG
def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered(img, bpp):
    """Rows of img [h, w, bpp] uint8, filter types 0-4 in turn."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out, prev = [], np.zeros(w * bpp, np.int64)
    for y in range(h):
        r = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = y % 5
        if kind == 0:
            e = r
        elif kind == 1:
            e = r - left
        elif kind == 2:
            e = r - prev
        elif kind == 3:
            e = r - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            e = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([kind]) + (e & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(path, samples, depth, ctype, interlace, plte=None, trns=None):
    """samples [H, W, C] (uint16 at 16 bits) -> a PNG put together here."""
    H, W, C = samples.shape
    bpp = C * depth // 8
    if depth == 16:
        img = samples.astype(">u2").view(np.uint8).reshape(H, W, bpp)
    else:
        img = samples.astype(np.uint8)
    if interlace:
        raw = b"".join(_filtered(img[y0::dy, x0::dx], bpp) for x0, y0, dx, dy in ADAM7
                       if x0 < W and y0 < H)
    else:
        raw = _filtered(img, bpp)
    body = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(body + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype,interlace", [
    (16, 0, 0), (16, 2, 0), (16, 4, 0), (16, 6, 0), (16, 0, 1), (16, 2, 1), (16, 4, 1), (16, 6, 1),
    (8, 3, 0), (8, 3, 1), (8, 0, 1), (8, 2, 1), (8, 4, 1), (8, 6, 1)])
def test_png_reads_as_pil(tmp_path, depth, ctype, interlace):
    rs = np.random.RandomState(depth * 10 + ctype + 100 * interlace)
    for H, W in ((13, 11), (1, 1), (3, 9), (17, 2), (9, 30)):
        C = SAMPLES[ctype]
        hi = 1 << 16 if depth == 16 else (40 if ctype == 3 else 256)
        samples = rs.randint(0, hi, (H, W, C))
        path = str(tmp_path / f"t{H}x{W}.png")
        # a palette of 40 entries; tRNS makes PIL keep the indices as P
        write_png(path, samples, depth, ctype, interlace,
                  plte=rs.randint(0, 256, 120).astype(np.uint8).tobytes() if ctype == 3 else None,
                  trns=b"\x00\x80" if ctype == 3 else None)
        assert_same_as_pil(path)


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (4, 3)])
def test_low_bit_png_raises(tmp_path, depth, ctype):
    path = str(tmp_path / "low.png")
    W, H = 8, 3
    raw = b"".join(b"\x00" + bytes(-(-W * depth // 8)) for _ in range(H))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
                + (_chunk(b"PLTE", bytes(48)) if ctype == 3 else b"")
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"{depth}-bit.*low.png"):
        read_image(path)
