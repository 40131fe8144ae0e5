"""Port vs reference: the image codecs of utils/image_io.py and utils/exr.py.

- PNG: the port's decoder reads PIL-written 8-bit gray, RGB and RGBA files
  (PIL's adaptive filtering uses all five filter types) equal to PIL's
  decode, and PIL decodes the port's writes equal to the array written;
  ``save_png`` writes the pixels of the JAX package's ``save_png``.
- Radiance RGBE: the port reads cv2-written files within 1 ulp of cv2's
  decode, cv2 reads the port's files within 1 ulp of the port's own
  decode, and the port's RLE bytes equal cv2's.  Flat (non-RLE)
  scanlines, as narrow images carry them, read back too.
- EXR: ``write_exr`` bytes equal to the JAX package's, read back equal.
"""

import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from mirres_restir_nerf_mesh_tpu.utils import exr as jexr
from mirres_restir_nerf_mesh_tpu.utils import image_io as jio
from mirres_restir_nerf_mesh_torch.utils import exr as texr
from mirres_restir_nerf_mesh_torch.utils import image_io as tio


def image(shape, seed):
    """Half noise, half smooth ramps (so PIL's adaptive filter picks several
    filter types)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, shape).astype(np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256).astype(np.uint8)
    half = shape[0] // 2
    a[:half] = ramp[:half] if a.ndim == 2 else ramp[:half, :, None]
    return a


def png_filter_types(path):
    """The filter byte of every row of an 8-bit PNG."""
    raw = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(raw):
        size = int.from_bytes(raw[pos: pos + 4], "big")
        kind = raw[pos + 4: pos + 8]
        if kind == b"IHDR":
            hdr = raw[pos + 8: pos + 8 + size]
        elif kind == b"IDAT":
            idat.append(raw[pos + 8: pos + 8 + size])
        pos += 12 + size
    W, H = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    C = {0: 1, 2: 3, 4: 2, 6: 4}[hdr[9]]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, W * C + 1)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("shape,mode", [((37, 53, 3), "RGB"), ((37, 53, 4), "RGBA"),
                                        ((37, 53), "L")])
def test_png_matches_pil(tmp_path, shape, mode):
    a = image(shape, seed=len(shape) + shape[-1])
    p = str(tmp_path / "pil.png")
    Image.fromarray(a, mode).save(p)
    got = tio.read_png(p)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(p)))
    q = str(tmp_path / "port.png")
    tio.write_png(q, a)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), a)
    np.testing.assert_array_equal(tio.read_png(q), a)


def test_png_reads_every_filter_type(tmp_path):
    """Across PIL's RGB and RGBA writes of the fixture, all five filter
    types occur, and the port decodes them all."""
    seen = set()
    for shape, mode in (((37, 53, 3), "RGB"), ((37, 53, 4), "RGBA"), ((64, 64, 3), "RGB")):
        a = image(shape, seed=shape[0])
        p = str(tmp_path / f"{mode}{shape[0]}.png")
        Image.fromarray(a, mode).save(p, optimize=True)
        seen |= png_filter_types(p)
        np.testing.assert_array_equal(tio.read_png(p), a)
    assert seen == {0, 1, 2, 3, 4}


def test_save_png_matches_reference(tmp_path):
    rng = np.random.RandomState(3)
    for shape in ((20, 30, 3), (20, 30)):
        x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
        jio.save_png(str(tmp_path / "j.png"), x)
        tio.save_png(str(tmp_path / "t.png"), x)
        np.testing.assert_array_equal(tio.read_png(str(tmp_path / "t.png")),
                                      np.asarray(Image.open(tmp_path / "j.png")))


def hdr_image(seed, H=20, W=40):
    rng = np.random.RandomState(seed)
    img = np.exp(rng.normal(size=(H, W, 3)) * 3).astype(np.float32)
    img[0, : W // 4] = 1.0      # runs for the RLE coder
    img[1] = 0.0
    img[2, 5:9] = [1e-35, 2.0, 3.0]
    return img


def within_ulp(a, b, n=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    assert np.abs(ia - ib).max() <= n


def cv2_read(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR),
                        cv2.COLOR_BGR2RGB)


def test_rgbe_matches_cv2(tmp_path):
    img = hdr_image(0)
    c = str(tmp_path / "cv2.hdr")
    cv2.imwrite(c, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    within_ulp(tio.load_hdr(c), cv2_read(c))
    p = str(tmp_path / "port.hdr")
    tio.save_hdr(p, img)
    within_ulp(cv2_read(p), tio.load_hdr(p))
    assert open(p, "rb").read() == open(c, "rb").read()
    # the quantization: truncation to an 8-bit mantissa shared by the pixel's
    # channels, below 2^-7 of the pixel's largest channel
    got = tio.load_hdr(p)
    assert (np.abs(got - img) <= img.max(axis=-1, keepdims=True) * 2 ** -7).all()
    assert (got <= img).all()


def test_rgbe_flat_scanlines(tmp_path):
    """Width 6 (< 8): scanlines are flat RGBE quadruples."""
    img = hdr_image(1, H=5, W=6)
    p = str(tmp_path / "narrow.hdr")
    tio.save_hdr(p, img)
    within_ulp(cv2_read(p), tio.load_hdr(p))
    c = str(tmp_path / "narrow_cv2.hdr")
    cv2.imwrite(c, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    within_ulp(tio.load_hdr(c), cv2_read(c))


@pytest.mark.parametrize("C", [1, 3, 4])
def test_exr_bytes_match_reference(tmp_path, C):
    rng = np.random.RandomState(C)
    img = rng.normal(size=(9, 14, C)).astype(np.float32)
    j, t = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(j, img)
    tio.save_exr(t, img)
    assert open(j, "rb").read() == open(t, "rb").read()
    np.testing.assert_array_equal(texr.read_exr(t), jexr.read_exr(j))
    np.testing.assert_array_equal(texr.read_exr(t), img)
    if C == 3:
        np.testing.assert_array_equal(tio.load_hdr(t), img)
