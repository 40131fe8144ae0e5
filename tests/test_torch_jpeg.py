"""The port's JPEG decoder (``utils/image_io.py:read_jpeg``) against PIL on
files PIL writes (libjpeg-turbo), and the JPEG path of ``_load_image``
against the reference's (PIL).

- Baseline files at quality 75 and 95, 4:4:4 / 4:2:2 / 4:2:0 and gray, at
  odd and even sizes, with and without a restart interval: pixels equal to
  PIL's (the decoder takes libjpeg's islow IDCT, "fancy" upsampling and
  fixed-point colour conversion).
- chip_smoke.py's own baseline encoder (the card run's images): its files
  decode equal to PIL's reading of them, within 1.1x the mean error of
  libjpeg's encoder at the same quality and sampling from the source.
- Lossless, 12-bit, CMYK and arithmetic-coded files raise ValueError naming
  the file and the format (progressive files: test_torch_image_formats.py).
- ``read_image`` tells PNG from JPEG by the signature.
- ``_load_image`` on JPEG frames equals the reference's at downscale 1 (gray
  frames become 3 channels) and lies within 1/255 at downscale 2 (PIL
  rounds its resized image to 8 bits).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from mirres_restir_nerf_mesh_tpu.data.provider import _load_image as j_load_image
from mirres_restir_nerf_mesh_torch.data.provider import _load_image as t_load_image
from mirres_restir_nerf_mesh_torch.utils.image_io import read_image, read_jpeg, write_png

from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def picture(h, w, gray=False, seed=0):
    """Smooth colour waves plus noise: sharp chroma edges and busy blocks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + k) * np.cos(yy / 4.0 - 2 * k) for k in range(3)], -1)
    a = np.clip(base * 110 + 128 + rng.normal(0, 18, base.shape), 0, 255).astype(np.uint8)
    a[h // 3: h // 2, w // 4: w // 2] = (250, 10, 30)          # a saturated patch
    return a[..., 0] if gray else a


CASES = [(q, sub, hw, rst) for q in (75, 95) for sub in ("4:4:4", "4:2:2", "4:2:0")
         for hw, rst in (((37, 53), 0), ((48, 64), 2))]
CASES += [(90, "4:2:0", (1, 1), 0), (90, "4:2:0", (3, 5), 1), (90, "4:2:2", (17, 3), 0),
          (85, "4:2:0", (101, 77), 7)]


@pytest.mark.parametrize("quality,sub,hw,restart", CASES)
def test_read_jpeg_equals_pil(tmp_path, quality, sub, hw, restart):
    path = str(tmp_path / "x.jpg")
    kw = dict(quality=quality, subsampling=SUBSAMPLING[sub])
    if restart:
        kw["restart_marker_blocks"] = restart
    Image.fromarray(picture(*hw)).save(path, **kw)
    got = read_jpeg(path)
    ref = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quality,hw,restart", [(75, (37, 53), 0), (95, (48, 64), 3)])
def test_read_jpeg_gray_equals_pil(tmp_path, quality, hw, restart):
    path = str(tmp_path / "g.jpg")
    kw = dict(quality=quality)
    if restart:
        kw["restart_marker_blocks"] = restart
    Image.fromarray(picture(*hw, gray=True)).save(path, **kw)
    got = read_jpeg(path)
    assert got.shape == hw
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("hw", [(24, 32), (37, 53)])
def test_chip_smoke_encoder_decodes_as_pil(tmp_path, hw):
    path = tmp_path / "c.jpg"
    src = picture(*hw, seed=3)
    chip_smoke.write_jpeg(path, src, quality=90)
    ref = np.asarray(Image.open(path))
    assert Image.open(path).info.get("jfif") is not None
    np.testing.assert_array_equal(read_jpeg(str(path)), ref)
    # as close to the source as libjpeg's own encoder at the same quality and sampling
    Image.fromarray(src).save(tmp_path / "pil.jpg", quality=90, subsampling=2)
    pil_err = np.abs(np.asarray(Image.open(tmp_path / "pil.jpg")).astype(np.int64) - src).mean()
    assert np.abs(ref.astype(np.int64) - src).mean() <= 1.1 * pil_err


def test_unsupported_jpeg_raise_naming_the_file(tmp_path):
    base = tmp_path / "base.jpg"
    Image.fromarray(picture(40, 48)).save(base, quality=90)
    data = bytes(base.read_bytes())
    sof = data.index(b"\xff\xc0")

    def variant(name, at, byte):
        d = bytearray(data)
        d[at] = byte
        (tmp_path / name).write_bytes(bytes(d))
        return str(tmp_path / name)

    # the same frame, arithmetic-coded; lossless; at 12-bit precision
    for name, at, byte, what in (("arith.jpg", sof + 1, 0xC9, "arithmetic"),
                                 ("lossless.jpg", sof + 1, 0xC3, "lossless"),
                                 ("twelve.jpg", sof + 4, 12, "12-bit")):
        with pytest.raises(ValueError, match=f"{what}.*{name}"):
            read_jpeg(variant(name, at, byte))
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(picture(40, 48)).convert("CMYK").save(cmyk, quality=90)
    with pytest.raises(ValueError, match="4 components.*cmyk.jpg"):
        read_jpeg(cmyk)


def test_read_image_dispatches_on_signature(tmp_path):
    a = picture(9, 11)
    write_png(str(tmp_path / "a.jpg"), a)            # a PNG, whatever its name says
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.jpg")), a)
    Image.fromarray(a).save(tmp_path / "b.png", format="JPEG", quality=90)
    np.testing.assert_array_equal(read_image(str(tmp_path / "b.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    (tmp_path / "c.jpg").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="c.jpg"):
        read_image(str(tmp_path / "c.jpg"))


@pytest.mark.parametrize("gray,downscale", [(False, 1), (True, 1), (False, 2), (True, 2)])
def test_load_image_jpeg_matches_reference(tmp_path, gray, downscale):
    path = str(tmp_path / "f.jpg")
    Image.fromarray(picture(37, 53, gray=gray, seed=5)).save(path, quality=92, subsampling=2)
    got, ref = t_load_image(path, downscale), j_load_image(path, downscale)
    assert got.shape == ref.shape == (37 // downscale, 53 // downscale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.0 if downscale == 1 else 1 / 255)
