"""Image I/O (counterpart of mirres_restir_nerf_mesh_tpu/utils/image_io.py)
on numpy and the standard library alone: no PIL, no cv2.

- Radiance RGBE (``.hdr``): ``load_hdr`` reads flat and new-style RLE
  scanlines, ``save_hdr`` writes RLE (the run rules of the rgbe.c that
  OpenCV's codec uses, so the bytes match its writer's).
- PNG: ``read_png`` decodes 8-bit gray, gray + alpha, RGB and RGBA,
  non-interlaced, all five filter types; ``write_png`` writes filter type 0
  through ``zlib``.
- EXR: the pure-numpy codec of ``utils/exr.py``.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

# ------------------------------------------------------------------ RGBE


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> [..., 3] float32: m * 2^(e - 136), 0 where e == 0."""
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where((e > 0)[..., None], rgb, np.float32(0.0)).astype(np.float32)


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float -> [..., 4] uint8 by the rgbe.c rule: v = max channel,
    scale = frexp(v).mantissa * 256 / v (in float32), bytes = trunc(c * scale),
    e = exponent + 128; zero below 1e-32.  Negative values are written as 0."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    v = rgb.max(axis=-1)
    mant, ex = np.frexp(v.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (mant * 256.0 / v.astype(np.float64)).astype(np.float32)
    live = v >= 1e-32
    scale = np.where(live, scale, np.float32(0.0))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.where(live[..., None], (rgb * scale[..., None]).astype(np.float32),
                            0.0).astype(np.uint8)
    out[..., 3] = np.where(live, ex + 128, 0).astype(np.uint8)
    return out


def _rle_runs(data: bytes) -> bytes:
    """One component of one scanline, RLE-coded (runs of >= 4 equal bytes,
    up to 127; literal spans up to 128)."""
    n = len(data)
    out = bytearray()
    cur = 0
    while cur < n:
        beg = cur
        run = old_run = 0
        while run < 4 and beg < n:
            beg += run
            old_run = run
            run = 1
            while beg + run < n and run < 127 and data[beg] == data[beg + run]:
                run += 1
        if old_run > 1 and old_run == beg - cur:
            out += bytes((128 + old_run, data[cur]))
            cur = beg
        while cur < beg:
            k = min(beg - cur, 128)
            out.append(k)
            out += data[cur: cur + k]
            cur += k
        if run >= 4:
            out += bytes((128 + run, data[beg]))
            cur += run
    return bytes(out)


def save_hdr(path: str, img: np.ndarray) -> None:
    """float [H, W, 3] -> Radiance .hdr, RLE scanlines (flat where the width
    is outside [8, 32767])."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    H, W = img.shape[:2]
    rgbe = _float_to_rgbe(img[..., :3])
    body = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode())
    if not 8 <= W <= 0x7FFF:
        body += rgbe.tobytes()
    else:
        for y in range(H):
            body += bytes((2, 2, W >> 8, W & 0xFF))
            for c in range(4):
                body += _rle_runs(rgbe[y, :, c].tobytes())
    with open(path, "wb") as f:
        f.write(bytes(body))


def _read_rgbe(buf: bytes) -> np.ndarray:
    """Radiance file bytes -> [H, W, 4] uint8."""
    pos = 0
    first = True
    while True:
        end = buf.index(b"\n", pos)
        line = buf[pos:end]
        pos = end + 1
        if first:
            if not line.startswith(b"#?"):
                raise ValueError("not a Radiance HDR file")
            first = False
            continue
        if line.startswith(b"FORMAT=") and line.strip() != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"unsupported HDR format {line!r}")
        if line.strip() == b"":
            break
    end = buf.index(b"\n", pos)
    m = re.fullmatch(rb"-Y (\d+) \+X (\d+)", buf[pos:end].strip())
    if m is None:
        raise ValueError(f"unsupported HDR orientation {buf[pos:end]!r}")
    H, W = int(m.group(1)), int(m.group(2))
    pos = end + 1
    data = np.frombuffer(buf, np.uint8, offset=pos)
    out = np.empty((H, W, 4), np.uint8)
    p = 0
    for y in range(H):
        rle = (8 <= W <= 0x7FFF and p + 4 <= data.size and data[p] == 2 and data[p + 1] == 2
               and not data[p + 2] & 0x80)
        if not rle:
            out[y] = data[p: p + 4 * W].reshape(W, 4)
            p += 4 * W
            continue
        if (int(data[p + 2]) << 8 | int(data[p + 3])) != W:
            raise ValueError("HDR scanline width mismatch")
        p += 4
        for c in range(4):
            x = 0
            while x < W:
                k = int(data[p])
                p += 1
                if k > 128:
                    k -= 128
                    out[y, x: x + k, c] = data[p]
                    p += 1
                else:
                    if k == 0 or x + k > W:
                        raise ValueError("bad HDR scanline data")
                    out[y, x: x + k, c] = data[p: p + k]
                    p += k
                x += k
    return out


def load_hdr(path: str) -> np.ndarray:
    """An HDR (.hdr) or EXR (.exr) image as float32 RGB [H, W, 3]."""
    if path.endswith(".exr"):
        from .exr import read_exr

        img = read_exr(path)[..., :3]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return np.asarray(img, np.float32)
    with open(path, "rb") as f:
        buf = f.read()
    return _rgbe_to_float(_read_rgbe(buf))


# ------------------------------------------------------------------ PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> channels (8-bit)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """uint8 [H, W] (gray), [H, W, 1|2|3|4] -> an 8-bit PNG, filter type 0."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    H, W, C = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), np.ascontiguousarray(a).reshape(H, W * C)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 1:      # Sub: a running sum along each channel
        return (np.cumsum(row.reshape(-1, bpp).astype(np.uint32), axis=0) & 0xFF).astype(
            np.uint8).reshape(-1)
    if kind == 2:      # Up
        return (row.astype(np.uint16) + prev).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"bad PNG filter type {kind}")
    cur = row.tolist()
    up = prev.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:          # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (gray, gray + alpha, RGB or RGBA) as uint8
    [H, W] (gray) or [H, W, C]."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_SIG):
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (size,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4: pos + 8]
        data = buf[pos + 8: pos + 8 + size]
        pos += 12 + size
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}): {path}")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, C)
    return out.reshape(H, W) if C == 1 else out.reshape(H, W, C)


# ------------------------------------------------------------------ float dumps


def save_exr(path: str, img: np.ndarray) -> None:
    """A float EXR through the pure-numpy codec."""
    from .exr import write_exr

    write_exr(path, np.asarray(img, np.float32))


def save_png(path: str, img: np.ndarray) -> None:
    """A float image in [0, 1] ([H, W] or [H, W, C]) as an 8-bit PNG
    (clip, x 255, truncate)."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_float(path: str, img: np.ndarray) -> None:
    """Float dump: .exr / .hdr by extension, .npy otherwise."""
    img = np.asarray(img, np.float32)
    if path.endswith(".exr"):
        save_exr(path, img)
    elif path.endswith(".hdr") and img.ndim == 3 and img.shape[-1] == 3:
        save_hdr(path, img)
    else:
        np.save(path if path.endswith(".npy") else path + ".npy", img)
