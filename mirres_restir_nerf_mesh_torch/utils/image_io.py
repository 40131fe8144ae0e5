"""Image I/O (counterpart of mirres_restir_nerf_mesh_tpu/utils/image_io.py)
on numpy and the standard library alone: no PIL, no cv2.

- Radiance RGBE (``.hdr``): ``load_hdr`` reads flat and new-style RLE
  scanlines, ``save_hdr`` writes RLE (the run rules of the rgbe.c that
  OpenCV's codec uses, so the bytes match its writer's).
- PNG: ``read_png`` decodes 8- and 16-bit gray, gray + alpha, RGB, RGBA
  and 8-bit palette images, plain or Adam7-interlaced, all five filter
  types, into what ``np.asarray(PIL.Image.open(p))`` gives (16-bit gray
  as uint16, 16-bit colour as its high bytes, a palette as its indices);
  1-, 2- and 4-bit images raise ``ValueError``.  ``write_png`` writes 8-bit
  images, filter type 0, through ``zlib``.
- JPEG: ``read_jpeg`` decodes baseline and progressive (Huffman, 8-bit)
  files: gray or YCbCr at 4:4:4, 4:2:2 and 4:2:0, restart markers, by
  libjpeg's rules (the progressive scans' successive approximation as
  jdphuff.c reads it, the ``islow`` integer IDCT, "fancy" triangular
  chroma upsampling, its fixed-point colour conversion), so its pixels
  equal what PIL reads through libjpeg-turbo.  Arithmetic-coded,
  lossless, 12-bit and CMYK files, and progressive ones whose scans leave
  coefficients unrefined (libjpeg smooths those), raise ``ValueError``.
- ``write_jpeg`` / ``encode_jpeg``: the baseline JFIF stream libjpeg
  writes with its defaults for RGB (PIL's ``save(..., "JPEG")``): its
  fixed-point YCbCr, 4:2:0 by ``h2v2_downsample``, the ``islow`` forward
  DCT, the quality-scaled Annex K tables and the standard Huffman tables.
- ``resize_lanczos``: PIL's ``Image.resize(..., LANCZOS)`` on uint8
  images, byte for byte.
- ``read_image``: PNG or JPEG by the file's signature; ``read_rgb`` the
  same as float RGB, as PIL's ``convert("RGB")`` (a palette applied).
- EXR: the pure-numpy codec of ``utils/exr.py``.
"""

from __future__ import annotations

import functools
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
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples a pixel
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h filtered rows of 1 + stride bytes -> [h, stride] uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG as ``_read_png`` reads it, without the palette."""
    return _read_png(path)[0]


def _read_png(path: str):
    """-> (the samples, the palette [256, 3] uint8 or None).  The samples
    are a PNG as ``np.asarray(PIL.Image.open(path))`` gives it: gray [H, W]
    (uint16 at 16 bits, PIL's mode I;16), gray + alpha [H, W, 2], RGB and
    RGBA [H, W, C] uint8 (at 16 bits the high byte of each sample, as PIL's
    RGB and RGBA modes keep; 16-bit gray + alpha comes out RGBA, as PIL
    opens it), palette [H, W] uint8 indices (PLTE and tRNS not applied, as
    PIL's P mode); 8 or 16 bits, plain or Adam7-interlaced.  1-, 2- and
    4-bit samples raise ValueError."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_SIG):
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(buf):
        (size,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4: pos + 8]
        data = buf[pos + 8: pos + 8 + size]
        pos += 12 + size
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = np.zeros((256, 3), np.uint8)
            n = min(len(data) // 3, 256)
            plte[:n] = np.frombuffer(data[:3 * n], np.uint8).reshape(n, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype == 3 and plte is None:
        raise ValueError(f"corrupt PNG (palette image without PLTE): {path}")
    if ctype not in _CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8) \
            or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG ({depth}-bit samples, colour type {ctype}, "
                         f"interlace {interlace}): {path}")
    C = _CHANNELS[ctype]
    bpp = C * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        out = _unfilter(raw[:H * (W * bpp + 1)], H, W * bpp, bpp).reshape(H, W, bpp)
    else:
        out = np.empty((H, W, bpp), np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
            if w <= 0 or h <= 0:
                continue
            n = h * (w * bpp + 1)
            out[y0::dy, x0::dx] = _unfilter(raw[at:at + n], h, w * bpp, bpp).reshape(h, w, bpp)
            at += n
    if depth == 16:
        out = out.reshape(H, W, C, 2)
        if C == 1:
            out = out[..., 0].astype(np.uint16) << 8 | out[..., 1]
        else:
            out = out[..., 0]
            if C == 2:        # PIL reads 16-bit gray + alpha as RGBA
                out, C = out[..., [0, 0, 0, 1]], 4
    out = np.ascontiguousarray(out.reshape(H, W, C))
    return (out[..., 0] if C == 1 else out), (plte if ctype == 3 else None)


# ------------------------------------------------------------------ JPEG

# natural (row-major) index of the k-th coefficient in zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_SOF_UNSUPPORTED = {0xC3: "lossless", 0xC5: "differential sequential",
                    0xC6: "differential progressive", 0xC7: "differential lossless",
                    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
                    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
                    0xCE: "arithmetic-coded differential progressive",
                    0xCF: "arithmetic-coded differential lossless"}


def _huffman_codes(counts: bytes, symbols: bytes):
    """A 16-bit peek -> (code length, symbol) of one Huffman table as two
    int64 arrays; length 0 where no code starts with the peek's bits."""
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            lo = code << (16 - L)
            length[lo: lo + (1 << (16 - L))] = L
            sym[lo: lo + (1 << (16 - L))] = symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return length, sym


@functools.lru_cache(maxsize=8)
def _huffman_pairs(counts: bytes, symbols: bytes) -> list:
    """A 16-bit peek -> (code length, symbol) list (progressive scans;
    kept for the next files, read only)."""
    return list(zip(*(x.tolist() for x in _huffman_codes(counts, symbols))))


@functools.lru_cache(maxsize=8)
def _huffman_lookup(counts: bytes, symbols: bytes, ac: bool) -> list:
    """A 16-bit peek -> (n, run, value) list for one Huffman table (kept
    for the next files, which mostly carry the same tables; read only).

    n > 0: the code and its extra bits fit in the peek; consume n bits, the
    coefficient is ``value`` after ``run`` zeros (run -1: end of block).
    n < 0: a code of -n bits whose extra bits (``value`` of them) lie past
    the peek.  n == 0: no code starts with these bits."""
    length, sym = _huffman_codes(counts, symbols)
    peek = np.arange(1 << 16, dtype=np.int64)
    s = sym & 15 if ac else sym
    run = sym >> 4 if ac else np.zeros_like(sym)
    tot = length + s
    fits = (length > 0) & (tot <= 16)
    bits = (peek >> np.clip(16 - tot, 0, 16)) & ((1 << s) - 1)
    val = np.where((s > 0) & (bits < (1 << np.maximum(s - 1, 0))), bits - (1 << s) + 1, bits)
    n = np.where(fits, tot, -length)
    if ac:
        eob = (sym == 0) & (length > 0)
        run = np.where(eob & fits, -1, run)
        bad = (s == 0) & (run > 0) & (run < 15)        # EOBn: progressive only
        n = np.where(bad, 0, n)
    val = np.where(fits, val, s)
    return list(zip(n.tolist(), run.tolist(), val.tolist()))


def _extend(bits: int, s: int) -> int:
    return bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits


def _decode_segment(seg: bytes, blocks, comp_of, dc_tabs, ac_tabs, coef, path):
    """Entropy-decode one restart interval: ``blocks`` (flat block indices
    into ``coef``, 64 zigzag entries each) in scan order, ``comp_of`` their
    scan component; DC predictions start at 0."""
    data = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
    win = ((data[:-3] << 24) | (data[1:-2] << 16) | (data[2:-1] << 8) | data[3:]).tolist()
    p = 0
    pred = [0] * len(dc_tabs)
    for b, ci in zip(blocks, comp_of):
        base = b * 64
        n, _, v = dc_tabs[ci][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if n > 0:
            p += n
        elif n < 0:
            p -= n
            if v:
                bits = (win[p >> 3] >> (32 - (p & 7) - v)) & ((1 << v) - 1)
                p += v
                v = _extend(bits, v)
        else:
            raise ValueError(f"corrupt JPEG (bad DC code): {path}")
        pred[ci] += v
        coef[base] = pred[ci]
        act = ac_tabs[ci]
        k = 1
        while k < 64:
            n, r, v = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if n > 0:
                p += n
                if r < 0:
                    break
                k += r
            elif n < 0:
                p -= n
                k += r
                bits = (win[p >> 3] >> (32 - (p & 7) - v)) & ((1 << v) - 1)
                p += v
                v = _extend(bits, v)
            else:
                raise ValueError(f"corrupt JPEG (bad AC code): {path}")
            if k > 63:
                raise ValueError(f"corrupt JPEG (coefficient past 63): {path}")
            coef[base + k] = v
            k += 1
    if (p + 7) >> 3 > len(seg):
        raise ValueError(f"corrupt JPEG (entropy data ran out): {path}")


def _decode_progressive_segment(seg: bytes, blocks, comp_of, spectral, dc_tabs, ac_tabs, coef,
                                path):
    """Entropy-decode one restart interval of a progressive scan (libjpeg's
    jdphuff.c): ``spectral`` = (Ss, Se, Ah, Al); a DC scan (Ss = 0) first
    (Huffman-coded differences, shifted left by Al) or refining (one bit a
    block); an AC scan (one component) first (runs, end-of-band runs,
    coefficients shifted left by Al) or refining (a correction bit for each
    nonzero coefficient passed, new coefficients of +-2^Al); DC predictions
    and the end-of-band run start at 0."""
    data = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
    win = ((data[:-3] << 24) | (data[1:-2] << 16) | (data[2:-1] << 8) | data[3:]).tolist()
    ss, se, ah, al = spectral
    p = 0

    def huff(tab):
        nonlocal p
        n, sym = tab[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if n == 0:
            raise ValueError(f"corrupt JPEG (bad Huffman code): {path}")
        p += n
        return sym

    def bits(n):
        nonlocal p
        v = (win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)
        p += n
        return v

    if ss == 0 and ah == 0:                        # DC, first scan
        pred = [0] * len(dc_tabs)
        for b, ci in zip(blocks, comp_of):
            s = huff(dc_tabs[ci])
            pred[ci] += _extend(bits(s), s) if s else 0
            coef[b * 64] = pred[ci] << al
    elif ss == 0:                                  # DC, refinement
        for b in blocks:
            if bits(1):
                coef[b * 64] |= 1 << al
    elif ah == 0:                                  # AC, first scan
        tab, eobrun = ac_tabs[0], 0
        for b in blocks:
            if eobrun:
                eobrun -= 1
                continue
            base, k = b * 64, ss
            while k <= se:
                rs = huff(tab)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError(f"corrupt JPEG (coefficient past 63): {path}")
                    coef[base + k] = _extend(bits(s), s) << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + (bits(r) if r else 0) - 1
                    break
                k += 1
    else:                                          # AC, refinement
        tab, eobrun = ac_tabs[0], 0
        p1 = 1 << al
        m1 = -p1
        for b in blocks:
            base, k = b * 64, ss
            if eobrun == 0:
                while k <= se:
                    rs = huff(tab)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if bits(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + (bits(r) if r else 0)
                        break
                    while k <= se:                 # pass r zero coefficients
                        c = coef[base + k]
                        if c:
                            if bits(1) and not c & p1:
                                coef[base + k] = c + (p1 if c >= 0 else m1)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > 63:
                            raise ValueError(f"corrupt JPEG (coefficient past 63): {path}")
                        coef[base + k] = s
                    k += 1
            if eobrun:                             # the band's rest: correction bits only
                while k <= se:
                    c = coef[base + k]
                    if c and bits(1) and not c & p1:
                        coef[base + k] = c + (p1 if c >= 0 else m1)
                    k += 1
                eobrun -= 1
    if (p + 7) >> 3 > len(seg):
        raise ValueError(f"corrupt JPEG (entropy data ran out): {path}")


def _scan_segments(buf: bytes, pos: int):
    """The entropy-coded data from ``pos``: (unstuffed restart intervals,
    the position of the marker that ends the scan)."""
    arr = np.frombuffer(buf, np.uint8)
    ff = np.nonzero(arr[pos:-1] == 0xFF)[0] + pos
    nxt = arr[ff + 1]
    marks = ff[(nxt != 0) & (nxt != 0xFF)]
    rst = (arr[marks + 1] >= 0xD0) & (arr[marks + 1] <= 0xD7)
    end = int(marks[~rst][0]) if (~rst).any() else len(buf)
    cuts = [int(m) for m in marks[rst] if m < end]
    segs, start = [], pos
    for c in cuts + [end]:
        segs.append(buf[start:c].replace(b"\xff\x00", b"\xff"))
        start = c + 2
    return segs, end


def _idct_1d(x, shift):
    """libjpeg's jidctint.c (``islow``) butterfly along axis 1 of int64
    x [N, 8, ...]: the eight outputs DESCALEd by ``shift`` bits."""
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[:, 0] + x[:, 4]) << 13
    tmp1 = (x[:, 0] - x[:, 4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    r = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + r) >> shift for o in out], axis=1)


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N, 8, 8] (row = vertical frequency) ->
    uint8 samples [N, 8, 8], bit for bit as libjpeg's ``jpeg_idct_islow``
    (columns first with 2 extra bits, then rows; its range-limit table,
    which wraps what lies beyond [-512, 511])."""
    ws = _idct_1d(blocks.astype(np.int64), 13 - 2)
    out = _idct_1d(ws.transpose(0, 2, 1), 13 + 2 + 3).transpose(0, 2, 1)
    x = out & 1023
    table = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                            np.arange(0, 128)]).astype(np.uint8)
    return table[x]


def _fancy_h2(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v1 "fancy" upsampling along axis 1 of int c [H, w]:
    (3 nearer + 1 farther + 1 or 2) >> 2, the edge samples repeated."""
    pad = np.concatenate([c[:, :1], c, c[:, -1:]], axis=1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int64)
    out[:, 0::2] = (3 * c + pad[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * c + pad[:, 2:] + 2) >> 2
    return out


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 "fancy" upsampling of int c [h, w]: column sums
    3 nearer + 1 farther row, then (3 nearer + 1 farther + 8 or 7) >> 4
    across; rows and columns past the edges repeat the last real one."""
    rows = np.concatenate([c[:1], c, c[-1:]], axis=0)
    cs = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
    cs[0::2] = 3 * c + rows[:-2]
    cs[1::2] = 3 * c + rows[2:]
    pad = np.concatenate([cs[:, :1], cs, cs[:, -1:]], axis=1)
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int64)
    out[:, 0::2] = (3 * cs + pad[:, :-2] + 8) >> 4
    out[:, 1::2] = (3 * cs + pad[:, 2:] + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's jdcolor.c fixed-point YCbCr -> RGB (16 fraction bits)."""
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline or progressive JPEG as uint8 [H, W] (gray) or [H, W, 3]
    (RGB), decoded by libjpeg's rules (see the module docstring).  The
    entropy decode is a Python loop; the rest runs on whole arrays."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"\xff\xd8"):
        raise ValueError(f"not a JPEG file: {path}")
    qt, huff, frame, comps, progressive = {}, {}, None, [], False
    restart, adobe, jfif = 0, None, False
    coef = None
    pos = 2
    while pos < len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG (no marker at byte {pos}): {path}")
        while buf[pos] == 0xFF:
            pos += 1
        m = buf[pos]
        pos += 1
        if m == 0xD9:                                       # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        (size,) = struct.unpack_from(">H", buf, pos)
        seg = buf[pos + 2: pos + size]
        pos += size
        if m in _SOF_UNSUPPORTED:
            raise ValueError(f"unsupported JPEG ({_SOF_UNSUPPORTED[m]}): {path}")
        if m in (0xC0, 0xC1, 0xC2):                         # baseline / extended / progressive
            prec, Y, X, nf = struct.unpack_from(">BHHB", seg)
            if prec != 8:
                raise ValueError(f"unsupported JPEG ({prec}-bit samples): {path}")
            if Y == 0:
                raise ValueError(f"unsupported JPEG (height in a DNL marker): {path}")
            comps = [dict(id=seg[6 + 3 * i], h=seg[7 + 3 * i] >> 4, v=seg[7 + 3 * i] & 15,
                          tq=seg[8 + 3 * i], bits=[-1] * 64) for i in range(nf)]
            frame = (Y, X)
            progressive = m == 0xC2
        elif m == 0xC4:                                     # DHT
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                counts = bytes(seg[i + 1: i + 17])
                syms = bytes(seg[i + 17: i + 17 + sum(counts)])
                huff[(tc_th >> 4, tc_th & 15)] = (counts, syms)
                i += 17 + sum(counts)
        elif m == 0xDB:                                     # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(seg[i + 1: i + 1 + n], ">u2" if pq else np.uint8)
                nat = np.empty(64, np.int64)
                nat[_ZIGZAG] = q
                qt[tq] = nat
                i += 1 + n
        elif m == 0xDD:                                     # DRI
            (restart,) = struct.unpack_from(">H", seg)
        elif m == 0xE0 and seg.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:                                     # SOS
            if frame is None:
                raise ValueError(f"corrupt JPEG (scan before frame header): {path}")
            coef, pos = _decode_scan(buf, pos, seg, frame, comps, qt, huff, restart, coef,
                                     progressive, path)
    if coef is None:
        raise ValueError(f"JPEG without a scan: {path}")
    # libjpeg smooths the blocks of a progressive image whose first ten
    # coefficients are not all fully refined (jdcoefct.c smoothing_ok)
    if progressive and any(b != 0 for c in comps for b in c["bits"][:10]):
        raise ValueError(f"unsupported JPEG (progressive scans that leave coefficients "
                         f"unrefined): {path}")
    return _reconstruct(frame, comps, coef, adobe, jfif, path)


def _geometry(frame, comps):
    Y, X = frame
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mx, my = -(-X // (8 * hmax)), -(-Y // (8 * vmax))
    for c in comps:
        c["bw"], c["bh"] = mx * c["h"], my * c["v"]
        c["w"], c["hgt"] = -(-X * c["h"] // hmax), -(-Y * c["v"] // vmax)
    return hmax, vmax, mx, my


def _decode_scan(buf, pos, sos, frame, comps, qt, huff, restart, coef, progressive, path):
    """One scan (interleaved, or one component alone; sequential, or a
    progressive scan's band and bits) into the flat zigzag coefficient
    list; returns (coef, position after the scan)."""
    hmax, vmax, mx, my = _geometry(frame, comps)
    if coef is None:
        offs = np.cumsum([0] + [c["bw"] * c["bh"] for c in comps])
        for c, o in zip(comps, offs[:-1]):
            c["off"] = int(o)
        coef = [0] * (int(offs[-1]) * 64)
    ns = sos[0]
    by_id = {c["id"]: c for c in comps}
    sc = [by_id[sos[1 + 2 * i]] for i in range(ns)]
    tabs = [(sos[2 + 2 * i] >> 4, sos[2 + 2 * i] & 15) for i in range(ns)]
    ss, se, ahl = sos[1 + 2 * ns], sos[2 + 2 * ns], sos[3 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if not progressive and (ss, se, ahl) != (0, 63, 0):
        raise ValueError(f"corrupt JPEG (spectral selection in a sequential scan): {path}")
    if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0) or (ss and ns != 1)
                        or al > 13):
        raise ValueError(f"corrupt JPEG (progressive scan {ss}..{se}, {ah}/{al}): {path}")
    for c in sc:
        if "q" not in c:
            if c["tq"] not in qt:
                raise ValueError(f"corrupt JPEG (missing quantization table): {path}")
            c["q"] = qt[c["tq"]]
        c["bits"][ss:se + 1] = [al] * (se + 1 - ss)
    try:
        if not progressive:
            dc = [_huffman_lookup(*huff[(0, t[0])], False) for t in tabs]
            ac = [_huffman_lookup(*huff[(1, t[1])], True) for t in tabs]
        else:
            dc = [_huffman_pairs(*huff[(0, t[0])]) for t in tabs] if ss == 0 and ah == 0 else []
            ac = [_huffman_pairs(*huff[(1, t[1])]) for t in tabs] if ss else []
    except KeyError as e:
        raise ValueError(f"corrupt JPEG (missing Huffman table {e}): {path}") from None
    if ns == 1:                          # non-interleaved: the component's own block grid
        c = sc[0]
        nbx, nby = -(-c["w"] // 8), -(-c["hgt"] // 8)
        r, q = np.divmod(np.arange(nbx * nby), nbx)
        blocks = c["off"] + r * c["bw"] + q
        comp_of = np.zeros(blocks.shape, np.int64)
        per_mcu = 1
    else:
        mcu = [(i, v, h) for i, c in enumerate(sc) for v in range(c["v"]) for h in range(c["h"])]
        ci = np.array([t[0] for t in mcu])
        vv = np.array([t[1] for t in mcu])
        hh = np.array([t[2] for t in mcu])
        off = np.array([sc[i]["off"] for i in ci])
        bw = np.array([sc[i]["bw"] for i in ci])
        cv = np.array([sc[i]["v"] for i in ci])
        ch = np.array([sc[i]["h"] for i in ci])
        mr, mc = np.divmod(np.arange(mx * my), mx)
        blocks = (off + (mr[:, None] * cv + vv) * bw + mc[:, None] * ch + hh).reshape(-1)
        comp_of = np.broadcast_to(ci, (mx * my, len(mcu))).reshape(-1)
        per_mcu = len(mcu)
    segs, end = _scan_segments(buf, pos)
    step = restart * per_mcu if restart else len(blocks)
    if len(segs) != -(-len(blocks) // step):
        raise ValueError(f"corrupt JPEG ({len(segs)} restart intervals, "
                         f"{-(-len(blocks) // step)} expected): {path}")
    blocks, comp_of = blocks.tolist(), comp_of.tolist()
    for k, s in enumerate(segs):
        part = blocks[k * step:(k + 1) * step], comp_of[k * step:(k + 1) * step]
        if progressive:
            _decode_progressive_segment(s, *part, (ss, se, ah, al), dc, ac, coef, path)
        else:
            _decode_segment(s, *part, dc, ac, coef, path)
    return coef, end


def _reconstruct(frame, comps, coef, adobe, jfif, path):
    """Dequantize, IDCT, upsample the chroma and convert the colours."""
    Y, X = frame
    hmax, vmax, _, _ = _geometry(frame, comps)
    allc = np.asarray(coef, np.int64).reshape(-1, 64)
    planes = []
    for c in comps:
        if "q" not in c:
            raise ValueError(f"corrupt JPEG (component {c['id']} in no scan): {path}")
        z = allc[c["off"]: c["off"] + c["bw"] * c["bh"]]
        nat = np.empty_like(z)
        nat[:, _ZIGZAG] = z
        pix = _idct_islow((nat * c["q"]).reshape(-1, 8, 8))
        plane = pix.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)[: c["hgt"], : c["w"]].astype(np.int64)
        fh, fv = hmax // c["h"], vmax // c["v"]
        if hmax % c["h"] or vmax % c["v"] or (fh, fv) not in ((1, 1), (2, 1), (2, 2)):
            raise ValueError(f"unsupported JPEG chroma sampling {hmax}x{vmax} over "
                             f"{c['h']}x{c['v']}: {path}")
        if (fh, fv) != (1, 1):
            if c["w"] <= 2:                # libjpeg repeats samples at such widths
                plane = np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
            elif fv == 1:
                plane = _fancy_h2(plane)
            else:
                plane = _fancy_h2v2(plane)
        planes.append(plane[:Y, :X])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    if len(comps) != 3:
        raise ValueError(f"unsupported JPEG ({len(comps)} components): {path}")
    ids = tuple(c["id"] for c in comps)
    rgb = not jfif and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def read_image(path: str) -> np.ndarray:
    """A PNG or a JPEG, told apart by the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_PNG_SIG):
        return read_png(path)
    if head.startswith(b"\xff\xd8"):
        return read_jpeg(path)
    raise ValueError(f"neither a PNG nor a JPEG file: {path}")


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG as float32 RGB [H, W, 3] in [0, 1], as PIL's
    ``convert("RGB")``: gray repeated (16-bit gray clipped to 255), alpha
    dropped, a palette applied."""
    with open(path, "rb") as f:
        png = f.read(8) == _PNG_SIG
    if png:
        a, plte = _read_png(path)
        if plte is not None:
            a = plte[a]
    else:
        a = read_image(path)
    if a.dtype == np.uint16:
        a = np.minimum(a, 255)
    if a.ndim == 2:
        a = a[..., None]
    a = a[..., :3] if a.shape[-1] >= 3 else np.repeat(a[..., :1], 3, axis=-1)
    return a.astype(np.float32) / 255.0

# ------------------------------------------------------------------ JPEG encoder

# ITU T.81 Annex K: quantization tables in natural order, Huffman code
# counts (lengths 1..16) and symbols of the DC and AC tables (luma, chroma)
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32, np.int64))
_STD_HUFF = {   # (class 0 DC / 1 AC, table) -> (counts, symbols)
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
        "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
        "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}
# libjpeg's jfdctint.c constants (13-bit fixed point) and its jccolor.c scale
_FIX = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
            c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)
_CB, _PB = 13, 2            # CONST_BITS, PASS1_BITS


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One pass of libjpeg's jpeg_fdct_islow over axis 0 of d [8, ...] (int64)."""
    f = _FIX
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    sh = _CB - _PB if pass1 else _CB + _PB
    if pass1:
        out[0] = (tmp10 + tmp11) << _PB
        out[4] = (tmp10 - tmp11) << _PB
    else:
        out[0] = _descale(tmp10 + tmp11, _PB)
        out[4] = _descale(tmp10 - tmp11, _PB)
    z1 = (tmp12 + tmp13) * f["c0541"]
    out[2] = _descale(z1 + tmp13 * f["c0765"], sh)
    out[6] = _descale(z1 - tmp12 * f["c1847"], sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["c1175"]
    tmp4, tmp5 = tmp4 * f["c0298"], tmp5 * f["c2053"]
    tmp6, tmp7 = tmp6 * f["c3072"], tmp7 * f["c1501"]
    z1, z2 = z1 * -f["c0899"], z2 * -f["c2562"]
    z3, z4 = z3 * -f["c1961"] + z5, z4 * -f["c0390"] + z5
    out[7] = _descale(tmp4 + z1 + z3, sh)
    out[5] = _descale(tmp5 + z2 + z4, sh)
    out[3] = _descale(tmp6 + z2 + z3, sh)
    out[1] = _descale(tmp7 + z1 + z4, sh)
    return np.stack(out)


def _quantized_blocks(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """[h, w] samples (multiples of 8) -> [h/8, w/8, 64] quantized islow DCT
    coefficients in natural order (libjpeg's divisor 8q, halves rounded
    away from zero)."""
    h, w = plane.shape
    b = plane.astype(np.int64).reshape(h // 8, 8, w // 8, 8).transpose(1, 3, 0, 2) - 128
    rows = _fdct_1d(b.transpose(1, 0, 2, 3), True).transpose(1, 0, 2, 3)   # along x
    c = _fdct_1d(rows, False)                                              # along y
    c = c.transpose(2, 3, 0, 1).reshape(h // 8, w // 8, 64)
    q = qt * 8
    return np.sign(c) * ((np.abs(c) + q // 2) // q)


def _quant_tables(quality: int):
    """libjpeg's jpeg_set_quality: the Annex K tables scaled and clamped to
    1..255 (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT]


@functools.lru_cache(maxsize=None)
def _huff_codes(key):
    """(class, table) -> (code [256], length [256]) of the standard table."""
    counts, symbols = _STD_HUFF[key]
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            code[symbols[k]], size[symbols[k]] = c, L
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


def _bit_len(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    n = np.zeros_like(a)
    while True:
        nz = a > 0
        if not nz.any():
            return n
        n += nz
        a >>= 1


def _entropy_code(zz: np.ndarray, tab: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code blocks in scan order: zz [B, 64] zigzag coefficients,
    tab [B] their table (0 luma, 1 chroma), comp [B] their component (for
    the DC predictions) -> the entropy-coded segment, byte-stuffed and
    padded with ones."""
    B = zz.shape[0]
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    ev_blk, ev_seq, ev_val, ev_len = [], [], [], []

    def emit(blk, seq, key_tab, cls, sym, extra, nextra):
        for t in (0, 1):
            m = key_tab == t
            if not m.any():
                continue
            code, size = _huff_codes((cls, t))
            s = sym[m]
            ev_blk.append(blk[m])
            ev_seq.append(seq[m])
            ev_val.append((code[s] << nextra[m]) | extra[m])
            ev_len.append(size[s] + nextra[m])

    blocks = np.arange(B)
    s = _bit_len(diff)
    emit(blocks, np.zeros(B, np.int64), tab, 0, s, np.where(diff < 0, diff + (1 << s) - 1, diff), s)
    bi, kk = np.nonzero(zz[:, 1:])
    kk = kk + 1
    if bi.size:
        first = np.r_[True, bi[1:] != bi[:-1]]
        prev = np.where(first, 0, np.r_[0, kk[:-1]])
        run = kk - prev - 1
        v = zz[bi, kk]
        s = _bit_len(v)
        emit(bi, 2 * kk, tab[bi], 1, ((run & 15) << 4) | s, np.where(v < 0, v + (1 << s) - 1, v), s)
        nzrl = run >> 4
        if nzrl.any():
            zb = np.repeat(bi, nzrl)
            zs = np.repeat(2 * kk - 1, nzrl)
            zero = np.zeros_like(zb)
            emit(zb, zs, tab[zb], 1, np.full_like(zb, 0xF0), zero, zero)
        last = np.full(B, 0, np.int64)
        last[bi] = kk          # the largest k of each block (nonzero lists k ascending)
    else:
        last = np.zeros(B, np.int64)
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros_like(eob)
    emit(eob, np.full_like(eob, 200), tab[eob], 1, zero, zero, zero)

    blk, seq = np.concatenate(ev_blk), np.concatenate(ev_seq)
    order = np.lexsort((seq, blk))
    val, ln = np.concatenate(ev_val)[order], np.concatenate(ev_len)[order]
    total = int(ln.sum())
    pos = np.repeat(np.cumsum(ln) - ln, ln)
    j = np.arange(total) - pos                             # bit index within its event
    bits = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - j)) & 1
    pad = -total % 8
    bits = np.concatenate([bits.astype(np.uint8), np.ones(pad, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """uint8 RGB [H, W, 3] or gray [H, W] -> the baseline JFIF stream libjpeg
    writes with its defaults, as PIL's ``save(..., "JPEG", quality=q)``
    does: its fixed-point YCbCr, 4:2:0 with ``h2v2_downsample``'s
    alternating rounding bias, the islow forward DCT, the quality-scaled
    Annex K tables, the standard Huffman tables; edge samples replicated as
    libjpeg's preprocessor replicates them, and the dummy luma blocks past
    the image zero with the previous block's DC.  Gray: one component, the
    luma tables."""
    a = np.asarray(img)
    gray = a.ndim == 2
    if a.dtype != np.uint8 or not (gray or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3] or [H, W], got {a.dtype} {a.shape}")
    H, W = a.shape[:2]
    qt = _quant_tables(quality)
    if gray:
        gh, gw = -(-H // 8), -(-W // 8)
        g = np.pad(a.astype(np.int64), ((0, 8 * gh - H), (0, 8 * gw - W)), mode="edge")
        zz = _quantized_blocks(g, qt[0]).reshape(-1, 64)[:, _ZIGZAG]
        zeros = np.zeros(zz.shape[0], np.int64)
        data = _entropy_code(zz, zeros, zeros)
        qt, sof, sos = qt[:1], bytes([1, 0x11, 0]), bytes([1, 1, 0x00, 0, 63, 0])
    else:
        data = _entropy_code_ycc(a, qt)
        sof = bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
        sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(qt):
        out.append(_segment(0xDB, bytes([i]) + bytes(t[_ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, len(sof) // 3) + sof))
    for t in range(len(qt)):
        for cls in (0, 1):
            counts, symbols = _STD_HUFF[(cls, t)]
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + counts + symbols))
    out.append(_segment(0xDA, sos))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def _entropy_code_ycc(a: np.ndarray, qt) -> bytes:
    """The entropy-coded scan of an RGB image at 4:2:0 (see encode_jpeg)."""
    H, W = a.shape[:2]
    x = a.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half = 1 << 15
    fx = lambda c: int(c * 65536 + 0.5)  # noqa: E731  (jccolor.c FIX)
    y = (fx(0.299) * r + fx(0.587) * g + fx(0.114) * b + half) >> 16
    cb = (-fx(0.16874) * r - fx(0.33126) * g + fx(0.5) * b + (128 << 16) + half - 1) >> 16
    cr = (fx(0.5) * r - fx(0.41869) * g - fx(0.08131) * b + (128 << 16) + half - 1) >> 16

    mh, mw = -(-H // 16), -(-W // 16)              # MCUs
    yh, yw = -(-H // 8), -(-W // 8)                # real luma blocks
    yp = np.pad(y, ((0, 8 * yh - H), (0, 8 * yw - W)), mode="edge")
    # chroma: rows edge-padded to a pair and columns to the MCU width,
    # downsampled, then the last downsampled row repeated to the MCU height
    bias = np.tile([1, 2], 4 * mw)[None]
    chroma = []
    for c in (cb, cr):
        c = np.pad(c, ((0, H % 2), (0, 16 * mw - W)), mode="edge")
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + bias) >> 2
        chroma.append(np.pad(c, ((0, 8 * mh - c.shape[0]), (0, 0)), mode="edge"))

    yq = _quantized_blocks(yp, qt[0])
    yfull = np.zeros((2 * mh, 2 * mw, 64), np.int64)
    yfull[:yh, :yw] = yq
    if yw < 2 * mw:                                # dummy column: the DC of its left neighbour
        yfull[:yh, yw, 0] = yfull[:yh, yw - 1, 0]
    if yh < 2 * mh:                                # dummy row: the DC of the MCU's upper-right block
        yfull[yh, :, 0] = np.repeat(yfull[yh - 1, 1::2, 0], 2)
    cq = [_quantized_blocks(c, qt[1]) for c in chroma]

    yb = yfull.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh, mw, 4, 64)
    mcu = np.concatenate([yb, cq[0][:, :, None], cq[1][:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    return _entropy_code(mcu[:, _ZIGZAG], (comp > 0).astype(np.int64), comp)


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    """uint8 RGB [H, W, 3] or gray [H, W] -> a baseline JPEG file
    (``encode_jpeg``)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))


# ------------------------------------------------------------------ resampling

_PRECISION_BITS = 32 - 8 - 2          # Pillow's 8-bit resampling coefficients


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's 3-lobe Lanczos: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(t):
        pt = np.pi * t
        return np.where(t == 0.0, 1.0, np.sin(pt) / np.where(t == 0.0, 1.0, pt))
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for a box
    [0, in_size): (first input index [out], taps [out, K] int64) with the
    filter's support scaled by the reduction factor and each row's weights
    normalized, then rounded to 22-bit fixed point."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None]
    w = _lanczos((x + xmin[:, None] - center[:, None] + 0.5) / fscale)
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one)).astype(np.int64)
    return xmin, k


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Pillow 8-bit resampling pass along axis 0 or 1 of uint8 [H, W, C]."""
    n = a.shape[axis]
    xmin, k = _resample_coeffs(n, out_size)
    src = np.moveaxis(a.astype(np.int64), axis, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    kk = k.reshape(k.shape + (1,) * (src.ndim - 1))
    for j in range(k.shape[1]):
        acc += src[np.minimum(xmin + j, n - 1)] * kk[:, j]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [h, w(, C)]: Pillow's ``Image.resize((w,
    h), LANCZOS)``: the horizontal pass then the vertical, each clipped to
    uint8; an image with alpha (C = 2 or 4) resized premultiplied, as
    Pillow converts RGBA to RGBa and back."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"resize_lanczos takes uint8, got {a.dtype}")
    gray = a.ndim == 2
    a = a[..., None] if gray else a
    alpha = a.shape[-1] in (2, 4)
    if alpha:
        x = a.astype(np.int64)
        t = x[..., :-1] * x[..., -1:] + 128
        a = np.concatenate([((t >> 8) + t) >> 8, x[..., -1:]], axis=-1).astype(np.uint8)
    if (a.shape[1], a.shape[0]) != (w, h):
        if a.shape[1] != w:
            a = _resample_axis(a, w, 1)
        if a.shape[0] != h:
            a = _resample_axis(a, h, 0)
    if alpha:
        x = a.astype(np.int64)
        al = x[..., -1:]
        un = np.clip(255 * x[..., :-1] // np.maximum(al, 1), 0, 255)
        col = np.where((al == 255) | (al == 0), x[..., :-1], un)
        a = np.concatenate([col, al], axis=-1).astype(np.uint8)
    return a[..., 0] if gray else a


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
