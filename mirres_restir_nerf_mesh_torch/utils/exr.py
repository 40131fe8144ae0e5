"""Minimal OpenEXR codec in pure numpy (a copy of
mirres_restir_nerf_mesh_tpu/utils/exr.py; no OpenEXR/pyexr dependency).

Writes and reads uncompressed scanline EXR 2.0 files with FLOAT or HALF
channels — enough for the reference's eval artifact dumps
(`nerf/utils.py:1368-1377`: kd/ks/normal/env_map/diffuse/specular EXRs) and
for `albedo_eval.py` to read them back.  Format per the OpenEXR technical
spec: magic 20000630, version 2, attribute list, scanline offset table,
then per-scanline blocks of (y:int32, size:int32, channel-major row data
with channels in alphabetical order).
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_MAGIC = 20000630
_HALF, _FLOAT = 1, 2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def _channels_attr(names, pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\x00" + struct.pack("<iiii", pixel_type, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str, img: np.ndarray, channel_names=None, half: bool = False) -> None:
    """Write [H,W] or [H,W,C] float array as an uncompressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}.get(
            C, [f"channel{i}" for i in range(C)]
        )
    assert len(channel_names) == C
    dtype = np.float16 if half else np.float32
    ptype = _HALF if half else _FLOAT
    psize = 2 if half else 4

    header = b""
    header += _attr(b"channels", b"chlist", _channels_attr(channel_names, ptype))
    header += _attr(b"compression", b"compression", b"\x00")  # NO_COMPRESSION
    header += _attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")  # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    # channel-major rows, channels alphabetical
    order = np.argsort(np.array(channel_names))
    rows = np.ascontiguousarray(
        img[:, :, order].transpose(0, 2, 1).astype(dtype)
    )  # [H, C, W]
    row_bytes = C * W * psize
    block_bytes = 8 + row_bytes

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        table_start = f.tell()
        data_start = table_start + 8 * H
        offsets = data_start + block_bytes * np.arange(H, dtype=np.uint64)
        f.write(offsets.astype("<u8").tobytes())
        body = bytearray()
        for y in range(H):
            body += struct.pack("<ii", y, row_bytes)
            body += rows[y].tobytes()
        f.write(bytes(body))


def _read_null_str(buf: bytes, pos: int):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode(), end + 1


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline EXR written by write_exr (or compatible).
    Returns [H,W,C] float32 with channels ordered R,G,B[,A] when present,
    else alphabetically."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    assert magic == _MAGIC, f"not an EXR file: {path}"
    pos = 8
    channels: Dict[str, int] = {}
    data_window = None
    compression = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_null_str(buf, pos)
        typ, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cn, cp = _read_null_str(payload, cp)
                (ptype,) = struct.unpack_from("<i", payload, cp)
                cp += 16
                channels[cn] = ptype
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    assert compression == 0, "only uncompressed EXR supported"
    x0, y0, x1, y1 = data_window
    H, W = y1 - y0 + 1, x1 - x0 + 1
    names = sorted(channels)
    C = len(names)

    pos += 8 * H  # skip offset table
    out = np.empty((H, C, W), np.float32)
    for _ in range(H):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        cp = pos
        for ci, cn in enumerate(names):
            if channels[cn] == _HALF:
                row = np.frombuffer(buf, "<f2", W, cp).astype(np.float32)
                cp += 2 * W
            else:
                row = np.frombuffer(buf, "<f4", W, cp)
                cp += 4 * W
            out[y - y0, ci] = row
        pos += size
    out = out.transpose(0, 2, 1)  # [H,W,C]
    want = [n for n in ["R", "G", "B", "A"] if n in names]
    if len(want) == C:
        idx = [names.index(n) for n in want]
        out = out[:, :, idx]
    return np.ascontiguousarray(out)
