"""Mesh files on the host (counterpart of mirres_restir_nerf_mesh_tpu/export/meshio.py):
binary PLY write and read (binary or ASCII), OBJ + MTL write."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
              "int": "<i4", "uint": "<u4"}
_FACE = np.dtype([("n", "u1"), ("idx", "<i4", 3)])


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(tris)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    faces = np.empty((len(tris),), dtype=_FACE)
    faces["n"] = 3
    faces["idx"] = tris
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        f.write(faces.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (verts [V, 3] f32, tris [T, 3] i32) of a triangle PLY."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n_v = n_f = 0
    fmt, cur, v_props = "binary_little_endian", None, []
    for line in data[:end].decode(errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_v = int(parts[2])
            elif cur == "face":
                n_f = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            v_props.append((parts[2], parts[1]))
    if fmt == "ascii":
        body = data[end:].decode().split()
        stride = len(v_props)
        verts = np.array(body[: n_v * stride], np.float32).reshape(n_v, stride)[:, :3]
        tris, i = [], n_v * stride
        for _ in range(n_f):
            tris.append([int(x) for x in body[i + 1: i + 4]])
            i += int(body[i]) + 1
        return verts.astype(np.float32), np.array(tris, np.int32)
    v_dtype = np.dtype([(n, _PLY_TYPES[t]) for n, t in v_props])
    vbuf = np.frombuffer(data, dtype=v_dtype, count=n_v, offset=end)
    verts = np.stack([vbuf["x"], vbuf["y"], vbuf["z"]], axis=-1).astype(np.float32)
    fbuf = np.frombuffer(data, dtype=_FACE, count=n_f, offset=end + v_dtype.itemsize * n_v)
    if not (fbuf["n"] == 3).all():
        raise ValueError(f"{path}: only triangle PLY files are supported")
    return verts, fbuf["idx"].astype(np.int32)


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray, uvs: Optional[np.ndarray] = None,
              uv_tris: Optional[np.ndarray] = None, mtl_name: str = "defaultMat",
              feat0_png: Optional[str] = None, feat1_png: Optional[str] = None) -> None:
    """OBJ and its MTL, with the baked feature textures as map_Kd / map_Ks."""
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if uvs is not None:
            for uv in uvs:
                f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        f.write(f"usemtl {mtl_name}\n")
        for i, t in enumerate(tris):
            if uvs is not None and uv_tris is not None:
                ut = uv_tris[i]
                f.write(f"f {t[0]+1}/{ut[0]+1} {t[1]+1}/{ut[1]+1} {t[2]+1}/{ut[2]+1}\n")
            else:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
    with open(mtl_path, "w") as f:
        f.write(f"newmtl {mtl_name}\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n")
        if feat0_png:
            f.write(f"map_Kd {os.path.basename(feat0_png)}\n")
        if feat1_png:
            f.write(f"map_Ks {os.path.basename(feat1_png)}\n")
