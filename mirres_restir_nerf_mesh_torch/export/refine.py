"""Mesh refinement: error-driven subdivision + decimation (host-side numpy;
a copy of mirres_restir_nerf_mesh_tpu/export/refine.py on the port's
export/meshops.py).

Re-implements the reference's refine loop (`nerf/renderer.py:230-316
refine_and_decimate`, `meshutils.py:228-267 decimate_and_refine_mesh`,
per-face error accumulation `nerf/renderer.py:1376-1396
update_triangles_errors`): faces whose accumulated render error is high get
midpoint-subdivided (1->4) with welded edge midpoints; the mesh is then
optionally decimated back toward a face budget with QEM.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .meshops import decimate


def subdivide_faces(
    verts: np.ndarray, tris: np.ndarray, face_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint 1->4 subdivision of masked faces; edge midpoints welded so
    neighbors sharing a subdivided edge stay crack-free (T-junctions on the
    boundary to unsubdivided faces are split 1->2)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    V = verts.shape[0]

    midpoint: Dict[Tuple[int, int], int] = {}
    new_verts = [verts]
    next_id = V

    def get_mid(a: int, b: int) -> int:
        nonlocal next_id
        k = (a, b) if a < b else (b, a)
        if k in midpoint:
            return midpoint[k]
        midpoint[k] = next_id
        new_verts.append(((verts[a] + verts[b]) * 0.5)[None])
        next_id += 1
        return midpoint[k]

    out = []
    # first pass: create midpoints for all masked faces
    for f in np.nonzero(face_mask)[0]:
        a, b, c = tris[f]
        get_mid(a, b), get_mid(b, c), get_mid(c, a)

    def has_mid(a, b):
        k = (a, b) if a < b else (b, a)
        return midpoint.get(k)

    for f in range(tris.shape[0]):
        a, b, c = tris[f]
        if face_mask[f]:
            ab, bc, ca = get_mid(a, b), get_mid(b, c), get_mid(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        else:
            # neighbor-driven T-junction fix: split edges that got midpoints
            mids = [has_mid(a, b), has_mid(b, c), has_mid(c, a)]
            n_mid = sum(m is not None for m in mids)
            if n_mid == 0:
                out.append([a, b, c])
            else:
                # fan-split around existing midpoints (handles 1-3 mids)
                ring = []
                for (u, v), m in zip(((a, b), (b, c), (c, a)), mids):
                    ring.append(u)
                    if m is not None:
                        ring.append(m)
                # triangulate the ring as a fan from vertex 0
                for i in range(1, len(ring) - 1):
                    out.append([ring[0], ring[i], ring[i + 1]])

    return np.concatenate(new_verts).astype(np.float32), np.array(out, np.int32)


def refine_and_decimate(
    verts: np.ndarray,
    tris: np.ndarray,
    face_errors: np.ndarray,
    refine_quantile: float = 0.9,
    decimate_ratio: float = 0.1,
    min_edge_len: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivide the top (1-refine_quantile) error faces, then QEM-decimate
    by `decimate_ratio` of the resulting face count (reference semantics:
    refine where error is high, simplify elsewhere)."""
    errs = np.asarray(face_errors)
    if errs.max() <= 0:
        return np.asarray(verts, np.float32), np.asarray(tris, np.int32)
    thresh = np.quantile(errs[errs > 0], refine_quantile) if (errs > 0).any() else np.inf
    mask = errs >= thresh

    if min_edge_len > 0:
        # don't subdivide already-tiny faces
        v = np.asarray(verts)
        e = v[np.asarray(tris)]
        elen = np.linalg.norm(e[:, 0] - e[:, 1], axis=1)
        mask &= elen > min_edge_len

    v2, t2 = subdivide_faces(verts, tris, mask)
    if decimate_ratio > 0:
        target = int(t2.shape[0] * (1.0 - decimate_ratio))
        v2, t2 = decimate(v2, t2, target)
    return v2, t2
