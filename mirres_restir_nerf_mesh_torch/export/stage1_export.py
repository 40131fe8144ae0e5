"""Stage-1 textured-mesh export: UV atlas + material texture bake + OBJ/MTL
(counterpart of mirres_restir_nerf_mesh_tpu/export/stage1_export.py).

The atlas (``chart_atlas``: normal-coherent charts, planar projection,
shelf packing; or ``grid_atlas``: two triangles a grid cell), the texel
raster and the margin inpainting stay numpy on the host, as in the JAX
package, so they are exact against it; the material field is queried on
the device in chunks of 262,144 texels.  feat0 = kd (sRGB-quantized),
feat1 = (occ, roughness, metallic), written through the port's PNG writer.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.image_io import write_png
from ..utils.math import linear_to_srgb
from .meshio import write_obj


def _phase(timer, name):
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def grid_atlas(n_tris: int, texture_size: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack each triangle into half of a square cell of a regular grid.

    Returns (uvs [2*n_tris*3? -> (T,3,2)], uv_tris [T,3], cells_per_side).
    Each cell holds two triangles (lower-left and upper-right halves) with a
    1-texel inset to avoid bleeding.
    """
    cells = int(np.ceil(np.sqrt(n_tris / 2.0)))
    cell_px = texture_size / cells
    inset = 1.0 / cell_px * 0.5

    uvs = np.zeros((n_tris, 3, 2), np.float32)
    for i in range(n_tris):
        cell = i // 2
        lower = i % 2 == 0
        cx = (cell % cells) / cells
        cy = (cell // cells) / cells
        s = 1.0 / cells
        if lower:
            corners = np.array(
                [[cx + inset * s, cy + inset * s],
                 [cx + s * (1 - 2 * inset), cy + inset * s],
                 [cx + inset * s, cy + s * (1 - 2 * inset)]]
            )
        else:
            corners = np.array(
                [[cx + s * (1 - inset), cy + s * (1 - inset)],
                 [cx + 2 * inset * s, cy + s * (1 - inset)],
                 [cx + s * (1 - inset), cy + 2 * inset * s]]
            )
        uvs[i] = corners
    uv_flat = uvs.reshape(-1, 2)
    uv_tris = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    return uv_flat, uv_tris, cells


def chart_atlas(
    verts: np.ndarray,
    tris: np.ndarray,
    texture_size: int,
    cone: float = 0.7,
    max_chart_faces: int = 20000,
    gutter_px: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Chart-based UV unwrap (xatlas-quality packing without the xatlas dep).

    Mirrors the reference's xatlas usage with chart merging disabled
    (renderer.py:334-342, max_iterations=0 -> simple projected charts):
      1. segment faces into normal-coherent connected charts by region
         growing (face joins while dot(face_n, seed_n) > cone, which keeps
         the chart a height field along the seed normal -> fold-free planar
         projection);
      2. project each chart onto the seed normal's tangent plane;
      3. shelf-pack chart rectangles at uniform world->texel density (binary
         search on the global scale), with a gutter against bleeding.

    Returns the same contract as grid_atlas: (uv_flat [F*3,2], uv_tris [F,3],
    n_charts).  Texel utilization is chart-area-bound instead of the grid
    atlas's 2-triangles-per-cell waste.
    """
    F = tris.shape[0]
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    area2 = np.linalg.norm(fn, axis=1)
    fn = fn / np.maximum(area2[:, None], 1e-20)

    # face adjacency via shared (sorted) edges
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    face_of_edge = np.tile(np.arange(F), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    es, fs = edges[order], face_of_edge[order]
    same = (es[1:] == es[:-1]).all(axis=1)
    pa, pb = fs[:-1][same], fs[1:][same]
    adj = [[] for _ in range(F)]
    for a, b in zip(pa, pb):
        adj[a].append(b)
        adj[b].append(a)

    # region growing, largest faces first
    assigned = np.full(F, -1, np.int64)
    charts = []
    for seed in np.argsort(-area2):
        if assigned[seed] >= 0:
            continue
        cid = len(charts)
        seed_n = fn[seed]
        stack = [int(seed)]
        assigned[seed] = cid
        members = []
        while stack and len(members) < max_chart_faces:
            f = stack.pop()
            members.append(f)
            for g in adj[f]:
                if assigned[g] < 0 and float(fn[g] @ seed_n) > cone:
                    assigned[g] = cid
                    stack.append(g)
        # faces still on the stack when the cap hits were claimed but never
        # placed — release them so a later seed charts them
        for f in stack:
            assigned[f] = -1
        charts.append((members, seed_n))

    # per-chart planar projection
    chart_uv = []   # per chart: (uv [m,3,2] in world units, w, h)
    for members, n in charts:
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        t1 = np.cross(n, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        tri_v = verts[tris[members]]                       # [m,3,3]
        uv = np.stack([tri_v @ t1, tri_v @ t2], axis=-1)   # [m,3,2]
        lo = uv.reshape(-1, 2).min(axis=0)
        uv = uv - lo
        hi = uv.reshape(-1, 2).max(axis=0)
        chart_uv.append((uv, float(hi[0]), float(hi[1])))

    # shelf packing at global scale s (texels per world unit), binary search
    T = texture_size
    gut = gutter_px / T

    def try_pack(s):
        rects = sorted(
            range(len(chart_uv)), key=lambda i: -(chart_uv[i][2] * s)
        )
        pos = [None] * len(chart_uv)
        x = y = shelf_h = 0.0
        for i in rects:
            w = chart_uv[i][1] * s + gut
            h = chart_uv[i][2] * s + gut
            if w > 1.0 or h > 1.0:
                return None
            if x + w > 1.0:
                y += shelf_h
                x = 0.0
                shelf_h = 0.0
            if y + h > 1.0:
                return None
            pos[i] = (x, y)
            x += w
            shelf_h = max(shelf_h, h)
        return pos

    total_area = sum(w * h for _, w, h in chart_uv)
    hi = 1.2 / max(np.sqrt(total_area), 1e-12)
    lo = hi * 1e-3
    pos = try_pack(lo)
    if pos is None:
        raise RuntimeError("chart packing failed")
    for _ in range(24):  # bisect the largest feasible uniform density
        mid = 0.5 * (lo + hi)
        p = try_pack(mid)
        if p is not None:
            lo, pos = mid, p
        else:
            hi = mid
    s = lo

    uvs = np.zeros((F, 3, 2), np.float32)
    for ci, ((uv, w, h), (members, _)) in enumerate(zip(chart_uv, charts)):
        ox, oy = pos[ci]
        uvs[np.asarray(members, np.int64)] = uv * s + np.array([ox, oy]) + gut * 0.5
    uv_flat = uvs.reshape(-1, 2)
    uv_tris = np.arange(F * 3, dtype=np.int32).reshape(-1, 3)
    return uv_flat, uv_tris, len(charts)


def knn_inpaint(feat: np.ndarray, covered: np.ndarray, pad: int = 32) -> np.ndarray:
    """Nearest-covered-texel inpainting of the atlas margins (reference
    renderer.py:400-417: dilate the coverage mask, 1-NN fill from the mask
    boundary ring)."""
    from scipy.ndimage import binary_dilation, binary_erosion
    from scipy.spatial import cKDTree

    mask = covered.astype(bool)
    if mask.all() or not mask.any():
        return feat
    inpaint_region = binary_dilation(mask, iterations=pad)
    inpaint_region[mask] = False
    search_region = mask.copy()
    interior = binary_erosion(search_region, iterations=3)
    search_region[interior] = False
    if not search_region.any():
        search_region = mask
    sc = np.stack(np.nonzero(search_region), axis=-1)
    ic = np.stack(np.nonzero(inpaint_region), axis=-1)
    if len(ic) == 0:
        return feat
    _, idx = cKDTree(sc).query(ic, k=1)
    out = feat.copy()
    out[tuple(ic.T)] = feat[tuple(sc[idx].T)]
    return out


def bake_textures(
    verts: np.ndarray,
    tris: np.ndarray,
    uv_flat: np.ndarray,
    material_fn: Callable[[torch.Tensor], torch.Tensor],
    texture_size: int,
    chunk: int = 262144,
    device="cuda",
    timer=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize the atlas on the host (texel centres inside each UV triangle,
    with a small barycentric overfill), query the material field at the
    interpolated world positions on ``device``, inpaint the margins."""
    dev = resolve_device(device)
    T = texture_size
    feat = np.zeros((T, T, 6), np.float32)
    weight = np.zeros((T, T), np.float32)

    tri_uv = uv_flat.reshape(-1, 3, 2)
    n_tris = tris.shape[0]

    all_pos = []
    all_px = []
    with _phase(timer, "raster"):
        for i in range(n_tris):
            uv = tri_uv[i] * T  # pixel coords
            lo = np.floor(uv.min(axis=0)).astype(int)
            hi = np.ceil(uv.max(axis=0)).astype(int)
            xs = np.arange(max(lo[0], 0), min(hi[0] + 1, T))
            ys = np.arange(max(lo[1], 0), min(hi[1] + 1, T))
            if len(xs) == 0 or len(ys) == 0:
                continue
            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            p = np.stack([gx.reshape(-1) + 0.5, gy.reshape(-1) + 0.5], axis=-1)
            # barycentric wrt uv triangle
            a, b, c = uv[0], uv[1], uv[2]
            den = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
            if abs(den) < 1e-12:
                continue
            w0 = ((b[1] - c[1]) * (p[:, 0] - c[0]) + (c[0] - b[0]) * (p[:, 1] - c[1])) / den
            w1 = ((c[1] - a[1]) * (p[:, 0] - c[0]) + (a[0] - c[0]) * (p[:, 1] - c[1])) / den
            w2 = 1.0 - w0 - w1
            eps = -0.2  # slight margin overfill for dilation
            ok = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
            if not ok.any():
                continue
            w = np.stack([w0[ok], w1[ok], w2[ok]], axis=-1)
            wclip = np.clip(w, 0.0, 1.0)
            wclip /= wclip.sum(axis=1, keepdims=True)
            v3 = verts[tris[i]]
            pos = wclip @ v3
            all_pos.append(pos)
            all_px.append(p[ok].astype(int))

    if all_pos:
        with _phase(timer, "material"):
            pos = np.concatenate(all_pos)
            px = np.concatenate(all_px)
            mats = np.empty((pos.shape[0], 6), np.float32)
            with torch.no_grad():
                for s in range(0, pos.shape[0], chunk):
                    x = torch.as_tensor(np.ascontiguousarray(pos[s: s + chunk], np.float32),
                                        device=dev)
                    mats[s: s + chunk] = material_fn(x).float().cpu().numpy()
            feat[px[:, 0], px[:, 1]] = mats
            weight[px[:, 0], px[:, 1]] = 1.0

    with _phase(timer, "inpaint"):
        feat = knn_inpaint(feat, weight > 0)

    kd = feat[..., 0:3]
    ks = feat[..., 3:6]
    return kd, ks


def export_stage1_mesh(
    verts: np.ndarray,
    tris: np.ndarray,
    material_fn,
    workspace: str,
    texture_size: int = 1024,
    cascade_id: int = 0,
    atlas: str = "chart",
    device="cuda",
    timer=None,
) -> str:
    """Full export: atlas + bake + PNG textures + OBJ/MTL -> the OBJ's path.
    ``timer``: a utils.profiling.PhaseTimer that takes the phases atlas,
    raster, material, inpaint and write."""
    os.makedirs(workspace, exist_ok=True)
    with _phase(timer, "atlas"):
        if atlas == "chart":
            uv_flat, uv_tris, _ = chart_atlas(verts, tris, texture_size)
        else:
            uv_flat, uv_tris, _ = grid_atlas(tris.shape[0], texture_size)
    kd, ks = bake_textures(verts, tris, uv_flat, material_fn, texture_size, device=device,
                           timer=timer)

    with _phase(timer, "write"):
        kd_srgb = linear_to_srgb(torch.from_numpy(np.clip(kd, 0, 1))).numpy()
        f0 = (np.clip(kd_srgb, 0, 1) * 255).astype(np.uint8)
        f1 = (np.clip(ks, 0, 1) * 255).astype(np.uint8)
        # texture (u,v) -> image (row = 1-v): transpose to image layout
        f0_img = np.flipud(np.transpose(f0, (1, 0, 2)))
        f1_img = np.flipud(np.transpose(f1, (1, 0, 2)))

        feat0 = os.path.join(workspace, f"feat0_{cascade_id}.png")
        feat1 = os.path.join(workspace, f"feat1_{cascade_id}.png")
        write_png(feat0, f0_img)
        write_png(feat1, f1_img)

        obj_path = os.path.join(workspace, f"mesh_{cascade_id}.obj")
        write_obj(obj_path, verts, tris, uvs=uv_flat, uv_tris=uv_tris, feat0_png=feat0,
                  feat1_png=feat1)
    return obj_path
