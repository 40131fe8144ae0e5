"""Dense closest-hit of every ray against every triangle: kernel K3
(counterpart of mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py
``pallas_dense_hit``).

``dense_hit`` launches the CUDA kernel (csrc/dense_hit.cu) for tensors on
the card and runs ``dense_hit_plain`` for tensors on the CPU; on the card
the plain version serves only as the yardstick of correctness.  Semantics
of both: first minimal triangle index, ``t > t_min``, ``prim >= 0``, no
t_max (the caller applies it); a miss leaves t = 1e30 and index -1.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

BM = 512      # triangle padding granularity of the [16, M] table
BIG = 1e30
RAY_CHUNK, TRI_CHUNK = 8192, 2048   # plain version's [rays, triangles] pass

_VP = ctypes.c_void_p


def tris_cm_from_soa(soa: torch.Tensor) -> torch.Tensor:
    """[16, Mpad] component-major table from a [10, M] SoA block (rows 0-9 =
    v0, e1, e2, prim), padded to a multiple of BM with prim = -1."""
    M = soa.shape[1]
    pad = (-M) % BM
    cm16 = torch.zeros((16, M + pad), dtype=torch.float32, device=soa.device)
    cm16[:10, :M] = soa
    if pad:
        cm16[9, M:] = -1.0
    return cm16


def pack_tris_cm(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """[16, Mpad] table straight from a mesh (prim = triangle index)."""
    tri = tris.to(torch.int64)
    v0 = verts[tri[:, 0]]
    e1 = verts[tri[:, 1]] - v0
    e2 = verts[tri[:, 2]] - v0
    prim = torch.arange(tri.shape[0], dtype=torch.float32, device=verts.device)
    return tris_cm_from_soa(torch.cat([v0.T, e1.T, e2.T, prim[None]], dim=0))


def _mt(comp, ox, oy, oz, dx, dy, dz, t_min):
    """Moeller-Trumbore of rays given as [N,1] columns against triangle rows
    [1,M]; the operation order of csrc/mt.cuh."""
    v0x, v0y, v0z = comp[0][None], comp[1][None], comp[2][None]
    e1x, e1y, e1z = comp[3][None], comp[4][None], comp[5][None]
    e2x, e2y, e2z = comp[6][None], comp[7][None], comp[8][None]
    prim = comp[9][None]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    dinv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * dinv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * dinv
    t = (e2x * qx + e2y * qy + e2z * qz) * dinv
    ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (prim >= 0)
    return torch.where(ok, t, BIG), u, v


def dense_hit_plain(tris_cm: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    t_min: float = 1e-4
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K3 kernel: (best_t, best_lin int64, u, v)."""
    N = rays_o.shape[0]
    M = tris_cm.shape[1]
    dev = rays_o.device
    best_t = torch.full((N,), BIG, device=dev)
    best_lin = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    for r0 in range(0, N, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, N)
        o, d = rays_o[r0:r1], rays_d[r0:r1]
        cols = (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])
        bt, bl, bu, bv = best_t[r0:r1], best_lin[r0:r1], best_u[r0:r1], best_v[r0:r1]
        for s in range(0, M, TRI_CHUNK):
            e = min(s + TRI_CHUNK, M)
            t, u, v = _mt(tris_cm[:, s:e], *cols, t_min)
            i = torch.argmin(t, dim=1, keepdim=True)   # first minimal index
            tmin_ = torch.gather(t, 1, i)[:, 0]
            better = tmin_ < bt
            bl = torch.where(better, s + i[:, 0], bl)
            bu = torch.where(better, torch.gather(u, 1, i)[:, 0], bu)
            bv = torch.where(better, torch.gather(v, 1, i)[:, 0], bv)
            bt = torch.where(better, tmin_, bt)
        best_t[r0:r1], best_lin[r0:r1], best_u[r0:r1], best_v[r0:r1] = bt, bl, bu, bv
    return best_t, best_lin, best_u, best_v


def _bind(lib):
    fn = lib.dense_hit_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_float, _VP, _VP]
    return fn


def _check_inputs(tris_cm, rays_o, rays_d):
    dev = tris_cm.device
    for name, x in (("tris_cm", tris_cm), ("rays_o", rays_o), ("rays_d", rays_d)):
        if x.device != dev:
            raise ValueError(f"dense_hit: {name} on {x.device}, tris_cm on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"dense_hit: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"dense_hit: {name} must be contiguous")
    if tris_cm.dim() != 2 or tris_cm.shape[0] != 16 or tris_cm.shape[1] % BM:
        raise ValueError(f"dense_hit: tris_cm must be [16, k*{BM}], got {tuple(tris_cm.shape)}")
    if rays_o.shape != rays_d.shape or rays_o.dim() != 2 or rays_o.shape[1] != 3:
        raise ValueError("dense_hit: rays must be [N, 3]")


def dense_hit(tris_cm: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              t_min: float = 1e-4):
    """tris_cm [16, Mpad] (prim = -1 padding), rays [N, 3] ->
    (best_t [N], best_lin [N] int64, u [N], v [N])."""
    rays_o = rays_o.to(torch.float32).contiguous()
    rays_d = rays_d.to(torch.float32).contiguous()
    _check_inputs(tris_cm, rays_o, rays_d)
    if not tris_cm.is_cuda:
        return dense_hit_plain(tris_cm, rays_o, rays_d, t_min)
    from ..cuda_build import check, load, stream_ptr

    N, M = rays_o.shape[0], tris_cm.shape[1]
    out = torch.empty((4, N), dtype=torch.float32, device=tris_cm.device)
    if N:
        launch = _bind(load("dense_hit"))
        check(launch(tris_cm.data_ptr(), M, rays_o.data_ptr(), rays_d.data_ptr(), N,
                     t_min, out.data_ptr(), stream_ptr(tris_cm.device)), "dense_hit")
        dense_hit.launches += 1
    return out[0], out[1].to(torch.int64), out[2], out[3]


dense_hit.launches = 0
