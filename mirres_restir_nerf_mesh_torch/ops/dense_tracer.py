"""Dense pass of every ray against every triangle: kernel K3 (counterpart of
mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py ``pallas_dense_hit``),
closest hit and any hit.

``dense_hit`` and ``dense_occluded`` launch the CUDA kernels
(csrc/dense_hit.cu) for tensors on the card and run ``dense_hit_plain`` /
``dense_occluded_plain`` for tensors on the CPU; on the card the plain
versions serve only as the yardstick of correctness.  The triangle table
is any [>= 10, M] float32 tensor whose rows are contiguous (rows 0-8 v0,
e1, e2, row 9 prim, < 0 = padding): the cluster SoA [10, C*S] or the
padded [16, Mpad] of ``pack_tris_cm``.  Closest hit: first minimal
triangle index, ``t > t_min``, ``prim >= 0``, no t_max (the caller applies
it); a miss leaves t = 1e30 and index -1.  Any hit: some triangle with
``t_min < t < t_max``.

``dense_intersect`` runs the closest hit on a bare (verts, tris) mesh and
returns a ``HitResult`` (counterpart of ``pallas_intersect``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from ..utils.math import cross
from .bvh import HitResult

BM = 512      # triangle padding granularity of the [16, M] table
BIG = 1e30
RAY_CHUNK, TRI_CHUNK = 8192, 2048   # plain versions' [rays, triangles] pass
KERNEL_BM = 256                      # triangles a staged block (csrc/dense_hit.cu)
THREADS = 128                        # threads (rays) a block
SPLIT_BLOCKS_PER_SM = 16             # blocks the split aims for, an SM
PART_BLOCKS = 4                      # staged blocks a part walks at most

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


def split_factor(n_ray_blocks: int, n_sms: int, n_blocks: int) -> int:
    """Parts the triangle range is cut into: enough blocks for
    SPLIT_BLOCKS_PER_SM an SM, and parts of at most PART_BLOCKS staged
    blocks (the cull makes a block's work depend on its rays, and short
    parts spread that over more blocks), clamped to 1..16 and to the
    count of staged blocks."""
    want = max(-(-SPLIT_BLOCKS_PER_SM * n_sms // max(n_ray_blocks, 1)),
               -(-n_blocks // PART_BLOCKS))
    return max(1, min(16, n_blocks, want))


def part_bounds(M: int, split: int) -> List[Tuple[int, int]]:
    """The kernel's parts: split runs of whole staged blocks, as columns."""
    nb = -(-M // KERNEL_BM)
    return [(min(M, p * nb // split * KERNEL_BM), min(M, (p + 1) * nb // split * KERNEL_BM))
            for p in range(split)]


def _mt(comp, ox, oy, oz, dx, dy, dz, t_min):
    """Moeller-Trumbore of rays given as [N,1] columns against triangle rows
    [1,M]; the operation order of csrc/mt.cuh -> (ok, t, u, v) without a
    t_max."""
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
    return ok, t, u, v


def _ray_cols(rays_o, rays_d, r0, r1):
    o, d = rays_o[r0:r1], rays_d[r0:r1]
    return (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])


def dense_hit_plain(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    t_min: float = 1e-4
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K3 closest hit: (best_t, best_lin int64, u, v)."""
    N = rays_o.shape[0]
    M = tris.shape[1]
    dev = rays_o.device
    best_t = torch.full((N,), BIG, device=dev)
    best_lin = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    for r0 in range(0, N, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, N)
        cols = _ray_cols(rays_o, rays_d, r0, r1)
        bt, bl, bu, bv = best_t[r0:r1], best_lin[r0:r1], best_u[r0:r1], best_v[r0:r1]
        for s in range(0, M, TRI_CHUNK):
            e = min(s + TRI_CHUNK, M)
            ok, t, u, v = _mt(tris[:, s:e], *cols, t_min)
            t = torch.where(ok, t, BIG)
            i = torch.argmin(t, dim=1, keepdim=True)   # first minimal index
            tmin_ = torch.gather(t, 1, i)[:, 0]
            better = tmin_ < bt
            bl = torch.where(better, s + i[:, 0], bl)
            bu = torch.where(better, torch.gather(u, 1, i)[:, 0], bu)
            bv = torch.where(better, torch.gather(v, 1, i)[:, 0], bv)
            bt = torch.where(better, tmin_, bt)
        best_t[r0:r1], best_lin[r0:r1], best_u[r0:r1], best_v[r0:r1] = bt, bl, bu, bv
    return best_t, best_lin, best_u, best_v


def dense_hit_split_plain(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          t_min: float = 1e-4, split: int = 1):
    """The kernel's split and combine rule in plain PyTorch: part p of
    ``split`` walks its run of staged blocks (``part_bounds``) against its
    own best only, and the parts combine by the smallest (t, index), t
    compared as a float (so -0 and +0 tie and the index decides), which is
    dense_hit_plain's answer: the first minimal index."""
    best = None
    for a, b in part_bounds(tris.shape[1], split):
        if a == b:
            continue
        t, lin, u, v = dense_hit_plain(tris[:, a:b], rays_o, rays_d, t_min)
        lin = torch.where(lin >= 0, lin + a, lin)
        if best is None:
            best = (t, lin, u, v)
            continue
        bt, bl = best[0], best[1]
        better = (t < bt) | ((t == bt) & (lin >= 0) & (lin < bl))
        best = tuple(torch.where(better, x, y) for x, y in zip((t, lin, u, v), best))
    if best is None:
        return dense_hit_plain(tris, rays_o, rays_d, t_min)
    return best


def dense_occluded_plain(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                         t_max: torch.Tensor, t_min: float = 1e-4) -> torch.Tensor:
    """Plain PyTorch version of the K3 any hit: [N] bool, some triangle with
    t_min < t < t_max[ray]."""
    N = rays_o.shape[0]
    M = tris.shape[1]
    occ = torch.zeros((N,), dtype=torch.bool, device=rays_o.device)
    for r0 in range(0, N, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, N)
        cols = _ray_cols(rays_o, rays_d, r0, r1)
        tm = t_max[r0:r1, None]
        live = tm[:, 0] > t_min
        for s in range(0, M, TRI_CHUNK):
            ok, t, _, _ = _mt(tris[:, s:min(s + TRI_CHUNK, M)], *cols, t_min)
            occ[r0:r1] |= (ok & (t < tm)).any(dim=1) & live
    return occ


def bundle_keep_plain(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      t_lim: torch.Tensor, live: Optional[torch.Tensor] = None,
                      warps_per_pass: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' warp-bundle cull (csrc/dense_hit.cu ``warp_bundle`` +
    ``group_maybe``, t_min >= 0) in fp32 -> (keep [W, G] bool, culls [W]
    bool) for the warps of 32 consecutive rays (the last one padded with
    rays that are not live) and the groups of 4 consecutive columns: keep
    is False where the kernel skips group g for warp w when the live rays
    of the warp reach at most t_lim (a group of padding only is dropped),
    and culls says whether the warp culls at all (a narrow cone, or a
    limit below 1e29); a warp that does not keeps every group, one with no
    live ray none (the kernel skips it)."""
    N, M = rays_o.shape[0], tris.shape[1]
    W, G = -(-N // 32), -(-M // 4)
    dev = rays_o.device
    live = torch.ones((N,), dtype=torch.bool, device=dev) if live is None else live
    pad_r, pad_c = 32 * W - N, 4 * G - M
    o = torch.cat([rays_o, rays_o[:1].expand(pad_r, 3)]).reshape(W, 32, 3)
    d = torch.cat([rays_d, rays_d[:1].expand(pad_r, 3)])
    lv = torch.cat([live, live.new_zeros(pad_r)]).reshape(W, 32)
    tl = torch.cat([t_lim, t_lim.new_zeros(pad_r)]).reshape(W, 32)
    comp = torch.cat([tris[:10], tris.new_zeros((10, pad_c))], 1)
    if pad_c:
        comp[9, M:] = -1.0
    dn = torch.sqrt((d * d).sum(1, keepdim=True))
    h = (d / dn).reshape(W, 32, 3)
    s = torch.where(lv[..., None], h, 0.0).sum(1)
    a = s / torch.sqrt((s * s).sum(1, keepdim=True))                          # [W, 3]
    c = torch.where(lv, (h * a[:, None]).sum(2), 1.0).amin(1) - 2e-6
    cone = lv.any(1) & (c > 0.05) & torch.isfinite(a.sum(1))
    sn = torch.sqrt(torch.clamp_min(1 - c * c, 0.0))
    lo = torch.where(lv[..., None], o, torch.inf).amin(1)
    hi = torch.where(lv[..., None], o, -torch.inf).amax(1)
    ob = 0.5 * (lo + hi)
    rho = 0.5 * torch.sqrt(((hi - lo) ** 2).sum(1)) * 1.0001 + 1e-6 * ob.abs().sum(1)
    lim = torch.where(lv, tl * dn.reshape(W, 32), -torch.inf).amax(1) * 1.0001
    culls = cone | (lim < 1e29)
    v0 = comp[0:3].T.reshape(G, 4, 3)
    pts = torch.stack([v0, v0 + comp[3:6].T.reshape(G, 4, 3),
                       v0 + comp[6:9].T.reshape(G, 4, 3)], 2)                 # [G, 4, 3, 3]
    real = (comp[9] >= 0).reshape(G, 4, 1, 1)
    blo = torch.where(real, pts, torch.inf).amin(dim=(1, 2))                    # [G, 3]
    bhi = torch.where(real, pts, -torch.inf).amax(dim=(1, 2))
    some = (bhi >= blo).all(1)
    half = 0.5 * torch.sqrt(((bhi - blo) ** 2).sum(1))
    centre = 0.5 * (blo + bhi)
    scale = torch.maximum(blo.abs(), bhi.abs()).amax(1)
    keep = torch.empty((W, G), dtype=torch.bool, device=dev)
    for w0 in range(0, W, warps_per_pass):
        w1 = min(W, w0 + warps_per_pass)
        R = half[None] + rho[w0:w1, None]                                       # [w, G]
        p = centre[None] - ob[w0:w1, None]                                      # [w, G, 3]
        pl = torch.sqrt((p * p).sum(2))
        margin = 1e-4 * (pl + R) + 1e-6 * scale[None]
        aw = a[w0:w1, None]
        pa = (p * aw).sum(2)
        pc = torch.linalg.cross(p, aw.expand_as(p), dim=2).norm(dim=2)
        cw, sw = c[w0:w1, None], sn[w0:w1, None]
        dist = torch.where(pa * cw + pc * sw <= 0, pl, pc * cw - pa * sw)
        in_cone = ~cone[w0:w1, None] | (pa >= pl * cw) | ~(dist - R > margin)
        maybe = some[None] & ~(pl - R - margin > lim[w0:w1, None]) & in_cone
        keep[w0:w1] = (maybe | ~culls[w0:w1, None]) & lv[w0:w1].any(1, keepdim=True)
    return keep, culls


@functools.lru_cache(maxsize=None)
def _kernels():
    """The bound C entries of csrc/dense_hit.cu, bound once."""
    from ..cuda_build import load

    lib = load("dense_hit")
    hit = lib.dense_hit_launch
    hit.restype = ctypes.c_int
    hit.argtypes = [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP, ctypes.c_int,
                    ctypes.c_float, ctypes.c_int, _VP, _VP, _VP]
    occ = lib.dense_occluded_launch
    occ.restype = ctypes.c_int
    occ.argtypes = [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, _VP, _VP]
    return hit, occ


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


def _prepare(what: str, tris, rays_o, rays_d):
    """Rays as contiguous float32; raise on what the kernel does not take."""
    rays_o = rays_o.to(torch.float32).contiguous()
    rays_d = rays_d.to(torch.float32).contiguous()
    dev = tris.device
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, tris on {dev}")
    if tris.dtype != torch.float32:
        raise TypeError(f"{what}: tris must be float32, got {tris.dtype}")
    if tris.dim() != 2 or tris.shape[0] < 10 or (tris.shape[1] > 1 and tris.stride(1) != 1):
        raise ValueError(f"{what}: tris must be [>= 10, M] with contiguous rows, got "
                         f"{tuple(tris.shape)} strides {tris.stride()}")
    if rays_o.shape != rays_d.shape or rays_o.dim() != 2 or rays_o.shape[1] != 3:
        raise ValueError(f"{what}: rays must be [N, 3]")
    if rays_o.shape[0] >= 2 ** 31 or tris.shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: more than 2^31 rays or triangles")
    return rays_o, rays_d


def _table_args(tris):
    """(row stride, M, 16-byte rows) of the triangle table."""
    ld = tris.stride(0)
    return ld, tris.shape[1], int(ld % 4 == 0 and tris.data_ptr() % 16 == 0)


def _split(split, n_ray_blocks, M, dev):
    if split is None:
        split = split_factor(n_ray_blocks, _sms(dev), -(-M // KERNEL_BM))
    if not 1 <= split <= 64:
        raise ValueError(f"dense tracer: split {split} outside 1..64")
    return split


def dense_hit(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              t_min: float = 1e-4, split: Optional[int] = None):
    """tris [>= 10, M] (prim < 0 = padding), rays [N, 3] -> (best_t [N],
    best_lin [N] int64, u [N], v [N]).  On the card the triangle range is cut
    into ``split`` parts (None: ``split_factor`` of the SM count)."""
    rays_o, rays_d = _prepare("dense_hit", tris, rays_o, rays_d)
    if not tris.is_cuda:
        return dense_hit_plain(tris, rays_o, rays_d, t_min)
    from ..cuda_build import check, stream_ptr

    dev = tris.device
    N = rays_o.shape[0]
    ld, M, vec = _table_args(tris)
    out = torch.empty((4, N), dtype=torch.float32, device=dev)
    if N and M:
        split = _split(split, -(-N // THREADS), M, dev)
        keys = torch.empty((N,) if split > 1 else (0,), dtype=torch.int64, device=dev)
        check(_kernels()[0](tris.data_ptr(), ld, M, vec, rays_o.data_ptr(), rays_d.data_ptr(),
                            N, t_min, split, out.data_ptr(), keys.data_ptr(),
                            stream_ptr(dev)), "dense_hit")
        dense_hit.launches += 1
    elif N:
        out[0], out[1], out[2:] = BIG, -1.0, 0.0
    return out[0], out[1].to(torch.int64), out[2], out[3]


dense_hit.launches = 0


def dense_occluded(tris: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, t_max,
                   t_min: float = 1e-4, split: Optional[int] = None) -> torch.Tensor:
    """tris [>= 10, M], rays [N, 3], t_max [N] or a scalar -> [N] bool: some
    triangle with t_min < t < t_max.  On the card the triangle range is cut
    into ``split`` parts (None: ``split_factor`` of the SM count)."""
    rays_o, rays_d = _prepare("dense_occluded", tris, rays_o, rays_d)
    N = rays_o.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=tris.device),
                               (N,)).contiguous()
    if not tris.is_cuda:
        return dense_occluded_plain(tris, rays_o, rays_d, t_max, t_min)
    from ..cuda_build import check, stream_ptr

    dev = tris.device
    ld, M, vec = _table_args(tris)
    occ = torch.zeros((N,), dtype=torch.uint8, device=dev)
    if N and M:
        split = _split(split, -(-N // THREADS), M, dev)
        check(_kernels()[1](tris.data_ptr(), ld, M, vec, rays_o.data_ptr(), rays_d.data_ptr(),
                            t_max.data_ptr(), N, t_min, split, occ.data_ptr(),
                            stream_ptr(dev)), "dense_occluded")
        dense_occluded.launches += 1
    return occ.bool()


dense_occluded.launches = 0


def dense_intersect(verts: torch.Tensor, tris: torch.Tensor, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, t_min: float = 1e-4, t_max=1e10,
                    split: Optional[int] = None) -> HitResult:
    """Closest hit of every ray against every triangle of a bare mesh: K3
    (``dense_hit``) on the card, its plain version on the CPU.  A miss is
    best_t >= min(BIG / 2, t_max) or no index; the normal and the prim id
    come from one row gather of the packed table."""
    cm = pack_tris_cm(verts, tris)
    best_t, best_lin, u, v = dense_hit(cm, rays_o, rays_d, t_min=t_min, split=split)
    t_max_arr = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                   device=best_t.device), best_t.shape)
    miss = (best_t >= torch.clamp_max(t_max_arr, BIG * 0.5)) | (best_lin < 0)
    rows = cm.T[torch.clamp(best_lin, 0, cm.shape[1] - 1)]
    return HitResult(
        t=torch.where(miss, torch.inf, best_t),
        prim=torch.where(miss, -1, rows[:, 9].to(torch.int64)),
        u=u,
        v=v,
        normal=torch.where(miss[:, None], 0.0, cross(rows[:, 3:6], rows[:, 6:9])),
    )
