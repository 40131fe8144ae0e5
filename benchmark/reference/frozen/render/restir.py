"""ReSTIR DI: reservoir-based spatiotemporal importance resampling
(counterpart of mirres_restir_nerf_mesh_tpu/render/restir.py).

Per-pixel array programs over [P] lanes: light tiles of presampled envmap
directions, initial RIS over light-tile + BRDF candidates, temporal reuse
of the previous spp iteration's reservoir, pairwise-MIS spatial reuse with
(optionally) cross visibility, and the final sample Li = W * Le * vis,
differentiable with respect to the envmap.  Targets use the nearest-texel
Le (``eval_le_nearest``) and are threaded on the reservoir (``p``) instead
of re-evaluated, as the reference does.

Randoms come in pre-drawn, in pixel space (``u=`` / ``rand=`` arguments;
``render_stage1`` draws them all in ``FrameRandoms``).  Sums that decide a
pick keep the reference's order: the neighbour stream adds one neighbour
at a time.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..models import envlight
from ..ops.tracer import Tracer
from ..utils.math import luminance, onb_frame
from . import brdf
from .pathtracer import LightSample


class Reservoir(NamedTuple):
    dir: torch.Tensor      # [P,3] world light direction of the winner
    W: torch.Tensor        # [P] unbiased contribution weight
    M: torch.Tensor        # [P] effective sample count
    valid: torch.Tensor    # [P] bool
    # the winner's target at its own pixel (luminance(Le * f)); threaded
    # through the passes instead of re-evaluated.  None = unknown.
    p: Optional[torch.Tensor] = None


def empty_reservoir(P: int, device) -> Reservoir:
    z = torch.zeros((P,), device=device)
    return Reservoir(dir=torch.zeros((P, 3), device=device), W=z, M=z,
                     valid=torch.zeros((P,), dtype=torch.bool, device=device), p=z)


class PixelCtx(NamedTuple):
    """Per-pixel shading context of the target function."""

    position: torch.Tensor   # [P,3]
    normal: torch.Tensor     # [P,3]
    view_dir: torch.Tensor   # [P,3]
    kd: torch.Tensor         # [P,3]
    roughness: torch.Tensor  # [P]
    metallic: torch.Tensor   # [P]
    mask: torch.Tensor       # [P] bool
    depth: torch.Tensor      # [P]


def target_function(ctx: PixelCtx, ldir: torch.Tensor, le: torch.Tensor) -> torch.Tensor:
    """p_hat = luminance(Le * f(view, light))."""
    w_view = brdf.to_local(-ctx.view_dir, ctx.normal)
    w_l = brdf.to_local(ldir, ctx.normal)
    alpha = brdf.alpha_from_roughness(ctx.roughness)
    p_diff, p_spec = brdf.lobe_probabilities(ctx.kd, ctx.metallic,
                                             torch.sum(-ctx.view_dir * ctx.normal, dim=-1))
    f = brdf.brdf_eval(w_view, w_l, ctx.kd, ctx.metallic, alpha, p_diff, p_spec)
    return torch.clamp_min(luminance(le * f), 0.0)


class CtxPre(NamedTuple):
    """Per-pixel precompute of the target: local frame, local view dir,
    GGX alpha, lobe probabilities (pixel leading shape)."""

    t: torch.Tensor        # [..,3] tangent
    b: torch.Tensor        # [..,3] bitangent
    n: torch.Tensor        # [..,3] normal
    wv: torch.Tensor       # [..,3] view dir, local frame
    alpha: torch.Tensor    # [..]
    p_diff: torch.Tensor   # [..]
    p_spec: torch.Tensor   # [..]
    kd: torch.Tensor       # [..,3]
    metallic: torch.Tensor  # [..]


def precompute_ctx(ctx: PixelCtx) -> CtxPre:
    t, b, n = onb_frame(ctx.normal)
    wv = brdf.to_local(-ctx.view_dir, ctx.normal)
    alpha = brdf.alpha_from_roughness(ctx.roughness)
    p_diff, p_spec = brdf.lobe_probabilities(ctx.kd, ctx.metallic,
                                             torch.sum(-ctx.view_dir * ctx.normal, dim=-1))
    return CtxPre(t=t, b=b, n=n, wv=wv, alpha=alpha, p_diff=p_diff, p_spec=p_spec, kd=ctx.kd,
                  metallic=ctx.metallic)


def target_soa(pre: CtxPre, ld: torch.Tensor, le: torch.Tensor, with_pdf: bool = False):
    """``target_function`` (and, with_pdf, ``brdf.brdf_pdf``) on component
    planes.  pre leaves have pixel shape [..]; ld / le are [.., K, 3] or
    [.., 3], the candidate axes broadcasting against the pixel planes.
    Returns p_hat [.., K] (and the mixed BRDF pdf)."""
    extra = ld.dim() - pre.alpha.dim() - 1

    def pp(x):
        return x.reshape(tuple(x.shape) + (1,) * extra) if extra > 0 else x

    ldx, ldy, ldz = ld[..., 0], ld[..., 1], ld[..., 2]
    lex, ley, lez = le[..., 0], le[..., 1], le[..., 2]
    tx, ty, tz = pp(pre.t[..., 0]), pp(pre.t[..., 1]), pp(pre.t[..., 2])
    bx, by, bz = pp(pre.b[..., 0]), pp(pre.b[..., 1]), pp(pre.b[..., 2])
    nx, ny, nz = pp(pre.n[..., 0]), pp(pre.n[..., 1]), pp(pre.n[..., 2])
    wvx, wvy, wvz = pp(pre.wv[..., 0]), pp(pre.wv[..., 1]), pp(pre.wv[..., 2])
    a = pp(pre.alpha)
    met = pp(pre.metallic)
    kdr, kdg, kdb = pp(pre.kd[..., 0]), pp(pre.kd[..., 1]), pp(pre.kd[..., 2])
    gate_d = pp(pre.p_diff > 0)
    gate_s = pp(pre.p_spec > 0)

    wlx = ldx * tx + ldy * ty + ldz * tz
    wly = ldx * bx + ldy * by + ldz * bz
    wlz = ldx * nx + ldy * ny + ldz * nz

    ok = torch.minimum(wvz, wlz) >= 1e-6
    ndl = torch.where(ok, torch.clamp_min(brdf.INV_PI * wlz, 0.0), 0.0)
    difw = 1.0 - met
    f_r = torch.where(gate_d, kdr * difw * ndl, 0.0)
    f_g = torch.where(gate_d, kdg * difw * ndl, 0.0)
    f_b = torch.where(gate_d, kdb * difw * ndl, 0.0)

    hx, hy, hz = wvx + wlx, wvy + wly, wvz + wlz
    hn = torch.clamp_min(torch.sqrt(hx * hx + hy * hy + hz * hz), 1e-12)
    hx, hy, hz = hx / hn, hy / hn, hz / hn
    vdoth = wvx * hx + wvy * hy + wvz * hz
    a2 = a * a
    d_ = (hz * a2 - hz) * hz + 1.0
    D = a2 / torch.clamp_min(d_ * d_ * math.pi, 1e-12)

    def _lam(c):
        c2 = torch.clamp(c, 1e-6, 1.0) ** 2
        tan2 = torch.clamp_min(1.0 - c2, 0.0) / c2
        lam = 0.5 * (-1.0 + torch.sqrt(1.0 + a2 * tan2))
        return torch.where(c <= 0, 0.0, lam)

    G = 1.0 / torch.clamp_min(1.0 + _lam(wvz) + _lam(wlz), 1e-12)
    f5 = torch.clamp_min(1.0 - vdoth, 0.0) ** 5
    sar = brdf.F0 * (1.0 - met) + kdr * met
    sag = brdf.F0 * (1.0 - met) + kdg * met
    sab = brdf.F0 * (1.0 - met) + kdb * met
    dg = D * G * 0.25 / torch.clamp_min(wvz, 1e-6)
    dg = torch.where((a > 0) & ok, dg, 0.0)
    f_r = f_r + torch.where(gate_s, (sar + (1.0 - sar) * f5) * dg, 0.0)
    f_g = f_g + torch.where(gate_s, (sag + (1.0 - sag) * f5) * dg, 0.0)
    f_b = f_b + torch.where(gate_s, (sab + (1.0 - sab) * f5) * dg, 0.0)

    p_hat = torch.clamp_min(lex * f_r * 0.2126 + ley * f_g * 0.7152 + lez * f_b * 0.0722, 0.0)
    if not with_pdf:
        return p_hat
    dpdf = torch.clamp_min(wlz, 0.0) * brdf.INV_PI
    spdf = D * hz / torch.clamp_min(4.0 * vdoth, 1e-12)
    spdf = torch.where(ok & (a > 0) & (vdoth > 0), spdf, 0.0)
    return p_hat, pp(pre.p_diff) * dpdf + pp(pre.p_spec) * spdf


class LightTiles(NamedTuple):
    dirs: torch.Tensor   # [T, S, 3]
    le: torch.Tensor     # [T, S, 3] nearest-texel Le
    pdf: torch.Tensor    # [T, S]


def generate_light_tiles(env_tex: torch.Tensor, dist, n_tiles: int,
                         tile_size: int, u: torch.Tensor) -> LightTiles:
    """Presampled envmap samples from uniforms u [n_tiles, tile_size, 2].
    With an ``EnvSampler`` tile Le is the sampled texel's own (nearest)
    value, since it only enters resampling targets; an
    ``EnvDistribution``'s tiles carry the bilinear Le."""
    dirs, le, pdf = envlight.sample_li(env_tex, dist, u.reshape(-1, 2),
                                       nearest_le=isinstance(dist, envlight.EnvSampler))
    return LightTiles(dirs=dirs.reshape(n_tiles, tile_size, 3),
                      le=le.reshape(n_tiles, tile_size, 3), pdf=pdf.reshape(n_tiles, tile_size))


class InitialRandoms(NamedTuple):
    """Draws of one initial_resampling call ([P] lanes).  Packed fast path:
    blk [P] candidate block, us [1 + n_brdf, P] (one categorical pick for
    the light block, one stream uniform per BRDF candidate).  Strided slow
    path: blk [P] is the walk's offset, stride [P] its odd stride, us
    [n_light + n_brdf, P]."""

    tile_id: torch.Tensor
    blk: torch.Tensor
    us: torch.Tensor
    brdf_us: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # (u_sel, u_d, u_s) per BRDF sample
    stride: Optional[torch.Tensor] = None


def initial_resampling(ctx: PixelCtx, tiles: LightTiles, env_tex: torch.Tensor,
                       dist, tracer: Optional[Tracer],
                       n_light_samples: int, n_brdf_samples: int, check_visibility: bool,
                       rand: InitialRandoms) -> Reservoir:
    """RIS over light-tile + BRDF candidates.  The packed fast path (taken
    when tile_size % n_light_samples == 0) fetches an aligned block of
    n_light_samples consecutive tile samples per pixel and picks one by a
    single inverse-CDF draw over their weights; the slow path walks the tile
    with a per-pixel offset and odd stride, streaming one candidate at a
    time.  BRDF candidates stream after the light candidates."""
    P = ctx.position.shape[0]
    dev = ctx.position.device
    T, S = tiles.pdf.shape
    n = n_light_samples
    fast_path = n > 0 and S % n == 0
    if rand.us.shape[0] == 1 + n_brdf_samples and not fast_path:
        raise ValueError(f"initial_resampling: packed us rows need the fast path "
                         f"(tile_size {S} % n_light_samples {n} == 0)")
    tile_id, us = rand.tile_id.long(), rand.us
    ratio = n_brdf_samples / max(n + n_brdf_samples, 1)

    alpha = brdf.alpha_from_roughness(ctx.roughness)
    t_onb, b_onb, _ = onb_frame(ctx.normal)
    w_view = brdf.to_local(-ctx.view_dir, ctx.normal)
    p_diff, p_spec = brdf.lobe_probabilities(ctx.kd, ctx.metallic,
                                             torch.sum(-ctx.view_dir * ctx.normal, dim=-1))
    pre = CtxPre(t=t_onb, b=b_onb, n=ctx.normal, wv=w_view, alpha=alpha, p_diff=p_diff,
                 p_spec=p_spec, kd=ctx.kd, metallic=ctx.metallic)

    table = torch.cat([tiles.dirs, tiles.le, tiles.pdf[..., None]], dim=-1)   # [T,S,7]
    if fast_path:
        blocks = table.reshape(T * (S // n), n * 7)
        rows = blocks[tile_id * (S // n) + rand.blk.long()].reshape(P, n, 7)
        ld_all, le_all, lpdf_all = rows[..., 0:3], rows[..., 3:6], rows[..., 6]
        if n_brdf_samples > 0:
            p_hat_all, bpdf_all = target_soa(pre, ld_all, le_all, with_pdf=True)
            src_all = (1.0 - ratio) * lpdf_all + ratio * bpdf_all
        else:
            p_hat_all = target_soa(pre, ld_all, le_all)
            src_all = lpdf_all
        w_all = torch.where(src_all > 1e-12, p_hat_all / torch.clamp_min(src_all, 1e-12), 0.0)
        # the streaming pick over materialized weights is a categorical
        # draw: one inverse-CDF uniform selects candidate i with w_i / W
        w_cum = torch.cumsum(w_all, dim=1)
        W_l = w_cum[:, -1]
        any_pick = W_l > 0
        tgt = us[0] * W_l
        idx = torch.clamp_max(torch.sum(w_cum <= tgt[:, None], dim=1), n - 1)
        ar = torch.arange(P, device=dev)
        sel_dir = torch.where(any_pick[:, None], ld_all[ar, idx], 0.0)
        sel_p = torch.where(any_pick, p_hat_all[ar, idx], 0.0)
        w_sum = W_l
        M = torch.full((P,), float(n), device=dev)
        sel_valid = any_pick
    else:
        flat = table.reshape(T * S, 7)
        offset, stride = rand.blk.long(), rand.stride.long()
        base = tile_id * S
        w_sum = torch.zeros((P,), device=dev)
        M = torch.zeros((P,), device=dev)
        sel_dir = torch.zeros((P, 3), device=dev)
        sel_p = torch.zeros((P,), device=dev)
        sel_valid = torch.zeros((P,), dtype=torch.bool, device=dev)
        for i in range(n):
            row = flat[base + (offset + i * stride) % S]
            ldir, le, lpdf = row[:, 0:3], row[:, 3:6], row[:, 6]
            p_hat = target_function(ctx, ldir, le)
            if n_brdf_samples > 0:
                bpdf = brdf.brdf_pdf(w_view, brdf.to_local(ldir, ctx.normal), alpha, p_diff, p_spec)
                src = (1.0 - ratio) * lpdf + ratio * bpdf
            else:
                src = lpdf
            w = torch.where(src > 1e-12, p_hat / torch.clamp_min(src, 1e-12), 0.0)
            w_sum = w_sum + w
            M = M + 1.0
            pick = us[i] * w_sum < w
            sel_dir = torch.where(pick[:, None], ldir, sel_dir)
            sel_p = torch.where(pick, p_hat, sel_p)
            sel_valid = sel_valid | pick

    u0 = 1 if fast_path else n
    for j in range(n_brdf_samples):
        s = brdf.brdf_sample(w_view, ctx.kd, ctx.metallic, alpha, u=rand.brdf_us[j])
        ldir = brdf.to_global(s.w_light_l, ctx.normal)
        le = envlight.eval_le_nearest(env_tex, ldir)
        p_hat, bpdf_b = target_soa(pre, ldir, le, with_pdf=True)
        p_hat = torch.where(s.valid, p_hat, 0.0)
        src = (1.0 - ratio) * envlight.pdf_li(dist, ldir) + ratio * bpdf_b
        w = torch.where(s.valid & (src > 1e-12), p_hat / torch.clamp_min(src, 1e-12), 0.0)
        w_sum = w_sum + w
        M = M + 1.0
        pick = us[u0 + j] * w_sum < w
        sel_dir = torch.where(pick[:, None], ldir, sel_dir)
        sel_p = torch.where(pick, p_hat, sel_p)
        sel_valid = sel_valid | pick

    sel_valid = sel_valid & ctx.mask
    if check_visibility and tracer is not None:
        occ = tracer.occluded(ctx.position + ctx.normal * 1e-4, sel_dir,
                              torch.where(sel_valid, 1e9, 0.0), incoherent=True)
        sel_valid = sel_valid & ~occ
    W = torch.where(sel_valid & (sel_p > 0),
                    (w_sum / torch.clamp_min(M, 1.0)) / torch.clamp_min(sel_p, 1e-12), 0.0)
    W = torch.where(torch.isfinite(W), W, 0.0)
    # with an EnvSampler the tiles and BRDF candidates both carry
    # nearest-texel Le, so sel_p is the target temporal and spatial reuse
    # would re-evaluate: cache it.  An EnvDistribution's tiles carry
    # bilinear Le, so the later passes re-evaluate (p None).
    p_out = sel_p if isinstance(dist, envlight.EnvSampler) else None
    return Reservoir(dir=sel_dir, W=W, M=torch.ones((P,), device=dev), valid=sel_valid & (W > 0),
                     p=p_out)


def _valid_neighbor(ctx: PixelCtx, n_normal, n_depth, normal_thresh: float = 0.5,
                    depth_thresh: float = 0.1):
    return ((torch.sum(ctx.normal * n_normal, dim=-1) >= normal_thresh)
            & (torch.abs(ctx.depth - n_depth) <= depth_thresh * torch.clamp_min(ctx.depth, 1e-8)))


def temporal_resampling(ctx: PixelCtx, curr: Reservoir, prev: Reservoir, prev_normal, prev_depth,
                        env_tex: torch.Tensor, u: torch.Tensor, max_history: float = 20.0,
                        v_curr: Optional[torch.Tensor] = None,
                        v_prev: Optional[torch.Tensor] = None):
    """Merge the previous iteration's reservoir (zero motion: same pixel).
    With v_curr and v_prev (known visibility of each direction) returns
    (Reservoir, visibility of the winner); u [P] the pick uniforms."""
    ok = prev.valid & _valid_neighbor(ctx, prev_normal, prev_depth)
    prev_M = torch.where(ok, torch.minimum(prev.M, max_history * torch.clamp_min(curr.M, 1.0)), 0.0)

    pre = None
    if curr.p is not None:
        p_curr = torch.where(curr.valid, curr.p, 0.0)
    else:
        pre = precompute_ctx(ctx)
        p_curr = torch.where(curr.valid, target_soa(
            pre, curr.dir, envlight.eval_le_nearest(env_tex, curr.dir)), 0.0)
    if prev.p is not None:
        p_prev = torch.where(ok, prev.p, 0.0)
    else:
        pre = precompute_ctx(ctx) if pre is None else pre
        p_prev = torch.where(ok, target_soa(
            pre, prev.dir, envlight.eval_le_nearest(env_tex, prev.dir)), 0.0)

    w_curr = p_curr * curr.W * curr.M
    w_prev = p_prev * prev.W * prev_M
    w_sum = w_curr + w_prev
    M = curr.M + prev_M
    pick_prev = u * w_sum >= w_curr
    sel_dir = torch.where(pick_prev[:, None], prev.dir, curr.dir)
    sel_p = torch.where(pick_prev, p_prev, p_curr)
    W = torch.where(sel_p > 0, w_sum / torch.clamp_min(M, 1e-8) / torch.clamp_min(sel_p, 1e-12), 0.0)
    W = torch.where(torch.isfinite(W), W, 0.0)
    out = Reservoir(dir=sel_dir, W=W, M=M, valid=(W > 0) & ctx.mask, p=sel_p)
    if v_curr is not None and v_prev is not None:
        return out, torch.where(pick_prev, v_prev, v_curr)
    return out


def _m_factor(q0, q1):
    return torch.where(q0 == 0, 1.0,
                       torch.clamp(torch.clamp_max(q1 / torch.clamp_min(q0, 1e-12), 1.0) ** 8, 0.0, 1.0))


def _pairwise_mis(q0, q1, n0, n1):
    return torch.where(q1 == 0, 0.0, (n0 * q0) / torch.clamp_min(q0 * n0 + q1 * n1, 1e-12))


def make_neighbor_offsets(u: torch.Tensor, radius: float = 30.0) -> torch.Tensor:
    """Disc offsets in pixels from uniforms u [count, 2] (radius, angle)."""
    r = torch.sqrt(u[:, 0]) * radius
    th = u[:, 1] * 2 * math.pi
    return torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)


def pack_spatial_record(ctx: PixelCtx, res: Reservoir, v_self: Optional[torch.Tensor] = None, *,
                        env_tex: torch.Tensor) -> torch.Tensor:
    """The per-pixel record spatial reuse gathers from neighbours, [P, 38(+1)]:
    ctx (0:16), reservoir (16:22), the winner's target at its own pixel (22)
    and its nearest-texel Le (23:26), the shading-frame precompute (26:38),
    and v_self (38) when given.  Directions are copied bit for bit: the
    dedup compares them with ==."""
    pre = precompute_ctx(ctx)
    if res.p is not None:
        p_rec = torch.where(res.valid, res.p, 0.0)
    else:
        p_rec = torch.where(res.valid, target_soa(
            pre, res.dir, envlight.eval_le_nearest(env_tex, res.dir)), 0.0)
    le_rec = envlight.eval_le_nearest(env_tex, res.dir)
    cols = [ctx.position, ctx.normal, ctx.view_dir, ctx.kd, ctx.roughness[:, None],
            ctx.metallic[:, None], ctx.mask.to(torch.float32)[:, None], ctx.depth[:, None],
            res.dir, res.W[:, None], res.M[:, None], res.valid.to(torch.float32)[:, None],
            p_rec[:, None], le_rec, pre.t, pre.b, pre.wv, pre.alpha[:, None],
            pre.p_diff[:, None], pre.p_spec[:, None]]
    if v_self is not None:
        cols.append(v_self.to(torch.float32)[:, None])
    return torch.cat(cols, dim=1)


def spatial_resampling(ctx: PixelCtx, res: Reservoir, env_tex: torch.Tensor, H: int, W_img: int,
                       offsets: torch.Tensor, rand: Tuple[torch.Tensor, torch.Tensor],
                       tracer: Optional[Tracer] = None, n_neighbors: int = 5,
                       unbiased: bool = True, v_self: Optional[torch.Tensor] = None,
                       packed: Optional[torch.Tensor] = None,
                       pix_idx: Optional[torch.Tensor] = None):
    """Pairwise-MIS spatial reuse over n_neighbors disc neighbours, with
    cross visibility when unbiased and a tracer is given.

    v_self [P] bool: known visibility of res.dir (visibility threading).
    With it, pairs whose neighbour carries the canonical's exact direction
    reuse v_self instead of tracing, later neighbour slots that repeat an
    earlier slot's direction copy its ray's answer, and the function
    returns (Reservoir, visibility of the winner).

    packed / pix_idx: rows of a subset of the frame (live pixels): `packed`
    is the full-frame record (pack_spatial_record, in pixel order) the
    neighbours are read from, pix_idx [P] each row's pixel index.  Default:
    the rows are the whole frame.  rand: (start [P] disc-offset index,
    us [nn+1, P] pick uniforms)."""
    P = ctx.position.shape[0]
    dev = ctx.position.device
    nn = n_neighbors
    if pix_idx is None:
        pix_idx = torch.arange(P, device=dev)
    px = pix_idx % W_img
    py = pix_idx // W_img
    start, us = rand[0].long(), rand[1]

    le_c = envlight.eval_le_nearest(env_tex, res.dir)
    pre_c = precompute_ctx(ctx)
    if res.p is not None:
        p_canon = torch.where(res.valid, res.p, 0.0)
    else:
        p_canon = torch.where(res.valid, target_soa(pre_c, res.dir, le_c), 0.0)

    if nn <= 0:
        if v_self is not None and unbiased and tracer is not None:
            return res, v_self
        return res

    offs = offsets[(start[:, None] + torch.arange(nn, device=dev)[None, :]) % offsets.shape[0]]
    nx = torch.clamp(px[:, None] + offs[..., 0].to(torch.int32), 0, W_img - 1)
    ny = torch.clamp(py[:, None] + offs[..., 1].to(torch.int32), 0, H - 1)
    nidx = (ny * W_img + nx).reshape(-1).long()                         # [P*nn]

    def rep(x):
        return torch.repeat_interleave(x, nn, dim=0)

    ctx_rep = PixelCtx(*(rep(f) for f in ctx))
    if packed is None:
        packed = pack_spatial_record(ctx, res, v_self, env_tex=env_tex)
    g = packed[nidx]
    n_ctx = PixelCtx(position=g[:, 0:3], normal=g[:, 3:6], view_dir=g[:, 6:9], kd=g[:, 9:12],
                     roughness=g[:, 12], metallic=g[:, 13], mask=g[:, 14] > 0.5, depth=g[:, 15])
    n_res = Reservoir(dir=g[:, 16:19], W=g[:, 19], M=g[:, 20], valid=g[:, 21] > 0.5)
    ok_flat = n_ctx.mask & n_res.valid & _valid_neighbor(ctx_rep, n_ctx.normal, n_ctx.depth)

    # the neighbour's own target and Le ride the record; only the two cross
    # terms are evaluated on the [P*nn] axis
    le_n = g[:, 23:26]
    q_cand = g[:, 22]
    q_cand_at_c = target_soa(pre_c, n_res.dir.reshape(P, nn, 3), le_n.reshape(P, nn, 3)).reshape(-1)

    def g2(lo, hi):
        return g[:, lo:hi].reshape((P, nn) + ((hi - lo,) if hi - lo > 1 else ()))

    pre_n = CtxPre(t=g2(26, 29), b=g2(29, 32), n=g2(3, 6), wv=g2(32, 35), alpha=g2(35, 36),
                   p_diff=g2(36, 37), p_spec=g2(37, 38), kd=g2(9, 12), metallic=g2(13, 14))
    q_canon_at_n = target_soa(pre_n, res.dir[:, None, :], le_c[:, None, :]).reshape(-1)

    if unbiased and tracer is not None:
        # one shadow-ray launch for both cross-visibility sets
        origins = torch.cat([ctx_rep.position + ctx_rep.normal * 1e-4,
                             n_ctx.position + n_ctx.normal * 1e-4])
        dirs = torch.cat([n_res.dir, rep(res.dir)])
        if v_self is not None:
            same = torch.all(n_res.dir == rep(res.dir), dim=-1)           # [P*nn]
            dirs_nb = n_res.dir.reshape(P, nn, 3)
            same2 = same.reshape(P, nn)
            src_ok = same2 | ok_flat.reshape(P, nn)
            dup = torch.zeros((P, nn), dtype=torch.bool, device=dev)
            eq = {}
            for j in range(1, nn):
                dj = torch.zeros((P,), dtype=torch.bool, device=dev)
                for i in range(j):
                    eq[i, j] = torch.all(dirs_nb[:, j] == dirs_nb[:, i], dim=-1)
                    dj = dj | (eq[i, j] & src_ok[:, i])
                dup[:, j] = dj & ~same2[:, j]
            tmax_c = torch.where(same | ~ok_flat | dup.reshape(-1) | (q_cand_at_c <= 0), 0.0, 1e9)
            tmax_n = torch.where(same | ~ok_flat | (q_canon_at_n <= 0), 0.0, 1e9)
            occ2 = tracer.occluded(origins, dirs, torch.cat([tmax_c, tmax_n]), incoherent=True)
            vc2 = torch.where(same, rep(v_self), ~occ2[: P * nn]).reshape(P, nn)
            for j in range(1, nn):
                for i in range(j):
                    m = eq[i, j] & dup[:, j] & src_ok[:, i]
                    vc2[:, j] = torch.where(m, vc2[:, i], vc2[:, j])
            vis_c = vc2.reshape(-1)
            vis_n = torch.where(same, g[:, 38] > 0.5, ~occ2[P * nn:])
        else:
            tmax_pair = torch.where(ok_flat, 1e9, 0.0)
            occ2 = tracer.occluded(origins, dirs, torch.cat([tmax_pair, tmax_pair]),
                                   incoherent=True)
            vis_c = ~occ2[: P * nn]
            vis_n = ~occ2[P * nn:]
        q_cand_at_c = q_cand_at_c * vis_c
        q_canon_at_n = q_canon_at_n * vis_n

    kf = float(nn)
    m0 = _pairwise_mis(q_cand, q_cand_at_c, n_res.M * kf, rep(res.M))
    m1 = 1.0 - _pairwise_mis(q_canon_at_n, rep(p_canon), n_res.M * kf, rep(res.M))
    w_all = torch.where(ok_flat, q_cand_at_c * n_res.W * m0, 0.0).reshape(P, nn)
    M_all = torch.where(ok_flat, n_res.M * torch.minimum(_m_factor(q_cand, q_cand_at_c),
                                                        _m_factor(q_canon_at_n, rep(p_canon))),
                        0.0).reshape(P, nn)
    m1_all = torch.where(ok_flat, m1, 0.0).reshape(P, nn)
    ok_all = ok_flat.reshape(P, nn)
    q_at_c_all = q_cand_at_c.reshape(P, nn)
    ndir_all = n_res.dir.reshape(P, nn, 3)

    valid_count = torch.sum(ok_all, dim=1).to(torch.float32)
    # the canonical MIS weight starts at 1 and gathers the defensive terms;
    # these sums decide nothing, the stream below keeps the reference order
    canon_mis = 1.0 + torch.sum(m1_all, dim=1)
    M = torch.sum(M_all, dim=1)

    w_sum = torch.zeros((P,), device=dev)
    sel_dir = res.dir
    sel_p = torch.zeros((P,), device=dev)
    sel_canon = torch.ones((P,), dtype=torch.bool, device=dev)
    for i in range(nn):
        w = w_all[:, i]
        w_sum = w_sum + w
        pick = (us[i] * w_sum < w) & ok_all[:, i]
        sel_dir = torch.where(pick[:, None], ndir_all[:, i], sel_dir)
        sel_p = torch.where(pick, q_at_c_all[:, i], sel_p)
        sel_canon = sel_canon & ~pick

    w_c = p_canon * res.W * canon_mis
    M = M + res.M
    w_sum = w_sum + w_c
    pick_c = us[nn] * w_sum < w_c
    sel_dir = torch.where(pick_c[:, None], res.dir, sel_dir)
    sel_p = torch.where(pick_c, p_canon, sel_p)
    sel_canon = sel_canon | pick_c

    Wn = torch.where(sel_p > 0, (w_sum / (valid_count + 1.0)) / torch.clamp_min(sel_p, 1e-12), 0.0)
    Wn = torch.where(torch.isfinite(Wn), Wn, 0.0)
    out = Reservoir(dir=sel_dir, W=Wn, M=res.M, valid=(Wn > 0) & ctx.mask, p=sel_p)
    if v_self is not None and unbiased and tracer is not None:
        # a picked neighbour had its visibility multiplied into w, so it is
        # visible; a canonical winner carries v_self
        return out, torch.where(sel_canon, v_self, True)
    return out


def evaluate_final_samples(ctx: PixelCtx, res: Reservoir, env_tex: torch.Tensor,
                           tracer: Optional[Tracer], check_visibility: bool = True,
                           known_vis: Optional[torch.Tensor] = None) -> LightSample:
    """Winning reservoir -> LightSample with Li = W * Le * vis, differentiable
    with respect to env_tex (W is detached).  known_vis [P] bool: the
    winner's visibility threaded through the passes (no shadow ray)."""
    if known_vis is not None:
        vis = known_vis.to(torch.float32)
    elif check_visibility and tracer is not None:
        ok_ = res.valid & ctx.mask
        vis = (~tracer.occluded(ctx.position + ctx.normal * 1e-4, res.dir,
                                torch.where(ok_, 1e9, 0.0), incoherent=True)).to(torch.float32)
    else:
        vis = torch.ones((ctx.position.shape[0],), device=ctx.position.device)
    li = envlight.eval_le(env_tex, res.dir) * (res.W.detach() * vis)[:, None]
    ok = res.valid & ctx.mask
    return LightSample(dir=res.dir, distance=torch.where(ok, 1e9, 0.0),
                       Li=torch.where(ok[:, None], li, 0.0))
