"""Stage-1 forward frame (counterpart of mirres_restir_nerf_mesh_tpu/render/stage1.py
``render_stage1``).

Cluster rebuild from (base vertices + offsets), ray-cast G-buffer,
shading-normal prep, material + jittered smoothness taps, NeRF radiance
image, direct light per spp (one-sample MIS, or ReSTIR DI), no-grad
indirect bounces with NEE batched across spp, the EAW or bilateral
denoiser, composite, silhouette antialiasing and the normal-AO buffer, with
the reference's output dict.

ReSTIR: light tiles once per frame; initial RIS batched over all spp on
live lanes, its winners' visibility rays fused into the first NEE launch of
the indirect pass; then per spp, in order, temporal reuse, spatial reuse
(neighbours read from a full-frame record table by pixel index, cross
visibility in one launch) and the final sample, with visibility threaded
so the final sample traces nothing.  The chain runs once on the live
pixels; the reference's chunked chain exists for XLA's static shapes.

Randoms: every draw of the frame is one ``FrameRandoms`` (pixel space, row
per lane), drawn from a ``torch.Generator`` or passed in; the parity tests
pass the reference's own draws.

Data parallelism (``Stage1Static.dp``, the counterpart of the reference's
``shard_mesh``): the rays are this rank's band of whole image rows
(``frame_band``; at ssaa > 1 whole rows of the GT image), the randoms are
the whole frame's and the rank takes its rows of them.  The tracer sees
only the band's rays against the replicated mesh; the env sampler and the
light tiles are built on every rank from the replicated params.  Every
read across pixels sees the whole frame through ``parallel.mesh.gather_rows``
(whose gradient returns to the rank that owns the rows): the normal
smoothness taps, spatial reuse's neighbour records, the denoisers,
normal-AO and the silhouette antialiasing run on the gathered frame and
keep the band's rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..models import envlight
from ..models import material as material_mod
from ..models import nerf as nerf_model
from ..ops.tracer import build_tracer
from ..parallel import mesh as pmesh
from ..utils.compact import apply_in_chunks, masked_apply
from ..utils.profiling import count_sync, span
from . import pathtracer
from . import restir as restir_mod
from .gbuffer import prepare_shading_normal, raycast_gbuffer


class Stage1Params(NamedTuple):
    """Trainable state for stage 1 (the reference's three optimizer groups)."""

    nerf: Any                # radiance field params (dict of tensors)
    offsets: torch.Tensor    # [V,3] vertex offsets
    mat: Any                 # material field params
    env: torch.Tensor        # [H,W,3] envmap


@dataclass(frozen=True)
class Stage1Static:
    """Non-trainable per-scene state (the knobs of this slice)."""

    tris: Any                    # [F,3] int tensor
    nerf_spec: nerf_model.NeRFSpec
    mat_spec: material_mod.MaterialSpec
    spp: int = 4
    bounces: int = 2
    smooth_eps: float = 0.01     # jitter radius for smoothness taps
    enable_offset_nerf_grad: bool = False
    H: int = 0                   # pixel layout (0 = ray batch; ReSTIR and denoise need it)
    W: int = 0

    # ReSTIR DI
    use_restir: bool = False
    restir_tiles: int = 128
    restir_tile_size: int = 1024
    restir_light_samples: int = 32
    restir_brdf_samples: int = 1
    restir_neighbors: int = 5
    restir_radius: float = 30.0
    restir_offsets: int = 8192
    restir_history: float = 20.0
    restir_unbiased_spatial: bool = True

    # denoiser (0 = off; step width 2^(iters-1))
    denoise_iters: int = 0
    denoise_bilateral: bool = False
    c_phi: float = 1.0
    n_phi: float = 0.1
    p_phi: float = 0.1

    tracer: str = "auto"         # 'tile' ('auto'), 'cluster' or 'lbvh'
    cluster_size: int = 128
    max_candidates: int = 10     # cluster kind: cluster boxes tested a ray
    dense_threshold: int = 8192  # <=: single dense pass over all triangles
    k_cap: int = 128             # candidate clusters per ray tile
    k_cap_incoherent: int = 512  # same for bounce / shadow batches
    ray_tile: int = 512
    queue_avg: int = 64          # work budget (avg candidates per tile)
    queue_avg_incoherent: int = 64
    antialias: bool = True
    pos_gradient_boost: float = 1.0
    compute_normal_ao: bool = False   # screen-space AO buffer of the lambda_extra_kd loss
    compact_chunks: int = 4      # > 1: field, path and ReSTIR passes run on live lanes only
    ssaa: int = 1                # supersampling: H, W are the GT size times ssaa; the
                                 # train step box-downsamples the image buffers
    dp: Optional[pmesh.DataParallel] = None   # data parallelism: render this rank's band


class FrameRandoms(NamedTuple):
    """All random numbers of one frame, in pixel space (P pixels).  The
    direct field serves the one-sample MIS path, the restir_* fields the
    ReSTIR path (None where the frame does not use them)."""

    jitter: torch.Tensor     # [P,3] standard normal (material smoothness tap)
    tap: torch.Tensor        # [P,2] standard normal (normal smoothness tap)
    direct: Optional[torch.Tensor]   # [spp, P, 8] uniforms (pathtracer.DIRECT_U layout)
    indirect: torch.Tensor   # [spp*P, 5 + 10*bounces] uniforms
    restir_tiles: Optional[torch.Tensor] = None     # [tiles, tile_size, 2] light-tile uniforms
    restir_offsets: Optional[torch.Tensor] = None   # [restir_offsets, 2] disc (radius, angle)
    init_tile: Optional[torch.Tensor] = None        # [spp*P] int light tile
    init_blk: Optional[torch.Tensor] = None         # [spp*P] int candidate block
    init_us: Optional[torch.Tensor] = None          # [spp*P, 1+n_brdf] pick uniforms
    init_bu: Optional[torch.Tensor] = None          # [spp*P, 5*n_brdf] BRDF-sample uniforms
    temporal_u: Optional[torch.Tensor] = None       # [spp, P] temporal pick
    spatial_start: Optional[torch.Tensor] = None    # [spp, P] int disc-offset index
    spatial_us: Optional[torch.Tensor] = None       # [spp, nn+1, P] spatial picks

    def to(self, device) -> "FrameRandoms":
        return FrameRandoms(*(None if x is None else x.to(device) for x in self))


def frame_band(static: Stage1Static, gt: bool = False) -> Optional[pmesh.Shard]:
    """This rank's band of the frame (None without ``static.dp``): whole
    rows of the GT image, as a shard of the rendered pixels (``gt``: of the
    GT image's pixels)."""
    if static.dp is None:
        return None
    if static.H <= 0:
        raise ValueError("data parallelism needs the pixel layout (static.H, static.W)")
    s = max(static.ssaa, 1)
    rows = pmesh.shard_of(static.H // s, static.dp)
    return rows.scaled(static.W // s if gt else static.W * s)


def band_randoms(rand: FrameRandoms, spp: int, band: pmesh.Shard) -> FrameRandoms:
    """The band's rows of the whole frame's randoms (per-spp fields are
    spp-major: [spp * P] rows, or [spp, P] / [spp, k, P])."""
    lo, hi, P = band.lo, band.hi, band.n

    def rows(x):
        return None if x is None else x[lo:hi]

    def per_spp(x):
        return None if x is None else x.reshape((spp, P) + x.shape[1:])[:, lo:hi].reshape(
            (spp * (hi - lo),) + x.shape[1:])

    def last(x):
        return None if x is None else x[..., lo:hi]

    return rand._replace(
        jitter=rows(rand.jitter), tap=rows(rand.tap),
        direct=None if rand.direct is None else rand.direct[:, lo:hi],
        indirect=per_spp(rand.indirect), init_tile=per_spp(rand.init_tile),
        init_blk=per_spp(rand.init_blk), init_us=per_spp(rand.init_us),
        init_bu=per_spp(rand.init_bu), temporal_u=last(rand.temporal_u),
        spatial_start=last(rand.spatial_start), spatial_us=last(rand.spatial_us))


def full_frame(band: Optional[pmesh.Shard], *xs: torch.Tensor):
    """The whole frame of each per-pixel x (its band's rows on this rank):
    one ``gather_rows`` of them all (bool as float); the inputs unchanged
    without a band."""
    if band is None:
        return list(xs)
    flat = [x.reshape(x.shape[0], -1) for x in xs]
    g = pmesh.gather_rows(torch.cat([f.to(torch.float32) for f in flat], dim=1), band.dp,
                          band.counts)
    out, c = [], 0
    for x, f in zip(xs, flat):
        y = g[:, c:c + f.shape[1]]
        c += f.shape[1]
        y = y > 0.5 if x.dtype == torch.bool else y.to(x.dtype)
        out.append(y.reshape((g.shape[0],) + tuple(x.shape[1:])))
    return out


def draw_frame_randoms(P: int, static: Stage1Static, generator: Optional[torch.Generator],
                       device) -> FrameRandoms:
    g, dev = generator, device
    spp = static.spp
    # (the draw order of the one-sample MIS frame is that of earlier versions)
    jitter = torch.randn((P, 3), generator=g, device=dev)
    tap = torch.randn((P, 2), generator=g, device=dev)
    direct = (None if static.use_restir else
              torch.rand((spp, P, pathtracer.DIRECT_U), generator=g, device=dev))
    base = dict(jitter=jitter, tap=tap, direct=direct,
                indirect=torch.rand((spp * P, pathtracer.indirect_u_width(static.bounces)),
                                    generator=g, device=dev))
    if not static.use_restir:
        return FrameRandoms(**base)
    nl, nbs, nn = static.restir_light_samples, static.restir_brdf_samples, static.restir_neighbors
    return FrameRandoms(
        **base,
        restir_tiles=torch.rand((static.restir_tiles, static.restir_tile_size, 2), generator=g,
                                device=dev),
        restir_offsets=torch.rand((static.restir_offsets, 2), generator=g, device=dev),
        init_tile=torch.randint(0, static.restir_tiles, (spp * P,), generator=g, device=dev),
        init_blk=torch.randint(0, max(static.restir_tile_size // max(nl, 1), 1), (spp * P,),
                               generator=g, device=dev),
        init_us=torch.rand((spp * P, 1 + nbs), generator=g, device=dev),
        init_bu=torch.rand((spp * P, max(nbs, 1) * 5), generator=g, device=dev),
        temporal_u=torch.rand((spp, P), generator=g, device=dev),
        spatial_start=torch.randint(0, static.restir_offsets, (spp, P), generator=g, device=dev),
        spatial_us=torch.rand((spp, nn + 1, P), generator=g, device=dev),
    )


def _bilinear_tap(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H,W,C] at float pixel coords (clamped)."""
    H, W = img.shape[0], img.shape[1]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = torch.clamp_max(x0i + 1, W - 1), torch.clamp_max(y0i + 1, H - 1)
    flat = img.reshape(H * W, -1)
    top = flat[y0i * W + x0i] * (1 - fx) + flat[y0i * W + x1i] * fx
    bot = flat[y1i * W + x0i] * (1 - fx) + flat[y1i * W + x1i] * fx
    return top * (1 - fy) + bot * fy


def _jittered_tap_grad(tap_n: torch.Tensor, normal: torch.Tensor, mask: torch.Tensor,
                       H: int, W: int, std_uv: float = 0.005,
                       band: Optional[pmesh.Shard] = None) -> torch.Tensor:
    """Normal-smoothness tap: |normal(pixel + N(0, std_uv)*(W,H)) - normal|,
    weighted by mask * bilinear(mask); tap_n [P,2] standard normals; the P
    pixels are the frame's, or the band's (taps read the whole frame)."""
    lo = 0 if band is None else band.lo
    ar = torch.arange(lo, lo + normal.shape[0], device=normal.device)
    off = tap_n * std_uv
    x = (ar % W).to(torch.float32) + off[:, 0] * W
    y = (ar // W).to(torch.float32) + off[:, 1] * H
    mf = mask.to(torch.float32)
    nrm_all, mf_all = full_frame(band, normal, mf)
    nrm_tap = _bilinear_tap(nrm_all.reshape(H, W, 3), x, y)
    mask_tap = _bilinear_tap(mf_all.reshape(H, W, 1), x, y)[:, 0]
    return torch.sum(torch.abs(nrm_tap - normal), dim=-1) * (mf * mask_tap)


def render_stage1(params: Stage1Params, static: Stage1Static, base_verts: torch.Tensor,
                  rays_o: torch.Tensor, rays_d: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  rand: Optional[FrameRandoms] = None,
                  relight_env: Optional[torch.Tensor] = None,
                  albedo_scale: Optional[torch.Tensor] = None,
                  exposure_scale: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One forward frame over the pixel batch (rays_o, rays_d [P,3]); all
    tensors on one device.  rand: the frame's randoms (else drawn from
    ``generator``).  With ``static.dp``: the rays of this rank's band
    (``frame_band``), rand the whole frame's, the outputs the band's."""
    dev = rays_o.device
    P = rays_o.shape[0]
    SPP = static.spp
    tris = torch.as_tensor(static.tris, device=dev).long()
    verts = base_verts + params.offsets
    band = frame_band(static)
    if rand is None:
        rand = draw_frame_randoms(P if band is None else band.n, static, generator, dev)
    if band is not None:
        if P != band.hi - band.lo:
            raise ValueError(f"{P} rays for a band of {band.hi - band.lo} pixels")
        rand = band_randoms(rand, SPP, band)

    def mapply(fn, mask, args, fills):
        # live-lane compaction on the rule of the whole frame's row count
        total = mask.shape[0] if band is None else mask.shape[0] // P * band.n
        return masked_apply(fn, mask, args, fills, chunks=static.compact_chunks,
                            total_rows=total)

    tracer = build_tracer(
        verts.detach(), tris, kind=static.tracer, cluster_size=static.cluster_size,
        max_candidates=static.max_candidates, dense_threshold=static.dense_threshold,
        k_cap=static.k_cap, k_cap_incoherent=static.k_cap_incoherent, tile=static.ray_tile,
        queue_avg=static.queue_avg, queue_avg_incoherent=static.queue_avg_incoherent,
    )
    with span("gbuffer"):
        gb = raycast_gbuffer(verts, tris, tracer, rays_o, rays_d)
    normal = prepare_shading_normal(gb.view_dir, gb.normal, gb.face_normal)

    # material, jittered material and NeRF radiance on live lanes
    xyzs = gb.position
    xyzs_j = xyzs.detach() + rand.jitter * static.smooth_eps

    def field_queries(pos, pos_j, vdir):
        m = material_mod.sample_material(params.mat, pos, static.mat_spec)
        m_j = material_mod.sample_material(params.mat, pos_j, static.mat_spec)
        npts = pos if static.enable_offset_nerf_grad else pos.detach()
        return m, m_j, nerf_model.rgb_only(params.nerf, npts, vdir, static.nerf_spec)

    with span("fields"):
        mat, mat_j, nerf_rgb = mapply(field_queries, gb.mask, (xyzs, xyzs_j, gb.view_dir),
                                      fills=(0.5, 0.5, 0.0))
    kd, rough, metal = material_mod.split_material(mat)
    kd_j, rough_j, metal_j = material_mod.split_material(mat_j)
    msk = gb.mask[:, None]
    kd_grad = torch.abs(kd_j - kd) * msk
    ks_grad = torch.sum(torch.abs(torch.stack([rough_j - rough, metal_j - metal], -1)) * msk, dim=-1)
    if static.H > 0:
        normal_grad = _jittered_tap_grad(rand.tap, gb.normal, gb.mask, static.H, static.W,
                                         band=band)
    else:
        normal_grad = torch.sum(torch.abs(gb.normal - gb.face_normal), dim=-1) * gb.mask
    image = torch.where(msk, nerf_rgb, 1.0)

    # lighting
    env_tex = params.env if relight_env is None else relight_env
    env_dist = envlight.build_sampler(env_tex.detach())
    kd_shade = kd if albedo_scale is None else kd * albedo_scale[None, :]

    def material_fn(pts, stochastic_u=None):
        m = material_mod.sample_material(params.mat, pts, static.mat_spec, stochastic_u=stochastic_u)
        if albedo_scale is not None:
            m = torch.cat([m[:, 0:3] * albedo_scale[None, :], m[:, 3:]], dim=1)
        return m

    env_bg = envlight.eval_le(env_tex, gb.view_dir)

    def tile_spp(x):
        return torch.cat([x] * SPP, dim=0) if SPP > 1 else x

    mask_b = tile_spp(gb.mask)
    ctx = res0_b = None
    if static.use_restir:
        if static.H <= 0:
            raise ValueError("use_restir needs the pixel layout (static.H, static.W)")
        ctx = restir_mod.PixelCtx(position=xyzs.detach(), normal=normal.detach(),
                                  view_dir=gb.view_dir, kd=kd_shade.detach(),
                                  roughness=rough.detach(), metallic=metal.detach(),
                                  mask=gb.mask, depth=gb.depth.detach())
        with span("restir_initial"):
            res0_b = _initial_ris(static, rand, ctx, tile_spp, env_tex.detach(), env_dist,
                                  mapply)

    # indirect bounces, batched across all spp (no grad); with ReSTIR the
    # initial winners' visibility rays ride the first NEE launch
    def indirect_fn(m_c, pos_c, nrm_c, vd_c, kd_c, r_c, mt_c, u_c, *eo_c):
        out = pathtracer.render_indirect(
            m_c, pos_c, nrm_c, vd_c, kd_c, r_c, mt_c, tracer, verts.detach(), tris,
            material_fn, env_tex, env_dist, bounces=static.bounces, u=u_c,
            extra_occ=tuple(eo_c) if eo_c else None,
        )
        if not eo_c:
            return (out,)
        return out[0], out[1].to(torch.float32)[:, None]

    ind_args = (mask_b, tile_spp(xyzs.detach()), tile_spp(normal.detach()), tile_spp(gb.view_dir),
                tile_spp(kd_shade.detach()), tile_spp(rough.detach()), tile_spp(metal.detach()),
                rand.indirect)
    if res0_b is not None:
        ind_args += (tile_spp(ctx.position + ctx.normal * 1e-4), res0_b.dir,
                     torch.where(res0_b.valid, 1e9, 0.0))
    with span("indirect"):
        outs = mapply(indirect_fn, mask_b, ind_args, fills=(0.0, 0.0))
    sum_i = outs[0].reshape(SPP, P, 3).sum(dim=0)

    if static.use_restir:
        # an occluded initial winner is an invalidated reservoir
        init_occ = outs[1][:, 0] > 0.5
        res_b = res0_b._replace(W=torch.where(init_occ, 0.0, res0_b.W),
                                valid=res0_b.valid & ~init_occ)
        sum_d, sum_s = _restir_chain(static, rand, ctx, res_b, tracer, env_tex, normal, kd_shade,
                                     rough, metal, band)
    else:
        sum_d, sum_s = _direct_mis(static, rand, gb, xyzs, normal, kd_shade, rough, metal,
                                   env_tex, env_dist, tracer, mapply)
    uncertain_count = tracer.pop_telemetry()
    traced_total = tracer.pop_traced()
    inv = 1.0 / float(SPP)
    diffuse_light = sum_d * inv
    specular_light = sum_s * inv
    indirect = sum_i * inv

    def own(x):
        return x if band is None else x[band.lo:band.hi]

    # the whole frame's G-buffer for the image-space passes
    denoise = static.denoise_iters > 0 and static.H > 0
    want_ao = static.compute_normal_ao and static.H > 0
    if denoise or want_ao:
        nrm_f, pos_f, mask_f, depth_f = full_frame(band, normal.detach(), xyzs.detach(), gb.mask,
                                                   gb.depth.detach())

    # denoise diffuse / specular (differentiable) and indirect (no grad)
    if denoise:
        from .denoise import bilateral_denoise, eaw_denoise

        H, W = static.H, static.W

        def to2d(x):
            return x.reshape(H, W, -1)

        with span("denoise"):
            dif_f, spec_f, ind_f = full_frame(band, diffuse_light, specular_light,
                                              indirect.detach())
            n2, p2, m2 = to2d(nrm_f), to2d(pos_f), mask_f.reshape(H, W)
            sw = 2 ** (static.denoise_iters - 1)
            if static.denoise_bilateral:
                zdz = torch.stack([depth_f.reshape(H, W), torch.full((H, W), 2.0, device=dev)], -1)
                dif_f = bilateral_denoise(to2d(dif_f), n2, zdz)
                spec_f = bilateral_denoise(to2d(spec_f), n2, zdz)
                ind_f = bilateral_denoise(to2d(ind_f), n2, zdz).detach()
            else:
                eaw = dict(iterations=static.denoise_iters, step_width=sw, c_phi=static.c_phi,
                           n_phi=static.n_phi, p_phi=static.p_phi)
                dif_f = eaw_denoise(to2d(dif_f), n2, p2, m2, **eaw)
                spec_f = eaw_denoise(to2d(spec_f), n2, p2, m2, **eaw)
                ind_f = eaw_denoise(to2d(ind_f), n2, p2, m2, differentiable=False, **eaw)
            diffuse_light = own(dif_f.reshape(-1, 3))
            specular_light = own(spec_f.reshape(-1, 3))
            indirect = own(ind_f.reshape(-1, 3))

    image_brdf = kd_shade * (1.0 - metal[:, None]) * diffuse_light + specular_light + indirect
    image_brdf = torch.where(msk, image_brdf, env_bg)
    if exposure_scale is not None:
        image_brdf = image_brdf * exposure_scale

    weights_sum = gb.mask.to(torch.float32)
    if static.antialias and static.H > 0:
        from .antialias import antialias as aa_fn

        names = ("image", "image_brdf", "diffuse_light", "specular_light", "img_brdf_indirect")
        with span("antialias"):
            *vals, m_all, v0, v1, v2, o_all, d_all = full_frame(
                band, image, image_brdf, diffuse_light, specular_light, indirect.detach(),
                gb.mask, gb.tri_v0, gb.tri_v1, gb.tri_v2, rays_o, gb.view_dir)
            bufs, weights_sum = aa_fn(dict(zip(names, vals)), m_all, (v0, v1, v2), o_all, d_all,
                                      static.H, static.W, boost=static.pos_gradient_boost)
            bufs = {k: own(v) for k, v in bufs.items()}
            weights_sum = own(weights_sum)
        image, image_brdf = bufs["image"], bufs["image_brdf"]
        diffuse_light, specular_light = bufs["diffuse_light"], bufs["specular_light"]
        indirect = bufs["img_brdf_indirect"]

    nrm_ao = None
    if static.compute_normal_ao and static.H > 0:
        from .denoise import normal_ao

        nrm_ao = own(normal_ao(nrm_f.reshape(static.H, static.W, 3),
                               mask_f.reshape(static.H, static.W)).reshape(-1))

    return {
        "image": image,
        "image_brdf": image_brdf,
        "diffuse_light": diffuse_light,
        "specular_light": specular_light,
        "img_brdf_indirect": indirect,
        "weights_sum": weights_sum,
        "depth": gb.depth,
        "normal": normal,
        "kd": kd_shade,
        "ks": torch.stack([torch.zeros_like(rough), rough, metal], dim=-1),
        "kd_grad": kd_grad,
        "ks_grad": ks_grad,
        "normal_grad": normal_grad,
        "xyzs": xyzs,
        "mask": gb.mask,
        "face_id": gb.face_id,
        # rays whose result may lie in a budget-dropped candidate (> 0 =>
        # raise the k_cap / queue budgets)
        "uncertain_count": uncertain_count,
        # live lanes (t_max > t_min) entering tracer launches this frame
        "traced_rays": traced_total,
        **({"normal_ao": nrm_ao} if nrm_ao is not None else {}),
    }


def _direct_mis(static, rand, gb, xyzs, normal, kd_shade, rough, metal, env_tex, env_dist,
                tracer, mapply):
    """One-sample MIS direct light per spp on live lanes -> (sum_d, sum_s)."""
    P = gb.mask.shape[0]

    def direct_fn(pos, nrm, vd, m_c, kd_c, r_c, mt_c, nrm_d, kd_d, r_d, mt_d, u_c):
        light_c = pathtracer.sample_direct_mis(pos, nrm, vd, m_c, kd_c, r_c, mt_c,
                                               env_tex, env_dist, tracer, u=u_c)
        _, dv, sv = pathtracer.shade_direct(light_c, m_c, nrm_d, vd, kd_d, r_d, mt_d,
                                            torch.zeros_like(pos))
        return dv, sv

    sum_d = torch.zeros((P, 3), device=gb.mask.device)
    sum_s = torch.zeros((P, 3), device=gb.mask.device)
    for s in range(static.spp):
        with span("direct"):
            diff_s, spec_s = mapply(
                direct_fn, gb.mask,
                (xyzs.detach(), normal.detach(), gb.view_dir, gb.mask, kd_shade.detach(),
                 rough.detach(), metal.detach(), normal, kd_shade, rough, metal, rand.direct[s]),
                fills=(0.0, 0.0),
            )
        sum_d = sum_d + diff_s
        sum_s = sum_s + spec_s
    return sum_d, sum_s


# initial-RIS lanes per pass: bounds the [lanes, 32, 7] candidate gather and
# the target planes (rowwise, so the result does not depend on it)
RIS_LANES = 1 << 18


def _initial_ris(static, rand, ctx, tile_spp, env_tex, env_dist,
                 mapply) -> "restir_mod.Reservoir":
    """Light tiles, then initial RIS for all spp at once on live lanes ->
    the [spp*P] reservoirs (visibility not yet applied)."""
    nl, nbs = static.restir_light_samples, static.restir_brdf_samples
    tiles = restir_mod.generate_light_tiles(env_tex, env_dist, static.restir_tiles,
                                            static.restir_tile_size, rand.restir_tiles)

    def initial_fn(tid, blk, us, bu, *ctx_fields):
        r = restir_mod.initial_resampling(
            restir_mod.PixelCtx(*ctx_fields), tiles, env_tex, env_dist, tracer=None,
            n_light_samples=nl, n_brdf_samples=nbs, check_visibility=False,
            rand=restir_mod.InitialRandoms(
                tid[:, 0], blk[:, 0], us.T,
                [(bu[:, 5 * j], bu[:, 5 * j + 1:5 * j + 3], bu[:, 5 * j + 3:5 * j + 5])
                 for j in range(nbs)]),
        )
        return r.dir, r.W[:, None], r.M[:, None], r.valid.to(torch.float32)[:, None], r.p[:, None]

    ctx_b = [tile_spp(f) for f in ctx]
    r_dir, r_w, r_m, r_v, r_p = mapply(
        lambda *a: apply_in_chunks(initial_fn, a, RIS_LANES), ctx_b[6],
        (rand.init_tile[:, None], rand.init_blk[:, None], rand.init_us, rand.init_bu, *ctx_b),
        fills=(0.0, 0.0, 0.0, 0.0, 0.0))
    return restir_mod.Reservoir(dir=r_dir, W=r_w[:, 0], M=r_m[:, 0], valid=r_v[:, 0] > 0.5,
                                p=r_p[:, 0])


def _restir_chain(static, rand, ctx, res_b, tracer, env_tex, normal, kd_shade, rough, metal,
                  band=None):
    """The serial spp chain on live pixels: temporal, spatial, final sample
    and shading per spp -> full-frame (or the band's) (sum_d, sum_s).
    Spatial reuse reads its neighbours' records from the whole frame."""
    P = ctx.mask.shape[0]
    SPP = static.spp
    dev = ctx.mask.device
    P_rule = P if band is None else band.n
    if static.compact_chunks > 1 and P_rule % static.compact_chunks == 0:
        count_sync("restir_live", ctx.mask.is_cuda)
        live = torch.nonzero(ctx.mask)[:, 0]
    else:
        live = torch.arange(P, device=dev)
    L = live.shape[0]
    env_ng = env_tex.detach()
    pctx = restir_mod.PixelCtx(*(f[live] for f in ctx))
    p_norm, p_kd, p_rough, p_metal = normal[live], kd_shade[live], rough[live], metal[live]
    offsets = restir_mod.make_neighbor_offsets(rand.restir_offsets, static.restir_radius)
    thread_vis = static.restir_unbiased_spatial
    res_all = restir_mod.Reservoir(*(a.reshape((SPP, P) + tuple(a.shape[1:])) for a in res_b))
    prev_res = restir_mod.empty_reservoir(L, dev)
    prev_vis = torch.ones((L,), dtype=torch.bool, device=dev)
    ones = torch.ones((L,), dtype=torch.bool, device=dev)
    sum_d = torch.zeros((L, 3), device=dev)
    sum_s = torch.zeros((L, 3), device=dev)
    for s in range(SPP):
        res = restir_mod.Reservoir(*(a[s][live] for a in res_all))
        sp_rand = (rand.spatial_start[s][live], rand.spatial_us[s][:, live])
        with span("restir_temporal"):
            kw = dict(v_curr=ones, v_prev=prev_vis) if thread_vis else {}
            out = restir_mod.temporal_resampling(pctx, res, prev_res, pctx.normal, pctx.depth,
                                                 env_ng, rand.temporal_u[s][live],
                                                 max_history=static.restir_history, **kw)
            res, v_self = out if thread_vis else (out, None)
            rec = restir_mod.pack_spatial_record(pctx, res, v_self, env_tex=env_ng)
            packed = torch.zeros((P, rec.shape[1]), device=dev).index_put((live,), rec)
            packed, = full_frame(band, packed)
        with span("restir_spatial"):
            out = restir_mod.spatial_resampling(
                pctx, res, env_ng, static.H, static.W, offsets, sp_rand, tracer=tracer,
                n_neighbors=static.restir_neighbors, unbiased=thread_vis, v_self=v_self,
                packed=packed, pix_idx=live if band is None else live + band.lo)
        with span("restir_final"):
            if thread_vis:
                res, final_vis = out
                prev_res, prev_vis = res, final_vis
                light = restir_mod.evaluate_final_samples(pctx, res, env_tex, tracer,
                                                          known_vis=final_vis)
            else:
                res = prev_res = out
                light = restir_mod.evaluate_final_samples(pctx, res, env_tex, tracer)
            _, dval, sval = pathtracer.shade_direct(light, pctx.mask, p_norm, pctx.view_dir, p_kd,
                                                    p_rough, p_metal, torch.zeros_like(p_kd))
        sum_d = sum_d + dval
        sum_s = sum_s + sval
    zero = torch.zeros((P, 3), device=dev)
    return zero.index_put((live,), sum_d), zero.index_put((live,), sum_s)
