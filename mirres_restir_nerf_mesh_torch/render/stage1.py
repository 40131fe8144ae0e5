"""Stage-1 forward frame (counterpart of mirres_restir_nerf_mesh_tpu/render/stage1.py
``render_stage1``, its ``use_restir=False`` branch).

Cluster rebuild from (base vertices + offsets), ray-cast G-buffer,
shading-normal prep, material + jittered smoothness taps, NeRF radiance
image, one-sample MIS direct light per spp, no-grad indirect bounces with
NEE batched across spp, composite and silhouette antialiasing, with the
reference's output dict.  ReSTIR, the denoisers and the normal-AO buffer
come in a later slice and raise NotImplementedError here.

Randoms: every draw of the frame is one ``FrameRandoms`` (pixel space, row
per lane), drawn from a ``torch.Generator`` or passed in; the parity tests
pass the reference's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..models import envlight
from ..models import material as material_mod
from ..models import nerf as nerf_model
from ..ops.tracer import build_tracer
from ..utils.compact import masked_apply
from . import pathtracer
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
    use_restir: bool = False     # not ported yet
    H: int = 0                   # pixel layout (0 = ray batch)
    W: int = 0
    denoise_iters: int = 0       # not ported yet
    tracer: str = "auto"         # 'auto' = 'tile'
    cluster_size: int = 128
    dense_threshold: int = 8192  # <=: single dense pass over all triangles
    k_cap: int = 128             # candidate clusters per ray tile
    k_cap_incoherent: int = 512  # same for bounce / shadow batches
    ray_tile: int = 512
    queue_avg: int = 64          # work budget (avg candidates per tile)
    queue_avg_incoherent: int = 64
    antialias: bool = True
    pos_gradient_boost: float = 1.0
    compute_normal_ao: bool = False   # not ported yet
    compact_chunks: int = 4      # > 1: field and path passes run on live lanes only


class FrameRandoms(NamedTuple):
    """All random numbers of one frame, in pixel space (P pixels)."""

    jitter: torch.Tensor     # [P,3] standard normal (material smoothness tap)
    tap: torch.Tensor        # [P,2] standard normal (normal smoothness tap)
    direct: torch.Tensor     # [spp, P, 8] uniforms (pathtracer.DIRECT_U layout)
    indirect: torch.Tensor   # [spp*P, 5 + 10*bounces] uniforms


def draw_frame_randoms(P: int, static: Stage1Static, generator: Optional[torch.Generator],
                       device) -> FrameRandoms:
    g, dev = generator, device
    return FrameRandoms(
        jitter=torch.randn((P, 3), generator=g, device=dev),
        tap=torch.randn((P, 2), generator=g, device=dev),
        direct=torch.rand((static.spp, P, pathtracer.DIRECT_U), generator=g, device=dev),
        indirect=torch.rand((static.spp * P, pathtracer.indirect_u_width(static.bounces)),
                            generator=g, device=dev),
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
                       H: int, W: int, std_uv: float = 0.005) -> torch.Tensor:
    """Normal-smoothness tap: |normal(pixel + N(0, std_uv)*(W,H)) - normal|,
    weighted by mask * bilinear(mask); tap_n [HW,2] standard normals."""
    HW = H * W
    ar = torch.arange(HW, device=normal.device)
    off = tap_n * std_uv
    x = (ar % W).to(torch.float32) + off[:, 0] * W
    y = (ar // W).to(torch.float32) + off[:, 1] * H
    mf = mask.to(torch.float32)
    nrm_tap = _bilinear_tap(normal.reshape(H, W, 3), x, y)
    mask_tap = _bilinear_tap(mf.reshape(H, W, 1), x, y)[:, 0]
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
    ``generator``)."""
    if static.use_restir:
        raise NotImplementedError("use_restir=True (ReSTIR DI) is not ported yet")
    if static.denoise_iters > 0:
        raise NotImplementedError("denoise_iters > 0 (EAW/bilateral) is not ported yet")
    if static.compute_normal_ao:
        raise NotImplementedError("compute_normal_ao is not ported yet")
    dev = rays_o.device
    P = rays_o.shape[0]
    SPP = static.spp
    tris = torch.as_tensor(static.tris, device=dev).long()
    verts = base_verts + params.offsets
    if rand is None:
        rand = draw_frame_randoms(P, static, generator, dev)

    tracer = build_tracer(
        verts.detach(), tris, kind=static.tracer, cluster_size=static.cluster_size,
        dense_threshold=static.dense_threshold, k_cap=static.k_cap,
        k_cap_incoherent=static.k_cap_incoherent, tile=static.ray_tile,
        queue_avg=static.queue_avg, queue_avg_incoherent=static.queue_avg_incoherent,
    )
    with record_function("gbuffer"):
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

    with record_function("fields"):
        mat, mat_j, nerf_rgb = masked_apply(field_queries, gb.mask, (xyzs, xyzs_j, gb.view_dir),
                                            fills=(0.5, 0.5, 0.0), chunks=static.compact_chunks)
    kd, rough, metal = material_mod.split_material(mat)
    kd_j, rough_j, metal_j = material_mod.split_material(mat_j)
    msk = gb.mask[:, None]
    kd_grad = torch.abs(kd_j - kd) * msk
    ks_grad = torch.sum(torch.abs(torch.stack([rough_j - rough, metal_j - metal], -1)) * msk, dim=-1)
    if static.H > 0:
        normal_grad = _jittered_tap_grad(rand.tap, gb.normal, gb.mask, static.H, static.W)
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

    # indirect bounces, batched across all spp (no grad)
    def tile_spp(x):
        return torch.cat([x] * SPP, dim=0) if SPP > 1 else x

    def indirect_fn(m_c, pos_c, nrm_c, vd_c, kd_c, r_c, mt_c, u_c):
        tot = pathtracer.render_indirect(
            m_c, pos_c, nrm_c, vd_c, kd_c, r_c, mt_c, tracer, verts.detach(), tris,
            material_fn, env_tex, env_dist, bounces=static.bounces, u=u_c,
        )
        return (tot,)

    mask_b = tile_spp(gb.mask)
    ind_args = (mask_b, tile_spp(xyzs.detach()), tile_spp(normal.detach()), tile_spp(gb.view_dir),
                tile_spp(kd_shade.detach()), tile_spp(rough.detach()), tile_spp(metal.detach()),
                rand.indirect)
    with record_function("indirect"):
        (sum_i_b,) = masked_apply(indirect_fn, mask_b, ind_args, fills=(0.0,),
                                  chunks=static.compact_chunks)
    sum_i = sum_i_b.reshape(SPP, P, 3).sum(dim=0)

    # one-sample MIS direct light per spp
    def direct_fn(pos, nrm, vd, m_c, kd_c, r_c, mt_c, nrm_d, kd_d, r_d, mt_d, u_c):
        light_c = pathtracer.sample_direct_mis(pos, nrm, vd, m_c, kd_c, r_c, mt_c,
                                               env_tex, env_dist, tracer, u=u_c)
        _, dv, sv = pathtracer.shade_direct(light_c, m_c, nrm_d, vd, kd_d, r_d, mt_d,
                                            torch.zeros_like(pos))
        return dv, sv

    sum_d = torch.zeros((P, 3), device=dev)
    sum_s = torch.zeros((P, 3), device=dev)
    for s in range(SPP):
        with record_function("direct"):
            diff_s, spec_s = masked_apply(
                direct_fn, gb.mask,
                (xyzs.detach(), normal.detach(), gb.view_dir, gb.mask, kd_shade.detach(),
                 rough.detach(), metal.detach(), normal, kd_shade, rough, metal, rand.direct[s]),
                fills=(0.0, 0.0), chunks=static.compact_chunks,
            )
        sum_d = sum_d + diff_s
        sum_s = sum_s + spec_s
    uncertain_count = tracer.pop_telemetry()
    traced_total = tracer.pop_traced()
    inv = 1.0 / float(SPP)
    diffuse_light = sum_d * inv
    specular_light = sum_s * inv
    indirect = sum_i * inv

    image_brdf = kd_shade * (1.0 - metal[:, None]) * diffuse_light + specular_light + indirect
    image_brdf = torch.where(msk, image_brdf, env_bg)
    if exposure_scale is not None:
        image_brdf = image_brdf * exposure_scale

    weights_sum = gb.mask.to(torch.float32)
    if static.antialias and static.H > 0:
        from .antialias import antialias as aa_fn

        bufs = {"image": image, "image_brdf": image_brdf, "diffuse_light": diffuse_light,
                "specular_light": specular_light, "img_brdf_indirect": indirect.detach()}
        with record_function("antialias"):
            bufs, weights_sum = aa_fn(bufs, gb.mask, (gb.tri_v0, gb.tri_v1, gb.tri_v2), rays_o,
                                      gb.view_dir, static.H, static.W,
                                      boost=static.pos_gradient_boost)
        image, image_brdf = bufs["image"], bufs["image_brdf"]
        diffuse_light, specular_light = bufs["diffuse_light"], bufs["specular_light"]
        indirect = bufs["img_brdf_indirect"]

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
    }
