"""Stage-1 geometry / material / shading regularizers (counterpart of
mirres_restir_nerf_mesh_tpu/train/losses.py).

Mesh topology (edges, face adjacency, degree) is built once on the host with
numpy and passed in; the losses are gather / index_add programs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.math import cross, linear_to_srgb
from ..utils.profiling import count_upload


class MeshTopology(NamedTuple):
    """Static adjacency for the regularizers (host-precomputed)."""

    edges: np.ndarray        # [E, 2] unique undirected vertex pairs
    face_pairs: np.ndarray   # [P, 2] face indices sharing an edge
    degree: np.ndarray       # [V] vertex degree


def build_topology(tris: np.ndarray, num_verts: int) -> MeshTopology:
    tris = np.asarray(tris)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    edges, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    # faces sharing an edge: group the 3F edge slots by edge id
    face_ids = np.tile(np.arange(tris.shape[0]), 3)
    order = np.argsort(inv, kind="stable")
    inv_s, fid_s = inv[order], face_ids[order]
    pair = inv_s[1:] == inv_s[:-1]
    face_pairs = np.stack([fid_s[:-1][pair], fid_s[1:][pair]], axis=1)
    degree = np.zeros(num_verts, np.float32)
    np.add.at(degree, edges[:, 0], 1)
    np.add.at(degree, edges[:, 1], 1)
    return MeshTopology(edges=edges.astype(np.int32), face_pairs=face_pairs.astype(np.int32),
                        degree=degree)


def _t(a: np.ndarray, like: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    count_upload("topology", like.device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=like.device)


def laplacian_smooth_loss(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Uniform Laplacian: mean over vertices of ||deg*v - sum of neighbours||."""
    e = _t(topo.edges, verts)
    nb_sum = torch.zeros_like(verts).index_add(0, e[:, 0], verts[e[:, 1]])
    nb_sum = nb_sum.index_add(0, e[:, 1], verts[e[:, 0]])
    lap = _t(topo.degree, verts, torch.float32)[:, None] * verts - nb_sum
    return torch.mean(torch.linalg.norm(lap, dim=-1))


def _face_normals(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    n = cross(v1 - v0, v2 - v0)
    return n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)


def normal_consistency_loss(verts: torch.Tensor, tris, topo: MeshTopology) -> torch.Tensor:
    """Mean (1 - cos) between the normals of edge-adjacent faces."""
    n = _face_normals(verts, torch.as_tensor(tris, device=verts.device).long())
    fp = _t(topo.face_pairs, verts)
    return torch.mean(1.0 - torch.sum(n[fp[:, 0]] * n[fp[:, 1]], dim=-1))


def edge_length_loss(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Mean squared edge length (target 0)."""
    e = _t(topo.edges, verts)
    d = verts[e[:, 0]] - verts[e[:, 1]]
    return torch.mean(torch.sum(d * d, dim=-1))


def material_smoothness_grad(kd_grad, ks_grad, nrm_grad, lambda_kd: float, lambda_ks: float,
                             lambda_nrm: float, mean=torch.mean) -> torch.Tensor:
    """Jittered-tap material smoothness.  ``mean``: the mean over pixels
    (under data parallelism the whole frame's, ``parallel.mesh.global_mean``),
    as in the two losses below."""
    loss = mean(torch.mean(kd_grad[..., 0:3], dim=-1)) * lambda_kd
    loss = loss + mean(ks_grad) * lambda_ks
    return loss + mean(nrm_grad) * lambda_nrm


def _luma3(x):
    return torch.mean(x[..., 0:3], dim=-1, keepdim=True)


def _value3(x):
    return torch.amax(x[..., 0:3], dim=-1, keepdim=True)


def shading_loss(diffuse_light, specular_light, color_ref, lambda_diffuse: float,
                 lambda_specular: float, mean=torch.mean) -> torch.Tensor:
    """Monochrome-shading regularizer: log-tonemapped diffuse+specular luma
    towards the reference's value channel, weighted by the diffuse share,
    plus a specular-vs-diffuse energy ratio."""
    eps = 1e-3
    d_luma, s_luma = _luma3(diffuse_light), _luma3(specular_light)
    ref = _value3(color_ref)
    img = linear_to_srgb(torch.log(torch.clamp(d_luma + s_luma, 0.0, 65535.0) + 1.0))
    target = linear_to_srgb(torch.log(torch.clamp(ref, 0.0, 65535.0) + 1.0))
    err = torch.abs(img - target) * d_luma / torch.clamp_min(d_luma + s_luma, eps)
    loss = mean(err) * lambda_diffuse
    return loss + mean(s_luma) / torch.clamp_min(mean(d_luma), eps) * lambda_specular


def chroma_loss(kd, color_ref, lam: float, mean=torch.mean) -> torch.Tensor:
    """Chroma match between albedo and reference."""
    eps = 1e-3
    ref_c = color_ref[..., 0:3] / torch.clamp_min(_value3(color_ref), eps)
    opt_c = kd[..., 0:3] / torch.clamp_min(_value3(kd), eps)
    return mean(torch.abs(opt_c - ref_c)) * lam


def offsets_loss(offsets: torch.Tensor, inner_count: Optional[int] = None) -> torch.Tensor:
    """L2 on vertex offsets, outer-cascade vertices down-weighted x0.1."""
    if inner_count is None or inner_count >= offsets.shape[0]:
        return torch.mean(torch.sum(offsets ** 2, dim=-1))
    inner = torch.mean(torch.sum(offsets[:inner_count] ** 2, dim=-1))
    outer = torch.mean(torch.sum(offsets[inner_count:] ** 2, dim=-1))
    return inner + 0.1 * outer
