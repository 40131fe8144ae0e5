"""Model FLOPs and kernel bytes.

- An MLP layer of ``fan_in x fan_out`` costs 2 fan_in fan_out FLOPs a row
  (a multiply and an add per weight); activations are not counted.
- A hash-grid encode costs 2 FLOPs per corner feature it interpolates:
  levels x corners x level_dim a row, with 8 corners for the exact
  trilinear encode and 1 for the one-corner stochastic one.
- Training costs 3 times the forward of the rows it differentiates (the
  forward, and a backward of twice its work: the gradient of the inputs
  and of the weights); rows evaluated without a gradient cost the forward.
- Kernel K4 (the hash-grid backward's scatter-add) has to read each
  update's values (4 bytes a channel) and its row index (4 bytes) once,
  and write each table row it touches once: at most min(table rows,
  updates) rows of 4 bytes a channel.

A step's model FLOPs come from its shapes alone (host integers: no
wrapper, no sync), term by term beside the call of the port that each
stands for; ``harness/counting.py``'s wrappers count the same calls where
they run, which the tests hold these counts to.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

TRAIN_FACTOR = 3


def mlp_flops(rows: int, shapes: Iterable[Sequence[int]]) -> int:
    return 2 * int(rows) * sum(int(i) * int(o) for i, o in shapes)


def hashgrid_flops(rows: int, levels: int, level_dim: int, stochastic: bool) -> int:
    corners = 1 if stochastic else 8
    return 2 * int(rows) * int(levels) * corners * int(level_dim)


def step_factor(differentiated: bool) -> int:
    return TRAIN_FACTOR if differentiated else 1


def k4_bytes(updates: int, channels: int, table_rows: int) -> int:
    rows_written = min(int(table_rows), int(updates))
    return int(updates) * (4 * int(channels) + 4) + rows_written * 4 * int(channels)


def mlp_shapes(in_dim: int, hidden: int, layers: int, out_dim: int) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each of an MLP's ``layers`` products."""
    dims = [int(in_dim)] + [int(hidden)] * (int(layers) - 1) + [int(out_dim)]
    return list(zip(dims, dims[1:]))


def nerf_shapes(spec) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """The radiance field's sigma and colour MLPs (``models/nerf.py``
    ``init_nerf``) from its ``NeRFSpec``."""
    g = spec.grid
    sigma = mlp_shapes(g.num_levels * g.level_dim, spec.hidden_dim, spec.num_layers,
                       1 + spec.geo_feat_dim)
    color = mlp_shapes(spec.sh_degree ** 2 + spec.geo_feat_dim, spec.hidden_dim_color,
                       spec.num_layers_color, 3)
    return sigma, color


def nerf_density_flops(rows: int, spec, stochastic: bool) -> int:
    """``models/nerf.py`` ``density``: the encode and the sigma MLP."""
    g = spec.grid
    return (hashgrid_flops(rows, g.num_levels, g.level_dim, stochastic)
            + mlp_flops(rows, nerf_shapes(spec)[0]))


def nerf_field_flops(rows: int, spec, stochastic: bool) -> int:
    """``models/nerf.py`` ``forward`` / ``rgb_only``: density, then the
    colour MLP."""
    return nerf_density_flops(rows, spec, stochastic) + mlp_flops(rows, nerf_shapes(spec)[1])


def material_flops(rows: int, spec, stochastic: bool) -> int:
    """``models/material.py`` ``sample_material``: the encode and the
    two-layer MLP."""
    g = spec.grid
    return (hashgrid_flops(rows, g.num_levels, g.level_dim, stochastic)
            + mlp_flops(rows, mlp_shapes(g.num_levels * g.level_dim, spec.hidden, 2,
                                         spec.channels)))


def field_rows(num_rays: int, samples: int, compact_points: Optional[int]) -> int:
    """Rows the stage-0 field evaluates for ``num_rays`` rays of ``samples``
    marched samples: the first ``compact_points`` of them where that is
    fewer (a copy of ``render/volume.py:32`` ``field_points``, not in sdf
    mode)."""
    n = int(num_rays) * int(samples)
    return int(compact_points) if compact_points is not None and compact_points < n else n


def stage0_step_flops(spec, rows: int, stochastic: bool) -> int:
    """One stage-0 train step: ``render/volume.py:76`` ``nerf_model.forward``
    on the step's ``rows``, differentiated (the parameters require their
    gradient)."""
    return step_factor(True) * nerf_field_flops(rows, spec, stochastic)


def occupancy_update_flops(spec, cascade: int, grid_size: int, stochastic: bool) -> int:
    """One occupancy update: ``train/stage0.py:403`` ``nerf_model.density``
    at every cell of each cascade, without a gradient."""
    return step_factor(False) * nerf_density_flops(int(cascade) * int(grid_size) ** 3, spec,
                                                   stochastic)


def stage1_step_flops(static) -> int:
    """A stage-1 train step's nominal FLOPs from its ``Stage1Static``: every
    pixel of the H x W frame counted, covered by the mesh or not, and every
    spp and bounce the static asks for, live or not (the port evaluates only
    covered pixels and the lanes they spawn, so this bounds its count from
    above and does not follow the view's coverage).

    - ``render/stage1.py:302`` and ``:303``: ``sample_material`` at the
      G-buffer position and at its jittered tap, exact encode,
      differentiated;
    - ``render/stage1.py:305``: ``nerf_model.rgb_only``, exact encode,
      differentiated (the field's parameters are trained);
    - ``render/pathtracer.py:160``: each bounce's ``material_fn`` on the spp
      x pixels lanes, one-corner encode, no gradient."""
    P = int(static.H) * int(static.W)
    fields = step_factor(True) * (2 * material_flops(P, static.mat_spec, False)
                                  + nerf_field_flops(P, static.nerf_spec, False))
    bounces = step_factor(False) * int(static.spp) * int(static.bounces) * material_flops(
        P, static.mat_spec, True)
    return fields + bounces


def roofline_share(bytes_moved: float, flops: float, seconds: float, peak_bytes_per_s: float,
                   peak_flops: float) -> float:
    """Percent of the roofline: the least time the chip could take (the
    larger of bytes / bandwidth and operations / peak) over the time
    taken."""
    least = max(bytes_moved / peak_bytes_per_s, flops / peak_flops)
    return 100.0 * least / seconds
