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
"""

from __future__ import annotations

from typing import Iterable, Sequence

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


def nominal_rays(H: int, W: int, spp: int, neighbors: int, bounces: int,
                 unbiased_spatial: bool = True) -> int:
    """bench.py's nominal rays of a stage-1 frame (a copy of
    ``mirres_restir_nerf_mesh_torch/bench.py:rays_per_frame``): the primary
    G-buffer, then per spp the initial and final visibility, 2 x neighbours
    cross visibility and a closest hit + NEE shadow a bounce."""
    spatial = (2 * neighbors) if unbiased_spatial else 0
    return H * W * (1 + spp * (1 + spatial + 1 + 2 * bounces))


def roofline_share(bytes_moved: float, flops: float, seconds: float, peak_bytes_per_s: float,
                   peak_flops: float) -> float:
    """Percent of the roofline: the least time the chip could take (the
    larger of bytes / bandwidth and operations / peak) over the time
    taken."""
    least = max(bytes_moved / peak_bytes_per_s, flops / peak_flops)
    return 100.0 * least / seconds
