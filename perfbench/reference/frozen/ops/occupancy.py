"""Dense occupancy grid over [-1,1]^3 and its fixed-step ray trace.

Port of `bundlesdf_tpu/ops/occupancy.py` (the replacement for the
reference's kaolin SPC octree, `Utils.py:359-475`, and its CUDA ray-trace
postprocess, `mycuda/common.cu:128-167`). The grid is built on the host
with numpy/scipy exactly as in the JAX package and then lives on the
device; the trace returns per-ray per-step occupancy over a static step
count.

The trace grid is `grid` dilated one extra voxel at res // trace_factor
(cell = OR of the fine block). With n_steps >= trace_res the midpoint
marcher provably never skips an occupied voxel (see the JAX module's
`OccupancyGrid.trace` note).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class OccupancyGrid:
    grid: torch.Tensor           # (res,res,res) bool -- the sampling grid
    res: int
    trace: torch.Tensor          # (tr,tr,tr) uint8 -- +1-dilated trace grid
    trace_res: int

    @property
    def voxel_size(self) -> float:
        return 2.0 / self.res


def build_occupancy_grid(pts, res: int, dilate_radius: int = 1,
                         trace_factor: int = 2, device=None) -> OccupancyGrid:
    """Voxelize normalized points into a (res,res,res) bool grid and dilate
    by `dilate_radius` voxels with a 27-neighborhood, matching the reference
    dilation loop (`nerf_runner.py:449-464`); also build the +1-dilated
    trace grid at res // trace_factor. @pts: (N,3) numpy in [-1,1]."""
    from scipy import ndimage

    pts = np.asarray(pts)
    coords = np.floor((pts + 1.0) / (2.0 / res)).astype(np.int64)
    coords = np.clip(coords, 0, res - 1)
    grid = np.zeros((res, res, res), bool)
    grid[coords[:, 0], coords[:, 1], coords[:, 2]] = True
    st = np.ones((3, 3, 3), bool)
    if dilate_radius > 0:
        grid = ndimage.binary_dilation(grid, iterations=dilate_radius,
                                       structure=st)
    f = max(1, int(trace_factor))
    while res % f:
        f -= 1
    tr = res // f
    coarse = grid.reshape(tr, f, tr, f, tr, f).any(axis=(1, 3, 5))
    trace = ndimage.binary_dilation(coarse, structure=st)
    return OccupancyGrid(
        grid=torch.as_tensor(grid, device=device), res=res,
        trace=torch.as_tensor(trace.astype(np.uint8), device=device),
        trace_res=tr)


def query_occupancy(grid: OccupancyGrid, pts, use_trace: bool = False):
    """True where a normalized point lies in an occupied voxel
    (replaces OctreeManager.get_center_ids>=0, Utils.py:392-395).
    @use_trace: query the +1-dilated trace grid instead."""
    if use_trace:
        g, res = grid.trace, grid.trace_res
    else:
        g, res = grid.grid, grid.res
    coords = torch.floor((pts + 1.0) * (res / 2.0)).long()
    inside = torch.all((coords >= 0) & (coords < res), dim=-1)
    coords = coords.clamp(0, res - 1)
    flat = (coords[..., 0] * res + coords[..., 1]) * res + coords[..., 2]
    occ = g.reshape(-1)[flat] != 0
    return occ & inside


def ray_trace_occupancy(grid: OccupancyGrid, rays_o, rays_d,
                        n_steps: int = 256):
    """March unit-direction rays through the grid with fixed steps.

    Returns dict with:
      t0, t1      -- (N, n_steps) step interval bounds (ray-parameter t)
      occ         -- (N, n_steps) bool, step midpoint in an occupied voxel
    (The JAX version also returns per-ray near/far/hit, which nothing reads.)
    """
    N = rays_o.shape[0]
    # ray/[-1,1]^3 intersection
    inv = 1.0 / torch.where(torch.abs(rays_d) < 1e-12,
                            torch.full_like(rays_d, 1e-12), rays_d)
    ta = (-1.0 - rays_o) * inv
    tb = (1.0 - rays_o) * inv
    tmin = torch.amax(torch.minimum(ta, tb), dim=-1)
    tmax = torch.amin(torch.maximum(ta, tb), dim=-1)
    tmin = torch.clamp(tmin, min=0.0)
    box_hit = tmax > tmin

    dt = (tmax - tmin) / n_steps  # (N,)
    steps = torch.arange(n_steps, dtype=torch.float32, device=rays_o.device)
    t0 = tmin[:, None] + steps[None, :] * dt[:, None]
    t1 = t0 + dt[:, None]
    tm = 0.5 * (t0 + t1)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * tm[..., None]  # (N,S,3)
    # query the +1-dilated trace grid: midpoint stepping at dt <= 2*voxel
    # then provably never skips an occupied voxel
    occ = query_occupancy(grid, pts.reshape(-1, 3),
                          use_trace=True).reshape(N, n_steps)
    occ = occ & box_hit[:, None]
    return {"t0": t0, "t1": t1, "occ": occ}
