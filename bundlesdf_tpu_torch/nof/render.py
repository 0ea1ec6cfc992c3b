"""SDF volume rendering over occupancy-guided samples.

Port of `bundlesdf_tpu/nof/render.py`, the re-design of the reference render
path (`nerf_runner.py:1014-1224`): render_rays (occupancy trace + dual
sampling) -> field query -> raw2outputs (sdf2weights band-limited
compositing, :1132-1169).

Ray batches are dicts of tensors:
  dirs (N,3) GL-camera ray dirs (z=-1 plane), rgb (N,3), depth (N,),
  mask (N,), frame_id (N,) int, ray_type (N,), near (N,), far (N,)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from bundlesdf_tpu_torch.nof.models import pose_array_matrices
from bundlesdf_tpu_torch.ops.occupancy import OccupancyGrid, ray_trace_occupancy
from bundlesdf_tpu_torch.ops.sampling import (draw_occupied_samples,
                                              occupied_sampler_state,
                                              sample_pdf, sample_rays_uniform)


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (subset of config.yml keys)."""
    n_samples: int = 64               # N_samples along occupied voxels
    n_samples_around_depth: int = 64  # N_samples_around_depth
    trunc: float = 0.01               # * sc_factor at build time
    neg_trunc_ratio: float = 1.0
    sdf_lambda: float = 5.0
    near: float = 0.1                 # * sc_factor at build time
    far: float = 2.0                  # * sc_factor at build time
    n_trace_steps: int = 128          # DDA steps for the occupancy trace
    raw_noise_std: float = 0.0
    # hierarchical importance sampling (ref nerf_runner.py:1090-1126): PDF
    # resample from the composited weights, re-query, merge, recomposite
    n_importance: int = 0
    n_importance_iter: int = 1
    # bfloat16 MLP/SH compute during training (the reference trains under
    # torch AMP fp16, nerf_runner.py:159). Outputs and losses stay f32.
    compute_bf16: bool = True
    # per-sample SDF gradients ("normals") by central finite differences
    # for the eikonal loss (ref nerf_runner.py:734-738)
    eikonal: bool = False
    eikonal_eps: float = 1e-3


def render_rays(field, rcfg: RenderConfig, rays: dict, c2w,
                occ_grid: OccupancyGrid, generator=None, perturb: bool = True,
                trunc=None, trunc_inv=None):
    """Render a ray batch through @field (a NofField). @c2w: (F,4,4)
    normalized GL cam-to-object poses. @trunc: optional truncation
    (annealing); defaults to rcfg.trunc; a 0-dim device tensor comes with
    @trunc_inv (see `raw2outputs`). @generator: torch.Generator for
    the stratified jitter (unused when perturb is False and
    raw_noise_std is 0).

    Returns dict: rgb_map (N,3), sdf (N,S), z_vals (N,S), weights (N,S),
    valid_samples (N,S), tf (N,4,4), raw_rgb (N,S,3), pts_w (N,S,3).
    """
    if trunc is None:
        trunc = rcfg.trunc
    spec = field.spec
    dirs = rays["dirs"]
    N = dirs.shape[0]
    frame_ids = rays["frame_id"].long()
    depth = rays["depth"]

    # corrected camera-to-object transform (ref nerf_runner.py:1051-1053)
    tf = pose_array_matrices(field.pose_array, frame_ids, spec.max_trans,
                             spec.max_rot_deg) @ c2w[frame_ids]

    viewdirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_o_w = tf[:, :3, 3]
    viewdirs_w = torch.einsum("nij,nj->ni", tf[:, :3, :3], viewdirs)

    # DDA trace through the occupancy grid; t is euclidean along unit dir,
    # converted to z-depth by |dir_cam.z| (ref nerf_runner.py:991)
    tr = ray_trace_occupancy(occ_grid, rays_o_w, viewdirs_w,
                             n_steps=rcfg.n_trace_steps)
    dz = torch.abs(viewdirs[:, 2:3])
    t0 = tr["t0"] * dz
    t1 = tr["t1"] * dz

    # cap occupied segments at depth+trunc for valid-depth rays (ref :993-1000)
    valid_depth = (depth >= rcfg.near) & (depth <= rcfg.far)
    t_cap = torch.where(valid_depth, depth + trunc,
                        torch.full_like(depth, float("inf")))
    sampler = occupied_sampler_state(t0, t1, tr["occ"], t_cap=t_cap)
    z_occ = draw_occupied_samples(sampler, rcfg.n_samples, perturb=perturb,
                                  generator=generator)

    # samples around the measured depth (ref nerf_runner.py:1063-1080)
    if rcfg.n_samples_around_depth > 0:
        near_d = (depth - trunc)[:, None]
        far_d = (depth + trunc * rcfg.neg_trunc_ratio)[:, None]
        z_depth = sample_rays_uniform(near_d, far_d,
                                      rcfg.n_samples_around_depth,
                                      perturb=perturb, generator=generator)
        # invalid-depth rays fall back to occupancy-guided samples (the
        # t_cap clip is inf for them, so sharing the capped state is exact)
        z_inval = draw_occupied_samples(sampler, rcfg.n_samples_around_depth,
                                        perturb=perturb, generator=generator)
        z_depth = torch.where(valid_depth[:, None], z_depth, z_inval)
        z_vals = torch.cat([z_occ, z_depth], dim=-1)
    else:
        z_vals = z_occ

    # points in GL camera frame then to object space (ref run_network :1243)
    pts_cam = dirs[:, None, :] * z_vals[..., None]  # (N,S,3)
    S = z_vals.shape[-1]
    pts_w = (torch.einsum("nij,nsj->nsi", tf[:, :3, :3], pts_cam)
             + tf[:, None, :3, 3])

    compute_dtype = torch.bfloat16 if rcfg.compute_bf16 else torch.float32

    def query(z):
        """Field query at per-ray z samples -> (raw (N,S,4), valid (N,S))."""
        s = z.shape[-1]
        p_cam = dirs[:, None, :] * z[..., None]
        p_w = (torch.einsum("nij,nsj->nsi", tf[:, :3, :3], p_cam)
               + tf[:, None, :3, 3])
        valid = torch.all(torch.abs(p_w) <= 1.0, dim=-1)
        r = field(p_w.reshape(-1, 3),
                  viewdirs=torch.repeat_interleave(viewdirs_w, s, dim=0),
                  frame_ids=frame_ids, samples_per_ray=s,
                  compute_dtype=compute_dtype)
        return r.reshape(N, s, 4), valid

    raw, valid_samples = query(z_vals)
    normals = eik_sdf = eik_valid = None
    if rcfg.eikonal:
        # central-difference SDF gradient at the initial samples (the
        # reference computes normals only for the first network call,
        # nerf_runner.py:1086); one batched density query of 6*N*S points
        eps = rcfg.eikonal_eps
        p = pts_w.reshape(-1, 3)
        eye = torch.eye(3, dtype=p.dtype, device=p.device)
        offs = torch.cat([eye, -eye], dim=0) * eps  # (6,3)
        pq = (p[None, :, :] + offs[:, None, :]).reshape(-1, 3)
        # f32 compute regardless of amp: bf16 quantizes the +/-eps SDF
        # difference to zero in flat regions
        sq = field.sdf(pq, compute_dtype=torch.float32).reshape(6, -1)
        normals = ((sq[:3] - sq[3:]) / (2.0 * eps)).T.reshape(N, S, 3)
        # snapshot the matching sdf/validity: importance sampling below
        # may extend the per-ray sample axis past the normals' samples
        eik_sdf = raw[..., 3]
        eik_valid = valid_samples
    sdf = raw[..., 3]
    if rcfg.raw_noise_std > 0:
        sdf = sdf + torch.randn(sdf.shape, generator=generator,
                                device=sdf.device) * rcfg.raw_noise_std

    rgb_map, weights = raw2outputs(raw[..., :3], sdf, z_vals, depth, rcfg,
                                   valid_samples, trunc=trunc,
                                   trunc_inv=trunc_inv)

    # hierarchical importance sampling (ref nerf_runner.py:1090-1126)
    for _ in range(rcfg.n_importance_iter if rcfg.n_importance > 0 else 0):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_imp = sample_pdf(z_mid, weights[..., 1:-1], rcfg.n_importance,
                           det=not perturb, generator=generator)
        z_imp = torch.sort(z_imp.detach(), dim=-1).values
        raw_imp, valid_imp = query(z_imp)
        z_vals = torch.cat([z_vals, z_imp], dim=-1)
        z_vals, order = torch.sort(z_vals, dim=-1)
        raw = torch.gather(torch.cat([raw, raw_imp], dim=1), 1,
                           order[..., None].expand(-1, -1, 4))
        valid_samples = torch.gather(
            torch.cat([valid_samples, valid_imp], dim=-1), 1, order)
        sdf = raw[..., 3]
        rgb_map, weights = raw2outputs(raw[..., :3], sdf, z_vals, depth,
                                       rcfg, valid_samples, trunc=trunc,
                                       trunc_inv=trunc_inv)

    out = {"rgb_map": rgb_map, "sdf": sdf, "z_vals": z_vals,
           "weights": weights, "valid_samples": valid_samples, "tf": tf,
           "raw_rgb": raw[..., :3], "pts_w": pts_w}
    if normals is not None:
        out["normals"] = normals
        out["eik_sdf"] = eik_sdf
        out["eik_valid"] = eik_valid
    return out


def raw2outputs(rgb_logits, sdf, z_vals, depth, rcfg: RenderConfig,
                valid_samples, trunc=None, trunc_inv=None):
    """Band-limited SDF compositing (ref raw2outputs + sdf2weights
    nerf_runner.py:1132-1169): bell-shaped weights around the depth-derived
    zero crossing, truncated to [depth-trunc, depth+trunc*neg_ratio],
    zeroed for invalid depth, normalized. @trunc_inv: with a device
    truncation (a captured step's), float32(1 / trunc) computed on the host
    in double precision: CUDA divides by a host scalar as a product with
    that reciprocal, so the step gives the bits a float truncation gives."""
    if trunc is None:
        trunc = rcfg.trunc
    if trunc_inv is None:
        sdf_from_depth = (depth[:, None] - z_vals) / trunc
    else:
        sdf_from_depth = (depth[:, None] - z_vals) * trunc_inv
    w = (torch.sigmoid(sdf_from_depth * rcfg.sdf_lambda)
         * torch.sigmoid(-sdf_from_depth * rcfg.sdf_lambda))
    band = ((z_vals - depth[:, None] <= trunc * rcfg.neg_trunc_ratio)
            & (z_vals - depth[:, None] >= -trunc))
    depth_invalid = (depth > rcfg.far)[:, None]
    zero = torch.zeros_like(w)
    w = torch.where(depth_invalid, zero, torch.where(band, w, zero))
    w = torch.where(valid_samples, w, zero)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)
    rgb = torch.sigmoid(rgb_logits)
    rgb_map = torch.sum(w[..., None] * rgb, dim=-2)
    return rgb_map, w
