"""NOF losses: truncated-SDF objective + rgb + regularizers.

Line-for-line port of `bundlesdf_tpu/nof/losses.py`, which keeps the exact
semantics of the reference loss assembly (`nerf_runner.py:679-752`,
`nerf_helpers.py:367-399` get_masks/get_sdf_loss). All reductions are
masked means over static-shape tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossConfig:
    rgb_weight: float = 10.0
    fs_weight: float = 100.0
    empty_weight: float = 0.01
    trunc_weight: float = 6000.0
    fs_rgb_weight: float = 0.0
    eikonal_weight: float = 0.0
    feature_reg_weight: float = 0.1
    pose_reg_weight: float = 0.0
    first_frame_weight: float = 1.0
    fs_sdf: float = 0.001
    near: float = 0.1   # * sc_factor at build time
    far: float = 2.0    # * sc_factor at build time
    neg_trunc_ratio: float = 1.0


def sdf_losses(z_vals, target_d, sdf, truncation, lcfg: LossConfig,
               sample_weights):
    """Free-space + empty + truncation losses (ref get_sdf_loss
    nerf_helpers.py:385-399 with get_masks :367-381).

    @z_vals, @sdf, @sample_weights: (N,S); @target_d: (N,).
    Returns (fs_loss_incl_empty, sdf_loss) with the reference's 0.5 weights
    folded in (fs_weight=0.5, sdf_weight=0.5 from get_masks).
    """
    d = target_d[:, None]
    valid_depth = (d >= lcfg.near) & (d <= lcfg.far)
    front = z_vals < d - truncation
    back = z_vals > d + truncation * lcfg.neg_trunc_ratio
    sdf_mask = (~front) & (~back) & valid_depth

    # rays whose measured depth is beyond far: push sdf up to fs_sdf
    m1 = (d > lcfg.far) & (sdf < lcfg.fs_sdf)
    fs_loss = torch.mean(((sdf - lcfg.fs_sdf) * m1) ** 2 * sample_weights) * 0.5

    # free space before the surface: sdf -> 1 (L1)
    m2 = front & (d <= lcfg.far) & (sdf < 1.0)
    empty_loss = torch.mean(torch.abs(sdf - 1.0) * m2 * sample_weights) \
        * lcfg.empty_weight
    fs_total = fs_loss + empty_loss

    # truncation region: predicted zero crossing z + sdf*trunc matches depth
    sdf_loss = torch.mean(((z_vals + sdf * truncation) * sdf_mask
                           - d * sdf_mask) ** 2 * sample_weights) * 0.5
    return fs_total, sdf_loss


def nof_loss(out: dict, rays: dict, field, truncation: float,
             lcfg: LossConfig):
    """Total training loss for one rendered batch (ref train_loop
    nerf_runner.py:679-752). @field: the NofField whose regularized
    parameters enter the loss. Returns (loss, metrics dict)."""
    rgb_map = out["rgb_map"]
    sdf = out["sdf"]
    z_vals = out["z_vals"]
    valid_samples = out["valid_samples"].float()

    frame_ids = rays["frame_id"]
    ray_type = rays["ray_type"]
    valid_rays = (torch.any(valid_samples > 0, dim=-1)
                  & (ray_type == 0)).float()
    ray_weights = torch.where(frame_ids == 0,
                              torch.full_like(valid_rays, lcfg.first_frame_weight),
                              torch.ones_like(valid_rays))
    ray_weights = ray_weights * valid_rays
    sample_weights = ray_weights[:, None] * valid_samples
    sample_weights = torch.where((ray_type == 1)[:, None],
                                 torch.zeros_like(sample_weights),
                                 sample_weights)

    img_loss = torch.mean((rgb_map - rays["rgb"]) ** 2 * ray_weights[:, None])
    rgb_loss = lcfg.rgb_weight * img_loss

    fs_loss, sdf_loss = sdf_losses(z_vals, rays["depth"], sdf, truncation,
                                   lcfg, sample_weights)
    fs_loss = fs_loss * lcfg.fs_weight
    sdf_loss = sdf_loss * lcfg.trunc_weight
    loss = rgb_loss + fs_loss + sdf_loss

    metrics = {"rgb_loss": rgb_loss, "fs_loss": fs_loss, "sdf_loss": sdf_loss}

    if lcfg.fs_rgb_weight > 0:
        front = z_vals < rays["depth"][:, None] - truncation
        fs_rgb = torch.mean(((torch.sigmoid(out["raw_rgb"]) - 1.0)
                             * front[..., None]) ** 2
                            * sample_weights[..., None])
        loss = loss + fs_rgb * lcfg.fs_rgb_weight
        metrics["fs_rgb_loss"] = fs_rgb * lcfg.fs_rgb_weight

    if lcfg.eikonal_weight > 0 and "normals" in out:
        # ref nerf_runner.py:734-738: ((|grad sdf| - 1)^2) over samples with
        # sdf < 1 (the near-surface band); masked mean over valid samples
        m = ((out["eik_sdf"] < 1.0) & out["eik_valid"]).float()
        # safe norm: |grad sdf| can be exactly 0 at init (flat field)
        nrm = torch.sqrt(torch.sum(out["normals"] ** 2, dim=-1) + 1e-12)
        eik = (torch.sum((nrm - 1.0) ** 2 * m) / (torch.sum(m) + 1e-9)
               * lcfg.eikonal_weight)
        loss = loss + eik
        metrics["eikonal_loss"] = eik

    if field.spec.frame_features > 0:
        reg = lcfg.feature_reg_weight * torch.mean(field.feature_array ** 2)
        loss = loss + reg
        metrics["feature_reg"] = reg

    if lcfg.pose_reg_weight > 0:
        reg = lcfg.pose_reg_weight * torch.linalg.norm(field.pose_array[1:])
        loss = loss + reg
        metrics["pose_reg"] = reg

    metrics["loss"] = loss
    return loss, metrics
