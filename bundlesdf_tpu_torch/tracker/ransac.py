"""Batched-trial RANSAC rigid pose estimation, batched over pairs.

Port of `bundlesdf_tpu/tracker/ransac.py` (re-design of the reference's
per-pair CUDA-stream RANSAC, `cuda_ransac.cu:1368-1616` + host
`FeatureManager.cpp:1587-1713`). Semantics preserved:
  - 3-point samples over the valid matches, trials with repeated indices
    discarded (:1386)
  - Kabsch model fit per trial (exact SVD here; the JAX package runs a
    20-step power iteration, so single trial poses differ by its
    convergence error, not the inlier sets)
  - inlier = dist <= thres AND normal angle within thres, conf-weighted
    count (:1417-1444)
  - trials whose pose exceeds per-pair max trans/rot caps are zeroed
    (:1482-1505); inputs are model-frame points so the pose is a correction
    around identity
  - best trial by weighted inlier count (the first on ties); its inlier
    set is returned

Sample indices are drawn on the device from a `torch.Generator` seeded by
the caller, or injected (`sample_idx`) — the parity tests inject the
indices JAX's threefry drew.
"""
from __future__ import annotations

import torch

from bundlesdf_tpu_torch.utils.profiling import span
from bundlesdf_tpu_torch.utils.se3 import kabsch


def draw_samples(valid, n_trials: int, seed: int):
    """(P, n_trials, 3) int64 indices into each pair's valid-first order,
    uniform in [0, max(n_valid, 1)), from a device generator seeded by
    @seed."""
    P = valid.shape[0]
    count = torch.clamp(valid.sum(-1), min=1)
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(int(seed))
    u = torch.rand((P, n_trials, 3), generator=gen, device=valid.device)
    idx = (u * count[:, None, None]).long()
    return torch.minimum(idx, (count - 1)[:, None, None])


def ransac_pose(ptsA, ptsB, normalsA, normalsB, conf, valid, dist_thres,
                cos_normal_angle, max_trans, max_rot, n_trials: int = 2000,
                seed: int = 0, sample_idx=None):
    """@ptsA/@ptsB/@normalsA/@normalsB: (P,M,3) correspondence points and
    normals in the MODEL frame; @conf (P,M); @valid (P,M) bool, padded rows
    False; @max_trans/@max_rot: (P,) caps. @sample_idx: optional
    (P, n_trials, 3) integer draws in [0, n_valid) replacing the seeded
    draw. Returns dict: best_pose (P,4,4), inlier_mask (P,M), n_inliers
    (P,)."""
    P, M, _ = ptsA.shape
    if sample_idx is None:
        sample_idx = draw_samples(valid, n_trials, seed)
    # valid first, in index order (a stable sort, as jnp.argsort is)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    idx3 = torch.gather(order, 1, sample_idx.long().reshape(P, -1))
    idx3 = idx3.reshape(P, -1, 3)                             # (P,T,3)
    distinct = ((idx3[..., 0] != idx3[..., 1])
                & (idx3[..., 1] != idx3[..., 2])
                & (idx3[..., 0] != idx3[..., 2]))

    def take(a):
        g = torch.gather(a, 1, idx3.reshape(P, -1, 1).expand(-1, -1, 3))
        return g.reshape(P, -1, 3, 3)

    with span("pull.track.kabsch"):  # the batched SVD waits for the card
        poses = kabsch(take(ptsA), take(ptsB))                # (P,T,4,4)

    # inlier eval: (P,T,M)
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    pA_tf = torch.einsum("ptij,pmj->ptmi", R, ptsA) + t[:, :, None, :]
    dist = torch.linalg.norm(pA_tf - ptsB[:, None], dim=-1)
    nA_tf = torch.einsum("ptij,pmj->ptmi", R, normalsA)
    ndot = torch.sum(nA_tf * normalsB[:, None], dim=-1)
    inlier = ((dist <= dist_thres) & (ndot >= cos_normal_angle)
              & valid[:, None])
    score = torch.sum(inlier * conf[:, None], dim=-1)         # (P,T)

    # pose-magnitude caps vs identity (correction should be small)
    trans_mag = torch.linalg.norm(t, dim=-1)
    cos_r = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2,
                        -1, 1)
    rot_mag = torch.arccos(cos_r)
    ok = (distinct & (trans_mag <= max_trans[:, None])
          & (rot_mag <= max_rot[:, None]))
    score = torch.where(ok, score, 0.0)

    best = torch.argmax(score, dim=1)                         # (P,)
    ar = torch.arange(P, device=best.device)
    best_score = score[ar, best]
    return {
        "best_pose": poses[ar, best],
        "inlier_mask": inlier[ar, best] & (best_score > 0)[:, None],
        "n_inliers": best_score,
    }
