"""The per-frame RGBD depth chain as torch stencil ops.

Port of `bundlesdf_tpu/ops/preprocess.py` (the reference's CUDA chain,
`Frame.cpp:225-334` + `BundleTrack/src/cuda/CUDAImageUtil.cu`):
  erode -> 2x bilateral depth filter -> depth->xyz -> normals ->
  edge-aware depth filter -> recompute xyz -> mask invalidation.

A stencil gathers its (2r+1)^2 shifted neighbours into one stacked
(taps, H, W) tensor (one copy kernel), does the per-tap math on the whole
stack, and accumulates the taps in the JAX package's dy-major, dx-minor
order, so float32 sums round as its loop does.

Validity convention follows the reference: depth < 0.1 means invalid.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bundlesdf_tpu_torch.utils.profiling import span

_VALID_MIN = 0.1


def _neighbors(img, radius, fill):
    """(H,W[,C]) -> (taps,H,W[,C]) with tap (dy,dx) in dy-major order:
    out[t, y, x] = img[y+dy, x+dx], out-of-image -> @fill."""
    r = radius
    H, W = img.shape[:2]
    if img.dim() == 2:
        p = F.pad(img[None, None], (r, r, r, r), value=fill)[0, 0]
    else:
        p = F.pad(img.permute(2, 0, 1)[None], (r, r, r, r),
                  value=fill)[0].permute(1, 2, 0)
    taps = [p[r + dy:r + dy + H, r + dx:r + dx + W]
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    return torch.stack(taps)


def _ordered_sum(stack):
    """Sum over the leading (tap) axis in tap order."""
    acc = torch.zeros_like(stack[0])
    for t in range(stack.shape[0]):
        acc = acc + stack[t]
    return acc


def erode_depth(depth, radius=1, diff=0.001, ratio=0.8, zfar=1.0):
    """Depth erosion (ref CUDAImageUtil.cu:758-800 erodeDepthMapDevice):
    zero a pixel when the fraction of neighbors that are invalid or differ
    by more than `diff` is >= `ratio`; out-of-range centers are zeroed.
    Out-of-image neighbours are not counted as bad but still divide the
    tap count."""
    depth = depth.float()
    bad_center = (depth <= _VALID_MIN) | (depth > zfar)
    total = (2 * radius + 1) ** 2
    nb = _neighbors(depth, radius, float("nan"))
    inb = ~torch.isnan(nb)
    bad = inb & ((nb < _VALID_MIN) | (torch.abs(nb - depth) > diff))
    count = _ordered_sum(bad.float())
    out = torch.where(count / total >= ratio, 0.0, depth)
    return torch.where(bad_center, 0.0, out)


def bilateral_filter_depth(depth, radius=2, sigma_d=2.0, sigma_r=100000.0,
                           zfar=1.0):
    """Edge-preserving depth smoothing
    (ref CUDAImageUtil.cu:822-898 gaussFilterDepthMapDevice): neighbors must
    be valid, within zfar, and within 0.01 of the local mean; weights are
    gaussian in pixel distance and in depth difference to the center."""
    depth = depth.float()
    nb = _neighbors(depth, radius, 0.0)
    ok = (nb >= _VALID_MIN) & (nb <= zfar)
    mean_sum = _ordered_sum(torch.where(ok, nb, 0.0))
    mean_cnt = _ordered_sum(ok.float())
    mean_depth = mean_sum / torch.clamp(mean_cnt, min=1.0)

    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = 1.0 / (2.0 * sigma_r * sigma_r)
    with span("pull.track.preprocess"):  # a host->device copy: a wait
        d2 = torch.tensor([float(dy * dy + dx * dx)
                           for dy in range(-radius, radius + 1)
                           for dx in range(-radius, radius + 1)],
                          device=depth.device)[:, None, None]
    ok = ok & (torch.abs(nb - mean_depth) < 0.01)
    w = torch.exp(-d2 * inv_2sd2 - (depth - nb) ** 2 * inv_2sr2)
    w = torch.where(ok, w, 0.0)
    wsum = _ordered_sum(w)
    vsum = _ordered_sum(w * nb)
    return torch.where((wsum > 0.0) & (mean_cnt > 0.0),
                       vsum / torch.clamp(wsum, min=1e-12), 0.0)


def depth_to_xyz(depth, K):
    """Depth -> camera-space xyz map (invalid pixels keep z<0.1 semantics;
    ref CUDAImageUtil.cu:371 convertDepthFloatToCameraSpaceFloat4).
    @K: (3,3) float32 tensor on the depth's device."""
    H, W = depth.shape
    us = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    vs = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (us - K[0, 2]) * depth / K[0, 0]
    y = (vs - K[1, 2]) * depth / K[1, 1]
    return torch.stack([x, y, depth], dim=-1)


def compute_normals(xyz):
    """Camera-facing normals from central/one-sided differences with a 2cm
    z-continuity gate (ref CUDAImageUtil.cu:418-489 computeNormals_Kernel).
    Returns (H,W,3); invalid -> 0."""
    z_diff_thres = 0.02
    z = xyz[..., 2]
    CC = xyz
    nb = _neighbors(xyz, 1, 0.0)
    # ref naming: PC=(y+1,x), CP=(y,x+1), MC=(y-1,x), CM=(y,x-1)
    PC, CP, MC, CM = nb[7], nb[5], nb[1], nb[3]

    def pick_dir(plus, minus):
        ok_p = (plus[..., 2] >= _VALID_MIN) & (torch.abs(plus[..., 2] - z)
                                               <= z_diff_thres)
        ok_m = (minus[..., 2] >= _VALID_MIN) & (torch.abs(minus[..., 2] - z)
                                                <= z_diff_thres)
        d = torch.where((ok_p & ok_m)[..., None], plus - minus,
                        torch.where(ok_p[..., None], plus - CC,
                                    torch.where(ok_m[..., None], minus - CC,
                                                0.0)))
        return d, ok_p | ok_m

    x_dir, ok_x = pick_dir(PC, MC)
    y_dir, ok_y = pick_dir(CP, CM)
    n = torch.linalg.cross(x_dir, y_dir, dim=-1)
    length = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(length, min=1e-12)
    # orient toward camera
    flip = torch.sum(n * (-CC), dim=-1, keepdim=True) < 0
    n = torch.where(flip, -n, n)

    H, W = z.shape
    ys = torch.arange(H, device=z.device)[:, None]
    xs = torch.arange(W, device=z.device)[None, :]
    interior = (ys > 0) & (ys < H - 1) & (xs > 0) & (xs < W - 1)
    valid = (interior & (z >= _VALID_MIN) & ok_x & ok_y
             & (length[..., 0] > 0.0))
    return torch.where(valid[..., None], n, 0.0)


def filter_depth_edges(depth, normal, K, angle_thres_rad):
    """Zero depth where the normal is near-perpendicular to the viewing ray
    (grazing surfaces / depth edges; ref CUDAImageUtil.cu:1066-1097)."""
    xyz = depth_to_xyz(depth, K)
    view = xyz / torch.clamp(torch.linalg.norm(xyz, dim=-1, keepdim=True),
                             min=1e-12)
    nrm = normal / torch.clamp(torch.linalg.norm(normal, dim=-1,
                                                 keepdim=True), min=1e-12)
    dot = torch.clamp(torch.sum(nrm * view, dim=-1), -1.0, 1.0)
    angle = torch.arccos(dot)
    edge = torch.abs(angle - math.pi / 2.0) < angle_thres_rad
    return torch.where((depth >= _VALID_MIN) & ~edge, depth, 0.0)


def preprocess_depth_frame(depth, K, mask=None, erode_radius=1,
                           erode_diff=0.001, erode_ratio=0.8, bf_radius=2,
                           sigma_d=2.0, sigma_r=100000.0, zfar=1.0,
                           edge_angle_thres_rad=10.0 * math.pi / 180.0):
    """Full per-frame depth pipeline (ref Frame.cpp:24-334): erode ->
    bilateral x2 -> xyz -> normals -> edge filter -> optional mask
    invalidation (Frame.cpp:432-451) -> xyz again. @mask: (H,W) tensor or
    None. Returns (depth, xyz_map, normal_map), all (H,W[,3]) float32."""
    d = erode_depth(depth, radius=erode_radius, diff=erode_diff,
                    ratio=erode_ratio, zfar=zfar)
    d = bilateral_filter_depth(d, radius=bf_radius, sigma_d=sigma_d,
                               sigma_r=sigma_r, zfar=zfar)
    d = bilateral_filter_depth(d, radius=bf_radius, sigma_d=sigma_d,
                               sigma_r=sigma_r, zfar=zfar)
    xyz = depth_to_xyz(d, K)
    nrm = compute_normals(xyz)
    d = filter_depth_edges(d, nrm, K, edge_angle_thres_rad)
    if mask is not None:
        keep = mask > 0
        d = torch.where(keep, d, 0.0)
        nrm = torch.where(keep[..., None], nrm, 0.0)
    xyz = depth_to_xyz(d, K)
    nrm = torch.where((d >= _VALID_MIN)[..., None], nrm, 0.0)
    return d, xyz, nrm


def compute_covisibility(xyzA, normalA, validA, A_in_B, visible_angle_deg=70.0,
                         stride=2):
    """Fraction of frame A's valid points whose normals face camera B
    (ref Frame.h:122-165 computeCovisibility): transform A's cloud+normals by
    cur_in_kfcam = B_pose^-1 @ A_pose, count dot(-p_hat, n_hat) > cos(thres)."""
    xyz = xyzA[::stride, ::stride].reshape(-1, 3)
    nrm = normalA[::stride, ::stride].reshape(-1, 3)
    ok = validA[::stride, ::stride].reshape(-1)
    ok = ok & (torch.linalg.norm(nrm, dim=-1) > 1e-6)
    R = A_in_B[:3, :3]
    t = A_in_B[:3, 3]
    p = xyz @ R.T + t
    n = nrm @ R.T
    p_hat = -p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                             min=1e-12)
    n_hat = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-12)
    dot = torch.sum(p_hat * n_hat, dim=-1)
    thres = torch.cos(torch.deg2rad(torch.tensor(float(visible_angle_deg),
                                                 device=dot.device)))
    vis = torch.sum((dot > thres) & ok)
    total = torch.sum(ok)
    return vis.float() / (total.float() + 1e-7)
