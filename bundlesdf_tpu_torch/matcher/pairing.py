"""Frame-pair canonicalization for the matcher.

Port of `bundlesdf_tpu/matcher/pairing.py` (ref `processImagePair`,
FeatureManager.cpp:126-257): rotate frame B into frame A's in-plane
orientation (the camera-Z component of the relative rotation under the
current pose estimates), crop each foreground ROI with a 10 px margin,
scale both to a shared square `out_size`, and keep the 3x3 pixel
transforms so matches map back to full-resolution coordinates.

The transforms are float64 numpy, computed as the JAX package computes
them; its three cv2 calls are replaced: `cv2.Rodrigues` by
`utils/se3.py::so3_log_np` (the same arithmetic), `cv2.cvtColor` by
`matcher/orb.py::rgb_to_gray`, and `cv2.warpPerspective` (INTER_LINEAR,
constant-0 border) by `warp_perspective`, a torch gather on the
matcher's device in the arithmetic of OpenCV 5's float32 warp, bit-equal
to it on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from bundlesdf_tpu_torch.matcher.orb import rgb_to_gray
from bundlesdf_tpu_torch.utils.se3 import so3_log_np


def mask_roi(mask, pad=0):
    """Bounding box of the foreground mask: (umin, umax, vmin, vmax), from
    the rows and columns that hold any foreground (a pass over the mask,
    not the list of its foreground pixels)."""
    fg = np.asarray(mask) > 0
    vs = np.flatnonzero(fg.any(axis=1))
    us = np.flatnonzero(fg.any(axis=0))
    if len(vs) == 0:
        H, W = fg.shape[:2]
        return np.array([0, W - 1, 0, H - 1])
    return np.array([max(us[0] - pad, 0), us[-1] + pad,
                     max(vs[0] - pad, 0), vs[-1] + pad])


def _rotate_image_transform(H, W, angle_rad):
    """In-plane rotation about the image center as a 3x3 pixel transform
    (ref Utils::getRotateImageTransform)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    cx, cy = W / 2.0, H / 2.0
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    T2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
    return T2 @ R @ T1


def pair_transforms(H, W, roiA, roiB, poseA, poseB, out_size=400,
                    margin=10):
    """The 3x3 full-res -> crop pixel transforms (tfA, tfB) of a pair.
    @H/@W: frame B's size; @roiA/@roiB: (4,) mask bboxes; @poseA/@poseB:
    current cam-in-model poses."""
    tfA = np.eye(3)
    tfB = np.eye(3)

    # rotate B into A's in-plane orientation: z-component of axis-angle of
    # RA @ RB^-1 with R = pose[:3,:3].T (ob-in-cam rotations)
    RA = np.asarray(poseA)[:3, :3].T
    RB = np.asarray(poseB)[:3, :3].T
    rvec = so3_log_np(RA @ RB.T)
    tfB = _rotate_image_transform(H, W, float(rvec[2])) @ tfB

    corners = np.array([[roiB[0], roiB[2], 1], [roiB[0], roiB[3], 1],
                        [roiB[1], roiB[2], 1], [roiB[1], roiB[3], 1]],
                       np.float64)
    tc = (tfB @ corners.T).T
    umin, vmin = tc[:, 0].min(), tc[:, 1].min()
    umax, vmax = tc[:, 0].max(), tc[:, 1].max()

    tA = np.eye(3)
    tA[0, 2] = -roiA[0] + margin
    tA[1, 2] = -roiA[2] + margin
    tfA = tA @ tfA
    tB = np.eye(3)
    tB[0, 2] = -umin + margin
    tB[1, 2] = -vmin + margin
    tfB = tB @ tfB

    WA = roiA[1] - roiA[0] + margin * 2
    HA = roiA[3] - roiA[2] + margin * 2
    WB = umax - umin + margin * 2
    HB = vmax - vmin + margin * 2
    max_dim = max(WA, HA, WB, HB)
    sA = np.eye(3)
    sA[:2, :2] *= max_dim / max(WA, HA)
    tfA = sA @ tfA
    sB = np.eye(3)
    sB[:2, :2] *= max_dim / max(WB, HB)
    tfB = sB @ tfB
    so = np.eye(3)
    so[:2, :2] *= out_size / max_dim
    return so @ tfA, so @ tfB


def warp_matrix(tf):
    """The float32 destination -> source map that cv2.warpPerspective
    samples with for the forward transform @tf: @tf rounded to float32,
    inverted in float64 by cv2's closed-form 3x3 inverse (its `invert`
    for n = 3), then rounded to float32. Returns (9,) float32."""
    S = [[float(v) for v in row] for row in np.asarray(tf, np.float32)]
    det = (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
           - S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0])
           + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    d = 1.0 / det
    t = [(S[1][1] * S[2][2] - S[1][2] * S[2][1]) * d,
         (S[0][2] * S[2][1] - S[0][1] * S[2][2]) * d,
         (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * d,
         (S[1][2] * S[2][0] - S[1][0] * S[2][2]) * d,
         (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * d,
         (S[0][2] * S[1][0] - S[0][0] * S[1][2]) * d,
         (S[1][0] * S[2][1] - S[1][1] * S[2][0]) * d,
         (S[0][1] * S[2][0] - S[0][0] * S[2][1]) * d,
         (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * d]
    return np.array(t, np.float32)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def warp_perspective(src, index, mats, out_size):
    """cv2.warpPerspective(src[index[k]], tf_k, (out_size, out_size),
    INTER_LINEAR, BORDER_CONSTANT 0) for every k, as one gather.

    @src: (F,H,W) uint8; @index: (B,) int64 frame of each output; @mats:
    (B,9) float32 `warp_matrix`es, all on one device. Returns (B,S,S)
    uint8. The arithmetic is OpenCV 5's float32 path: per output pixel
    sx = fma(x, M0, float32(y*M1) + M2) (likewise sy and w), both divided
    by w; taps at floor(sx), floor(sy), a tap off the image reads 0; two
    horizontal fused lerps then a vertical one; rounded half to even."""
    F_, H, W = src.shape
    B = mats.shape[0]
    dev = src.device
    ar = torch.arange(out_size, dtype=torch.float32, device=dev)
    x = ar[None, None, :]
    y = ar[None, :, None]
    M = [mats[:, i, None, None] for i in range(9)]
    w = _fma(x, M[6], y * M[7] + M[8])
    sx = _fma(x, M[0], y * M[1] + M[2]) / w
    sy = _fma(x, M[3], y * M[4] + M[5]) / w
    ix = torch.floor(sx)
    iy = torch.floor(sy)
    ax = sx - ix
    ay = sy - iy
    ix = ix.clamp(-2, W + 1).long()
    iy = iy.clamp(-2, H + 1).long()
    flat = src.reshape(-1)
    base = index.view(B, 1, 1) * (H * W)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = flat[base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
        return torch.where(inside, v, torch.zeros_like(v)).float()

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma(ax, p01 - p00, p00)
    bot = _fma(ax, p11 - p10, p10)
    v = _fma(ay, bot - top, top)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def _grey(img, device):
    t = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return rgb_to_gray(t) if t.ndim == 3 else t


def process_image_pair(imgA, imgB, roiA, roiB, poseA, poseB, out_size=400,
                       margin=10, device="cpu"):
    """@imgA/@imgB: (H,W[,3]) uint8. @roiA/@roiB: (4,) mask bboxes.
    @poseA/@poseB: current cam-in-model poses. Returns (outA, outB, tfA,
    tfB): the grey (out_size,out_size) uint8 crops and the 3x3 full-res ->
    crop pixel transforms."""
    H, W = np.asarray(imgB).shape[:2]
    tfA, tfB = pair_transforms(H, W, roiA, roiB, poseA, poseB, out_size,
                               margin)
    outs = []
    for img, tf in ((imgA, tfA), (imgB, tfB)):
        src = _grey(img, device)[None]
        mat = torch.from_numpy(warp_matrix(tf)[None]).to(device)
        idx = torch.zeros(1, dtype=torch.int64, device=device)
        outs.append(warp_perspective(src, idx, mat, out_size)[0]
                    .cpu().numpy())
    return outs[0], outs[1], tfA, tfB


def process_image_pairs(frame_pairs, out_size=400, device="cpu"):
    """Canonicalize every pair of @frame_pairs ([(fA, fB)] of tracker
    frames of one size) on @device: each frame's grey image is uploaded
    and its mask's ROI found once, and all crops come from one
    `warp_perspective`. Returns (cropsA, cropsB, tfs): (P,S,S) uint8
    tensors and [(tfA, tfB)]."""
    slot, colors, rois = {}, [], {}
    for pair in frame_pairs:
        for f in pair:
            if f.id not in slot:
                slot[f.id] = len(colors)
                colors.append(f.color)
                rois[f.id] = mask_roi(f.fg_mask)
    src = torch.from_numpy(np.stack(colors)).to(device)
    if src.ndim == 4:
        src = rgb_to_gray(src)
    tfs, mats, index = [], [], []
    for fA, fB in frame_pairs:
        tfA, tfB = pair_transforms(
            fB.H, fB.W, rois[fA.id], rois[fB.id],
            fA.pose_in_model, fB.pose_in_model, out_size)
        tfs.append((tfA, tfB))
    for side in (0, 1):
        for (fA, fB), tf in zip(frame_pairs, tfs):
            mats.append(warp_matrix(tf[side]))
            index.append(slot[(fA, fB)[side].id])
    crops = warp_perspective(
        src, torch.tensor(index, dtype=torch.int64, device=device),
        torch.from_numpy(np.stack(mats)).to(device), out_size)
    P = len(frame_pairs)
    return crops[:P], crops[P:], tfs


def map_matches_back(uv_matches, tfA, tfB):
    """Map (N,>=4) [uA,vA,uB,vB,...] crop-space matches back to full-res
    pixels via the inverse affines (ref bundlesdf.py:364-368)."""
    if len(uv_matches) == 0:
        return uv_matches
    out = np.array(uv_matches, np.float64).copy()
    invA = np.linalg.inv(tfA)
    invB = np.linalg.inv(tfB)

    def apply(uv, T):
        homo = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1)
        p = homo @ T.T
        return p[:, :2] / p[:, 2:3]

    out[:, 0:2] = apply(out[:, 0:2], invA)
    out[:, 2:4] = apply(out[:, 2:4], invB)
    return out
