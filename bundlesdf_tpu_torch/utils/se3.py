"""SE(3)/SO(3) math in torch, with numpy twins for host-side pose math.

Port of `bundlesdf_tpu/utils/se3.py`. Convention: `se3_exp(tau)` with
tau = (trans[3], rot[3]) returns the row-major 4x4 T = [[R, V@t],[0,1]]
(the reference PoseArray's pytorch3d `se3_exp_map(...).permute(0,2,1)`,
nerf_helpers.py:150). All functions take a batch in the leading axes.

`kabsch` is the exact weighted SVD solve with the reflection fix (the
reference's Umeyama, Utils.cpp:360-404); the JAX package's Horn
quaternion + power iteration existed only because SVD and eigh were host
calls on its TPU stack. `kabsch_np` is the JAX package's numpy twin
(Horn via an exact eigh), kept as the independent reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def so3_exp(w):
    """Rodrigues. (...,3) axis-angle -> (...,3,3) rotation. Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    s = torch.sin(theta) / theta
    c = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + s[..., None, None] * W + c[..., None, None] * W2


def so3_log(R):
    """(...,3,3) -> (...,3) axis-angle. Stable away from pi."""
    cos = (R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    scale = theta / (2.0 * torch.sin(theta) + _EPS)
    return w * scale[..., None]


def _so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    b = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(tau):
    """(...,6) (trans, rot) -> (...,4,4)."""
    t, w = tau[..., :3], tau[..., 3:6]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    trans = (V @ t[..., None])[..., 0]
    top = torch.cat([R, trans[..., None]], dim=-1)
    # the [0, 0, 0, 1] row made on the device: a host constant would be a
    # copy that waits for the stream, and no CUDA graph can capture it
    bottom = top.new_zeros(top.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_log(T):
    """(...,4,4) -> (...,6) (trans, rot)."""
    w = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(w)
    t = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]
    return torch.cat([t, w], dim=-1)


def geodesic_distance(R1, R2):
    """Rotation geodesic distance in radians (ref Utils.py:201-205); takes
    torch tensors or numpy arrays."""
    if isinstance(R1, np.ndarray):
        cos = (np.trace(R1 @ np.swapaxes(R2, -1, -2), axis1=-2, axis2=-1)
               - 1.0) / 2.0
        return np.arccos(np.clip(cos, -1.0, 1.0))
    cos = ((R1 @ R2.transpose(-1, -2)).diagonal(dim1=-2, dim2=-1).sum(-1)
           - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def rot_geodesic_ignore_cam_z(R1, R2):
    """Geodesic distance of R2 @ R1^T with its rotation about camera Z
    zeroed (ref Utils.cpp:89-99): the angle of the relative rotation,
    or 0 when its axis is (near) pure Z."""
    R = R2 @ R1.transpose(-1, -2)
    w = so3_log(R)
    angle = torch.linalg.norm(w, dim=-1)
    axis = w / (angle[..., None] + _EPS)
    axis = torch.cat([axis[..., :2], torch.zeros_like(axis[..., 2:])], -1)
    norm = torch.linalg.norm(axis, dim=-1)
    axis = axis / (norm[..., None] + _EPS)
    R_out = so3_exp(axis * angle[..., None])
    eye = torch.eye(3, dtype=R_out.dtype, device=R_out.device)
    return geodesic_distance(R_out, eye) * (norm > 1e-6)


def kabsch(src, dst, weights=None):
    """Weighted least-squares rigid transform T with T @ src ~= dst.

    @src, @dst: (...,N,3); @weights: optional (...,N) nonnegative.
    Returns (...,4,4). Exact SVD of the 3x3 cross-covariance with the
    reflection fix R = V diag(1,1,sign det(V U^T)) U^T."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = (weights / (weights.sum(-1, keepdim=True) + _EPS))[..., None]
    mean1 = (src * w).sum(-2)
    mean2 = (dst * w).sum(-2)
    P = src - mean1[..., None, :]
    Q = dst - mean2[..., None, :]
    S = (P * w).transpose(-1, -2) @ Q          # sum_k w_k p_k q_k^T
    U, _, Vh = torch.linalg.svd(S)
    V = Vh.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    d = torch.where(d == 0, torch.ones_like(d), d)
    fix = torch.ones(S.shape[:-1], dtype=S.dtype, device=S.device)
    fix = torch.cat([fix[..., :2], d[..., None]], -1)
    R = (V * fix[..., None, :]) @ U.transpose(-1, -2)
    t = mean2 - (R @ mean1[..., None])[..., 0]
    T = torch.zeros(S.shape[:-2] + (4, 4), dtype=S.dtype, device=S.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rot_geodesic_ignore_cam_z_np(R1, R2):
    """NumPy twin of rot_geodesic_ignore_cam_z (ref Utils.cpp:89-99)."""
    from scipy.spatial.transform import Rotation

    R = np.asarray(R2) @ np.asarray(R1).T
    w = Rotation.from_matrix(R).as_rotvec()
    angle = np.linalg.norm(w)
    if angle < 1e-12:
        return 0.0
    axis = w / angle
    axis[2] = 0.0
    n = np.linalg.norm(axis)
    if n < 1e-6:  # pure cam-Z roll -> distance 0
        return 0.0
    return float(angle)


def so3_log_np(R):
    """NumPy twin of so3_log for one (3,3) rotation, in float64 and in
    cv2.Rodrigues's arithmetic: R projected onto SO(3) by its SVD, then
    w * theta / (2 s) with s = |w| / 2 (no epsilon); where s < 1e-5 the
    result is 0 (theta near 0) or the axis from the diagonal, signed by
    the off-diagonal entries (theta near pi)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = math.sqrt((r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * 0.25)
    c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0), 1.0)
    theta = math.acos(c)
    if s >= 1e-5:
        return r * (1 / (2 * s) * theta)
    if c > 0:
        return np.zeros(3)
    rx = math.sqrt(max((R[0, 0] + 1) * 0.5, 0.0))
    ry = math.sqrt(max((R[1, 1] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0
                                                     else 1.0)
    rz = math.sqrt(max((R[2, 2] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0
                                                     else 1.0)
    if (abs(rx) < abs(ry) and abs(rx) < abs(rz)
            and (R[1, 2] > 0) != (ry * rz > 0)):
        rz = -rz
    r = np.array([rx, ry, rz])
    return r * (theta / np.linalg.norm(r))


def kabsch_np(src, dst, weights=None):
    """NumPy rigid fit (Horn quaternion via an exact eigh of the 4x4), the
    JAX package's host twin; the reference `kabsch` is held against it."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if weights is None:
        weights = np.ones(src.shape[0])
    w = (weights / (weights.sum() + _EPS))[:, None]
    mean1 = (src * w).sum(axis=0)
    mean2 = (dst * w).sum(axis=0)
    P = src - mean1
    Q = dst - mean2
    S = (P * w).T @ Q
    sxx, sxy, sxz = S[0]
    syx, syy, syz = S[1]
    szx, szy, szz = S[2]
    N = np.array([
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
    ])
    _, vecs = np.linalg.eigh(N)
    qw, qx, qy, qz = vecs[:, -1]
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mean2 - R @ mean1
    return T


def _hat_np(w):
    zeros = np.zeros_like(w[..., 0])
    return np.stack([
        np.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
        np.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
        np.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
    ], axis=-2)


def se3_exp_np(tau):
    """NumPy twin of se3_exp for host-side pose math (pose export)."""
    tau = np.asarray(tau, np.float64)
    t, w = tau[..., :3], tau[..., 3:6]
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(theta2 + _EPS * _EPS)
    W = _hat_np(w)
    W2 = W @ W
    s = (np.sin(theta) / theta)[..., None, None]
    c = ((1.0 - np.cos(theta)) / (theta2 + _EPS * _EPS))[..., None, None]
    R = np.eye(3) + s * W + c * W2
    b = ((theta - np.sin(theta)) / (theta2 * theta + _EPS))[..., None, None]
    V = np.eye(3) + c * W + b * W2
    T = np.zeros(tau.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ t[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T
