"""SE(3)/SO(3) math in torch (the subset the NOF step needs).

Port of `bundlesdf_tpu/utils/se3.py:22-78` plus its numpy twin
`se3_exp_np` (`:252`). Convention: `se3_exp(tau)` with tau = (trans[3],
rot[3]) returns the row-major 4x4 T = [[R, V@t],[0,1]] (the reference
PoseArray's pytorch3d `se3_exp_map(...).permute(0,2,1)`,
nerf_helpers.py:150). All functions take a batch in the leading axes.
"""
from __future__ import annotations

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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tau.dtype,
                          device=tau.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


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
