"""Pose and mesh evaluation metrics, numerics-identical to the reference
(host numpy). Copy of `bundlesdf_tpu/eval/metrics.py`:
- add_err / adi_err: Utils.py:82-103
- compute_auc: Utils.py:175-198 (VOC-style AP at 0.1m)
- chamfer mutual: Utils.py:268-273
- ICP: open3d point-to-point ICP replacement (benchmark_ho3d.py:125)
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def add_err(pred, gt, model_pts):
    pred_pts = model_pts @ pred[:3, :3].T + pred[:3, 3]
    gt_pts = model_pts @ gt[:3, :3].T + gt[:3, 3]
    return np.linalg.norm(pred_pts - gt_pts, axis=1).mean()


def adi_err(pred, gt, model_pts):
    pred_pts = model_pts @ pred[:3, :3].T + pred[:3, 3]
    gt_pts = model_pts @ gt[:3, :3].T + gt[:3, 3]
    nn_dists, _ = cKDTree(pred_pts).query(gt_pts, k=1, workers=-1)
    return nn_dists.mean()


def compute_auc(rec, max_val=0.1):
    if len(rec) == 0:
        return 0
    rec = np.sort(np.array(rec))
    n = len(rec)
    prec = np.arange(1, n + 1) / float(n)
    index = np.where(rec < max_val)[0]
    rec = rec[index]
    prec = prec[index]
    if len(prec) == 0:
        return 0.0
    mrec = np.array([0, *list(rec), max_val])
    mpre = np.array([0, *list(prec), prec[-1]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    i = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) / max_val


def chamfer_distance_mutual(pts1, pts2):
    d1, _ = cKDTree(pts1).query(pts2)
    d2, _ = cKDTree(pts2).query(pts1)
    return 0.5 * (d1.mean() + d2.mean())


def _kabsch_np(src, dst):
    """Rigid transform (4,4) mapping src -> dst, least squares (Umeyama
    without scale). Pure numpy: eval must never touch a device — this is
    the post-run scoring path and a flaky accelerator transport must not
    be able to hang it (Utils.cpp:360-404 semantics)."""
    c_s = src.mean(axis=0)
    c_d = dst.mean(axis=0)
    H = (src - c_s).T @ (dst - c_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ S @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = c_d - R @ c_s
    return T


def icp_point_to_point(src, dst, max_dist=0.02, max_iter=30, tol=1e-7):
    """Iterative closest point with point-to-point Kabsch updates
    (open3d registration_icp equivalent). Returns (4,4) transform mapping
    src -> dst."""
    T = np.eye(4)
    cur = np.asarray(src, np.float64).copy()
    tree = cKDTree(dst)
    prev_err = np.inf
    for _ in range(max_iter):
        dists, idx = tree.query(cur, k=1, workers=-1)
        keep = dists <= max_dist
        if keep.sum() < 3:
            break
        T_step = _kabsch_np(cur[keep], dst[idx[keep]])
        cur = cur @ T_step[:3, :3].T + T_step[:3, 3]
        T = T_step @ T
        err = dists[keep].mean()
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T
