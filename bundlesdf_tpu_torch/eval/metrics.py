"""Pose error metrics, numerics-identical to the reference (host numpy).

Copy of `bundlesdf_tpu/eval/metrics.py:13-44`:
- add_err / adi_err: Utils.py:82-103
- compute_auc: Utils.py:175-198 (VOC-style AP at 0.1m)
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
