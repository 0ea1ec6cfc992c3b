"""Per-video benchmark: ADD/ADD-S AUC + mesh Chamfer after ICP.

Mirrors `benchmark_one_video` (`benchmark_ho3d.py:18-139`): first-frame GT
alignment, per-frame ADD/ADD-S over the GT model cloud, AUC@0.1m, mesh
cropped/cleaned/biggest-component, 99999 surface samples, point-to-point
ICP at 2cm, mutual Chamfer. Copy of `bundlesdf_tpu/eval/benchmark.py`.
"""
from __future__ import annotations

import glob
import logging

import numpy as np

from bundlesdf_tpu_torch.eval.metrics import (add_err, adi_err,
                                              chamfer_distance_mutual,
                                              compute_auc,
                                              icp_point_to_point)
from bundlesdf_tpu_torch.scene.bounds import voxel_downsample


def benchmark_video(out_dir, gt_poses, gt_model_pts, gt_visible_pts=None,
                    pred_poses=None, pred_mesh=None, ids=None):
    """@out_dir: run output dir with ob_in_cam/*.txt (ignored when
    @pred_poses given). @gt_poses: (F,4,4) ob-in-cam GT. @gt_model_pts:
    (N,3) GT model cloud for ADD. @gt_visible_pts: (M,3) GT visible surface
    cloud for Chamfer. Returns metrics dict."""
    if pred_poses is None:
        pose_files = sorted(glob.glob(f"{out_dir}/ob_in_cam/*.txt"))
        pred_poses = np.array([np.loadtxt(f) for f in pose_files])
    gt_poses = np.asarray(gt_poses)
    if ids is not None:
        pred_poses = pred_poses[np.asarray(ids)]
    assert len(pred_poses) == len(gt_poses)

    # first-frame alignment (ref benchmark_ho3d.py:62)
    pred_pose_init_old = pred_poses[0].copy()
    pred_poses = pred_poses @ np.linalg.inv(pred_poses[0]) @ gt_poses[0]

    add_errs = np.array([add_err(pred_poses[i], gt_poses[i], gt_model_pts)
                         for i in range(len(gt_poses))])
    adi_errs = np.array([adi_err(pred_poses[i], gt_poses[i], gt_model_pts)
                         for i in range(len(gt_poses))])
    out = {
        "ADD(cm)": add_errs.mean() * 100,
        "ADDS(cm)": adi_errs.mean() * 100,
        "ADD_AUC(%)": compute_auc(add_errs) * 100,
        "ADDS_AUC(%)": compute_auc(adi_errs) * 100,
        "chamfer(cm)": np.inf,
    }

    if pred_mesh is not None and gt_visible_pts is not None:
        gt_pts = voxel_downsample(np.asarray(gt_visible_pts), 0.005)
        mesh = pred_mesh.copy()
        # into GT's first-frame camera frame (ref :88-89)
        mesh.apply_transform(pred_pose_init_old)
        mesh.apply_transform(np.linalg.inv(gt_poses[0]))
        # crop far outliers (ref :107-111)
        max_c = gt_pts.max(axis=0) + 0.3
        min_c = gt_pts.min(axis=0) - 0.3
        keep = ((mesh.vertices <= max_c) & (mesh.vertices >= min_c)).all(-1)
        mesh.remove_vertices_by_mask(keep)
        mesh.merge_vertices()
        # biggest near-origin component (ref :114-125)
        comps = mesh.split_components()
        best = None
        for c in comps:
            if np.linalg.norm(c.vertices, axis=-1).min() > 0.1:
                continue
            if best is None or len(c.vertices) > len(best.vertices):
                best = c
        if best is None and comps:
            best = max(comps, key=lambda c: len(c.vertices))
        if best is not None and len(best.faces) > 0:
            pred_pts = best.sample_surface(99999)
            pred_pts_ds = voxel_downsample(pred_pts, 0.005)
            T_icp = icp_point_to_point(pred_pts_ds, gt_pts, max_dist=0.02)
            pred_icp = pred_pts @ T_icp[:3, :3].T + T_icp[:3, 3]
            out["chamfer(cm)"] = chamfer_distance_mutual(pred_icp, gt_pts) * 100
        else:
            logging.info("benchmark: no valid mesh component")
    return out
