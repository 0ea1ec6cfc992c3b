"""GT-oracle debug matcher.

Port of `bundlesdf_tpu/matcher/gt.py`, the reference's
`SiftManager::findCorresbyGroundtruth` (FeatureManager.cpp:990-1039):
given ground-truth poses-in-model for every frame, correspondences are
keypoints whose GT-transformed 3D points coincide within 2 mm. It plugs
into the pluggable-matcher slot (`BundleSdf(matcher=GtMatcher(...))`), so
an oracle run exercises the whole tracker with perfect data association.
Keypoints come from the port's ORB (`matcher/orb.py`, detection only, on
the whole frame) on the matcher's device; the matching is host numpy.
"""
from __future__ import annotations

import numpy as np

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.matcher import orb


class GtMatcher:
    """Oracle matcher: mutual GT-3D proximity instead of descriptors.

    @gt_poses: {frame.id_str or frame.id: (4,4) gt_pose_in_model} or a
        callable frame -> (4,4), mapping camera-frame points into the
        model frame.
    @max_dist: acceptance radius in meters (ref: 0.002, the hard-coded
        `0.002*0.002` squared gate at FeatureManager.cpp:1025).
    @device: where the keypoints are detected.
    @detector: optional `fn(frame) -> uv (n,2)` in place of the port's
        ORB keypoints.
    """

    CACHE_CAP = 256

    def __init__(self, gt_poses, max_dist: float = 0.002,
                 n_features: int = 2000, device="cuda", detector=None):
        self.gt_poses = gt_poses
        self.max_dist = float(max_dist)
        self.n_features = int(n_features)
        self.device = resolve_device(device)
        self.detector = detector
        self._cache: dict[int, tuple] = {}

    def _gt_pose(self, frame) -> np.ndarray:
        if callable(self.gt_poses):
            return np.asarray(self.gt_poses(frame), np.float64)
        try:
            return np.asarray(self.gt_poses[frame.id_str], np.float64)
        except (KeyError, TypeError):
            return np.asarray(self.gt_poses[frame.id], np.float64)

    def detect_keypoints(self, frame):
        """(n, 2) float32 ORB keypoints of the whole frame (host)."""
        color = orb.to_device(frame.color, self.device)
        gray = orb.rgb_to_gray(color) if color.ndim == 3 else color
        out = orb.detect_and_compute(gray, None, self.n_features,
                                     descriptors=False)
        return out["pt"].cpu().numpy()

    def _keypts(self, frame):
        """(uv (N,2) float32, pts_model (N,3) float64) of keypoints with
        valid depth, GT-transformed into the model frame; cached per
        frame."""
        hit = self._cache.get(frame.id)
        if hit is not None:
            return hit
        uv = (self.detector(frame) if self.detector is not None
              else self.detect_keypoints(frame))
        xyz = np.asarray(frame.xyz_map)
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
        if len(uv):
            ij = np.round(uv).astype(np.int64)
            ij[:, 0] = np.clip(ij[:, 0], 0, xyz.shape[1] - 1)
            ij[:, 1] = np.clip(ij[:, 1], 0, xyz.shape[0] - 1)
            pts = xyz[ij[:, 1], ij[:, 0]].astype(np.float64)
            ok = np.abs(pts[:, 2]) > 1e-6  # xyz_map zeroes invalid depth
            uv, pts = uv[ok], pts[ok]
        else:
            pts = np.zeros((0, 3), np.float64)
        gt = self._gt_pose(frame)
        out = (uv, pts @ gt[:3, :3].T + gt[:3, 3])
        if len(self._cache) >= self.CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[frame.id] = out
        return out

    def match_frames(self, frame_pairs):
        """[(fA, fB)] -> per-pair (N,5) [uA,vA,uB,vB,conf] full-res pixels.
        For each keypoint of A, the nearest GT-3D keypoint of B within
        @max_dist (one-directional, as the reference loop at
        FeatureManager.cpp:1002-1033)."""
        out = []
        for fA, fB in frame_pairs:
            uvA, ptsA = self._keypts(fA)
            uvB, ptsB = self._keypts(fB)
            if not len(uvA) or not len(uvB):
                out.append(np.zeros((0, 5), np.float32))
                continue
            d2 = (np.einsum("id,id->i", ptsA, ptsA)[:, None]
                  + np.einsum("jd,jd->j", ptsB, ptsB)[None, :]
                  - 2.0 * (ptsA @ ptsB.T))
            j = np.argmin(d2, axis=1)
            ok = d2[np.arange(len(uvA)), j] <= self.max_dist ** 2
            rows = np.concatenate(
                [uvA[ok], uvB[j[ok]],
                 np.ones((int(ok.sum()), 1), np.float32)], axis=1)
            out.append(rows.astype(np.float32))
        return out
