"""RGBD frame record backed by the device-resident frame pool.

Port of `bundlesdf_tpu/tracker/frame.py` (the reference `Frame`,
`BundleTrack/src/Frame.{h,cpp}`): the depth chain runs on the device and
writes the frame's maps into the shared FramePool; pose and bookkeeping
stay host-side numpy. The valid-point count starts its device->host copy
at construction, so the FAIL gate that reads it later does not wait for
a fresh transfer. Frames constructed without a pool keep standalone
device tensors; the Bundler adopts them into its pool on first touch.
"""
from __future__ import annotations

import enum
import math

import numpy as np
import torch
from scipy.spatial import cKDTree

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.ops.preprocess import preprocess_depth_frame
from bundlesdf_tpu_torch.scene.bounds import voxel_downsample
from bundlesdf_tpu_torch.utils.transfer import HostPull


class FrameStatus(enum.Enum):
    """Ref Frame.h:27-32."""
    FAIL = 0
    NO_BA = 1
    OTHER = 2


class Frame:
    """@color: (H,W,3) uint8; @depth: (H,W) float32 meters; @mask optional
    (H,W); @pose_in_model: (4,4) cam-in-object (cv convention).
    @pool: optional FramePool — when given, maps live in the pool (on its
    device); else on @device."""

    def __init__(self, color, depth, K, id: int, id_str: str, cfg,
                 mask=None, occ_mask=None, pose_in_model=None, pool=None,
                 device="cuda"):
        self.cfg = cfg
        self.color = np.asarray(color)
        self.H, self.W = self.color.shape[:2]
        self.K = np.asarray(K, np.float64)
        self.id = id
        self.id_str = id_str
        self.status = FrameStatus.OTHER
        self.ref_frame_id = -1
        self.nerfed = False
        self.pose_in_model = (np.eye(4) if pose_in_model is None
                              else np.asarray(pose_in_model, np.float64).copy())
        self.fg_mask = (np.ones((self.H, self.W), np.uint8) if mask is None
                        else (np.asarray(mask) > 0).astype(np.uint8))
        self.occ_mask = None if occ_mask is None else np.asarray(occ_mask)
        if self.occ_mask is not None:
            self.fg_mask[self.occ_mask > 0] = 0
        # raw depth kept for debug dumps (ref _depth_raw, Bundler.cpp:998)
        self.depth_raw = np.asarray(depth, np.float32).copy()

        self.pool = pool
        self._n_valid_pull = None   # in-flight valid-count copy
        self._n_valid = None
        self._depth_host = None
        self._xyz_host = None
        self._normal_host = None

        if pool is not None:
            self.device = pool.device
            self.slot, n_valid = pool.insert_preprocessed(
                self.id, depth, self.K, self.fg_mask,
                cfg["depth_processing"])
            self._n_valid_pull = HostPull({"n": n_valid}, "track.frame")
            self.depth_dev = self.xyz_dev = self.normal_dev = None
            if float(cfg.get("bundle", {}).get("w_dense_color", 0)
                     or 0) > 0:
                # grey map for the dense photometric BA term
                # (SolverBundling.cu:236-257; weight off by default)
                pool.set_grey(self.id, self.color.astype(np.float32)
                              .mean(axis=-1) / 255.0)
        else:
            self.device = resolve_device(device)
            self.slot = None
            dp = cfg["depth_processing"]
            dev = self.device
            d, xyz, nrm = preprocess_depth_frame(
                torch.as_tensor(np.asarray(depth, np.float32), device=dev),
                torch.as_tensor(self.K, dtype=torch.float32, device=dev),
                mask=torch.as_tensor(self.fg_mask, device=dev),
                erode_radius=int(dp["erode"]["radius"]),
                erode_diff=dp["erode"]["diff"],
                erode_ratio=dp["erode"]["ratio"],
                bf_radius=int(dp["bilateral_filter"]["radius"]),
                sigma_d=dp["bilateral_filter"]["sigma_D"],
                sigma_r=dp["bilateral_filter"]["sigma_R"],
                zfar=dp["zfar"],
                edge_angle_thres_rad=dp["edge_normal_thres"] * math.pi / 180.0)
            self.depth_dev = d
            self.xyz_dev = xyz
            self.normal_dev = nrm

    @property
    def pooled(self) -> bool:
        return self.pool is not None and self.slot is not None

    # -- lazy host views -----------------------------------------------------
    def _pull_host(self):
        if self.pooled:
            (self._depth_host, self._xyz_host,
             self._normal_host) = self.pool.host_maps(self.id)
        else:
            h = HostPull({"d": self.depth_dev, "x": self.xyz_dev,
                          "n": self.normal_dev}, "track.frame_maps").get()
            self._depth_host, self._xyz_host, self._normal_host = \
                h["d"], h["x"], h["n"]

    @property
    def depth(self):
        if self._depth_host is None:
            self._pull_host()
        return self._depth_host

    @property
    def xyz_map(self):
        if self._xyz_host is None:
            self._pull_host()
        return self._xyz_host

    @property
    def normal_map(self):
        if self._normal_host is None:
            self._pull_host()
        return self._normal_host

    # -- ref Frame.cpp:453-464 ---------------------------------------------
    def count_valid_points(self) -> int:
        if self._n_valid is None:
            if self._n_valid_pull is not None:
                self._n_valid = int(self._n_valid_pull.get()["n"])
                self._n_valid_pull = None
            else:
                keep = torch.as_tensor(self.fg_mask, device=self.device) > 0
                self._n_valid = int(torch.sum((self.depth_dev > 0.1) & keep))
        return self._n_valid

    # -- ref Frame.cpp:147-170 ---------------------------------------------
    def set_new_init_coordinate(self):
        """Center the model frame on the first frame's (outlier-removed)
        object cloud: pose translation = -bbox center."""
        valid = (self.depth > 0.1) & (self.fg_mask > 0)
        pts = self.xyz_map[valid]
        if len(pts) < 10:
            return
        pts = statistical_outlier_removal(pts, n_neighbors=30, std_mul=3.0)
        center = (pts.max(axis=0) + pts.min(axis=0)) / 2.0
        self.pose_in_model[:3, 3] = -center

    # -- ref Frame.cpp:337-384 ----------------------------------------------
    def point_cloud_denoise(self):
        """Voxel-downsample + z-passfilter + statistical outlier removal on
        the frame cloud, then invalidate pixels whose point is >5mm from the
        cleaned cloud (depth_processing.denoise_cloud path)."""
        dp = self.cfg["depth_processing"]
        valid = (self.depth > 0.1) & (self.fg_mask > 0)
        pts = self.xyz_map[valid]
        if len(pts) < 10:
            return
        down = voxel_downsample(pts, 0.005)
        down = down[(down[:, 2] >= 0.1) & (down[:, 2] <= dp["zfar"])]
        down = statistical_outlier_removal(
            down, n_neighbors=int(dp["outlier_removal"]["num"]),
            std_mul=dp["outlier_removal"]["std_mul"])
        if len(down) == 0:
            return
        tree = cKDTree(down)
        d, _ = tree.query(pts, k=1, workers=-1)
        bad = d > 0.005
        vs, us = np.nonzero(valid)
        self.fg_mask[vs[bad], us[bad]] = 0
        self.invalidate_pixels_by_mask(self.fg_mask)

    def invalidate_pixels_by_mask(self, mask):
        """Ref Frame.cpp:432-451 — zero depth/normals outside the mask, on
        the device; host views are invalidated. Call only when the mask
        shrank (construction already applied it)."""
        mask = np.asarray(mask) > 0
        if self.pooled:
            self._n_valid_pull = HostPull(
                {"n": self.pool.apply_mask(self.id, mask)}, "track.frame")
        else:
            keep = torch.as_tensor(mask, device=self.device)
            self.depth_dev = torch.where(keep, self.depth_dev, 0.0)
            self.xyz_dev = torch.where(keep[..., None], self.xyz_dev, 0.0)
            self.normal_dev = torch.where(keep[..., None], self.normal_dev,
                                          0.0)
            self._n_valid_pull = None
        self._depth_host = None
        self._xyz_host = None
        self._normal_host = None
        self._n_valid = None

    def __repr__(self):
        return f"Frame({self.id_str}, status={self.status.name})"


def statistical_outlier_removal(pts, n_neighbors=30, std_mul=3.0):
    """PCL-style statistical outlier removal (ref Utils::outlierRemovalStatistic):
    drop points whose mean kNN distance exceeds mean + std_mul * std."""
    if len(pts) <= n_neighbors:
        return pts
    tree = cKDTree(pts)
    dists, _ = tree.query(pts, k=n_neighbors + 1, workers=-1)
    mean_d = dists[:, 1:].mean(axis=1)
    thres = mean_d.mean() + std_mul * mean_d.std()
    return pts[mean_d <= thres]

