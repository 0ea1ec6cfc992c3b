"""Segmenter (ref `segmentation_utils.py:13-18`): the reference excludes
XMem for license reasons and reads precomputed masks; same here.

Port of `bundlesdf_tpu/utils/segmentation.py`: masks are read with
`utils/png.py` (a colour mask comes back RGB where cv2 gives BGR; the
mask is the nonzero of the channel sum either way), and the background
subtraction is the same scipy cKDTree query on the host.

Additionally implements the background-cloud subtraction that the
reference's YCBInEOAT config declares (`config_ycbineoat.yml`
segmentation.bg_dist / segmentation.bg_dir) but whose consumer lives in
external tooling: pixels whose lifted 3D point lies within `bg_dist` of a
pre-captured static background cloud are removed from the mask.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from bundlesdf_tpu_torch.utils.png import read_png


def load_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii or binary_little_endian float xyz
    leading properties). No trimesh/open3d in this image."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = 0
        fmt = "ascii"
        props = []
        in_vertex = False
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                in_vertex = t[1] == "vertex"
                if in_vertex:
                    n_verts = int(t[2])
            elif t[0] == "property" and in_vertex:
                props.append((t[1], t[2]))
        if fmt == "ascii":
            rows = [f.readline().split()[:3] for _ in range(n_verts)]
            return np.asarray(rows, np.float64)
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}
        dtype = np.dtype([(name, "<" + type_map[tp]) for tp, name in props])
        data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=-1).astype(np.float64)


class Segmenter:
    """Reads precomputed masks from disk (ref readme.md:67); optionally
    subtracts a static background cloud (cfg['segmentation']['bg_dir'] /
    ['bg_dist'], ref config_ycbineoat.yml:14-15)."""

    def __init__(self, cfg: dict | None = None):
        self.bg_pts = None
        self.bg_dist = 0.01
        self._bg_tree = None
        seg = (cfg or {}).get("segmentation", {})
        bg_dir = seg.get("bg_dir", "")
        self.bg_dist = float(seg.get("bg_dist", 0.01))
        if bg_dir and os.path.exists(bg_dir):
            try:
                self.bg_pts = load_ply_vertices(bg_dir)
                from scipy.spatial import cKDTree

                self._bg_tree = cKDTree(self.bg_pts)
                logging.info(f"segmenter: bg cloud {len(self.bg_pts)} pts "
                             f"from {bg_dir}, dist {self.bg_dist}")
            except Exception as e:  # malformed ply -> run without bg
                logging.warning(f"segmenter: failed to load bg {bg_dir}: {e}")

    def run(self, mask_file: str, depth=None, K=None):
        """The mask in @mask_file (None where there is none), with the
        background subtracted where @depth and @K are given."""
        mask = read_png(mask_file) if os.path.exists(mask_file) else None
        if mask is not None and mask.ndim == 3:
            mask = (mask.sum(axis=-1) > 0).astype("uint8") * 255
        if mask is not None and depth is not None and K is not None:
            mask = self.subtract_background(mask, depth, K)
        return mask

    def subtract_background(self, mask, depth, K):
        """Zero mask pixels whose camera-space 3D point is within bg_dist
        of the background cloud."""
        if self._bg_tree is None:
            return mask
        mask = np.asarray(mask).copy()
        depth = np.asarray(depth, np.float64)
        vs, us = np.nonzero((mask > 0) & (depth > 0.1))
        if len(vs) == 0:
            return mask
        z = depth[vs, us]
        x = (us - K[0, 2]) * z / K[0, 0]
        y = (vs - K[1, 2]) * z / K[1, 1]
        pts = np.stack([x, y, z], axis=-1)
        d, _ = self._bg_tree.query(pts, k=1, workers=-1)
        bg = d <= self.bg_dist
        mask[vs[bg], us[bg]] = 0
        return mask
