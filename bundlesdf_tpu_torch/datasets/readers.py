"""Video dataset readers.

Port of `YcbineoatReader` from `bundlesdf_tpu/datasets/readers.py`
(ref `BundleTrack/scripts/data_reader.py:21-110`): the YCBInEOAT / custom
folder layout, rgb/*.png + depth/*.png (mm) + masks/*.png + cam_K.txt.
Images are decoded by `utils/png.py` and resized by `resize_nearest`,
cv2's INTER_NEAREST in numpy, so the reader runs where cv2 is not
installed. `Ho3dReader` is not ported yet.
"""
from __future__ import annotations

import glob
import logging
import os

import numpy as np

from bundlesdf_tpu_torch.utils.common import depth2xyzmap, resize_nearest
from bundlesdf_tpu_torch.utils.png import read_png


class YcbineoatReader:
    """Ref data_reader.py:21-110. Works for any folder with
    rgb/*.png, depth/*.png (mm), masks/*.png, cam_K.txt."""

    def __init__(self, video_dir, downscale=1, shorter_side=None):
        self.video_dir = video_dir
        self.downscale = downscale
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.png"))
        self.K = np.loadtxt(f"{video_dir}/cam_K.txt").reshape(3, 3)
        self.id_strs = [os.path.basename(f).replace(".png", "")
                        for f in self.color_files]
        self.H, self.W = read_png(self.color_files[0]).shape[:2]
        if shorter_side is not None:
            self.downscale = shorter_side / min(self.H, self.W)
        self.H = int(self.H * self.downscale)
        self.W = int(self.W * self.downscale)
        self.K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{video_dir}/annotated_poses/*"))

    def get_video_name(self):
        return self.video_dir.rstrip("/").split("/")[-1]

    def __len__(self):
        return len(self.color_files)

    def _resize(self, img):
        return resize_nearest(img, (self.W, self.H))

    def get_color(self, i):
        return self._resize(read_png(self.color_files[i])[..., :3])

    def get_mask(self, i):
        path = self.color_files[i].replace("rgb", "masks")
        if not os.path.exists(path):
            return None
        mask = read_png(path)
        if mask.ndim == 3:
            mask = (mask.sum(axis=-1) > 0).astype(np.uint8)
        return self._resize(mask)

    def get_depth(self, i):
        depth = read_png(self.color_files[i].replace("rgb", "depth")) / 1e3
        return self._resize(depth).astype(np.float32)

    def get_xyz_map(self, i):
        return depth2xyzmap(self.get_depth(i), self.K)

    def get_occ_mask(self, i):
        occ = np.zeros((self.H, self.W), bool)
        for sub in ("masks_hand", "masks_hand_right"):
            f = self.color_files[i].replace("rgb", sub)
            if os.path.exists(f):
                occ |= self._resize(read_png(f)) > 0
        return occ.astype(np.uint8)

    def get_gt_pose(self, i):
        try:
            return np.loadtxt(self.gt_pose_files[i]).reshape(4, 4)
        except (IndexError, OSError):
            logging.info("GT pose not found")
            return None
