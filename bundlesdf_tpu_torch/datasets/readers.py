"""Video dataset readers.

Port of `bundlesdf_tpu/datasets/readers.py` (ref
`BundleTrack/scripts/data_reader.py:21-185`), without cv2, imageio or
Pillow:
- `YcbineoatReader`: the YCBInEOAT / custom folder layout, rgb/*.png +
  depth/*.png (mm) + masks/*.png + cam_K.txt. Images are decoded by
  `utils/png.py` and resized by `resize_nearest`, cv2's INTER_NEAREST in
  numpy.
- `Ho3dReader`: HO3D's layout, rgb/*.jpg decoded by `utils/jpeg.py` (the
  pixels imageio gives), packed two-channel depth PNGs, XMem masks read
  with cv2.imread(-1)'s channels (`utils/png.py::read_png_unchanged`),
  and GT poses from the pickled meta, the axis-angle rotation turned into
  a matrix with cv2.Rodrigues's formula in float64.
"""
from __future__ import annotations

import glob
import logging
import math
import os
import pickle

import numpy as np

from bundlesdf_tpu_torch.utils.common import (GLCAM_IN_CVCAM, depth2xyzmap,
                                              resize_nearest)
from bundlesdf_tpu_torch.utils.jpeg import read_jpeg
from bundlesdf_tpu_torch.utils.png import read_png, read_png_unchanged


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


def rodrigues(rvec) -> np.ndarray:
    """cv2.Rodrigues(rvec)[0] for one axis-angle vector, in its float64
    arithmetic: the identity below DBL_EPSILON, else
    cos(t) I + (1 - cos(t)) r r^T + sin(t) [r]x with r = rvec / t."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = math.sqrt(float(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    x, y, z = r * (1.0 / theta)
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z],
                    [x * z, y * z, z * z]])
    r_x = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + c1 * rrt + s * r_x


class Ho3dReader:
    """Ref data_reader.py:113-185 (`bundlesdf_tpu/datasets/readers.py:87-146`).
    Works for a folder with rgb/*.jpg, depth/*.png (two-channel packed),
    meta/*.pkl (camMat, objRot, objTrans) and, under @ho3d_root,
    masks_XMem/<video>/<index:05d>.png and <video>_hand/<index:04d>.png."""

    DEPTH_SCALE = 0.00012498664727900177

    def __init__(self, video_dir, ho3d_root=None):
        self.video_dir = video_dir
        self.ho3d_root = ho3d_root or os.path.dirname(
            os.path.dirname(os.path.abspath(video_dir)))
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.jpg"))
        meta0 = self.color_files[0].replace(".jpg", ".pkl").replace("rgb",
                                                                    "meta")
        with open(meta0, "rb") as f:
            self.K = pickle.load(f)["camMat"]
        self.id_strs = [os.path.basename(f).split(".")[0]
                        for f in self.color_files]

    def __len__(self):
        return len(self.color_files)

    def get_video_name(self):
        return os.path.dirname(
            os.path.abspath(self.color_files[0])).split("/")[-2]

    def get_color(self, i):
        return read_jpeg(self.color_files[i])[..., :3]

    def get_depth(self, i):
        """Packed two-channel depth (ref data_reader.py:162-167): cv2's
        channel 2 (the file's R) + 256 x channel 1 (G), times DEPTH_SCALE,
        as float32. 8-bit samples are widened to uint16 first, the type
        NumPy 1 gave `uint8 * 256`; 16-bit samples stay uint16, so the sum
        wraps as the reference's does."""
        depth = read_png_unchanged(self.color_files[i].replace(".jpg", ".png")
                                   .replace("rgb", "depth"))
        if depth.dtype == np.uint8:
            depth = depth.astype(np.uint16)
        return ((depth[..., 2] + depth[..., 1] * 256)
                * self.DEPTH_SCALE).astype(np.float32)

    def get_mask(self, i):
        name = self.get_video_name()
        index = int(self.id_strs[i])
        return read_png_unchanged(
            f"{self.ho3d_root}/masks_XMem/{name}/{index:05d}.png")

    def get_occ_mask(self, i):
        name = self.get_video_name()
        index = int(self.id_strs[i])
        return read_png_unchanged(
            f"{self.ho3d_root}/masks_XMem/{name}_hand/{index:04d}.png")

    def get_xyz_map(self, i):
        return depth2xyzmap(self.get_depth(i), self.K)

    def get_gt_pose(self, i):
        meta_file = self.color_files[i].replace(".jpg", ".pkl").replace("rgb",
                                                                        "meta")
        with open(meta_file, "rb") as f:
            meta = pickle.load(f)
        if meta["objTrans"] is None:
            return None
        T = np.eye(4)
        T[:3, 3] = meta["objTrans"]
        T[:3, :3] = rodrigues(meta["objRot"].reshape(3))
        return GLCAM_IN_CVCAM @ T
