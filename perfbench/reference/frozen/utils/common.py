"""Shared constants and geometry helpers (host numpy).

Parity notes: sentinels and conventions follow the reference
(`Utils.py:34-40`, `Utils.py:219-257`). Copy of `bundlesdf_tpu/utils/common.py`
without its jax branch: the helpers here take numpy arrays.
"""
from __future__ import annotations

import logging
import random

import numpy as np

# Sentinel values used when masking out pixels before NOF training
# (ref Utils.py:34-35).
BAD_DEPTH = 99.0
BAD_COLOR = 128

# OpenGL camera expressed in OpenCV camera (ref Utils.py:37-40).
GLCAM_IN_CVCAM = np.array(
    [[1, 0, 0, 0],
     [0, -1, 0, 0],
     [0, 0, -1, 0],
     [0, 0, 0, 1]], dtype=np.float64)


def set_seed(seed: int) -> None:
    """Determinism control (ref Utils.py:71-78). Torch randomness is drawn
    from explicit generators, so only python/numpy global state needs
    seeding here."""
    np.random.seed(seed)
    random.seed(seed)


def set_logging_format(level=logging.INFO):
    importer_format = "[%(asctime)s %(filename)s:%(lineno)d] %(message)s"
    logging.basicConfig(level=level, format=importer_format, datefmt="%H:%M:%S")


def to_homo(pts):
    """(N,D) -> (N,D+1) with a 1 appended (ref Utils.py:235-241)."""
    return np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)


def transform_pts(pts, tf):
    """Apply (...,4,4) (or 3x3 homography) transforms to (...,D) points
    (ref Utils.py:253-257)."""
    return (tf[..., :-1, :-1] @ pts[..., None] + tf[..., :-1, -1:])[..., 0]


def depth2xyzmap(depth, K):
    """Depth image -> camera-space xyz map; invalid (<0.1) pixels -> 0
    (ref Utils.py:219-232)."""
    H, W = depth.shape[:2]
    us = np.arange(W, dtype=depth.dtype)[None, :]
    vs = np.arange(H, dtype=depth.dtype)[:, None]
    zs = depth
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    xyz = np.stack([xs, ys, zs], axis=-1)
    invalid = depth < 0.1
    return np.where(invalid[..., None], np.zeros_like(xyz), xyz)


def geodesic_distance_np(R1, R2):
    """Rotation geodesic distance in radians, host numpy
    (ref Utils.py:201-205)."""
    cos = (np.trace(R1 @ R2.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(cos, -1.0, 1.0)))


def resize_nearest(img, size):
    """cv2.resize(img, size=(w, h), interpolation=cv2.INTER_NEAREST) in
    numpy: destination pixel x reads source floor(x * (1 / (w / W0))),
    clipped, with the scale rounded as cv2 rounds it (W0 / w itself can
    round the other way and move a pixel where x * W0 / w is whole)."""
    img = np.asarray(img)
    w, h = size
    H0, W0 = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W0))).astype(
        np.int64), W0 - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H0))).astype(
        np.int64), H0 - 1)
    return img[ys[:, None], xs[None, :]]
