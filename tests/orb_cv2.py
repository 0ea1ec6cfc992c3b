"""cv2's ORB detection as the JAX package's matchers call it, for the
tests that hold the port against the JAX package: both must see the same
features, so the port is fed these through `OrbMatcher(detector=...)`.

`detect_cv2` is the JAX `OrbMatcher._frame_feats` detection (cv2 ORB on
the mask bbox crop zoomed to 400 px, the FEAT_CAP strongest responses);
`cv2_keypoints` is the JAX `GtMatcher`'s (full frame, no mask, detection
only). The port's own detector, `bundlesdf_tpu_torch/matcher/orb.py`, is
held against these in `test_torch_orb.py`.
"""
from __future__ import annotations

import cv2
import numpy as np

DETECT_SIZE = 400
FEAT_CAP = 2048
_ORB = {}


def _orb(n_features):
    if n_features not in _ORB:
        _ORB[n_features] = cv2.ORB_create(nfeatures=n_features,
                                          fastThreshold=5)
    return _ORB[n_features]


def crop_zoom(color, fg_mask, detect_size=DETECT_SIZE):
    """(grey crop zoomed, mask crop zoomed, (u0, v0), zoom_uv) of the
    mask's bbox with a 10 px margin, or None for an empty mask."""
    gray = cv2.cvtColor(np.asarray(color), cv2.COLOR_RGB2GRAY)
    mask = (np.asarray(fg_mask) > 0).astype(np.uint8)
    vs, us = np.nonzero(mask)
    if len(vs) == 0:
        return None
    m = 10
    v0, v1 = max(vs.min() - m, 0), min(vs.max() + m + 1, mask.shape[0])
    u0, u1 = max(us.min() - m, 0), min(us.max() + m + 1, mask.shape[1])
    crop = gray[v0:v1, u0:u1]
    cmask = mask[v0:v1, u0:u1]
    zoom = detect_size / max(crop.shape)
    if abs(zoom - 1.0) > 0.05:
        size = (max(int(round(crop.shape[1] * zoom)), 8),
                max(int(round(crop.shape[0] * zoom)), 8))
        crop = cv2.resize(crop, size, interpolation=cv2.INTER_LINEAR)
        cmask = cv2.resize(cmask, size, interpolation=cv2.INTER_NEAREST)
        zoom_uv = (size[0] / (u1 - u0), size[1] / (v1 - v0))
    else:
        zoom_uv = (1.0, 1.0)
    return crop, cmask, (u0, v0), zoom_uv


def detect_cv2(color, fg_mask, n_features=2000, feat_cap=FEAT_CAP):
    """(uv (n,2) float32 full-res, des (n,32) uint8) as the JAX matcher
    detects them."""
    empty = (np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8))
    cz = crop_zoom(color, fg_mask)
    if cz is None:
        return empty
    crop, cmask, (u0, v0), zoom_uv = cz
    kps, des = _orb(n_features).detectAndCompute(crop, cmask)
    if des is None or len(kps) == 0:
        return empty
    uv = (np.array([k.pt for k in kps], np.float32) / zoom_uv
          + (u0, v0)).astype(np.float32)
    if len(uv) > feat_cap:
        order = np.argsort([-k.response for k in kps])[:feat_cap]
        uv, des = uv[order], des[order]
    return uv, des


def cv2_detector(frame):
    """`OrbMatcher(detector=cv2_detector)`: cv2's features of a Frame."""
    return detect_cv2(frame.color, frame.fg_mask)


def cv2_keypoints(color, n_features=2000):
    """(n, 2) float32 keypoints of the whole frame, as the JAX
    `GtMatcher` detects them."""
    color = np.asarray(color)
    gray = (cv2.cvtColor(color, cv2.COLOR_RGB2GRAY) if color.ndim == 3
            else color)
    kps = _orb(n_features).detect(gray, None)
    return np.asarray([k.pt for k in kps], np.float32).reshape(-1, 2)
