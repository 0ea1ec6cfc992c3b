"""Pose visualization helpers (ref `Utils.py:309-344` draw_xyz_axis,
`Utils.py:517-553` draw_posed_3d_box). cv2 drawing, host-side.

Copy of `bundlesdf_tpu/utils/viz.py` that imports cv2 inside the drawing
functions, so the module imports where cv2 is not installed."""
from __future__ import annotations

import numpy as np


def project_points(pts, K, ob_in_cam):
    """(N,3) object points -> (N,2) pixel coords under ob_in_cam."""
    p = pts @ ob_in_cam[:3, :3].T + ob_in_cam[:3, 3]
    uv = p[:, :2] / np.maximum(p[:, 2:3], 1e-9)
    return np.stack([uv[:, 0] * K[0, 0] + K[0, 2],
                     uv[:, 1] * K[1, 1] + K[1, 2]], axis=-1), p[:, 2]


def draw_posed_3d_box(K, img, ob_in_cam, bbox, line_color=(0, 255, 0),
                      linewidth=2):
    """Draw the wireframe of an axis-aligned (in object frame) 3D box.
    @bbox: (2,3) [min_xyz, max_xyz]."""
    mn, mx = np.asarray(bbox[0]), np.asarray(bbox[1])
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    import cv2

    uv, z = project_points(corners, K, ob_in_cam)
    img = img.copy()
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    for a, b in edges:
        if z[a] <= 0 or z[b] <= 0:
            continue
        cv2.line(img, tuple(np.round(uv[a]).astype(int)),
                 tuple(np.round(uv[b]).astype(int)), line_color, linewidth)
    return img


def draw_xyz_axis(color, ob_in_cam, K, scale=0.1, thickness=3):
    """Draw object-frame XYZ axes (x red, y green, z blue)."""
    import cv2

    pts = np.array([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]],
                   np.float64)
    uv, z = project_points(pts, K, ob_in_cam)
    img = color.copy()
    if (z <= 0).any():
        return img
    o = tuple(np.round(uv[0]).astype(int))
    for i, c in [(1, (0, 0, 255)), (2, (0, 255, 0)), (3, (255, 0, 0))]:
        cv2.arrowedLine(img, o, tuple(np.round(uv[i]).astype(int)), c,
                        thickness, cv2.LINE_AA)
    return img
