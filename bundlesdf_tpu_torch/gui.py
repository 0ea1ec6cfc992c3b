"""Live visualization, headless (ref `gui.py:14-188` BundleSdfGui + the
feed loop `bundlesdf.py:27-60`).

Port of `bundlesdf_tpu/gui.py`'s `HeadlessGui`, `_euler_xy` and the
`BundleSdfGui` factory. `HeadlessGui` keeps the orchestrator-facing
surface (`update_frame`, `update_mesh`, `set_nerf_num_frames`) and writes
the panels the interactive window would show (the posed frame, the masked
frame, the mesh render) to `gui_<id>.png` every `every_n` frames. The
interactive `DpgGui` needs dearpygui and a display, which neither the
CPU nor the GPU machine has, so the factory returns `HeadlessGui`.

Without cv2: the canvas is resized as cv2.resize's INTER_LINEAR does
(`matcher/orb.py::resize_linear`, channel by channel), the PNG is written
by `utils/png.py`, and the label is drawn in a small stroke font of this
module with cv2.line's LINE_8 pixels (`utils/viz.py::draw_line`). The
label's strokes are not cv2's Hershey glyphs: the label box
(`label_box`) is the one region where a panel may differ from the JAX
package's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from bundlesdf_tpu_torch.matcher.orb import resize_linear
from bundlesdf_tpu_torch.mesh.render import render_color
from bundlesdf_tpu_torch.utils.png import write_png
from bundlesdf_tpu_torch.utils.viz import draw_line, draw_xyz_axis

# the label's strokes: polylines on a grid 6 units wide and 10 high, y up
# from the baseline; one unit is fontScale * 2 pixels
_GLYPHS = {
    "0": [[(0, 0), (6, 0), (6, 10), (0, 10), (0, 0)], [(0, 0), (6, 10)]],
    "1": [[(1, 8), (3, 10), (3, 0)], [(1, 0), (5, 0)]],
    "2": [[(0, 10), (6, 10), (6, 5), (0, 5), (0, 0), (6, 0)]],
    "3": [[(0, 10), (6, 10), (6, 0), (0, 0)], [(1, 5), (6, 5)]],
    "4": [[(0, 10), (0, 5), (6, 5)], [(5, 10), (5, 0)]],
    "5": [[(6, 10), (0, 10), (0, 5), (6, 5), (6, 0), (0, 0)]],
    "6": [[(6, 10), (0, 10), (0, 0), (6, 0), (6, 5), (0, 5)]],
    "7": [[(0, 10), (6, 10), (2, 0)]],
    "8": [[(0, 0), (6, 0), (6, 10), (0, 10), (0, 0)], [(0, 5), (6, 5)]],
    "9": [[(6, 5), (0, 5), (0, 10), (6, 10), (6, 0), (0, 0)]],
    "k": [[(0, 10), (0, 0)], [(5, 7), (0, 2)], [(2, 4), (5, 0)]],
    "f": [[(2, 0), (2, 9), (3, 10), (5, 10)], [(0, 7), (4, 7)]],
    "n": [[(0, 7), (0, 0)], [(0, 6), (1, 7), (5, 7), (5, 0)]],
    "e": [[(0, 4), (5, 4), (5, 7), (0, 7), (0, 0), (5, 0)]],
    "r": [[(0, 7), (0, 0)], [(0, 5), (2, 7), (5, 7)]],
    ":": [[(2, 7), (2, 6)], [(2, 1), (2, 0)]],
    " ": [],
}
_ADVANCE, _HEIGHT = 9, 10


def label_box(text, org=(5, 18), font_scale=0.5):
    """(x0, y0, x1, y1), the pixels `draw_label` may touch, ends included:
    a band from one unit above the glyphs to one below the baseline."""
    u = font_scale * 2
    return (org[0], org[1] - int(np.ceil((_HEIGHT + 1) * u)),
            org[0] + int(np.ceil(_ADVANCE * u * len(text))),
            org[1] + int(np.ceil(u)))


def draw_label(img, text, org=(5, 18), font_scale=0.5, color=(0, 255, 0)):
    """@text in the module's stroke font, its baseline starting at @org,
    one pixel wide, in place; returns @img."""
    u = font_scale * 2
    for k, ch in enumerate(text):
        x0 = org[0] + _ADVANCE * u * k
        for line in _GLYPHS[ch]:
            pts = [(int(round(x0 + x * u)), int(round(org[1] - y * u)))
                   for x, y in line]
            for a, b in zip(pts[:-1], pts[1:]):
                draw_line(img, a, b, color)
    return img


def _resize_rgb(img, size):
    """cv2.resize(img, size, interpolation=INTER_LINEAR) of a uint8 RGB
    image, one channel at a time."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    return np.stack([resize_linear(t[..., c], size).numpy()
                     for c in range(img.shape[2])], axis=-1)


class HeadlessGui:
    """File-backed GUI: each `every_n`-th update renders the panels the
    dearpygui window shows and writes them under @out_dir."""

    def __init__(self, out_dir: str, img_height: int = 200,
                 every_n: int = 10):
        self.out_dir = out_dir
        self.img_height = img_height
        self.every_n = every_n
        self.n_keyframe = 0
        self.nerf_num_frames = 0
        self.mesh = None
        self._cnt = 0
        os.makedirs(out_dir, exist_ok=True)

    def set_nerf_num_frames(self, n: int):
        self.nerf_num_frames = n

    def update_mesh(self, mesh):
        self.mesh = mesh

    def update_frame(self, rgb, mask, ob_in_cam, id_str, K, n_keyframe):
        self.n_keyframe = n_keyframe
        self._cnt += 1
        if self._cnt % self.every_n != 0:
            return
        rgb = np.asarray(rgb)
        H, W = rgb.shape[:2]
        posed = draw_xyz_axis(rgb, ob_in_cam, K,
                              scale=0.05 * float(np.linalg.norm(
                                  ob_in_cam[:3, 3]) + 0.1))
        masked = rgb.copy()
        if mask is not None:
            masked[np.asarray(mask) == 0] = 0
        panels = [posed, masked]
        if self.mesh is not None and len(self.mesh.faces) > 0:
            img, _ = render_color(self.mesh, K, ob_in_cam, H, W)
            panels.append(img)
        canvas = np.concatenate(panels, axis=1)
        scale = self.img_height / H
        canvas = _resize_rgb(canvas, (int(canvas.shape[1] * scale),
                                      self.img_height))
        draw_label(canvas, f"kf:{n_keyframe} nerf:{self.nerf_num_frames}")
        write_png(os.path.join(self.out_dir, f"gui_{id_str}.png"), canvas)


def _euler_xy(rx, ry):
    """Rotation about x then y (the reference's euler_matrix(rx, ry, 0))."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    T = np.eye(4)
    T[:3, :3] = Ry @ Rx
    return T


def BundleSdfGui(out_dir, img_height=None, **kwargs):
    """Factory with the reference class name. The port carries no
    interactive window (dearpygui), so it is always the file-backed
    `HeadlessGui`, writing under @out_dir (`BundleSdf` passes
    `<debug_dir>/gui`)."""
    if img_height is not None:
        kwargs["img_height"] = img_height
    return HeadlessGui(out_dir, **kwargs)
