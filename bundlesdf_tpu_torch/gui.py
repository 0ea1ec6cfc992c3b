"""Live visualization (ref `gui.py:14-188` BundleSdfGui + the feed loop
`bundlesdf.py:27-60`).

Port of `bundlesdf_tpu/gui.py`. The orchestrator-facing surface
(`update_frame`, `update_mesh`, `set_nerf_num_frames`) is provided two
ways:
  - `DpgGui`: the interactive dearpygui window -- the posed frame, the
    masked frame and a live mesh render, mouse drag-rotate (left) /
    drag-move (right) of the mesh view, clean / export / reset buttons
    (ref gui.py:30-58 button row, :73-106 drag handlers, :109-121 mesh
    panel). It makes the JAX package's `dpg` calls, with the same tags,
    labels, sizes and callbacks, in the same order.
  - `HeadlessGui`: writes the same panels to `gui_<id>.png` every
    `every_n` frames, for machines without dearpygui or a display.
`BundleSdfGui` is the reference-named factory: the window where
dearpygui imports and a window opens, `HeadlessGui` otherwise. dearpygui
is imported only if it is installed.

Without cv2: the window's frame is resized as cv2.resize's INTER_LINEAR
does (`matcher/orb.py::resize_linear`, channel by channel) and its mask as
INTER_NEAREST does (`utils/common.py::resize_nearest`); the axes are
`utils/viz.py::draw_xyz_axis` and the mesh panel `mesh/render.py::
render_color`. The headless canvas is resized the same way and written by
`utils/png.py`, and its label is drawn in a small stroke font of this
module with cv2.line's LINE_8 pixels (`utils/viz.py::draw_line`). The
label's strokes are not cv2's Hershey glyphs: the label box (`label_box`)
is the one region where a headless panel may differ from the JAX
package's.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from bundlesdf_tpu_torch.matcher.orb import resize_linear
from bundlesdf_tpu_torch.mesh.render import render_color
from bundlesdf_tpu_torch.utils.common import resize_nearest
from bundlesdf_tpu_torch.utils.png import write_png
from bundlesdf_tpu_torch.utils.viz import draw_line, draw_xyz_axis

try:
    import dearpygui.dearpygui as dpg
    HAS_DPG = True
except ImportError:
    HAS_DPG = False

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


class DpgGui:
    """Interactive dearpygui window consuming the orchestrator's update
    calls (ref gui.py:14-188). The mesh panel renders with the repo's
    barycentric rasterizer (`mesh/render.py`), as the JAX package's does."""

    def __init__(self, img_height: int = 300):
        dpg.create_context()
        dpg.create_viewport(title="BundleSDF-TPU", width=1280, height=760)
        dpg.setup_dearpygui()
        self.H = int(img_height)
        self.W = None
        self.K = None
        self.mesh = None
        self.ob_in_cam = None
        self.ob_in_cam_view = None     # user-adjusted mesh view pose
        self._texes_ready = False

        with dpg.window(label="", tag="main"):
            with dpg.group(horizontal=True, tag="buttons"):
                dpg.add_button(label="clean_mesh", callback=self.clean_mesh)
                dpg.add_file_dialog(
                    directory_selector=False, show=False,
                    callback=self.export_mesh, tag="export_dialog",
                    default_filename="mesh.obj", height=600, width=900)
                dpg.add_button(label="export_mesh",
                               callback=lambda: dpg.show_item(
                                   "export_dialog"))
                dpg.add_button(label="reset_mesh_view",
                               callback=self.reset_mesh_view)
            with dpg.handler_registry():
                dpg.add_mouse_drag_handler(
                    button=dpg.mvMouseButton_Left,
                    callback=self.drag_rotate_pose)
                dpg.add_mouse_drag_handler(
                    button=dpg.mvMouseButton_Right,
                    callback=self.drag_move_pose)
            dpg.add_group(horizontal=True, tag="row_imgs")
            dpg.add_group(horizontal=True, tag="row_mesh")
            with dpg.group(horizontal=True, tag="row_text"):
                dpg.add_text("frame: 0", tag="frame_id", color=[0, 255, 0])
                dpg.add_text("keyframes: 0", tag="keyframe_num",
                             color=[0, 255, 0])
                dpg.add_text("nerf_frames: 0", tag="nerf_num_frames",
                             color=[0, 255, 0])
        dpg.set_primary_window("main", True)
        dpg.show_viewport()

    # -- button callbacks -------------------------------------------------
    def clean_mesh(self):
        if self.mesh is not None:
            try:
                self.mesh = self.mesh.keep_biggest_component()
                self._render_mesh_panel()
            except Exception as e:  # a button must not stop the pipeline
                logging.info(e)

    def export_mesh(self, sender, app_data):
        path = app_data.get("file_path_name", "")
        if path and self.mesh is not None:
            self.mesh.export(path)
            logging.info(f"exported mesh to {path}")

    def reset_mesh_view(self):
        if self.ob_in_cam is not None:
            self.ob_in_cam_view = self.ob_in_cam.copy()
            self._render_mesh_panel()

    # -- mouse-drag mesh-view control (ref gui.py:73-106) ----------------
    def drag_rotate_pose(self, sender, app_data):
        if self.ob_in_cam_view is None or self.mesh is None:
            return
        dx, dy = app_data[1], app_data[2]
        speed = 0.1
        rx = dy / 180.0 * np.pi * speed
        ry = -dx / 180.0 * np.pi * speed
        # pivot about the mesh's view-space center so the object spins in
        # place instead of orbiting the camera
        v = self.mesh.vertices @ self.ob_in_cam_view[:3, :3].T \
            + self.ob_in_cam_view[:3, 3]
        center = (v.max(axis=0) + v.min(axis=0)) / 2
        to0 = np.eye(4)
        to0[:3, 3] = -center
        back = np.eye(4)
        back[:3, 3] = center
        self.ob_in_cam_view = back @ _euler_xy(rx, ry) @ to0 \
            @ self.ob_in_cam_view
        self._render_mesh_panel()

    def drag_move_pose(self, sender, app_data):
        if self.ob_in_cam_view is None or self.mesh is None:
            return
        dx, dy = app_data[1], app_data[2]
        # pixel drag -> metric move at the object's depth
        speed = self.ob_in_cam_view[2, 3] / self.K[0, 0] * 0.1
        tf = np.eye(4)
        tf[:2, 3] = [dx * speed, dy * speed]
        self.ob_in_cam_view = tf @ self.ob_in_cam_view
        self._render_mesh_panel()

    # -- orchestrator surface ---------------------------------------------
    def set_nerf_num_frames(self, n: int):
        dpg.set_value("nerf_num_frames", f"nerf_frames: {n}")

    def update_mesh(self, mesh):
        self.mesh = mesh
        self._render_mesh_panel()

    def update_frame(self, rgb, mask, ob_in_cam, id_str, K, n_keyframe):
        if self.K is None:
            scale = self.H / rgb.shape[0]
            self.W = int(rgb.shape[1] * scale)
            self.K = np.asarray(K, np.float64).copy()
            self.K[:2] *= scale
        self.ob_in_cam = np.asarray(ob_in_cam, np.float64)
        if self.ob_in_cam_view is None:
            self.ob_in_cam_view = self.ob_in_cam.copy()
        rgb = _resize_rgb(np.asarray(rgb), (self.W, self.H))
        posed = draw_xyz_axis(rgb, self.ob_in_cam, self.K,
                              scale=0.05 * float(np.linalg.norm(
                                  self.ob_in_cam[:3, 3]) + 0.1))
        masked = rgb.copy()
        if mask is not None:
            m = resize_nearest(np.asarray(mask).astype(np.uint8),
                               (self.W, self.H))
            masked[m == 0] = 0
        if not self._texes_ready:
            blank = np.zeros((self.H, self.W, 4), np.float32).reshape(-1)
            with dpg.texture_registry(show=False):
                for tag in ("rgb", "masked_rgb", "mesh_render"):
                    dpg.add_dynamic_texture(self.W, self.H, blank, tag=tag)
            dpg.add_image("rgb", parent="row_imgs")
            dpg.add_image("masked_rgb", parent="row_imgs")
            dpg.add_image("mesh_render", parent="row_mesh")
            self._texes_ready = True
        dpg.set_value("rgb", self._rgba(posed))
        dpg.set_value("masked_rgb", self._rgba(masked))
        dpg.set_value("frame_id", f"frame: {id_str}")
        dpg.set_value("keyframe_num", f"keyframes: {n_keyframe}")
        self._render_mesh_panel()
        dpg.render_dearpygui_frame()

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _rgba(img):
        """(H,W,3) uint8 -> flat RGBA float32 in [0, 1], alpha 1."""
        rgba = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, img.dtype)], axis=-1)
        return rgba.reshape(-1).astype(np.float32) / 255.0

    def _render_mesh_panel(self):
        if (not self._texes_ready or self.mesh is None
                or len(self.mesh.faces) == 0
                or self.ob_in_cam_view is None):
            return
        img, m = render_color(self.mesh, self.K, self.ob_in_cam_view,
                              self.H, self.W)
        rgba = np.concatenate(
            [img, np.where(m[..., None] > 0, 255, 0)], axis=-1)
        dpg.set_value("mesh_render",
                      rgba.reshape(-1).astype(np.float32) / 255.0)

    def close(self):
        dpg.destroy_context()


def BundleSdfGui(out_dir, img_height=None, **kwargs):
    """Factory with the reference class name: the interactive `DpgGui`
    where dearpygui imports and its window opens (a failure to open it is
    logged as a warning), else the file-backed `HeadlessGui` writing under
    @out_dir (`BundleSdf` passes `<debug_dir>/gui`), which the window does
    not use."""
    if HAS_DPG:
        try:
            return DpgGui(img_height=img_height or 300)
        except Exception as e:
            logging.warning(f"dearpygui window failed ({e}); "
                            "falling back to HeadlessGui")
    if img_height is not None:
        kwargs["img_height"] = img_height
    return HeadlessGui(out_dir, **kwargs)
