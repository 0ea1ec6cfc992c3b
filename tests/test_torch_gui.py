"""The port's headless GUI (`bundlesdf_tpu_torch/gui.py`) against the JAX
package's `HeadlessGui` on `test_aux.py`'s inputs: the written panel is
pixel-equal outside the label box, where the port draws its own stroke
font instead of cv2's Hershey glyphs. Both packages draw the XYZ axes with
the port's `draw_xyz_axis` here (the anti-aliased arrows are close to
cv2's, not equal; `test_torch_viz.py` holds them). Also: the canvas resize
equals cv2.resize, the factory returns `HeadlessGui`, `_euler_xy` is a
rotation, and `BundleSdf(use_gui=True)` writes `gui_<id>.png` every
`every_n` frames."""
import cv2
import numpy as np
import pytest
import torch

import bundlesdf_tpu.gui as jgui
from synthetic import cube_orbit_sequence

from bundlesdf_tpu.mesh import Mesh as JMesh
from bundlesdf_tpu.mesh import marching_tetrahedra
from bundlesdf_tpu_torch import gui
from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import default_nerf_config, default_track_config
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.utils.png import read_png
from bundlesdf_tpu_torch.utils.viz import draw_xyz_axis

torch.set_num_threads(2)


def _cube_mesh():
    xs = np.linspace(-0.12, 0.12, 12)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    v, f = marching_tetrahedra(
        np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)]) - 0.08, 0)
    return v * (xs[1] - xs[0]) + xs[0], f


@pytest.mark.parametrize("mesh", [False, True])
def test_headless_panel_equals_jax(tmp_path, monkeypatch, mesh):
    monkeypatch.setattr(jgui, "draw_xyz_axis", draw_xyz_axis)
    seq = cube_orbit_sequence(n_frames=1, H=60, W=80)
    v, f = _cube_mesh()
    label = "kf:2 nerf:3"
    for name, mod, M in (("jax", jgui, JMesh), ("port", gui, Mesh)):
        g = mod.HeadlessGui(str(tmp_path / name), every_n=1)
        if mesh:
            g.update_mesh(M(v, f))
        g.set_nerf_num_frames(3)
        g.update_frame(rgb=seq["colors"][0], mask=seq["masks"][0],
                       ob_in_cam=np.linalg.inv(seq["cam_in_obs"][0]),
                       id_str="0000", K=seq["K"], n_keyframe=2)
    ref = cv2.imread(str(tmp_path / "jax" / "gui_0000.png"))[..., ::-1]
    got = read_png(str(tmp_path / "port" / "gui_0000.png"))
    assert got.shape == ref.shape == (200, 200 * (3 if mesh else 2) * 80
                                      // 60 // 1, 3)
    # the label box: the port's, widened to hold cv2's text box
    (tw, th), base = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
    x0, y0, x1, y1 = gui.label_box(label)
    x0, y0 = min(x0, 5), min(y0, 18 - th)
    x1, y1 = max(x1, 5 + tw), max(y1, 18 + base)
    outside = np.ones(got.shape[:2], bool)
    outside[y0:y1 + 1, x0:x1 + 1] = False
    np.testing.assert_array_equal(got[outside], ref[outside])
    # both wrote a green label inside the box
    for img in (got, ref):
        box = img[y0:y1 + 1, x0:x1 + 1]
        assert ((box == (0, 255, 0)).all(-1)).sum() > 20


@pytest.mark.parametrize("size", [(60, 80, 200, 266), (480, 1920, 200, 800),
                                  (37, 53, 91, 17)])
def test_canvas_resize_equals_cv2(size):
    H, W, h, w = size
    img = np.random.default_rng(H).integers(0, 256, (H, W, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(gui._resize_rgb(img, (w, h)),
                                  cv2.resize(img, (w, h)))


def test_factory_and_view_math(tmp_path):
    g = gui.BundleSdfGui(out_dir=str(tmp_path), img_height=120)
    assert isinstance(g, gui.HeadlessGui) and g.img_height == 120
    assert g.out_dir == str(tmp_path)
    with pytest.raises(TypeError):      # no shared default folder
        gui.BundleSdfGui()
    T = gui._euler_xy(0.3, -0.7)
    R = T[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert np.isclose(np.linalg.det(R), 1.0)
    np.testing.assert_array_equal(T, jgui._euler_xy(0.3, -0.7))
    assert np.allclose(T[3], [0, 0, 0, 1]) and np.allclose(T[:3, 3], 0)


def test_bundlesdf_use_gui_writes_every_n(tmp_path):
    n = 12
    seq = cube_orbit_sequence(n_frames=n, H=60, W=80, full_angle=0.3)
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp_path)
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 300
    t = BundleSdf(cfg_track=cfg, cfg_nerf=default_nerf_config(),
                  start_nerf_keyframes=99, use_gui=True, device="cpu")
    assert isinstance(t.gui, gui.HeadlessGui)
    for i in range(n):
        t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
              seq["id_strs"][i], mask=seq["masks"][i])
    t.on_finish()
    every = t.gui.every_n
    written = sorted(p.name for p in (tmp_path / "gui").iterdir())
    assert written == [f"gui_{seq['id_strs'][i]}.png"
                       for i in range(every - 1, n, every)]
    img = read_png(str(tmp_path / "gui" / written[0]))
    assert img.shape == (200, 2 * 200 * 80 // 60, 3)
