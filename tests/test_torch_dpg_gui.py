"""The port's interactive window (`bundlesdf_tpu_torch/gui.py::DpgGui`)
against the JAX package's, both driven through one recording dearpygui
stand-in (`tests/dpg_recorder.py`, given to each module as its `dpg`):

- one script on three 120x160 orbit frames (`update_frame` x3,
  `update_mesh`, both drags, `reset_mesh_view`, `clean_mesh`,
  `export_mesh`, `set_nerf_num_frames`, `close`) makes the same calls with
  the same arguments in the same order;
- the `rgb` and `masked_rgb` textures are bit-equal (the port resizes the
  frame and the mask as cv2 does; both packages draw the axes with the
  port's `draw_xyz_axis`, whose anti-aliased arrows are close to cv2's,
  not equal, see `test_torch_viz.py`), and so are the `mesh_render`
  textures, with both packages pinned to one rasterizer path (numpy, and
  the native library), since the two paths may differ on edge pixels;
- the mesh view pose after each drag is within 1e-12, and the exported
  OBJ files are equal;
- the factory `BundleSdfGui` returns `DpgGui` where the stand-in imports
  as dearpygui, `HeadlessGui` where dearpygui is missing, and
  `HeadlessGui` with a warning where the window fails to open.
"""
import importlib.util
import logging
import sys

import numpy as np
import pytest

import bundlesdf_tpu.gui as jgui
import bundlesdf_tpu.native as jnat
import bundlesdf_tpu_torch.native as tnat
from dpg_recorder import DpgRecorder, as_package
from synthetic import cube_orbit_sequence

from bundlesdf_tpu.mesh import Mesh as JMesh
from bundlesdf_tpu.mesh import marching_tetrahedra
from bundlesdf_tpu_torch import gui
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.utils.viz import draw_xyz_axis


@pytest.fixture(params=["numpy", "native"])
def raster_path(request, monkeypatch):
    """Both packages' rasterizer (and marching) on one path."""
    lib = None
    if request.param == "native":
        lib = tnat._load()
        assert lib is not None, "the native library did not build"
    for mod in (jnat, tnat):
        monkeypatch.setattr(mod, "_lib", lib)
        monkeypatch.setattr(mod, "_tried", True)
    return request.param


def _two_part_mesh():
    """A marched cube and, apart from it, one small tetrahedron: the
    biggest component is the cube."""
    xs = np.linspace(-0.12, 0.12, 12)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    v, f = marching_tetrahedra(
        np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)]) - 0.08, 0)
    v = v * (xs[1] - xs[0]) + xs[0]
    tet = np.array([[0.2, 0, 0], [0.22, 0, 0], [0.2, 0.02, 0],
                    [0.2, 0, 0.02]])
    tf = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]) + len(v)
    return np.concatenate([v, tet]), np.concatenate([f, tf])


def _drive(mod, mesh_cls, seq, out_path):
    """One session of the window; returns (the mesh view pose after each
    drag, the window)."""
    v, f = _two_part_mesh()
    poses = [np.linalg.inv(c) for c in seq["cam_in_obs"]]

    def frame(i):
        g.update_frame(rgb=seq["colors"][i], mask=seq["masks"][i],
                       ob_in_cam=poses[i], id_str=seq["id_strs"][i],
                       K=seq["K"], n_keyframe=i + 1)

    g = mod.DpgGui(img_height=90)
    frame(0)
    g.update_mesh(mesh_cls(v.copy(), f.copy()))
    g.set_nerf_num_frames(2)
    frame(1)
    views = []
    g.drag_rotate_pose("handler", [0, 12.0, -7.0])
    views.append(g.ob_in_cam_view.copy())
    g.drag_move_pose("handler", [0, -5.0, 9.0])
    views.append(g.ob_in_cam_view.copy())
    frame(2)
    g.reset_mesh_view()
    g.clean_mesh()
    g.export_mesh("export_dialog", {"file_path_name": str(out_path)})
    g.set_nerf_num_frames(3)
    g.close()
    return views, g


def test_window_equals_jax(tmp_path, monkeypatch, raster_path):
    monkeypatch.setattr(jgui, "draw_xyz_axis", draw_xyz_axis)
    seq = cube_orbit_sequence(n_frames=3, H=120, W=160, full_angle=0.6)
    recs, views, wins = {}, {}, {}
    for name, mod, mesh_cls in (("jax", jgui, JMesh), ("port", gui, Mesh)):
        recs[name] = DpgRecorder()
        monkeypatch.setattr(mod, "dpg", recs[name], raising=False)
        monkeypatch.setattr(mod, "HAS_DPG", True, raising=False)
        views[name], wins[name] = _drive(mod, mesh_cls, seq,
                                         tmp_path / name / "mesh.obj")
    ref, got = recs["jax"], recs["port"]
    assert got.calls == ref.calls
    names = [c[0] for c in got.calls]
    assert names[:3] == ["create_context", "create_viewport",
                         "setup_dearpygui"]
    assert names.count("add_dynamic_texture") == 3
    assert names.count("render_dearpygui_frame") == 3
    assert names[-1] == "destroy_context"
    # the textures: three frames each, the mesh panel at every render
    assert {k: len(v) for k, v in got.values.items()} == {
        "rgb": 3, "masked_rgb": 3, "mesh_render": 7}
    W = int(160 * 90 / 120)
    for tag in ("rgb", "masked_rgb", "mesh_render"):
        for a, b in zip(got.values[tag], ref.values[tag]):
            assert a.dtype == np.float32 and a.shape == (90 * W * 4,)
            assert 0 <= a.min() and a.max() <= 1
            np.testing.assert_array_equal(a, b, err_msg=tag)
    # the mesh panel shows the mesh, the masked panel blacks out the rest
    assert (got.values["mesh_render"][-1].reshape(90, W, 4)[..., 3]
            > 0).any()
    masked = got.values["masked_rgb"][0].reshape(90, W, 4)[..., :3]
    assert (masked == 0).all(-1).mean() > 0.3
    for a, b in zip(views["port"], views["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert not np.allclose(views["port"][0], views["port"][1])
    np.testing.assert_array_equal(wins["port"].ob_in_cam_view,
                                  wins["port"].ob_in_cam)
    assert len(wins["port"].mesh.faces) == len(wins["jax"].mesh.faces) \
        == len(_two_part_mesh()[1]) - 4
    obj = (tmp_path / "port" / "mesh.obj").read_text()
    assert obj == (tmp_path / "jax" / "mesh.obj").read_text()
    assert sum(ln.startswith("f ") for ln in obj.splitlines()) == len(
        wins["port"].mesh.faces)
    # the export button opens the file dialog
    cb = next(kw["callback"] for name, _, kw in got.raw
              if name == "add_button" and kw["label"] == "export_mesh")
    cb()
    assert got.calls[-1] == ("show_item", ("export_dialog",), {})


def _fresh_gui(monkeypatch, modules):
    """`bundlesdf_tpu_torch/gui.py` imported anew as a module of its own,
    with @modules in `sys.modules` (None blocks a name)."""
    for name, m in modules.items():
        monkeypatch.setitem(sys.modules, name, m)
    spec = importlib.util.spec_from_file_location("gui_under_test",
                                                  gui.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_factory_picks_the_window(tmp_path, monkeypatch, caplog):
    rec = DpgRecorder()
    mod = _fresh_gui(monkeypatch, as_package(rec))
    assert mod.HAS_DPG and mod.dpg is rec
    g = mod.BundleSdfGui(out_dir=str(tmp_path / "a"))
    assert isinstance(g, mod.DpgGui) and g.H == 300
    assert isinstance(mod.BundleSdfGui(str(tmp_path / "a"), img_height=120),
                      mod.DpgGui)
    assert rec.calls[0] == ("create_context", (), {})
    assert not (tmp_path / "a").exists()     # the window writes no files
    with pytest.raises(TypeError):           # out_dir stays required
        mod.BundleSdfGui()

    mod = _fresh_gui(monkeypatch, {"dearpygui": None,
                                   "dearpygui.dearpygui": None})
    assert not mod.HAS_DPG and not hasattr(mod, "dpg")
    g = mod.BundleSdfGui(out_dir=str(tmp_path / "b"), img_height=120)
    assert isinstance(g, mod.HeadlessGui) and g.img_height == 120

    broken = DpgRecorder(fail={"create_context"})
    mod = _fresh_gui(monkeypatch, as_package(broken))
    with caplog.at_level(logging.WARNING):
        g = mod.BundleSdfGui(out_dir=str(tmp_path / "c"), every_n=3)
    assert isinstance(g, mod.HeadlessGui) and g.every_n == 3
    assert g.out_dir == str(tmp_path / "c")
    assert any("dearpygui window failed" in r.getMessage()
               and r.levelno == logging.WARNING for r in caplog.records)
    assert broken.calls == []
