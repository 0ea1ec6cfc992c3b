"""`mesh/render.py` and `mesh/texture.py` of the port against the JAX
package, on the cube mesh of tests/test_texture.py. Both packages are
pinned to one rasterizer path in each case (numpy, or the native library
of the port's build), so the outputs are equal exactly: depth, face ids,
barycentrics, the shaded render, both UV atlases and the baked texture."""
import numpy as np
import pytest

from synthetic import cube_orbit_sequence

import bundlesdf_tpu.native as jnat
import bundlesdf_tpu_torch.native as tnat
from bundlesdf_tpu.mesh import Mesh as JMesh
from bundlesdf_tpu.mesh import marching_tetrahedra as j_march
from bundlesdf_tpu.mesh.render import rasterize as j_rasterize
from bundlesdf_tpu.mesh.render import render_color as j_render_color
from bundlesdf_tpu.mesh.texture import bake_texture as j_bake
from bundlesdf_tpu.mesh.texture import unwrap_charted_atlas as j_charted
from bundlesdf_tpu.mesh.texture import unwrap_trivial_atlas as j_trivial
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.mesh.render import rasterize, render_color
from bundlesdf_tpu_torch.mesh.texture import (bake_texture,
                                              unwrap_charted_atlas,
                                              unwrap_trivial_atlas)
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM
from bundlesdf_tpu_torch.utils.se3 import se3_exp_np


@pytest.fixture(params=["numpy", "native"])
def path(request, monkeypatch):
    lib = None
    if request.param == "native":
        lib = tnat._load()
        assert lib is not None, "the native library did not build"
    for mod in (jnat, tnat):
        monkeypatch.setattr(mod, "_lib", lib)
        monkeypatch.setattr(mod, "_tried", True)
    return request.param


def _cube_mesh(half=0.08):
    """tests/test_texture.py's cube (marched on the numpy path)."""
    xs = np.linspace(-1.5 * half, 1.5 * half, 24)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)]) - half
    v, f = j_march(sdf, 0)
    return v * (xs[1] - xs[0]) + xs[0], f


def test_rasterize_and_render_color_equal_jax(path):
    seq = cube_orbit_sequence(n_frames=2, H=60, W=80, radius=0.45,
                              obj_size=0.08)
    v, f = _cube_mesh()
    rng = np.random.default_rng(0)
    vc = rng.integers(0, 256, (len(v), 3)).astype(np.uint8)
    for i in range(2):
        T = np.linalg.inv(seq["cam_in_obs"][i])
        rt = rasterize(v, f, seq["K"], T, 60, 80)
        rj = j_rasterize(v, f, seq["K"], T, 60, 80)
        assert rasterize.last_path == path
        assert (rt["face_id"] >= 0).sum() > 100
        for k in ("depth", "face_id", "bary"):
            assert rt[k].dtype == rj[k].dtype
            np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
        for colors in (None, vc):
            it, dt = render_color(Mesh(v, f, vertex_colors=colors),
                                  seq["K"], T, 60, 80)
            ij, dj = j_render_color(JMesh(v, f, vertex_colors=colors),
                                    seq["K"], T, 60, 80)
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(dt, dj)


def test_atlases_equal_jax():
    v, f = _cube_mesh()
    for unwrap, j_unwrap in ((unwrap_trivial_atlas, j_trivial),
                             (unwrap_charted_atlas, j_charted)):
        t, j = unwrap(Mesh(v, f), 256), j_unwrap(JMesh(v, f), 256)
        np.testing.assert_array_equal(t.vertices, j.vertices)
        np.testing.assert_array_equal(t.faces, j.faces)
        np.testing.assert_array_equal(t.uv, j.uv)


def test_bake_texture_equals_jax(path, tmp_path):
    seq = cube_orbit_sequence(n_frames=3, H=80, W=100, radius=0.45,
                              obj_size=0.08)
    v, f = _cube_mesh()
    glcam = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    # small per-frame pose corrections, frame 0 pinned (as the NOF's)
    tau = np.random.default_rng(1).normal(0, 0.01, (3, 6))
    corr = se3_exp_np(tau)
    corr[0] = np.eye(4)
    t = bake_texture(Mesh(v, f), seq["colors"], seq["masks"], glcam,
                     seq["K"], pose_corrections=corr, tex_res=256)
    j = j_bake(JMesh(v, f), seq["colors"], seq["masks"], glcam, seq["K"],
               pose_corrections=corr, tex_res=256)
    assert rasterize.last_path == path
    baked = (t.texture != 128).any(-1)
    assert baked.mean() > 0.01
    np.testing.assert_array_equal(t.texture, j.texture)
    np.testing.assert_array_equal(t.uv, j.uv)
    np.testing.assert_array_equal(t.faces, j.faces)
    # the textured OBJ (mesh, material, texture image) writes as JAX's
    t.export(str(tmp_path / "t.obj"))
    j.export(str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_text().replace("t.mtl", "j.mtl") == \
        (tmp_path / "j.obj").read_text()
    from bundlesdf_tpu_torch.utils.png import read_png
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                  read_png(str(tmp_path / "j.png")))
