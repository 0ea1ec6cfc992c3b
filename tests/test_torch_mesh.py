"""Port parity for `mesh/`, `native.py` and the mesh half of `eval/`:
marching tetrahedra on an analytic sphere SDF gives the JAX package's
vertices and faces, exactly on the numpy path and order-free on the native
path; the `Mesh`
methods the online loop and the benchmark use (merge, biggest component,
split, seeded surface samples, obj round trip) and the Chamfer / ICP /
`benchmark_video` scoring equal the JAX package's."""
import os

import numpy as np
import pytest

import bundlesdf_tpu.native as jnat
import bundlesdf_tpu_torch.native as tnat
from bundlesdf_tpu.eval.benchmark import benchmark_video as j_benchmark
from bundlesdf_tpu.eval.metrics import (chamfer_distance_mutual as j_chamfer,
                                        icp_point_to_point as j_icp)
from bundlesdf_tpu.mesh import Mesh as JMesh
from bundlesdf_tpu.mesh import marching_tetrahedra as j_march
from bundlesdf_tpu_torch.eval import (benchmark_video, chamfer_distance_mutual,
                                      icp_point_to_point)
from bundlesdf_tpu_torch.mesh import Mesh, marching_tetrahedra


def _sphere(n=28, r=0.6, center=(0.0, 0.0, 0.0)):
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    c = np.asarray(center)
    return np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - r


def _pin_numpy(monkeypatch, *mods):
    """The marching (and rasterizer) paths of @mods take numpy for this
    test, whichever path their process loaded."""
    for mod in mods:
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


# order-free comparison: vertices match one to one within 1e-6 (index
# units; the native path interpolates in float64 from float32 field
# values, as the numpy path does from float64), and triangles are equal
# as cyclic triples of matched vertices (winding included)
MATCH_TOL = 1e-6


def assert_same_surface(va, fa, vb, fb, tol=MATCH_TOL):
    from scipy.spatial import cKDTree
    assert va.shape == vb.shape and fa.shape == fb.shape
    dist, idx = cKDTree(vb).query(va, k=1)
    assert dist.max() <= tol, dist.max()
    assert len(np.unique(idx)) == len(va), "vertex matching is not 1:1"

    def canon(f):
        r = np.argmin(f, axis=1)
        rolled = np.stack([f[np.arange(len(f)), (r + k) % 3]
                           for k in range(3)], axis=1)
        return rolled[np.lexsort(rolled.T[::-1])]

    np.testing.assert_array_equal(canon(idx[fa]), canon(fb))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_marching_equals_jax(path, monkeypatch):
    """numpy: both packages on their numpy paths, exactly equal. native:
    the port's native path, order-free against the port's numpy path and
    the JAX package's numpy path (the two paths emit the same surface in
    another vertex and face order)."""
    sdf = _sphere()
    if path == "numpy":
        _pin_numpy(monkeypatch, jnat, tnat)
        vj, fj = j_march(sdf, 0.0)
        vt, ft = marching_tetrahedra(sdf, 0.0)
        assert marching_tetrahedra.last_path == "numpy"
        assert len(ft) > 1000
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        return
    assert tnat.available(), "the native library did not build"
    vn, fn = marching_tetrahedra(sdf, 0.0)
    assert marching_tetrahedra.last_path == "native"
    assert len(fn) > 1000
    _pin_numpy(monkeypatch, jnat, tnat)
    vp, fp = marching_tetrahedra(sdf, 0.0)
    assert marching_tetrahedra.last_path == "numpy"
    vj, fj = j_march(sdf, 0.0)
    assert_same_surface(vn, fn, vp, fp)
    assert_same_surface(vn, fn, vj, fj)


def test_native_library_is_private():
    """The port loads its own build, renamed into its build directory
    whole, never the JAX package's `native/build/` file."""
    assert tnat.available()
    path = tnat.library_path()
    assert os.path.dirname(path) == tnat.BUILD_DIR
    assert os.path.exists(path)
    assert os.path.realpath(tnat._lib._name) == os.path.realpath(path)
    assert "native/build" not in path


def _two_spheres():
    sdf = np.minimum(_sphere(24, 0.3, (-0.45, 0, 0)),
                     _sphere(24, 0.2, (0.5, 0, 0)))
    v, f = marching_tetrahedra(sdf, 0.0)
    return v / 23.0 * 2 - 1, f


def test_mesh_methods_equal_jax(tmp_path):
    v, f = _two_spheres()
    # duplicate the vertices so merge_vertices has work to do
    v2 = np.concatenate([v, v])
    f2 = np.concatenate([f[: len(f) // 2], f[len(f) // 2:] + len(v)])
    mj, mt = JMesh(v2, f2), Mesh(v2, f2)
    for m in (mj, mt):
        m.merge_vertices()
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)
    cj, ct = mj.split_components(), mt.split_components()
    assert len(ct) == len(cj) == 2
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_array_equal(mt.sample_surface(5000, seed=3),
                                  mj.sample_surface(5000, seed=3))
    T = np.eye(4)
    T[:3, 3] = (0.1, -0.2, 0.3)
    for m in (mj, mt):
        m.keep_biggest_component()
        m.apply_transform(T)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)
    mt.export(str(tmp_path / "t.obj"))
    mj.export(str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    back = Mesh.load(str(tmp_path / "t.obj"))
    np.testing.assert_allclose(back.vertices, mt.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(back.faces, mt.faces)


def test_chamfer_icp_and_benchmark_equal_jax():
    v, f = _two_spheres()
    mesh = Mesh(v * 0.05, f)
    rng = np.random.default_rng(0)
    gt = mesh.sample_surface(4000, seed=1) + rng.normal(0, 1e-3, (4000, 3))
    src = gt @ np.array([[1, -0.02, 0], [0.02, 1, 0], [0, 0, 1]]).T + 0.003
    np.testing.assert_array_equal(icp_point_to_point(src, gt),
                                  j_icp(src, gt))
    assert chamfer_distance_mutual(src, gt) == j_chamfer(src, gt)
    gt_poses = np.tile(np.eye(4), (5, 1, 1))
    gt_poses[:, 2, 3] = 0.5 + 0.01 * np.arange(5)
    pred = gt_poses.copy()
    pred[:, :3, 3] += rng.normal(0, 0.002, (5, 3))
    kw = dict(gt_poses=gt_poses, gt_model_pts=gt, gt_visible_pts=gt,
              pred_poses=pred)
    out_t = benchmark_video(None, pred_mesh=mesh, **kw)
    out_j = j_benchmark(None, pred_mesh=JMesh(mesh.vertices, mesh.faces), **kw)
    assert out_t == out_j
    # the scoring keeps the biggest component, so the small sphere is missed
    assert np.isfinite(out_t["chamfer(cm)"]) and out_t["chamfer(cm)"] < 1.0
