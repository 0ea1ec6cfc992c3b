"""The offline half of the pipeline in the port, held against the JAX
package: a small JAX online run (tests/test_global_refine.py's) writes the
artifacts, then

- the port's `run_global_nerf` reads them into exactly the runner inputs
  the JAX package's does (images, depths, masks, poses, K, sc_factor,
  translation, point cloud);
- artifacts the port's online run writes (PNGs, `keyframes.yml`) read
  back in cv2 / PyYAML as the port wrote them, and the JAX package's
  `run_global_nerf` reads them into the same inputs as the port's;
- with the JAX-trained weights carried across through `load_weights`, the
  port's refine outputs match JAX's: cleaned mesh faces equal and
  vertices within 1e-5 (float32 MLP sums in another order move the SDF
  ~1e-6; both packages march and rasterize on the native path, through
  the port's build), optimized poses within 1e-6, and the baked texture
  within 1 grey level on 99 % of its texels;
- an end-to-end port refine at the tiny config of test_global_refine.py
  passes that test's artifact checks."""
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
import yaml

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

import bundlesdf_tpu.bundlesdf as jbsdf
import bundlesdf_tpu.native as jnat
import bundlesdf_tpu_torch.bundlesdf as tbsdf
import bundlesdf_tpu_torch.native as tnat
from bundlesdf_tpu.config import default_nerf_config, default_track_config
from bundlesdf_tpu_torch.config import load_yaml
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra
from bundlesdf_tpu_torch.mesh.render import rasterize
from bundlesdf_tpu_torch.utils.png import read_png

torch.set_num_threads(2)
N_FRAMES = 8
TINY = dict(
    n_step=100, N_rand=512, N_samples=16, N_samples_around_depth=16,
    num_levels=4, finest_res=48, base_res=8, log2_hashmap_size=14,
    n_trace_steps=64, mesh_resolution=0.01, frame_features=2,
    rgb_weight=100, first_frame_weight=1, fs_sdf=0.1, n_train_image=100)


def _seq():
    return cube_orbit_sequence(n_frames=N_FRAMES, H=90, W=120, radius=0.45,
                               obj_size=0.08, full_angle=0.35)


def _track_cfg(tmp):
    cfg_t = default_track_config()
    cfg_t["debug_dir"] = tmp
    cfg_t["ransac"]["max_trans_neighbor"] = 0.05
    cfg_t["ransac"]["max_iter"] = 500
    cfg_t["bundle"]["max_BA_frames"] = 5
    cfg_t["bundle"]["depth_association_radius"] = 2
    return cfg_t


@pytest.fixture(scope="module")
def jax_online(tmp_path_factory):
    """tests/test_global_refine.py's online run (JAX, tracker only)."""
    tmp = str(tmp_path_factory.mktemp("jax_online"))
    seq = _seq()
    cfg_t = _track_cfg(tmp)
    tracker = jbsdf.BundleSdf(cfg_track=cfg_t, cfg_nerf=default_nerf_config(),
                              start_nerf_keyframes=99)
    for i in range(N_FRAMES):
        tracker.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                    seq["id_strs"][i], mask=seq["masks"][i])
    tracker.flush_pipeline()
    return tmp, seq


@pytest.fixture(scope="module")
def port_online(tmp_path_factory):
    """The same run through the port on the CPU, fed cv2's features."""
    tmp = str(tmp_path_factory.mktemp("port_online"))
    seq = _seq()
    tracker = tbsdf.BundleSdf(cfg_track=_track_cfg(tmp),
                              cfg_nerf=default_nerf_config(),
                              start_nerf_keyframes=99, device="cpu",
                              matcher=OrbMatcher(device="cpu",
                                                 detector=cv2_detector))
    for i in range(N_FRAMES):
        tracker.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                    seq["id_strs"][i], mask=seq["masks"][i])
    tracker.flush_pipeline()
    return tmp, seq


class _Captured(Exception):
    pass


def _runner_inputs(monkeypatch, module, debug_dir, **kw):
    """What `run_global_nerf` of @module hands its NofRunner."""
    got = {}

    def stub(cfg, images, depths, masks, normal_maps, poses, K,
             build_octree_pts=None, **_):
        got.update(sc_factor=cfg["sc_factor"],
                   translation=np.asarray(cfg["translation"]), images=images,
                   depths=depths, masks=masks, poses=poses, K=K,
                   pcd=build_octree_pts, normals=normal_maps)
        raise _Captured

    monkeypatch.setattr(module, "NofRunner", stub)
    cfg_n = default_nerf_config()
    cfg_n.update(TINY)
    t = module.BundleSdf(cfg_track=_track_cfg(debug_dir), cfg_nerf=cfg_n,
                         start_nerf_keyframes=5, **kw)
    with pytest.raises(_Captured):
        t.run_global_nerf(get_texture=True, tex_res=256)
    monkeypatch.undo()
    return got


def _assert_same_inputs(a, b):
    assert a.keys() == b.keys()
    assert a["normals"] is None and b["normals"] is None
    assert a["sc_factor"] == b["sc_factor"]
    for k in ("translation", "images", "depths", "masks", "poses", "K",
              "pcd"):
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_loader_equals_jax(jax_online, monkeypatch):
    tmp, _ = jax_online
    j = _runner_inputs(monkeypatch, jbsdf, tmp)
    t = _runner_inputs(monkeypatch, tbsdf, tmp, device="cpu")
    assert len(t["images"]) >= 3
    _assert_same_inputs(t, j)


def test_jax_reads_port_artifacts(port_online, jax_online, monkeypatch):
    tmp, seq = port_online
    # every PNG the port wrote reads back in cv2 as the port wrote it
    n_png = 0
    for sub in ("color", "color_segmented", "depth", "depth_filtered",
                "depth_vis", "normal", "mask"):
        for f in sorted(os.listdir(os.path.join(tmp, sub))):
            p = os.path.join(tmp, sub, f)
            ours = read_png(p)
            theirs = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            if ours.ndim == 3:
                theirs = theirs[..., ::-1]
            np.testing.assert_array_equal(theirs, ours, err_msg=p)
            n_png += 1
    assert n_png == 7 * N_FRAMES
    # the color and mask artifacts are the inputs, as in the JAX run's
    jtmp, _ = jax_online
    for i, id_str in enumerate(seq["id_strs"]):
        np.testing.assert_array_equal(
            read_png(os.path.join(tmp, "color", f"{id_str}.png")),
            seq["colors"][i])
        np.testing.assert_array_equal(
            read_png(os.path.join(tmp, "mask", f"{id_str}.png")),
            read_png(os.path.join(jtmp, "mask", f"{id_str}.png")))
    # the keyframe registries PyYAML reads are what the port wrote
    regs = sorted(d for d in os.listdir(tmp)
                  if os.path.exists(os.path.join(tmp, d, "keyframes.yml")))
    assert len(regs) == N_FRAMES
    for d in regs:
        p = os.path.join(tmp, d, "keyframes.yml")
        with open(p) as f:
            assert yaml.safe_load(f) == load_yaml(p)
    j = _runner_inputs(monkeypatch, jbsdf, tmp)
    t = _runner_inputs(monkeypatch, tbsdf, tmp, device="cpu")
    _assert_same_inputs(t, j)


def _pin_native(monkeypatch):
    """Both packages march and rasterize through the port's native build,
    whichever path their process loaded."""
    lib = tnat._load()
    assert lib is not None, "the native library did not build"
    for mod in (jnat, tnat):
        monkeypatch.setattr(mod, "_lib", lib)
        monkeypatch.setattr(mod, "_tried", True)


def test_refine_outputs_match_jax_with_jax_weights(jax_online, tmp_path,
                                                   monkeypatch):
    src, _ = jax_online
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    for d in (jdir, tdir):
        shutil.copytree(src, d)
    _pin_native(monkeypatch)
    cfg_n = default_nerf_config()
    # 16 JAX steps in two scan chunks (a JAX step takes ~1 s on the CPU)
    cfg_n.update(TINY, n_step=15, scan_chunk=8)
    jt = jbsdf.BundleSdf(cfg_track=_track_cfg(jdir), cfg_nerf=dict(cfg_n),
                         start_nerf_keyframes=5)
    jt.run_global_nerf(get_texture=True, tex_res=256)
    ckpt = str(tmp_path / "model_latest.npz")
    jt.nerf.save_weights(ckpt)

    def load_instead(self, n_steps=None):
        self.load_weights(ckpt)
    monkeypatch.setattr(tbsdf.NofRunner, "train", load_instead)
    tt = tbsdf.BundleSdf(cfg_track=_track_cfg(tdir), cfg_nerf=dict(cfg_n),
                         start_nerf_keyframes=5, device="cpu")
    tt.run_global_nerf(get_texture=True, tex_res=256)
    assert marching_tetrahedra.last_path == rasterize.last_path == "native"

    out = "nerf_with_bundletrack_online"
    for name in ("mesh_cleaned.obj", "mesh_real_world.obj"):
        mt = Mesh.load(os.path.join(tdir, out, name))
        mj = Mesh.load(os.path.join(jdir, out, name))
        assert len(mt.faces) > 50
        np.testing.assert_array_equal(mt.faces, mj.faces, err_msg=name)
        np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(tdir, out, "optimized_poses.txt")),
        np.loadtxt(os.path.join(jdir, out, "optimized_poses.txt")),
        rtol=0, atol=1e-6)
    tex_t = read_png(os.path.join(tdir, "textured_mesh.png")).astype(int)
    tex_j = cv2.imread(os.path.join(jdir, "textured_mesh.png"))[..., ::-1]
    assert tex_t.shape == (256, 256, 3)
    assert (tex_t != 128).any(-1).mean() > 0.05
    close = (np.abs(tex_t - tex_j) <= 1).all(-1)
    assert close.mean() >= 0.99, close.mean()
    # the config artifact PyYAML reads holds the port's normalization
    with open(os.path.join(tdir, out, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["sc_factor"] == tt.sc_factor
    assert cfg["translation"] == np.asarray(tt.translation).tolist()
    assert cfg == load_yaml(os.path.join(tdir, out, "config.yml"))


def test_port_refine_end_to_end(jax_online, tmp_path):
    """tests/test_global_refine.py's checks on the port's own refine."""
    src, _ = jax_online
    tmp = str(tmp_path / "run")
    shutil.copytree(src, tmp)
    cfg_n = default_nerf_config()
    cfg_n.update(TINY)
    tracker = tbsdf.BundleSdf(cfg_track=_track_cfg(tmp), cfg_nerf=cfg_n,
                              start_nerf_keyframes=5, device="cpu")
    mesh = tracker.run_global_nerf(get_texture=True, tex_res=256)
    d = os.path.join(tmp, "nerf_with_bundletrack_online")
    for f in ("mesh_cleaned.obj", "mesh_real_world.obj",
              "optimized_poses.txt", "config.yml"):
        assert os.path.exists(os.path.join(d, f)), f
    for f in ("textured_mesh.obj", "textured_mesh.png", "textured_mesh.mtl"):
        assert os.path.exists(os.path.join(tmp, f)), f
    assert mesh is not None and len(mesh.faces) > 50
    ext = mesh.vertices.max(0) - mesh.vertices.min(0)
    assert (ext > 0.05).all() and (ext < 0.5).all()
    poses = np.loadtxt(os.path.join(d, "optimized_poses.txt")).reshape(-1, 4, 4)
    assert len(poses) >= 3
    for T in poses:
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                                   atol=1e-3)
    st = tracker.refine_stats
    # the first chunk is timed apart from the refine rate
    n_first = min(tracker.nerf.scan_chunk, st["steps"])
    assert st["steps"] == TINY["n_step"] + 1 and st["first_chunk_s"] > 0
    assert 0 < st["timed_steps"] == st["steps"] - n_first
    assert st["steps_per_s"] > 0
