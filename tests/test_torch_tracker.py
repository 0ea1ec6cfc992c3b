"""Port parity for the tracker-only online loop: `BundleSdf.run` of the JAX
package and of `bundlesdf_tpu_torch` on the `test_pipeline.py` fixture (8
frames of the synthetic orbit at 120x160, NOF off, fused matcher in both).
RANSAC draws differ (threefry vs Philox), so the stacks are held to each
other per frame within 2 mm and 1 deg, to the ground truth as
test_pipeline.py holds JAX (< 5 mm mean), and to the same keyframes, FAIL
statuses and artifact files. Both stacks see cv2's features (the port's
own detector is held against cv2 in test_torch_orb.py)."""
import numpy as np
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu.bundlesdf import BundleSdf as JaxBundleSdf
from bundlesdf_tpu.config import default_nerf_config
from bundlesdf_tpu_torch.bundlesdf import BundleSdf, resize_nearest
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher

torch.set_num_threads(2)
N = 8


def _cfg(tmp):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp)
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 500
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["depth_association_radius"] = 2
    cfg["feature_corres"]["fused_matcher"] = True
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    seq = cube_orbit_sequence(n_frames=N, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.35)
    out = {}
    for name, cls, kw in (("jax", JaxBundleSdf,
                           {"cfg_nerf": default_nerf_config()}),
                          ("torch", BundleSdf, {"device": "cpu"})):
        if name == "torch":
            # both stacks see cv2's features
            kw["matcher"] = OrbMatcher(device="cpu", detector=cv2_detector)
        tmp = tmp_path_factory.mktemp(name)
        t = cls(cfg_track=_cfg(tmp), start_nerf_keyframes=10 ** 9, **kw)
        frames = [t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
                  for i in range(N)]
        t.flush_pipeline()
        out[name] = (t, frames, tmp)
    return seq, out


def _aligned(frames, gt):
    est = np.array([f.pose_in_model for f in frames])
    A = gt[0] @ np.linalg.inv(est[0])
    return np.einsum("ij,njk->nik", A, est)


def test_both_track_within_5mm(runs):
    seq, out = runs
    gt = seq["cam_in_obs"]
    for name, (_, frames, _) in out.items():
        est = _aligned(frames, gt)
        errs = [np.linalg.norm(est[i][:3, 3] - gt[i][:3, 3])
                for i in range(N)]
        assert np.mean(errs) < 0.005, (name, errs)


def test_poses_agree_per_frame(runs):
    _, out = runs
    for fj, ft in zip(out["jax"][1], out["torch"][1]):
        Tj, Tt = fj.pose_in_model, ft.pose_in_model
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.002, (fj, Tj, Tt)
        cos = (np.trace(Tj[:3, :3] @ Tt[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0


def test_keyframes_and_statuses_equal(runs):
    _, out = runs
    kj = [kf.id for kf in out["jax"][0].bundler.keyframes]
    kt = [kf.id for kf in out["torch"][0].bundler.keyframes]
    assert kj == kt
    assert ([f.status.name for f in out["jax"][1]]
            == [f.status.name for f in out["torch"][1]])


def test_artifacts_written_the_same_way(runs):
    seq, out = runs
    tj, tt = out["jax"][2], out["torch"][2]
    for i in range(N):
        a = np.loadtxt(tj / "ob_in_cam" / f"{i:04d}.txt")
        b = np.loadtxt(tt / "ob_in_cam" / f"{i:04d}.txt")
        assert a.shape == b.shape == (4, 4)
        np.testing.assert_allclose(a[3], b[3])
        assert ((tj / f"{i:04d}" / "frame.txt").read_text()
                == (tt / f"{i:04d}" / "frame.txt").read_text())
    names = lambda d: sorted(p.relative_to(d).as_posix()
                             for p in d.rglob("*") if p.is_file())
    assert names(tj) == names(tt)
    np.testing.assert_array_equal(np.loadtxt(tj / "cam_K.txt"),
                                  np.loadtxt(tt / "cam_K.txt"))


def test_resize_nearest_matches_cv2():
    cv2 = pytest.importorskip("cv2", reason="cv2 is the reference here")
    rng = np.random.default_rng(0)
    for H, W, down in ((120, 160, 2), (121, 161, 2), (97, 130, 3)):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        dep = rng.random((H, W)).astype(np.float32)
        size = (W // down, H // down)
        np.testing.assert_array_equal(
            resize_nearest(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(
            resize_nearest(dep, size),
            cv2.resize(dep, size, interpolation=cv2.INTER_NEAREST))

