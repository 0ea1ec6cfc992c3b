"""Port parity for the tracker branches that are off by default
(`depth_processing.denoise_cloud`, `feature_corres.map_points`,
`image_down_scale`, `bundle.w_dense_color`): each switched on in both the
JAX package's and the port's tracker-only `BundleSdf.run`, 5 frames of the
synthetic orbit at 120x160, poses held to each other within 2 mm / 1 deg
and to the ground truth (< 5 mm mean). Both stacks see cv2's features."""
import numpy as np
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu.bundlesdf import BundleSdf as JaxBundleSdf
from bundlesdf_tpu.config import default_nerf_config
from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher

torch.set_num_threads(2)


def _cfg(tmp):
    cfg = default_track_config()
    cfg.update(debug_dir=str(tmp), SPDLOG=0)
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 500
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["depth_association_radius"] = 2
    cfg["feature_corres"]["fused_matcher"] = True
    return cfg
@pytest.mark.parametrize("branch", ["denoise_cloud", "map_points",
                                    "image_down_scale", "w_dense_color"])
def test_off_by_default_branches(tmp_path, branch):
    seq = cube_orbit_sequence(n_frames=5, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.25)
    poses = {}
    for name, cls, kw in (("jax", JaxBundleSdf,
                           {"cfg_nerf": default_nerf_config()}),
                          ("torch", BundleSdf, {"device": "cpu"})):
        if name == "torch":
            kw["matcher"] = OrbMatcher(device="cpu", detector=cv2_detector)
        cfg = _cfg(tmp_path / name)
        if branch == "denoise_cloud":
            cfg["depth_processing"]["denoise_cloud"] = True
        elif branch == "map_points":
            cfg["feature_corres"]["map_points"] = True
        elif branch == "image_down_scale":
            cfg["image_down_scale"] = 2
        else:
            cfg["bundle"]["w_dense_color"] = 0.05
        t = cls(cfg_track=cfg, start_nerf_keyframes=10 ** 9, **kw)
        frames = [t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
                  for i in range(5)]
        t.flush_pipeline()
        assert all(f.status.name != "FAIL" for f in frames)
        poses[name] = np.array([f.pose_in_model for f in frames])
    for Tj, Tt in zip(poses["jax"], poses["torch"]):
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.002
        cos = (np.trace(Tj[:3, :3] @ Tt[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
    gt = seq["cam_in_obs"]
    A = gt[0] @ np.linalg.inv(poses["torch"][0])
    est = np.einsum("ij,njk->nik", A, poses["torch"])
    assert np.mean(np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)) < 0.005
