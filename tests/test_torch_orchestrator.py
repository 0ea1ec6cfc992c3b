"""Port parity for the NOF half of the orchestrator (`BundleSdf` with the
NOF on), held against the JAX package:

- one NOF batch, then a continual one, through both `_nerf_batch_body`
  from identical keyframes and poses: scene normalization (sc_factor and
  translation within 1e-12), clouds and ray stores equal; then, with the
  same `pose_array` in both runners, `_sync_poses_from_nerf` gives the
  same keyframe poses (1e-6) and the same `rematch_after_nerf` deletions;
- the whole loop on 8 frames (120x160, `start_nerf_keyframes=2`, strict
  sync, NOF pose corrections off): the same batch schedule, keyframes
  and `nerfed` flags, poses per frame within 2 mm and 1 deg (the stacks'
  RANSAC streams differ, as in test_torch_tracker.py), a mesh from both after
  `on_finish`, and in both stacks the BA leaves `nerfed` keyframes where
  the last sync put them."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu import bundlesdf as jbsdf
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch import bundlesdf as tbsdf
from bundlesdf_tpu_torch.config import (default_nerf_config,
                                        default_track_config)
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.nof import runner as trunner

torch.set_num_threads(2)
N = 8
SMALL = dict(n_step=20, N_rand=128, N_samples=8, N_samples_around_depth=8,
             num_levels=2, finest_res=32, base_res=8, log2_hashmap_size=12,
             n_trace_steps=32, sync_max_delay=0, async_host=False)


def _cfgs(tmp):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp)
    cfg["SPDLOG"] = 0
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 500
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["depth_association_radius"] = 2
    cfg["feature_corres"]["fused_matcher"] = True
    cfg["feature_corres"]["rematch_after_nerf"] = True
    cfg_n = default_nerf_config()
    cfg_n.update(SMALL)
    return cfg, cfg_n


def _stacks(tmp_path_factory, nerf=None, **kw):
    out = {}
    for name, mod, extra in (("jax", jbsdf, {}),
                             ("torch", tbsdf, {"device": "cpu"})):
        if name == "torch":
            # both stacks see cv2's features
            extra["matcher"] = OrbMatcher(device="cpu",
                                          detector=cv2_detector)
        cfg_t, cfg_n = _cfgs(tmp_path_factory.mktemp(name))
        cfg_n.update(nerf or {})
        out[name] = mod.BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, **kw,
                                  **extra)
    return out


# ---------------------------------------------------------------------------
# one batch, then a continual one
# ---------------------------------------------------------------------------

def _keyframes(poses):
    return [types.SimpleNamespace(id=i, pose_in_model=p.copy(), nerfed=False)
            for i, p in enumerate(poses)]


def _compare_runner(jr, tr):
    for k, v in jr._rays_host.items():
        np.testing.assert_array_equal(tr._rays_host[k], v, err_msg=k)
    np.testing.assert_array_equal(tr.occ_grid.grid.numpy(),
                                  np.asarray(jr.occ_grid.grid))
    np.testing.assert_array_equal(tr.build_octree_pts, jr.build_octree_pts)


def test_nerf_batches_and_pose_sync_match_jax(tmp_path_factory, monkeypatch):
    for mod in (jrunner, trunner):  # batch prep only: no training
        monkeypatch.setattr(mod.NofRunner, "start_training",
                            lambda self, n_steps=None: None)
    seq = cube_orbit_sequence(n_frames=5, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.6)
    rng = np.random.default_rng(0)
    poses = seq["cam_in_obs"].copy()
    poses[:, :3, 3] += rng.normal(0, 0.001, (5, 3))
    batch = [{"rgb": seq["colors"][i], "depth": seq["depths"][i],
              "mask": seq["masks"][i], "occ_mask": None, "normal_map": None}
             for i in range(5)]
    b = _stacks(tmp_path_factory, start_nerf_keyframes=10 ** 9)
    for s in b.values():
        s.K = seq["K"]
        s._nerf_batch_body(batch[:3], poses[:3], True)
    bj, bt = b["jax"], b["torch"]
    assert abs(bt.sc_factor - bj.sc_factor) <= 1e-12 * bj.sc_factor
    np.testing.assert_allclose(bt.translation, bj.translation, rtol=0,
                               atol=1e-12)
    assert bt.cfg_nerf["sc_factor"] == bt.sc_factor
    np.testing.assert_array_equal(bt.prev_pcd_real_scale,
                                  bj.prev_pcd_real_scale)
    _compare_runner(bj.nerf, bt.nerf)

    # keyframes moved since the first batch; two new ones join
    moved = poses.copy()
    moved[:, :3, 3] += rng.normal(0, 0.002, (5, 3))
    for s in b.values():
        s._nerf_batch_body(batch[3:], moved, False)
    np.testing.assert_array_equal(bt.prev_pcd_real_scale,
                                  bj.prev_pcd_real_scale)
    _compare_runner(bj.nerf, bt.nerf)
    assert len(bt.nerf.images) == 5

    # the same pose corrections in both runners, then the sync-back
    # frame 2's correction is large (> 5 mm: a rotation about the object
    # moves the camera by radius x angle), the others small
    pa = (rng.normal(0, 1, (5, 6))
          * np.array([0, 0.01, 0.5, 0.01, 0.01])[:, None]).astype(np.float32)
    with torch.no_grad():
        bt.nerf.field.pose_array.copy_(torch.from_numpy(pa))
    bj.nerf.params["pose_array"] = bj.nerf.params["pose_array"].at[:5].set(pa)
    keys = [(1, 0), (2, 1), (3, 2), (4, 3), (4, 0), (2, 0)]
    for s in b.values():
        s.bundler.keyframes = _keyframes(moved)
        s.bundler.matches = {k: None for k in keys}
        s._sync_poses_from_nerf()
    for kj, kt in zip(bj.bundler.keyframes, bt.bundler.keyframes):
        assert kj.nerfed and kt.nerfed
        np.testing.assert_allclose(kt.pose_in_model, kj.pose_in_model,
                                   rtol=0, atol=1e-6)
    assert sorted(bt.bundler.matches) == sorted(bj.bundler.matches) == [
        (1, 0), (4, 0), (4, 3)]


# ---------------------------------------------------------------------------
# the whole loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    seq = cube_orbit_sequence(n_frames=N, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.35)
    mp = pytest.MonkeyPatch()
    pinned = {"jax": [], "torch": []}
    for name, mod in (("jax", jbsdf), ("torch", tbsdf)):
        orig = mod.BundleSdf._sync_poses_from_nerf

        def spy(self, final=False, orig=orig, log=pinned[name]):
            # since the previous sync, BA must have left nerfed keyframes
            # where that sync put them
            for kf in self.bundler.keyframes:
                if kf.nerfed:
                    log.append(np.array_equal(kf.pose_in_model,
                                              kf._synced_pose))
            orig(self, final=final)
            for kf in self.bundler.keyframes:
                kf._synced_pose = kf.pose_in_model.copy()

        mp.setattr(mod.BundleSdf, "_sync_poses_from_nerf", spy)
    try:
        # pose corrections off: the stacks' NOF random streams differ
        # (threefry vs Philox), and 20 Adam steps then move each keyframe
        # by several mm in different directions, which changes the
        # keyframe choice downstream. The corrections themselves are held
        # by test_nerf_batches_and_pose_sync_match_jax.
        b = _stacks(tmp_path_factory, nerf={"optimize_poses": 0},
                    start_nerf_keyframes=2)
        frames = {}
        for name, s in b.items():
            frames[name] = [s.run(seq["colors"][i], seq["depths"][i].copy(),
                                  seq["K"], seq["id_strs"][i],
                                  mask=seq["masks"][i]) for i in range(N)]
            s.on_finish()
    finally:
        mp.undo()
    return seq, b, frames, pinned


def test_loop_batch_schedule_equal(loops):
    _, b, _, _ = loops
    bj, bt = b["jax"], b["torch"]
    for k in ("n_batches", "nof_steps_total"):
        assert bt.pipeline_stats[k] == bj.pipeline_stats[k], k
    assert bt.pipeline_stats["n_batches"] >= 2
    assert (bt.nerf_num_frames, bt.cnt_nerf) == (bj.nerf_num_frames,
                                                 bj.cnt_nerf)
    assert set(bt.pipeline_stats) == set(bj.pipeline_stats)
    assert ([kf.id for kf in bt.bundler.keyframes]
            == [kf.id for kf in bj.bundler.keyframes])
    assert ([kf.nerfed for kf in bt.bundler.keyframes]
            == [kf.nerfed for kf in bj.bundler.keyframes])
    assert all(kf.nerfed for kf in bt.bundler.keyframes)
    assert bt.nerf_num_frames == len(bt.bundler.keyframes)


def test_loop_poses_agree_per_frame(loops):
    _, _, frames, _ = loops
    for fj, ft in zip(frames["jax"], frames["torch"]):
        assert fj.status == ft.status or fj.status.name == ft.status.name
        Tj, Tt = fj.pose_in_model, ft.pose_in_model
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.002, (fj, Tj, Tt)
        cos = (np.trace(Tj[:3, :3] @ Tt[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0


def test_loop_meshes(loops):
    seq, b, _, _ = loops
    for name, s in b.items():
        assert s.mesh is not None, name
        assert len(s.mesh.faces) > 100
        # real-world coordinates: the mesh sits around the 8 cm cube
        ext = s.mesh.vertices.max(0) - s.mesh.vertices.min(0)
        assert (ext < 0.5).all() and (ext > 0.04).all(), (name, ext)


def test_ba_keeps_nerfed_keyframes_pinned(loops):
    _, _, _, pinned = loops
    for name, log in pinned.items():
        assert len(log) > 0 and all(log), name
    assert len(pinned["torch"]) == len(pinned["jax"])
