"""Port parity for `NofRunner.train_ba` (feature-match BA in ray space) and
`render_frame`, held against the JAX runner with the port's params carried
across (the test_train_ba.py setup: frame 1's pose perturbed by ~1 cm,
ground-truth pixel matches between frames 0 and 1).

Tolerances: the BA loss curve within 1e-5 relative (float32 points and
Adam in both; the se3 exponentials round differently by ~1e-7); the
rendered colours and depths within 1e-5 (f32, `perturb=False`, the JAX
hash grid given a run budget of one run per sample so it never clamps)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.nof.models import params_to_jax
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stacks():
    seq = cube_orbit_sequence(n_frames=3, H=64, W=80, radius=0.45,
                              obj_size=0.08, full_angle=0.2)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=10,
        N_rand=128, N_samples=8, N_samples_around_depth=8, num_levels=2,
        finest_res=32, base_res=8, log2_hashmap_size=12, n_trace_steps=32,
        octree_smallest_voxel_size=2.0 / 32 / sc,
        octree_dilate_size=2.0 / 32 / sc, max_trans=0.04, max_rot=10,
        amp=False))
    poses_gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    poses_gl[1][:3, 3] += np.array([0.008, -0.005, 0.004])
    data = preprocess_frame_data(seq["colors"], seq["depths"], seq["masks"],
                                 None, poses_gl, sc, np.zeros(3))
    port = NofRunner(dict(cfg), *data, seq["K"], device="cpu")
    port.train(n_steps=30)
    ref = jrunner.NofRunner(dict(cfg), *data, seq["K"])
    p = params_to_jax(port.field.state_dict())
    pa = np.zeros((ref.spec.n_frames, 6), np.float32)
    pa[:3] = p["pose_array"]
    p["pose_array"] = pa
    ref.params = jax.tree.map(jnp.asarray, p)
    S = cfg["N_samples"] + cfg["N_samples_around_depth"]
    ref.spec = replace(ref.spec, grid=replace(
        ref.spec.grid, k_runs=(S,) * ref.spec.grid.n_levels))
    return seq, port, ref


def _matches(seq):
    """Ground-truth pixel matches frame 0 -> frame 1 by reprojection."""
    m0 = (seq["masks"][0] > 0) & (seq["depths"][0] > 0.1)
    vs, us = np.nonzero(m0)
    sel = np.random.default_rng(0).choice(len(vs), 200, replace=False)
    vs, us = vs[sel], us[sel]
    K = seq["K"]
    z = seq["depths"][0][vs, us]
    pts_cam0 = np.stack([(us - K[0, 2]) * z / K[0, 0],
                         (vs - K[1, 2]) * z / K[1, 1], z], -1)
    T0, T1 = seq["cam_in_obs"][0], seq["cam_in_obs"][1]
    pts_w = pts_cam0 @ T0[:3, :3].T + T0[:3, 3]
    pts_c1 = (pts_w - T1[:3, 3]) @ T1[:3, :3]
    u1 = pts_c1[:, 0] / pts_c1[:, 2] * K[0, 0] + K[0, 2]
    v1 = pts_c1[:, 1] / pts_c1[:, 2] * K[1, 1] + K[1, 2]
    ok = (u1 >= 0) & (u1 < 80) & (v1 >= 0) & (v1 < 64)
    return {(0, 1): np.stack([us[ok], vs[ok], u1[ok], v1[ok]], -1)}


def test_render_frame_matches_jax(stacks):
    _, port, ref = stacks
    for fid in (0, 2):
        (ot, it), (oj, ij) = port.render_frame(fid), ref.render_frame(fid)
        np.testing.assert_array_equal(it, ij)
        assert len(it) > 100
        for k in ("rgb_map", "depth_pred"):
            np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_train_ba_matches_jax(stacks):
    seq, port, ref = stacks
    matches = _matches(seq)
    pairs = port.match_table_to_ray_pairs(matches)
    np.testing.assert_array_equal(pairs, ref.match_table_to_ray_pairs(matches))
    assert len(pairs) > 50
    before = port.field.pose_array.detach().clone()
    lt = port.train_ba(pairs, n_steps=150, max_dist=0.05)
    lj = ref.train_ba(pairs, n_steps=150, max_dist=0.05)
    assert lt.shape == lj.shape == (150,)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    assert lt[-1] < lt[0] * 0.7  # the match distance shrinks
    after = port.field.pose_array.detach()
    np.testing.assert_allclose(after.numpy(),
                               np.asarray(ref.params["pose_array"])[:3],
                               rtol=0, atol=1e-4)
    # frame 1 got corrected; frame 2 has no match, so Adam never moves it
    assert (after[1] - before[1]).abs().max() > 1e-3
    torch.testing.assert_close(after[2], before[2], rtol=0, atol=0)
    assert port.train_ba(np.zeros((0, 2), np.int64)) is None
