"""Port parity for `NofRunner`'s host half on the synthetic orbit: the ray
store and the occupancy grid equal the JAX runner's exactly; the scipy mask
dilation equals `cv2.dilate`; and the port's runner trains on the CPU with
a falling loss, as tests/test_nof_train.py asserts for JAX."""
import cv2
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.nof.runner import NofRunner as JaxNofRunner
from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.nof.runner import (NofRunner, dilate_mask,
                                            preprocess_frame_data)
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def orbit():
    seq = cube_orbit_sequence(n_frames=5, H=56, W=72, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=160, N_rand=768,
        N_samples=20, N_samples_around_depth=20, num_levels=4, finest_res=48,
        base_res=8, log2_hashmap_size=14, n_trace_steps=64,
        octree_smallest_voxel_size=2.0 / 64 / sc,
        octree_dilate_size=2.0 / 64 / sc))
    data = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    return cfg, data, seq["K"]


@pytest.fixture(scope="module", params=["depth_cloud", "given_cloud"])
def runners(request, orbit):
    """Both runners on the same frames; "given_cloud" passes a scene cloud,
    which also runs the KD-tree ray denoising."""
    cfg, (rgbs, depths, masks, normals, poses), K = orbit
    pts = None
    if request.param == "given_cloud":
        pts = np.random.default_rng(0).uniform(-0.15, 0.15, (4000, 3))
    port = NofRunner(cfg, rgbs, depths, masks, normals, poses, K,
                     build_octree_pts=pts, device="cpu")
    ref = JaxNofRunner(cfg, rgbs, depths, masks, normals, poses, K,
                       build_octree_pts=pts)
    return port, ref


def test_ray_store_matches_jax(runners):
    port, ref = runners
    assert set(port._rays_host) == set(ref._rays_host)
    for k, v in ref._rays_host.items():
        assert port._rays_host[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port._rays_host[k], v, err_msg=k)
        np.testing.assert_array_equal(port.rays[k].numpy(),
                                      v.astype(port.rays[k].numpy().dtype),
                                      err_msg=k)
    assert port.n_rays_valid == ref.n_rays_valid > 1000


def test_occupancy_grid_matches_jax(runners):
    port, ref = runners
    assert (port.occ_grid.res, port.occ_grid.trace_res) == \
        (ref.occ_grid.res, ref.occ_grid.trace_res)
    np.testing.assert_array_equal(port.occ_grid.grid.numpy(),
                                  np.asarray(ref.occ_grid.grid))
    np.testing.assert_array_equal(port.occ_grid.trace.numpy(),
                                  np.asarray(ref.occ_grid.trace))
    assert port.rcfg.n_trace_steps == ref.rcfg.n_trace_steps


@pytest.mark.parametrize("k", [100, 60])
def test_mask_dilation_matches_cv2(orbit, k):
    masks = orbit[1][2]
    for m in masks[..., 0].astype(np.uint8):
        np.testing.assert_array_equal(
            dilate_mask(m, k), cv2.dilate(m, np.ones((k, k), np.uint8),
                                          iterations=1))


def test_training_reduces_loss(orbit):
    cfg, (rgbs, depths, masks, normals, poses), K = orbit
    runner = NofRunner(cfg, rgbs, depths, masks, normals, poses, K,
                       device="cpu")
    metrics = runner.train(n_steps=40)
    assert runner.global_step == 40
    assert np.isfinite(metrics["loss"]).all()
    sdf = metrics["sdf_loss"]
    # the loss first climbs for a few steps, then falls: compare the
    # first and last five-step means
    assert sdf[-5:].mean() < 0.5 * sdf[:5].mean()
