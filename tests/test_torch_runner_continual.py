"""Port parity for the continual half of `NofRunner` on the synthetic orbit
(120x160, the sizes of test_async_nerf.py), held against the JAX runner:

- `add_new_frames` leaves the ray store and the occupancy grid equal to
  JAX's (exact: both are the same numpy on the same inputs);
- with the port's trained params carried to JAX, `extract_mesh` gives the
  SDF grid within 1e-5 (float32 MLP sums in another order) and, both
  packages marching on the native path, the same faces; pose export with a nonzero `pose_array` within 1e-6 (float32
  pose params, float64 host math in both); `mesh_to_real_world` equal;
- a JAX `save_weights` file (params and Adam state) loads in the port;
  the port's own checkpoint round-trips, and training resumes identically;
- `start/poll/finish_training` equals `train()`;
- the interval hooks write the files the JAX runner writes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu import native as jnative
from bundlesdf_tpu.nof import models as jm
from bundlesdf_tpu.nof import runner as jrunner
from bundlesdf_tpu_torch import native as tnative
from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra as tmarch
from bundlesdf_tpu_torch.nof import runner as trunner
from bundlesdf_tpu_torch.nof.models import params_from_jax, params_to_jax
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.scene.bounds import compute_scene_bounds
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)
SMALL = dict(n_step=20, N_rand=128, N_samples=8, N_samples_around_depth=8,
             num_levels=2, finest_res=32, base_res=8, log2_hashmap_size=12,
             n_trace_steps=32)


@pytest.fixture(scope="module")
def orbit():
    """5 frames with the online normalization (scene bounds of the first
    3, sc_factor * 0.7) and each frame's preprocessed data."""
    seq = cube_orbit_sequence(n_frames=5, H=120, W=160, radius=0.45,
                              obj_size=0.08)
    gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    sc, tr, pcd, _ = compute_scene_bounds(seq["colors"][:3], seq["depths"][:3],
                                          seq["masks"][:3], gl[:3], seq["K"])
    sc *= 0.7
    cfg = default_nerf_config()
    cfg.update(SMALL, sc_factor=sc, translation=np.asarray(tr))
    data = preprocess_frame_data(seq["colors"], seq["depths"], seq["masks"],
                                 None, gl, sc, tr)
    pcd_norm = np.clip((pcd + tr) * sc, -1, 1)
    return cfg, data, seq["K"], pcd_norm


def _first(data, n=3):
    rgbs, depths, masks, normals, poses = data
    return rgbs[:n], depths[:n], masks[:n], normals, poses[:n]


def _runners(orbit, seed=0):
    cfg, data, K, pcd = orbit
    port = NofRunner(dict(cfg), *_first(data), K, build_octree_pts=pcd,
                     seed=seed, device="cpu")
    ref = jrunner.NofRunner(dict(cfg), *_first(data), K, build_octree_pts=pcd)
    return port, ref


def _add(runner, orbit, shift):
    """Frames 3-4 join; every pose moves by @shift (normalized units); the
    scene cloud grows by a shifted copy."""
    cfg, (rgbs, depths, masks, _, poses), K, pcd = orbit
    poses = poses.copy()
    poses[:, :3, 3] += shift
    runner.add_new_frames(rgbs[3:], depths[3:], masks[3:], None, poses,
                          new_pcd=np.concatenate([pcd, pcd + 0.01]))


def _to_jax(port, n_pad=16):
    """The port's params as the JAX pytree, per-frame rows padded to the
    JAX runner's frame bucket."""
    p = params_to_jax(port.field.state_dict())
    pa = np.zeros((n_pad, 6), np.float32)
    pa[:len(p["pose_array"])] = p["pose_array"]
    p["pose_array"] = pa
    return jax.tree.map(jnp.asarray, p)


@pytest.fixture(scope="module")
def continual(orbit):
    port, ref = _runners(orbit)
    for r in (port, ref):
        _add(r, orbit, np.array([0.01, -0.02, 0.005]))
    return port, ref


def test_add_new_frames_matches_jax(continual):
    port, ref = continual
    assert len(port.images) == len(ref.images) == 5
    assert port.spec.n_frames == 5 and port.global_step == 0
    assert set(port._rays_host) == set(ref._rays_host)
    for k, v in ref._rays_host.items():
        assert port._rays_host[k].dtype == v.dtype, k
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(port._rays_host[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(port._rays_host[k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(
            port.rays[k].numpy(),
            port._rays_host[k].astype(port.rays[k].numpy().dtype))
    assert port.n_rays_valid == ref.n_rays_valid
    np.testing.assert_array_equal(port.occ_grid.grid.numpy(),
                                  np.asarray(ref.occ_grid.grid))
    np.testing.assert_array_equal(port.occ_grid.trace.numpy(),
                                  np.asarray(ref.occ_grid.trace))
    np.testing.assert_array_equal(port.c2w.numpy(),
                                  np.asarray(ref.c2w_array)[:5])
    assert tuple(port.field.pose_array.shape) == (5, 6)


@pytest.fixture(scope="module")
def trained(orbit):
    port, ref = _runners(orbit)
    port.train(n_steps=40)
    ref.params = _to_jax(port)
    return port, ref


def _grids(monkeypatch, runner, module):
    # both packages march on the native path, through the port's build of
    # `native/`, whichever path their process loaded: the numpy path's
    # vertex merge orders vertices by rounded position, which SDF grids
    # 1e-5 apart can reorder; the native path numbers them by grid edge
    lib = tnative._load()
    assert lib is not None, "the native library did not build"
    for nat in (jnative, tnative):
        monkeypatch.setattr(nat, "_lib", lib)
        monkeypatch.setattr(nat, "_tried", True)
    seen = []
    orig = module.marching_tetrahedra

    def spy(field, isolevel=0.0):
        seen.append(np.array(field))
        return orig(field, isolevel)

    monkeypatch.setattr(module, "marching_tetrahedra", spy)
    mesh = runner.extract_mesh()
    return mesh, seen[0]


def test_extract_mesh_matches_jax(trained, monkeypatch):
    port, ref = trained
    mt, gt = _grids(monkeypatch, port, trunner)
    assert tmarch.last_path == "native"
    mj, gj = _grids(monkeypatch, ref, jrunner)
    assert gt.shape == gj.shape and gt.shape[0] > 20
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    assert (gt < 0).any() and mt is not None and mj is not None
    np.testing.assert_array_equal(mt.faces, mj.faces)
    # a vertex interpolates the SDF along an edge: its error is the SDF's
    # over the edge's SDF difference, times the voxel size
    np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0, atol=1e-5)


def test_pose_export_and_mesh_to_real_world_match_jax(orbit, trained):
    port, ref = trained
    pa = np.random.default_rng(3).normal(0, 0.6, (3, 6)).astype(np.float32)
    with torch.no_grad():
        port.field.pose_array.copy_(torch.from_numpy(pa))
    ref.params["pose_array"] = ref.params["pose_array"].at[:3].set(pa)
    pt, ot = port.get_optimized_poses_in_real_world()
    pj, oj = ref.get_optimized_poses_in_real_world()
    assert pt.dtype == pj.dtype == np.float32
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-6)
    # the corrections moved the poses off the tracker's (frame 0 pinned)
    raw = port.poses.copy()
    raw[:, :3, 3] = raw[:, :3, 3] / port.cfg["sc_factor"] \
        - np.asarray(port.cfg["translation"])
    assert np.abs(pt[1:] - (raw @ GLCAM_IN_CVCAM)[1:]).max() > 1e-3
    mesh = port.extract_mesh()
    wt = port.mesh_to_real_world(mesh.copy(), pose_offset=ot)
    wj = ref.mesh_to_real_world(mesh.copy(), pose_offset=ot)
    np.testing.assert_array_equal(wt.vertices, wj.vertices)


def test_jax_checkpoint_loads_in_port(orbit, trained, tmp_path):
    port, ref = trained
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                            jnp.float32), ref.params)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape),
                                            jnp.float32), ref.params)
    ref.opt_state = optax.ScaleByAdamState(count=jnp.asarray(7, jnp.int32),
                                           mu=mu, nu=nu)
    ref.global_step = 123
    path = str(tmp_path / "model_latest.npz")
    ref.save_weights(path)
    cfg, data, K, pcd = orbit
    fresh = NofRunner(dict(cfg), *_first(data), K, build_octree_pts=pcd,
                      seed=9, device="cpu")
    fresh.load_weights(path)
    assert fresh.global_step == 123
    pts = np.random.default_rng(1).uniform(-0.3, 0.3, (2000, 3))
    sdf_j = np.asarray(jm.nof_sdf(ref.params, ref.spec,
                                  jnp.asarray(pts, jnp.float32)))
    with torch.no_grad():
        sdf_t = fresh.field.sdf(torch.as_tensor(pts, dtype=torch.float32))
    np.testing.assert_allclose(sdf_t.numpy(), sdf_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(fresh.field.pose_array.detach().numpy(),
                                  np.asarray(ref.params["pose_array"])[:3])
    m_ref = params_from_jax(jax.tree.map(np.asarray, mu))
    v_ref = params_from_jax(jax.tree.map(np.asarray, nu))
    for name, p in fresh.field.named_parameters():
        st = fresh.optimizer.state[p]
        assert float(st["step"]) == 7.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      m_ref[name][:len(p)].numpy())
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      v_ref[name][:len(p)].numpy())


def test_port_checkpoint_round_trip(orbit, tmp_path):
    cfg, data, K, pcd = orbit
    a = NofRunner(dict(cfg), *_first(data), K, build_octree_pts=pcd,
                  device="cpu")
    a.train(n_steps=12)
    path = str(tmp_path / "ckpt" / "model_latest.npz")
    a.save_weights(path)
    b = NofRunner(dict(cfg), *_first(data), K, build_octree_pts=pcd, seed=4,
                  device="cpu")
    b.load_weights(path)
    assert b.global_step == a.global_step == 12
    for k, v in a.field.state_dict().items():
        torch.testing.assert_close(b.field.state_dict()[k], v, rtol=0, atol=0)
    pb = dict(b.field.named_parameters())
    for name, p in a.field.named_parameters():
        sa, sb = a.optimizer.state[p], b.optimizer.state[pb[name]]
        assert float(sa["step"]) == float(sb["step"]) == 12
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0)
    b.generator.set_state(a.generator.get_state())
    ma, mb = a.train(n_steps=3), b.train(n_steps=3)
    for k in ma:
        np.testing.assert_array_equal(mb[k], ma[k], err_msg=k)


def test_chunked_training_equals_train(orbit):
    cfg, data, K, pcd = orbit
    cfg = dict(cfg, scan_chunk=8)
    a = NofRunner(cfg, *_first(data), K, build_octree_pts=pcd, device="cpu")
    b = NofRunner(cfg, *_first(data), K, build_octree_pts=pcd, device="cpu")
    ma = a.train()
    b.start_training()
    assert b.training_in_flight
    polls = 0
    while not b.poll_training(max_chunks=1):
        polls += 1
    mb = b.finish_training()
    assert not b.training_in_flight and b.finish_training() is None
    assert a.global_step == b.global_step == cfg["n_step"] + 1
    assert set(ma) == set(mb)
    for k in ma:
        assert len(mb[k]) == cfg["n_step"] + 1
        np.testing.assert_array_equal(mb[k], ma[k], err_msg=k)
    with pytest.raises(RuntimeError):
        b.start_training()
        b.start_training()


def test_interval_hooks_write_the_jax_files(tmp_path):
    """The JAX test_interval_hooks.py setup on both runners: the i_weights,
    i_img, i_mesh and i_pose hooks fire at step 50 of 60."""
    seq = cube_orbit_sequence(n_frames=3, H=48, W=64)
    sc = 0.9 / 0.6
    written = {}
    for name, cls, kw in (("jax", jrunner.NofRunner, {}),
                          ("torch", NofRunner, {"device": "cpu"})):
        out = tmp_path / name
        cfg = default_nerf_config()
        cfg.update(SMALL, sc_factor=sc, translation=[0.0, 0.0, 0.0],
                   n_step=60, scan_chunk=10,
                   octree_smallest_voxel_size=2.0 / 32 / sc,
                   octree_dilate_size=2.0 / 32 / sc, mesh_resolution=0.05,
                   save_dir=str(out), i_weights=50, i_img=50, i_mesh=50,
                   i_pose=50, i_print=50)
        data = preprocess_frame_data(
            seq["colors"], seq["depths"], seq["masks"], None,
            seq["cam_in_obs"] @ GLCAM_IN_CVCAM, sc, np.zeros(3))
        r = cls(cfg, *data, seq["K"], **kw)
        r.train(n_steps=60)
        written[name] = sorted(os.listdir(out))
    mesh = "step_0000050_mesh_normalized_space.obj"
    assert mesh in written["torch"]
    strip = lambda names: [n for n in names if n != mesh]  # noqa: E731
    # the JAX mesh may be empty this early in training; the rest must match
    assert strip(written["torch"]) == strip(written["jax"]) == [
        "image_step_0000050.png", "model_latest.npz",
        "step_0000050_optimized_poses.txt"]
    poses = np.loadtxt(tmp_path / "torch" / "step_0000050_optimized_poses.txt")
    assert poses.shape == (12, 4)
