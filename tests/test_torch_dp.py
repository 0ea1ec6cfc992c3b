"""Ray data parallelism on the port (`bundlesdf_tpu_torch/parallel/dp.py`,
`NofRunner`'s `dp_devices`), held against the JAX package's
`bundlesdf_tpu/parallel/dp.py` (on the conftest's 8 CPU devices) and
against the port's own single-device step. Replicas on the CPU all share
it: `[cpu] * N` is the counterpart of JAX's N virtual CPU devices.

Tolerances, f32: DP gradients against single-device ones rtol 1e-5, atol
1e-6 * max|g| (tests/test_dp_runner.py's: the shards' means averaged sum
the same terms in another order); against JAX's DP gradients atol 1e-4 *
max|g| (tests/test_torch_nof_step.py's f32 gradient tolerance: two stacks,
two summation orders). One DP step and one single-device step from the
same warmed-up Adam state: params atol 1e-5 = lrate / 1000, as
test_torch_nof_step.py's first Adam step. Replicas: bit-equal."""
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.nof.losses import nof_loss
from bundlesdf_tpu_torch.nof.render import render_rays
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.nof.train import train_step
from bundlesdf_tpu_torch.parallel import dp
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8


def _make_runner(dp_devices=0, n_frames=3, seed=0, **over):
    """tests/test_dp_runner.py's tiny runner, on the CPU."""
    seq = cube_orbit_sequence(n_frames=n_frames + 1, H=48, W=64,
                              radius=0.45, obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=40, N_rand=256,
        N_samples=8, N_samples_around_depth=8, num_levels=2, finest_res=32,
        base_res=8, log2_hashmap_size=12, n_trace_steps=32,
        octree_smallest_voxel_size=2.0 / 32 / sc,
        octree_dilate_size=2.0 / 32 / sc, dp_devices=dp_devices))
    cfg.update(over)
    poses_gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    rgbs, depths, masks, normals, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(),
        None, poses_gl.copy(), sc, np.zeros(3))
    r = NofRunner(cfg, rgbs[:n_frames], depths[:n_frames], masks[:n_frames],
                  None, poses[:n_frames], seq["K"], seed=seed, device="cpu")
    # add_new_frames takes only the NEW frames but ALL frames' poses
    extra = (rgbs[n_frames:], depths[n_frames:], masks[n_frames:], None,
             poses)
    return r, extra


def _assert_replicas_equal(r):
    """Every replica's parameters bit-equal to the master's, as the last
    chunk left them (reading `dp_replicas` syncs nothing)."""
    reps = r.dp_replicas
    assert len(reps) == len(r.dp_devices) and reps[0].field is r.field
    for rep in reps[1:]:
        for (n, p), q in zip(r.field.named_parameters(),
                             rep.field.parameters()):
            assert torch.equal(p, q), n


# -- sharding ---------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [None, 997])
@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_shards_bit_equal_to_jax(n_dev, n_valid):
    import jax
    import jax.numpy as jnp
    from bundlesdf_tpu.parallel import dp as jdp

    rng = np.random.default_rng(n_dev)
    n = 1003
    store = {"dirs": rng.normal(size=(n, 3)).astype(np.float32),
             "rgb": rng.random((n, 3), np.float32),
             "depth": rng.random(n, np.float32),
             "frame_id": rng.integers(0, 5, n).astype(np.int32)}
    mesh = jdp.make_ray_mesh(jax.devices()[:n_dev])
    j_out, j_nvl = jdp.shard_rays({k: jnp.asarray(v) for k, v in
                                   store.items()}, mesh, n_valid=n_valid)
    devs = dp.make_ray_devices(n_dev=n_dev, base="cpu")
    t_out, t_nvl = dp.shard_rays({k: torch.as_tensor(v) for k, v in
                                  store.items()}, devs, n_valid=n_valid)
    assert t_nvl == j_nvl and len(t_out) == n_dev
    for k, v in j_out.items():
        v = np.asarray(v)
        per = v.reshape(n_dev, -1, *v.shape[1:])
        for s in range(n_dev):
            got = t_out[s][k].numpy()
            assert got.dtype == per[s].dtype
            assert np.array_equal(got, per[s]), (k, s)

    batch = {k: v[:24] for k, v in store.items()}
    j_b = jdp.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          mesh)
    t_b = dp.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                         devs)
    for k, v in j_b.items():
        assert np.array_equal(np.concatenate([t[k].numpy() for t in t_b]),
                              np.asarray(v)), k


# -- gradients on one fixed batch ----------------------------------------------

def _fixed_batch(r, n=256):
    """@n rays spread over the whole store (its head is background)."""
    idx = torch.arange(0, r.n_rays_valid, r.n_rays_valid // n)[:n]
    assert len(idx) == n
    return {k: v[idx] for k, v in r.rays.items()}


def _single_device_grads(r, batch):
    trunc = r.tcfg.trunc
    out = render_rays(r.field, r.rcfg, batch, r.c2w, r.occ_grid,
                      perturb=False, trunc=trunc)
    loss = nof_loss(out, batch, r.field, trunc, r.lcfg)[0]
    r.field.zero_grad(set_to_none=True)
    loss.backward()
    g = {n: p.grad.clone() for n, p in r.field.named_parameters()}
    r.field.zero_grad(set_to_none=True)
    return g


def test_dp_grads_equal_single_device():
    """The multi-replica correctness pin (test_dp_runner.py's): a wrong
    denominator or a dropped shard fails it at 12 %+, not 1e-5."""
    r, _ = _make_runner(amp=False)
    batch = _fixed_batch(r)
    g_sd = _single_device_grads(r, batch)
    assert all(g.abs().max() > 0 for g in g_sd.values())
    reps = dp.make_replicas(r.field, CPU8)
    g_dp = dp.grads_on_batch_dp(reps, dp.shard_batch(batch, CPU8), r.c2w,
                                r.occ_grid, r.tcfg.trunc, r.rcfg, r.lcfg)
    assert set(g_dp) == set(g_sd)
    for n, a in g_sd.items():
        a, b = a.numpy(), g_dp[n].numpy()
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(a).max())),
            err_msg=n)
    for rep in reps[1:]:
        for (n, p), q in zip(reps[0].field.named_parameters(),
                             rep.field.parameters()):
            assert torch.equal(p.grad, q.grad), n


def test_dp_grads_match_jax():
    """The port's DP gradients against the JAX package's
    `grads_on_batch_dp` over 8 CPU devices, from the same weights
    (`params_from_jax`), at f32. The JAX spec gets one run per sample, so
    its ray-mode hash-grid dedup never clamps (as in
    test_torch_nof_step.py)."""
    import jax
    import jax.numpy as jnp
    from bundlesdf_tpu.nof import losses as jl
    from bundlesdf_tpu.nof import models as jm
    from bundlesdf_tpu.nof import render as jr
    from bundlesdf_tpu.ops.hashgrid import HashGridSpec as JGridSpec
    from bundlesdf_tpu.ops.occupancy import OccupancyGrid as JOccupancyGrid
    from bundlesdf_tpu.parallel import dp as jdp
    from bundlesdf_tpu_torch.nof.models import params_from_jax

    r, _ = _make_runner(amp=False)
    g, s = r.spec.grid, r.spec
    samples = r.rcfg.n_samples + r.rcfg.n_samples_around_depth
    j_spec = jm.NofSpec(
        grid=JGridSpec(n_levels=g.n_levels, level_dim=g.level_dim,
                       base_res=g.base_res, finest_res=g.finest_res,
                       log2_hashmap_size=g.log2_hashmap_size,
                       ray_samples=samples, k_runs=(samples,) * g.n_levels,
                       scatter_bf16=False, table_bf16=False),
        sh_degree=s.sh_degree, frame_features=s.frame_features,
        n_frames=s.n_frames, max_trans=s.max_trans,
        max_rot_deg=s.max_rot_deg)
    params = jm.init_nof_params(jax.random.PRNGKey(0), j_spec)
    # nonzero pose corrections, so the pose gradient path is exercised
    params["pose_array"] = jnp.asarray(np.random.default_rng(0).normal(
        0.0, 0.3, (s.n_frames, 6)).astype(np.float32))
    r.field.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                         params)))
    j_rcfg = jr.RenderConfig(**{k: getattr(r.rcfg, k) for k in (
        "n_samples", "n_samples_around_depth", "trunc", "neg_trunc_ratio",
        "sdf_lambda", "near", "far", "n_trace_steps", "raw_noise_std",
        "n_importance", "n_importance_iter", "compute_bf16", "eikonal",
        "eikonal_eps")})
    occ = r.occ_grid
    j_occ = JOccupancyGrid(grid=jnp.asarray(occ.grid.numpy()), res=occ.res,
                           trace=jnp.asarray(occ.trace.numpy()),
                           trace_res=occ.trace_res)
    batch = _fixed_batch(r)
    mesh = jdp.make_ray_mesh(jax.devices()[:8])
    j_batch = jdp.shard_batch({k: jnp.asarray(v.numpy()) for k, v in
                               batch.items()}, mesh)
    trunc = r.tcfg.trunc
    g_j = jdp.grads_on_batch_dp(
        params, j_batch, jnp.asarray(r.c2w.numpy()), j_occ,
        jax.random.PRNGKey(7), jnp.asarray(trunc), mesh, j_spec, j_rcfg,
        jl.LossConfig(**r.lcfg.__dict__))
    want = params_from_jax(jax.tree.map(np.asarray, g_j))

    reps = dp.make_replicas(r.field, CPU8)
    g_t = dp.grads_on_batch_dp(reps, dp.shard_batch(batch, CPU8), r.c2w,
                               r.occ_grid, trunc, r.rcfg, r.lcfg)
    assert set(g_t) == set(want)
    for n, w in want.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(g_t[n].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


def test_dp_step_equals_single_device_step():
    """One DP step over 8 replicas with injected shards (perturb off)
    lands where one single-device step on the union batch lands, from the
    same warmed-up Adam state, at a step whose staircase factor is not 1
    and with a pose lr unlike the field's: holds the averaging, the two
    lr groups and the factor."""
    r, _ = _make_runner(amp=False, lrate_pose=0.003, frame_features=2)
    r.train(n_steps=3)
    assert r.tcfg.lrate_pose != r.tcfg.lrate
    step = 25
    assert r.N_iters < 100 and step // 10 > 0  # factor 0.1 ** (20 / 41)
    # 8 DP replicas and a ninth, synced copy for the single-device step
    reps = dp.make_replicas(r.field, [torch.device("cpu")] * 9,
                            optimizer=r.optimizer, tcfg=r.tcfg)
    sd, reps = reps[8], reps[:8]
    batch = _fixed_batch(r)
    start = [p.detach().clone() for p in r.field.parameters()]
    dp.train_step_dp(reps, dp.shard_batch(batch, CPU8), step, [r.c2w] * 8,
                     [r.occ_grid] * 8, r.rcfg, r.lcfg, r.tcfg, r.N_iters,
                     perturb=False)
    train_step(sd.field, sd.optimizer, batch, step, r.c2w, r.occ_grid,
               r.rcfg, r.lcfg, r.tcfg, r.N_iters, perturb=False)
    for (n, p), q, s, p0 in zip(r.field.named_parameters(),
                                reps[1].field.parameters(),
                                sd.field.parameters(), start):
        assert torch.equal(p, q), n
        assert not torch.equal(p, p0), n
        np.testing.assert_allclose(p.detach().numpy(), s.detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    for group in reps[0].optimizer.param_groups:
        assert group["lr"] == pytest.approx(
            group["base_lr"] * 0.1 ** (20 / r.N_iters))


# -- the runner ----------------------------------------------------------------

def test_dp_runner_trains():
    r, _ = _make_runner(dp_devices=8)
    assert r.dp_devices == CPU8
    m = r.train(n_steps=40)
    losses = np.asarray(m["loss"])
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    _assert_replicas_equal(r)
    # each replica drew from its own generator
    draws = [torch.randint(0, 1000, (4,), generator=rep.generator)
             for rep in r.dp_replicas]
    assert len({tuple(d.tolist()) for d in draws}) == 8


def test_dp_matches_single_device_quality():
    # different draws per replica, so losses are not bitwise -- but with
    # gradient EQUALITY pinned above, the trajectories land near-equal
    r_dp, _ = _make_runner(dp_devices=8, seed=1)
    r_sd, _ = _make_runner(dp_devices=0, seed=1)
    assert r_sd.dp_devices is None
    f_dp = float(np.asarray(r_dp.train(n_steps=40)["loss"])[-5:].mean())
    f_sd = float(np.asarray(r_sd.train(n_steps=40)["loss"])[-5:].mean())
    assert f_dp < 1.35 * f_sd + 1e-3, (f_dp, f_sd)
    assert f_sd < 1.35 * f_dp + 1e-3, (f_dp, f_sd)


def test_dp_survives_add_new_frames():
    r, extra = _make_runner(dp_devices=8)
    r.train(n_steps=10)
    shards = r._dp_rays
    rgbs, depths, masks, normals, poses = extra
    r.add_new_frames(rgbs, depths, masks, normals, poses)
    assert r._dp_rays is None
    m = r.train(n_steps=10)
    assert np.isfinite(np.asarray(m["loss"])).all()
    # the new frame's rays reached the shards, the new spec the replicas
    assert sum(len(s["depth"]) for s in r._dp_rays[0]) >= r.n_rays_valid
    assert sum(len(s["depth"]) for s in shards[0]) < r.n_rays_valid
    assert all(rep.field.spec.n_frames == 4 for rep in r.dp_replicas)
    _assert_replicas_equal(r)


def _ba_pairs(r, n=32):
    """Ray pairs of frames 1 and 2 whose depth-lifted world points lie
    1-25 mm apart (normalized units; train_ba's threshold is 0.02 m * sc =
    30 mm): train_ba pulls them together through both frames' pose
    corrections."""
    h = r._rays_host
    ids = {f: np.nonzero((h["frame_id"] == f) & (h["mask"] > 0))[0]
           for f in (1, 2)}

    def world(i):
        pts = h["dirs"][i] * h["depth"][i][:, None]
        P = r.poses[h["frame_id"][i]]
        return np.einsum("nij,nj->ni", P[:, :3, :3], pts) + P[:, :3, 3]

    d, j = cKDTree(world(ids[2])).query(world(ids[1]), k=1)
    ok = np.nonzero((d > 1e-3) & (d < 2.5e-2))[0][:n]
    assert len(ok) == n
    return np.stack([ids[1][ok], ids[2][j[ok]]], -1)


@pytest.mark.parametrize("change", ["load_weights", "train_ba"])
def test_replicas_resync_after_master_changes(change, tmp_path):
    """Planted stale replicas: the master changes between chunks; the next
    chunk must start from it on every replica, or the replicas part."""
    r, _ = _make_runner(dp_devices=4)
    r.train(n_steps=5)
    before = r.field.pose_array.detach().clone()
    if change == "load_weights":
        other, _ = _make_runner(seed=3)
        other.train(n_steps=5)
        other.save_weights(str(tmp_path / "ckpt.npz"))
        r.load_weights(str(tmp_path / "ckpt.npz"))
        assert torch.equal(r.field.table, other.field.table)
    else:
        losses = r.train_ba(_ba_pairs(r), n_steps=10)
        assert losses[-1] < losses[0]
        assert not torch.equal(r.field.pose_array, before)
    r.train(n_steps=1)
    _assert_replicas_equal(r)


def test_dp_async_training():
    """start/poll/finish_training under DP: chunks queue without host
    waits; the batch completes with every replica in sync."""
    r, _ = _make_runner(dp_devices=2, scan_chunk=10)
    r.start_training(n_steps=30)
    assert r.training_in_flight
    polls = 0
    while not r.poll_training(max_chunks=1):
        polls += 1
        assert polls < 100
    m = r.finish_training()
    assert not r.training_in_flight and r.global_step == 30
    assert m["loss"].shape == (30,) and np.isfinite(m["loss"]).all()
    _assert_replicas_equal(r)
