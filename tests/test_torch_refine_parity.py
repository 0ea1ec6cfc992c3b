"""Port parity of the offline refine's training: 50 steps of a
refine-shaped config in both packages, from the same weights, on the same
ray batches.

The config is the refine's (`bundlesdf_tpu_torch/run_custom.py`
`REFINE_CONFIG` over the online config of `make_configs`, as
`run_one_video_global_nerf` builds it) cut to a CPU size: `frame_features`
2, pose optimisation on (`optimize_poses` 1, `lrate_pose` 0.01), both
sample passes (`N_samples` + `N_samples_around_depth`), 4 levels of which
the two finest are hashed (`log2_hashmap_size` 12 below (res+1)^3), and
`n_step` 50, so the staircase learning-rate decay runs its whole course
(the refine has no warmup; `lr_factor_at` and `truncation_at` are held
equal at every step). Each package builds its own `NofRunner` from the
config: their render/loss/train configs, ray stores and occupancy grids
are held equal. Both start from the JAX package's initial parameters
(`params_from_jax`); each step's batch is drawn by one numpy index stream
and gathered from each runner's ray store. The JAX step is `train_steps`'
step with that batch: `render_rays` -> `nof_loss` -> value_and_grad ->
Adam with the per-group lr. The free-running test runs with
`perturb=False`, so no random numbers enter. The stratified jitter and the
invalid-depth rays' occupied fallback are held by a second test: the same
uniform draws, from one numpy stream, are injected into both renderers in
their call order (the occupied-segment draw, the draw around the depth,
the fallback draw), and at each of the first 25 steps the port's loss and
gradients are taken at the JAX run's parameters of that step. The JAX grid
gets one run per sample, so its ray-mode dedup never clamps, and its
hashed levels take the Pallas scatter in the backward.

Tolerances, float32, TF32 off (the port's default): the two stacks sum
the same terms in another order, and Adam's normalisation turns a
gradient rounding into a full-size step wherever |g| is small, so
differences compound over the steps. Measured on this cut: loss within
5.5e-7 relative at every step, the table within 7.7e-5, the MLP within
1.4e-5, the frame features and pose corrections within 3.1e-6. Held to
about ten times that: loss rtol 1e-5 at every step; after 50 steps the
hash table, the MLP and the frame features atol 5e-4 (against a learning
rate of 1e-2), the pose corrections and the refined poses atol 3e-5 (rad
and normalized units). With the jitter, free-running runs drift further
apart (Adam compounds the rounding: 2.5e-3 on one MLP weight after 50
steps), so that test compares each step at shared parameters instead:
measured, the loss within 3.8e-7 relative and every gradient within
1.3e-5 of its parameter's largest |gradient|; held at loss rtol 1e-5 and
gradients 1e-4 of the largest."""
from dataclasses import replace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.nof import losses as jl
from bundlesdf_tpu.nof import models as jm
from bundlesdf_tpu.nof import render as jr
from bundlesdf_tpu.nof import train as jt
from bundlesdf_tpu.nof.runner import NofRunner as JNofRunner
from bundlesdf_tpu_torch.nof.losses import nof_loss
from bundlesdf_tpu_torch.nof.models import (NofField, params_from_jax,
                                            pose_array_matrices)
from bundlesdf_tpu_torch.nof.render import render_rays
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.nof.train import (lr_factor_at, make_optimizer,
                                           train_step, truncation_at)
from bundlesdf_tpu_torch.run_custom import REFINE_CONFIG, make_configs
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)

N_STEPS = 50
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
POSE_ATOL = 3e-5
GRAD_RTOL_OF_MAX = 1e-4
N_JITTER_STEPS = 25     # three rungs of the staircase decay


def refine_config(tmp_path, sc):
    """`run_one_video_global_nerf`'s config at a CPU size."""
    _, cfg = make_configs(str(tmp_path))
    cfg.update(REFINE_CONFIG)
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=N_STEPS,
        N_rand=48, N_samples=8, N_samples_around_depth=16, num_levels=4,
        finest_res=32, base_res=8, log2_hashmap_size=12, n_trace_steps=64,
        octree_smallest_voxel_size=2.0 / 64 / sc,
        octree_dilate_size=2.0 / 64 / sc, amp=False))
    return cfg


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    seq = cube_orbit_sequence(n_frames=4, H=40, W=56, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = refine_config(tmp_path_factory.mktemp("refine"), sc)
    data = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    port = NofRunner(dict(cfg), *data, seq["K"], device="cpu")
    ref = JNofRunner(dict(cfg), *data, seq["K"])
    return port, ref


def test_refine_shape_is_the_refine(runners):
    """The cut keeps what the refine exercises: frame features, pose
    optimisation, both passes, a hashed level above dense ones; and both
    runners build the same configs, ray store and occupancy grid."""
    port, ref = runners
    layout = port.spec.grid.layout()
    assert [d for _, d, _, _ in layout] == [True, True, False, False]
    assert port.spec.frame_features == 2 and port.tcfg.lrate_pose > 0
    assert port.rcfg.n_samples > 0 and port.rcfg.n_samples_around_depth > 0
    for name in ("lcfg", "tcfg"):
        assert getattr(port, name).__dict__ == getattr(ref, name).__dict__
    j_r = ref.rcfg.__dict__
    assert {k: v for k, v in port.rcfg.__dict__.items()} == \
        {k: j_r[k] for k in port.rcfg.__dict__}
    assert port.spec.grid.layout() == [tuple(int(x) for x in lvl)
                                       for lvl in ref.spec.grid.layout()]
    assert set(port._rays_host) == set(ref._rays_host)
    for k, v in port._rays_host.items():
        np.testing.assert_array_equal(v, ref._rays_host[k], err_msg=k)
    np.testing.assert_array_equal(port.occ_grid.grid.numpy(),
                                  np.asarray(ref.occ_grid.grid))
    np.testing.assert_array_equal(port.occ_grid.trace.numpy(),
                                  np.asarray(ref.occ_grid.trace))
    for step in range(N_STEPS + 1):
        s = jnp.asarray(step, jnp.int32)
        assert lr_factor_at(step, port.tcfg, port.N_iters) == pytest.approx(
            float(jt.lr_factor_at(s, ref.tcfg, ref.N_iters)), rel=1e-6)
        assert truncation_at(step, port.tcfg, port.N_iters) == \
            pytest.approx(float(jt.truncation_at(s, ref.tcfg, ref.N_iters)),
                          rel=1e-6)


def _injected(draws, shape_arg):
    """A stand-in for `jax.random.uniform` / `torch.rand` that returns
    @draws in call order; the shape (positional argument @shape_arg) must
    match."""
    queue = list(draws)

    def draw(*args, **kwargs):
        shape = tuple(args[shape_arg])
        u = queue.pop(0)
        assert tuple(u.shape) == shape, (u.shape, shape)
        return u
    return draw, queue


def _jax_step(ref, j_spec, perturb):
    """`train_steps`' one step (bundlesdf_tpu/nof/train.py) with an
    injected batch and, with @perturb, injected uniform draws."""
    opt = jt.make_optimizer()
    rcfg, lcfg, tcfg, n_iters = ref.rcfg, ref.lcfg, ref.tcfg, ref.N_iters

    @jax.jit
    def step(params, opt_state, batch, i, draws):
        trunc = jt.truncation_at(i, tcfg, n_iters)

        def loss_fn(p):
            out = jr.render_rays(p, j_spec, rcfg, batch, ref.c2w_array,
                                 ref.occ_grid, jax.random.PRNGKey(0),
                                 perturb=perturb, trunc=trunc)
            return jl.nof_loss(out, batch, p, trunc, lcfg)

        uniform, left = _injected(draws, 1)
        with mock.patch.object(jax.random, "uniform", uniform):
            (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
        assert not left, "a draw was not taken"
        updates, new_state = opt.update(grads, opt_state)
        f = jt.lr_factor_at(i, tcfg, n_iters)
        updates = jax.tree_util.tree_map_with_path(
            lambda path, u: -(tcfg.lrate_pose if path[0].key == "pose_array"
                              else tcfg.lrate) * f * u, updates)
        return (optax.apply_updates(params, updates), new_state, metrics,
                grads)

    return opt, step


def _jax_setup(runners, perturb):
    port, ref = runners
    S = port.rcfg.n_samples + port.rcfg.n_samples_around_depth
    L = port.spec.grid.n_levels
    # the port's frame count (the JAX runner pads it to a bucket of 16)
    j_spec = replace(ref.spec, n_frames=port.spec.n_frames,
                     grid=replace(ref.spec.grid, k_runs=(S,) * L,
                                  scatter_bf16=False))
    params = jm.init_nof_params(jax.random.PRNGKey(0), j_spec)
    # a fresh trace, so the jitted samplers inside take the injected draws
    jax.clear_caches()
    opt, step = _jax_step(ref, j_spec, perturb)
    return j_spec, params, opt.init(params), step


def _batches(port, ref, perturb, n_steps=N_STEPS):
    """Each step's (JAX batch, port batch, uniform draws) from one numpy
    stream."""
    R = port.tcfg.n_rand
    shapes = ([(R, port.rcfg.n_samples)]
              + [(R, port.rcfg.n_samples_around_depth)] * 2) if perturb else []
    rng = np.random.default_rng(7)
    for _ in range(n_steps):
        idx = rng.integers(0, port.n_rays_valid, R)
        draws = [rng.random(sh, dtype=np.float32) for sh in shapes]
        yield ({k: jnp.asarray(v[idx]) for k, v in ref._rays_host.items()},
               {k: v[torch.as_tensor(idx)] for k, v in port.rays.items()},
               draws)


def _port_draws(draws):
    rand, left = _injected([torch.from_numpy(u) for u in draws], 0)
    return mock.patch.object(torch, "rand", rand), left


def test_fifty_refine_steps_match_jax(runners):
    port, ref = runners
    j_spec, params, opt_state, step = _jax_setup(runners, perturb=False)
    field = NofField(port.spec)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt_t = make_optimizer(field, port.tcfg)

    loss_j, loss_t = [], []
    for i, (b_j, b_t, draws) in enumerate(_batches(port, ref, False)):
        params, opt_state, m_j, _ = step(params, opt_state, b_j,
                                         jnp.asarray(i, jnp.int32), draws)
        m_t = train_step(field, opt_t, b_t, i, port.c2w, port.occ_grid,
                         port.rcfg, port.lcfg, port.tcfg, port.N_iters,
                         perturb=False)
        loss_j.append(float(m_j["loss"]))
        loss_t.append(float(m_t["loss"]))
    np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)
    # the run trained: the loss fell
    assert np.mean(loss_t[-5:]) < np.mean(loss_t[:5])

    want = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in field.named_parameters():
        atol = POSE_ATOL if name == "pose_array" else PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)
    # the pose corrections moved, and the refined poses agree
    assert np.abs(want["pose_array"].numpy()).max() > 1e-4
    ids = np.arange(port.spec.n_frames)
    corr_t = pose_array_matrices(field.pose_array, torch.as_tensor(ids),
                                 port.spec.max_trans,
                                 port.spec.max_rot_deg).detach().numpy()
    corr_j = np.asarray(jm.pose_array_matrices(
        params["pose_array"], jnp.asarray(ids), j_spec.max_trans,
        j_spec.max_rot_deg))
    np.testing.assert_allclose(port.poses @ corr_t, port.poses @ corr_j,
                               atol=POSE_ATOL, rtol=0)


def test_fifty_jittered_refine_steps_match_jax(runners):
    """The stratified jitter and the invalid-depth fallback on the same
    draws: at each of 25 steps of the JAX run, the port's loss and
    gradients at that step's parameters."""
    port, ref = runners
    _, params, opt_state, step = _jax_setup(runners, perturb=True)
    field = NofField(port.spec)
    n_invalid = 0
    for i, (b_j, b_t, draws) in enumerate(_batches(port, ref, True,
                                                       N_JITTER_STEPS)):
        d = b_t["depth"]
        n_invalid += int(((d < port.rcfg.near) | (d > port.rcfg.far)).sum())
        field.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
        field.zero_grad(set_to_none=True)
        trunc = truncation_at(i, port.tcfg, port.N_iters)
        patch, left = _port_draws(draws)
        with patch:
            out = render_rays(field, port.rcfg, b_t, port.c2w, port.occ_grid,
                              perturb=True, trunc=trunc)
        assert not left, "a draw was not taken"
        loss, _ = nof_loss(out, b_t, field, trunc, port.lcfg)
        loss.backward()
        params, opt_state, m_j, g_j = step(
            params, opt_state, b_j, jnp.asarray(i, jnp.int32),
            [jnp.asarray(u) for u in draws])
        assert float(loss.detach()) == pytest.approx(
            float(m_j["loss"]), rel=LOSS_RTOL), i
        want = params_from_jax(jax.tree.map(np.asarray, g_j))
        for name, p in field.named_parameters():
            g = want[name].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), g, rtol=0,
                atol=GRAD_RTOL_OF_MAX * np.abs(g).max(),
                err_msg=f"step {i}: {name}")
    # the batches hold invalid-depth rays, which take the fallback draw
    assert n_invalid > 0
