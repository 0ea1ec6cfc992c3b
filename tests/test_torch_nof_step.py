"""Port parity for the whole NOF training step: the same bridged params and
the same ray batch go through the JAX package (`render_rays` -> `nof_loss`
-> `jax.value_and_grad` -> optax Adam) and the port (`train_step`), with
`perturb=False` so no random numbers enter. The JAX spec gets a run budget
of one run per sample, so its ray-mode hash-grid dedup never clamps and
both stacks compute the exact gradient; its hashed levels (2 x 16,384 rows)
take the Pallas sorted-tile scatter in the backward.

Tolerances, f32: losses rtol 1e-4 and gradients atol 1e-4 * max|g| --
the two stacks sum the same terms in another order (measured ~1e-6).
Adam's first step is -lr * g / |g| wherever |g| >> eps, so the updated
params agree to atol 1e-5 = lr / 1000. Ten steps compound the rounding
through Adam's normalisation: losses rtol 1e-4, params atol 1e-3.
Under amp the MLP runs in bf16 (8-bit mantissa) in both stacks, rounding
at different places, and a pre-activation that rounds across zero flips a
ReLU gate, so single elements may differ by far more than an ulp: loss
rtol 1e-3, each gradient leaf within 5e-2 in relative L2 norm (measured
up to 3e-2, on color_net.0.weight)."""
from dataclasses import replace

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
from bundlesdf_tpu.ops.hashgrid import HashGridSpec as JGridSpec
from bundlesdf_tpu.ops.occupancy import OccupancyGrid as JOccupancyGrid
from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.nof.losses import nof_loss
from bundlesdf_tpu_torch.nof.models import NofField, params_from_jax
from bundlesdf_tpu_torch.nof.render import render_rays
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.nof.train import (lr_factor_at, make_optimizer,
                                           train_step)
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)

N_RAYS = 64
SAMPLES = 20 + 20


@pytest.fixture(scope="module")
def stacks():
    """Port runner (ray store, occupancy grid, configs) on the synthetic
    orbit at the test_nof_train.py grid, and the matching JAX configs."""
    seq = cube_orbit_sequence(n_frames=5, H=56, W=72, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=160,
        N_rand=N_RAYS, N_samples=20, N_samples_around_depth=20, num_levels=4,
        finest_res=48, base_res=8, log2_hashmap_size=14, n_trace_steps=64,
        octree_smallest_voxel_size=2.0 / 64 / sc,
        octree_dilate_size=2.0 / 64 / sc, amp=False, frame_features=2))
    rgbs, depths, masks, normals, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    runner = NofRunner(cfg, rgbs, depths, masks, normals, poses, seq["K"],
                       device="cpu")
    occ = runner.occ_grid
    j_occ = JOccupancyGrid(grid=jnp.asarray(occ.grid.numpy()), res=occ.res,
                           trace=jnp.asarray(occ.trace.numpy()),
                           trace_res=occ.trace_res)
    g = runner.spec.grid
    j_grid = JGridSpec(n_levels=g.n_levels, level_dim=g.level_dim,
                       base_res=g.base_res, finest_res=g.finest_res,
                       log2_hashmap_size=g.log2_hashmap_size,
                       ray_samples=SAMPLES, k_runs=(SAMPLES,) * g.n_levels,
                       scatter_bf16=False)
    s = runner.spec
    j_spec = jm.NofSpec(grid=j_grid, sh_degree=s.sh_degree,
                        frame_features=s.frame_features, n_frames=s.n_frames,
                        max_trans=s.max_trans, max_rot_deg=s.max_rot_deg)
    params = jm.init_nof_params(jax.random.PRNGKey(0), j_spec)
    # nonzero pose corrections, so the pose gradient path is exercised
    params["pose_array"] = jnp.asarray(np.random.default_rng(0).normal(
        0.0, 0.3, (s.n_frames, 6)).astype(np.float32))
    return {"runner": runner, "j_occ": j_occ, "j_spec": j_spec,
            "params": params, "c2w": jnp.asarray(runner.c2w.numpy()),
            "vg": {}}


def _j_rcfg(rcfg):
    return jr.RenderConfig(**{k: getattr(rcfg, k) for k in (
        "n_samples", "n_samples_around_depth", "trunc", "neg_trunc_ratio",
        "sdf_lambda", "near", "far", "n_trace_steps", "raw_noise_std",
        "n_importance", "n_importance_iter", "compute_bf16", "eikonal",
        "eikonal_eps")})


def _jax_value_and_grad(st, amp: bool):
    """Jitted (loss, metrics), grads of one JAX step, cached per amp."""
    if amp not in st["vg"]:
        r = st["runner"]
        j_spec = st["j_spec"]
        j_spec = replace(j_spec, grid=replace(j_spec.grid, table_bf16=amp))
        j_rcfg = _j_rcfg(replace(r.rcfg, compute_bf16=amp))
        j_lcfg = jl.LossConfig(**r.lcfg.__dict__)
        trunc = r.tcfg.trunc

        def loss_fn(p, batch):
            out = jr.render_rays(p, j_spec, j_rcfg, batch, st["c2w"],
                                 st["j_occ"], jax.random.PRNGKey(0),
                                 perturb=False, trunc=trunc)
            return jl.nof_loss(out, batch, p, trunc, j_lcfg)

        st["vg"][amp] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return st["vg"][amp]


def _jax_adam_update(r):
    opt = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15)

    @jax.jit
    def update(grads, opt_state, params, f):
        u, opt_state = opt.update(grads, opt_state)
        u = jax.tree_util.tree_map_with_path(
            lambda path, x: -(r.tcfg.lrate_pose if path[0].key == "pose_array"
                              else r.tcfg.lrate) * f * x, u)
        return optax.apply_updates(params, u), opt_state

    return opt, update


def _field(st, amp: bool):
    r = st["runner"]
    spec = replace(r.spec, grid=replace(r.spec.grid, table_bf16=amp))
    field = NofField(spec)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       st["params"])))
    return field


def _batch(r, idx):
    return ({k: jnp.asarray(v[idx]) for k, v in r._rays_host.items()},
            {k: v[torch.as_tensor(idx)] for k, v in r.rays.items()})


def _assert_state_close(field, j_params, atol):
    want = params_from_jax(jax.tree.map(np.asarray, j_params))
    for name, p in field.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_grads_close(field, j_grads, frac=None, rel_l2=None):
    """Every gradient leaf within @frac * max|g| elementwise, or within
    @rel_l2 in relative L2 norm."""
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(want) == {n for n, _ in field.named_parameters()}
    for name, p in field.named_parameters():
        w = want[name].numpy()
        g = p.grad.numpy()
        assert np.abs(w).max() > 0, name
        if rel_l2 is not None:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err < rel_l2, (name, err)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=frac * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("amp", [False, True])
def test_one_step_matches_jax(stacks, amp):
    r = stacks["runner"]
    idx = np.random.default_rng(1).choice(r.n_rays_valid, N_RAYS,
                                          replace=False)
    b_j, b_t = _batch(r, idx)
    (_, m_j), g_j = _jax_value_and_grad(stacks, amp)(stacks["params"], b_j)

    field = _field(stacks, amp)
    rcfg = replace(r.rcfg, compute_bf16=amp)
    trunc = r.tcfg.trunc
    out = render_rays(field, rcfg, b_t, r.c2w, r.occ_grid, perturb=False,
                      trunc=trunc)
    loss, m_t = nof_loss(out, b_t, field, trunc, r.lcfg)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]),
                                   rtol=1e-3 if amp else 1e-4, err_msg=k)
    loss.backward()
    if amp:
        _assert_grads_close(field, g_j, rel_l2=5e-2)
    else:
        _assert_grads_close(field, g_j, frac=1e-4)

    if not amp:
        opt_j, update = _jax_adam_update(r)
        f = lr_factor_at(0, r.tcfg, r.N_iters)
        p_j, _ = update(g_j, opt_j.init(stacks["params"]), stacks["params"], f)
        opt_t = make_optimizer(field, r.tcfg)
        for group in opt_t.param_groups:
            group["lr"] = group["base_lr"] * f
        opt_t.step()
        _assert_state_close(field, p_j, atol=1e-5)


def test_ten_step_curve_matches_jax(stacks):
    """Ten Adam steps on injected batches (numpy-drawn indices)."""
    r = stacks["runner"]
    vg = _jax_value_and_grad(stacks, False)
    opt_j, update = _jax_adam_update(r)
    p_j = stacks["params"]
    s_j = opt_j.init(p_j)
    field = _field(stacks, False)
    opt_t = make_optimizer(field, r.tcfg)
    rng = np.random.default_rng(2)
    loss_j, loss_t = [], []
    for step in range(10):
        b_j, b_t = _batch(r, rng.choice(r.n_rays_valid, N_RAYS, replace=False))
        (_, m), g = vg(p_j, b_j)
        p_j, s_j = update(g, s_j, p_j, lr_factor_at(step, r.tcfg, r.N_iters))
        loss_j.append(float(m["loss"]))
        m_t = train_step(field, opt_t, b_t, step, r.c2w, r.occ_grid, r.rcfg,
                         r.lcfg, r.tcfg, r.N_iters, perturb=False)
        loss_t.append(float(m_t["loss"]))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    _assert_state_close(field, p_j, atol=1e-3)
