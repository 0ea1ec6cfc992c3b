"""Port parity of the NOF step's building blocks, function by function:
occupancy trace, samplers, SE(3) exp, pose corrections and SH encoding,
against the JAX package on the same numpy inputs. Deterministic modes
only (perturb=False / det=True): the two RNGs differ by design."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.nof import models as jm
from bundlesdf_tpu.ops import occupancy as jocc
from bundlesdf_tpu.ops import sampling as jsmp
from bundlesdf_tpu.utils import se3 as jse3
from bundlesdf_tpu_torch.nof import models as tm
from bundlesdf_tpu_torch.ops import occupancy as tocc
from bundlesdf_tpu_torch.ops import sampling as tsmp
from bundlesdf_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)


def _rays(n=96, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.2, 0.2, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def grids():
    pts = np.random.default_rng(1).uniform(-0.3, 0.3, (500, 3))
    j = jocc.build_occupancy_grid(pts, res=32, dilate_radius=1)
    t = tocc.build_occupancy_grid(pts, res=32, dilate_radius=1)
    return j, t


def test_build_occupancy_grid_matches_jax(grids):
    j, t = grids
    np.testing.assert_array_equal(t.grid.numpy(), np.asarray(j.grid))
    np.testing.assert_array_equal(t.trace.numpy(), np.asarray(j.trace))
    assert (t.res, t.trace_res) == (j.res, j.trace_res)


@pytest.mark.parametrize("use_trace", [False, True])
def test_query_occupancy_matches_jax(grids, use_trace):
    j, t = grids
    p = np.random.default_rng(2).uniform(-1.2, 1.2, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tocc.query_occupancy(t, torch.from_numpy(p), use_trace).numpy(),
        np.asarray(jocc.query_occupancy(j, jnp.asarray(p), use_trace)))


def test_ray_trace_matches_jax(grids):
    j, t = grids
    o, d = _rays()
    rj = jocc.ray_trace_occupancy(j, jnp.asarray(o), jnp.asarray(d), n_steps=32)
    rt = tocc.ray_trace_occupancy(t, torch.from_numpy(o), torch.from_numpy(d),
                                  n_steps=32)
    assert set(rt) == {"t0", "t1", "occ"} and np.asarray(rj["hit"]).any()
    np.testing.assert_array_equal(rt["occ"].numpy(), np.asarray(rj["occ"]))
    for k in ("t0", "t1"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_occupied_samples_match_jax(grids):
    """Deterministic occupied-segment samples and their gradient through
    the segment tables (the pose gradient path)."""
    j, _ = grids
    o, d = _rays(seed=3)
    tr = jocc.ray_trace_occupancy(j, jnp.asarray(o), jnp.asarray(d), n_steps=32)
    t0, t1, occ = (np.array(tr[k]) for k in ("t0", "t1", "occ"))
    cap = np.random.default_rng(4).uniform(0.5, 3.0, len(o)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((len(o), 24)).astype(np.float32)

    def jz(t0_, t1_):
        st = jsmp.occupied_sampler_state(t0_, t1_, jnp.asarray(occ),
                                         t_cap=jnp.asarray(cap))
        return jsmp.draw_occupied_samples(st, None, 24, perturb=False)

    z_j = np.asarray(jz(jnp.asarray(t0), jnp.asarray(t1)))
    g_j = jax.grad(lambda a, b: jnp.sum(jz(a, b) * w), argnums=(0, 1))(
        jnp.asarray(t0), jnp.asarray(t1))
    t0_t = torch.tensor(t0, requires_grad=True)
    t1_t = torch.tensor(t1, requires_grad=True)
    st = tsmp.occupied_sampler_state(t0_t, t1_t, torch.from_numpy(occ),
                                     t_cap=torch.from_numpy(cap))
    z_t = tsmp.draw_occupied_samples(st, 24, perturb=False)
    torch.sum(z_t * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(z_t.detach().numpy(), z_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t0_t.grad.numpy(), np.asarray(g_j[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t1_t.grad.numpy(), np.asarray(g_j[1]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capped", [False, True])
def test_sample_occupied_steps_matches_jax(grids, capped):
    """The one-call sampler, deterministic, against JAX's, rays with no
    occupied step (uniform over the whole step range) included."""
    j, _ = grids
    o, d = _rays(seed=9)
    tr = jocc.ray_trace_occupancy(j, jnp.asarray(o), jnp.asarray(d), n_steps=32)
    t0, t1, occ = (np.array(tr[k]) for k in ("t0", "t1", "occ"))
    occ[:5] = False
    assert occ.any(1).sum() > 20
    cap = (np.random.default_rng(10).uniform(0.5, 3.0, len(o)).astype(
        np.float32) if capped else None)
    z_j = jsmp.sample_occupied_steps(
        None, jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(occ), 24,
        perturb=False, t_cap=None if cap is None else jnp.asarray(cap))
    z_t = tsmp.sample_occupied_steps(
        torch.from_numpy(t0), torch.from_numpy(t1), torch.from_numpy(occ), 24,
        perturb=False, t_cap=None if cap is None else torch.from_numpy(cap))
    assert z_t.shape == (len(o), 24)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6,
                               atol=1e-6)
    if cap is not None:
        t0, t1 = np.minimum(t0, cap[:, None]), np.minimum(t1, cap[:, None])
    np.testing.assert_allclose(
        z_t[:5].numpy(), t0[:5, :1] + tsmp.linspace01(24).numpy()
        * (t1[:5, -1:] - t0[:5, :1]), rtol=1e-6)


def test_sample_occupied_steps_is_the_composition(grids):
    """Perturbed, under one seeded generator: bit-equal to the state plus
    one draw, and so is the gradient through the segment tables."""
    _, t = grids
    o, d = _rays(seed=11)
    tr = tocc.ray_trace_occupancy(t, torch.from_numpy(o), torch.from_numpy(d),
                                  n_steps=32)
    cap = torch.from_numpy(np.random.default_rng(12).uniform(
        0.5, 3.0, len(o)).astype(np.float32))
    out = []
    for wrapper in (True, False):
        t0 = tr["t0"].clone().requires_grad_(True)
        g = torch.Generator().manual_seed(5)
        if wrapper:
            z = tsmp.sample_occupied_steps(t0, tr["t1"], tr["occ"], 24,
                                           generator=g, t_cap=cap)
        else:
            st = tsmp.occupied_sampler_state(t0, tr["t1"], tr["occ"],
                                             t_cap=cap)
            z = tsmp.draw_occupied_samples(st, 24, generator=g)
        (z * torch.linspace(-1, 1, 24)).sum().backward()
        out.append((z.detach(), t0.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and out[0][1].abs().sum() > 0


@pytest.mark.parametrize("res", [8, 32, 64])
def test_voxel_size_matches_jax(res):
    pts = np.zeros((1, 3))
    j = jocc.build_occupancy_grid(pts, res=res)
    t = tocc.build_occupancy_grid(pts, res=res)
    assert t.voxel_size == j.voxel_size == 2.0 / res


@pytest.mark.parametrize("n", [1, 20, 64, 128])
def test_uniform_samples_and_linspace_match_jax(n):
    near = np.random.default_rng(6).uniform(0.2, 1.0, (32, 1)).astype(np.float32)
    far = near + 0.3
    z_j = jsmp.sample_rays_uniform(None, jnp.asarray(near), jnp.asarray(far),
                                   n, perturb=False)
    z_t = tsmp.sample_rays_uniform(torch.from_numpy(near),
                                   torch.from_numpy(far), n, perturb=False)
    # XLA fuses near*(1-t) + far*t with an FMA: one f32 ulp apart
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)
    np.testing.assert_array_equal(
        tsmp.linspace01(n).numpy(),
        np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_sample_pdf_det_matches_jax():
    rng = np.random.default_rng(7)
    bins = np.sort(rng.uniform(0.5, 2.0, (32, 17)), axis=1).astype(np.float32)
    weights = rng.uniform(0, 1, (32, 16)).astype(np.float32)
    z_j = jsmp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 12,
                          det=True)
    z_t = tsmp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights),
                          12, det=True)
    # f32 cumsum and division in another order
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5)


def test_se3_exp_and_pose_matrices_match_jax():
    tau = np.random.default_rng(8).normal(0, 0.5, (6, 6)).astype(np.float32)
    tau[0] = 0.0   # the Taylor-safe branch at zero rotation
    np.testing.assert_allclose(tse3.se3_exp(torch.from_numpy(tau)).numpy(),
                               np.asarray(jse3.se3_exp(jnp.asarray(tau))),
                               atol=1e-6)
    np.testing.assert_allclose(tse3.se3_exp_np(tau),
                               jse3.se3_exp_np(tau), atol=1e-12)
    fids = np.array([0, 3, 5, 1, 0], np.int64)
    np.testing.assert_allclose(
        tm.pose_array_matrices(torch.from_numpy(tau), torch.from_numpy(fids),
                               0.03, 20.0).numpy(),
        np.asarray(jm.pose_array_matrices(jnp.asarray(tau), jnp.asarray(fids),
                                          0.03, 20.0)), atol=1e-6)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encode_matches_jax(degree):
    d = np.random.default_rng(9).standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tm.sh_encode(torch.from_numpy(d), degree).numpy(),
        np.asarray(jm.sh_encode(jnp.asarray(d), degree)), atol=1e-6)


def test_freq_encode_matches_jax():
    x = np.random.default_rng(10).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tm.freq_encode(torch.from_numpy(x), 8).numpy(),
        np.asarray(jm.freq_encode(jnp.asarray(x), 8)), atol=1e-5)
