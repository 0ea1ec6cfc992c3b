"""Port parity for bundle adjustment (`tracker/ba.py`): `bundle_adjust_pooled`
and `bundle_adjust` of the JAX package and of `bundlesdf_tpu_torch` on the
same pool maps, sparse correspondences and perturbed initial poses.

The JAX Jacobian is `jax.jacfwd` of the residuals; the port's is the
analytic left-perturbation one, so the two agree to float32 rounding.
Tolerances: with `assoc_dtype="f32"` and the early-out off, poses within
1e-5; with the early-out on, the port runs every iteration and freezes
converged poses, so it stays within `early_out_delta` (1e-4) of JAX. With
the default bf16 candidate scoring (and the early-out on) both stacks
round the candidate maps the same way and re-fetch the chosen one in
float32: poses within 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.ops.preprocess import preprocess_depth_frame
from bundlesdf_tpu.tracker import ba as jba
from bundlesdf_tpu.tracker import pool as jpool
from bundlesdf_tpu_torch.tracker import ba as tba
from bundlesdf_tpu_torch.tracker import pool as tpool

torch.set_num_threads(2)
N, H, W, FACTOR = 4, 96, 128, 4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problem():
    seq = cube_orbit_sequence(n_frames=N, H=H, W=W, radius=0.45,
                              obj_size=0.08, full_angle=0.4, noise=0.001)
    rng = np.random.default_rng(1)
    jp_ = jpool.FramePool(H, W, cap=N)
    tp_ = tpool.FramePool(H, W, cap=N, device="cpu")
    for i in range(N):
        d, x, n = map(np.asarray, preprocess_depth_frame(
            jnp.asarray(seq["depths"][i]), jnp.asarray(seq["K"], jnp.float32),
            mask=jnp.asarray(seq["masks"][i])))
        valid = (d > 0.1) & (seq["masks"][i] > 0)
        jp_.insert_maps(i, d, x, n, valid)
        tp_.insert_maps(i, d, x, n, valid)
        grey = seq["colors"][i].astype(np.float32).mean(-1) / 255.0
        jp_.set_grey(i, grey)
        tp_.set_grey(i, grey)
    poses = seq["cam_in_obs"].copy()
    poses[1:, :3, 3] += rng.normal(0, 0.003, (N - 1, 3))
    # sparse matches from GT geometry (as tests/test_ba_early_out.py)
    pts = rng.uniform(-0.04, 0.04, (24, 3))
    ci, cj, pi, pj = [], [], [], []
    for a in range(N):
        for b in range(a + 1, N):
            Ta = np.linalg.inv(seq["cam_in_obs"][a])
            Tb = np.linalg.inv(seq["cam_in_obs"][b])
            ci += [a] * 24
            cj += [b] * 24
            pi.append(pts @ Ta[:3, :3].T + Ta[:3, 3])
            pj.append(pts @ Tb[:3, :3].T + Tb[:3, 3])
    flats = [np.nonzero((seq["masks"][i][::FACTOR, ::FACTOR] > 0)
                        .reshape(-1))[0] for i in range(N)]
    D = 512
    src_idx = np.zeros((N, D), np.int32)
    src_valid = np.zeros((N, D), bool)
    for k, f in enumerate(flats):
        f = f[np.linspace(0, len(f) - 1, min(len(f), D)).astype(int)]
        src_idx[k, :len(f)] = f
        src_valid[k, :len(f)] = True
    pair_ij = np.array([(i, j) for i in range(N) for j in range(i + 1, N)],
                       np.int32)
    rows_w = [r for r, (i, j) in enumerate(pair_ij) if N - 1 in (i, j)]
    pair_ij_w = np.zeros((8, 2), np.int32)
    pair_w_dst = np.full(8, len(pair_ij), np.int32)   # pad rows: dropped
    pair_ij_w[:len(rows_w)] = pair_ij[rows_w]
    pair_w_dst[:len(rows_w)] = rows_w
    arrays = dict(
        slots=np.array([jp_.slot_of[i] for i in range(N)], np.int32),
        slot_live=np.ones(N, np.float32), poses0=poses.astype(np.float32),
        K=seq["K"].astype(np.float32), pair_ij=pair_ij,
        corr_i=np.array(ci, np.int32), corr_j=np.array(cj, np.int32),
        corr_pi=np.concatenate(pi).astype(np.float32),
        corr_pj=np.concatenate(pj).astype(np.float32),
        corr_valid=np.ones(len(ci), np.float32),
        update_flags=np.array([0, 1, 1, 1], np.float32),
        src_idx=src_idx, src_valid=src_valid,
        pair_valid=np.ones(len(pair_ij), np.float32),
        pair_ij_w=pair_ij_w, pair_w_dst=pair_w_dst)
    return seq, jp_, tp_, arrays


def _run_pooled(problem, cfg_kw, admission=False, color=False):
    seq, jp_, tp_, arr = problem
    cfg_j = jba.BAConfig(**cfg_kw)
    cfg_t = tba.BAConfig(**cfg_kw)
    hybrid = cfg_kw.get("assoc_entry_mode", "hybrid") == "hybrid"
    extra = {} if hybrid else {"pair_ij_w": None, "pair_w_dst": None}
    kw = {k: v for k, v in arr.items() if k not in extra}
    adm_j, adm_t = {}, {}
    if admission:
        kf = np.array([jp_.slot_of[0], jp_.slot_of[1], jp_.slot_of[2]],
                      np.int32)
        kf_poses = seq["cam_in_obs"][:3].astype(np.float32)
        win = np.array([0, -1, 2], np.int32)
        adm_j = dict(pool_valids=jp_.valids_h, nf_idx=3,
                     kf_slots=jnp.asarray(kf), kf_poses=jnp.asarray(kf_poses),
                     kf_window_idx=jnp.asarray(win), covis_thres_cos=0.342)
        adm_t = dict(pool_valids=tp_.valids_h, nf_idx=3, kf_slots=_t(kf),
                     kf_poses=_t(kf_poses), kf_window_idx=_t(win),
                     covis_thres_cos=0.342)
    out_j = jba.bundle_adjust_pooled(
        jp_.xyzs_h, jp_.nrms_h, **{k: jnp.asarray(v) for k, v in kw.items()},
        factor=FACTOR, cfg=cfg_j, pre_decim=2,
        pool_greys=jp_.greys_h if color else None, **adm_j)
    out_t = tba.bundle_adjust_pooled(
        tp_.xyzs_h, tp_.nrms_h, **{k: _t(v) for k, v in kw.items()},
        factor=FACTOR, cfg=cfg_t, pre_decim=2,
        pool_greys=tp_.greys_h if color else None, **adm_t)
    return out_j, out_t


def _pose_err(a, b):
    return np.abs(np.asarray(a) - b.numpy()).max()


@pytest.mark.parametrize("entry", ["window", "projective", "hybrid"])
@pytest.mark.parametrize("early_out", [0.0, 1e-4])
def test_pooled_f32(problem, entry, early_out):
    out_j, out_t = _run_pooled(problem, dict(
        assoc_entry_mode=entry, assoc_dtype="f32",
        early_out_delta=early_out))
    tol = 1e-5 if early_out == 0 else early_out
    assert _pose_err(out_j, out_t) < tol
    gt = problem[0]["cam_in_obs"]
    assert np.abs(out_t.numpy()[:, :3, 3] - gt[:, :3, 3]).max() < 2e-3


def test_pooled_bf16_admission(problem):
    """The default config (bf16 scoring, hybrid entry, early-out) plus the
    keyframe-admission covisibility at the post-BA poses."""
    (pj, cj), (pt, ct) = _run_pooled(problem, {}, admission=True)
    assert _pose_err(pj, pt) < 1e-4
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-3)


def test_refine_window_reassociation(problem):
    """reassoc_iters > 1 with the windowed refine pass (the reference's
    schedule), plus the dense photometric term."""
    kw = dict(assoc_entry_mode="window", assoc_dtype="f32",
              early_out_delta=0.0, reassoc_iters=3,
              assoc_refine_mode="window", w_dense_color=0.05)
    out_j, out_t = _run_pooled(problem, kw, color=True)
    assert _pose_err(out_j, out_t) < 1e-5


def test_pose_update_and_downsample():
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    delta = rng.normal(0, 0.05, 18).astype(np.float32)
    flags = np.array([0, 1, 1], np.float32)
    pj = np.asarray(jba._pose_update(jnp.asarray(poses), jnp.asarray(delta),
                                     jnp.asarray(flags)))
    pt = tba._pose_update(_t(poses), _t(delta), _t(flags)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    np.testing.assert_array_equal(pt[0], np.eye(4))
    x = rng.random((2, 16, 20, 3)).astype(np.float32)
    K = np.array([[50, 0, 10], [0, 50, 8], [0, 0, 1]], np.float32)
    dj = jba.downsample_maps(jnp.asarray(x), jnp.asarray(x), K, 4)
    dt = tba.downsample_maps(_t(x), _t(x), K, 4)
    for a, b in zip(dj, dt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bundle_adjust_direct(problem):
    """`bundle_adjust` on maps cut down by `downsample_maps` (window entry,
    f32, early-out off), without the pool front end."""
    seq, jp_, tp_, arr = problem
    slots = arr["slots"]
    x = np.asarray(jp_.xyzs)[slots]
    n = np.asarray(jp_.nrms)[slots]
    kw = {k: arr[k] for k in ("poses0", "pair_ij", "corr_i", "corr_j",
                              "corr_pi", "corr_pj", "corr_valid",
                              "update_flags", "src_idx", "src_valid")}
    cfg = dict(assoc_entry_mode="window", assoc_dtype="f32",
               early_out_delta=0.0)
    xj, nj, Kj = jba.downsample_maps(jnp.asarray(x), jnp.asarray(n),
                                     arr["K"], FACTOR)
    xt, nt, Kt = tba.downsample_maps(_t(x), _t(n), arr["K"], FACTOR)
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(Kj))
    pj = jba.bundle_adjust(kw["poses0"], Kj, xj, nj,
                           *(jnp.asarray(kw[k]) for k in list(kw)[1:]),
                           cfg=jba.BAConfig(**cfg))
    pt = tba.bundle_adjust(_t(kw["poses0"]), Kt, xt, nt,
                           *(_t(kw[k]) for k in list(kw)[1:]),
                           cfg=tba.BAConfig(**cfg))
    assert _pose_err(pj, pt) < 1e-5
    assert _pose_err(kw["poses0"], pt) > 1e-4      # the solve moved poses
