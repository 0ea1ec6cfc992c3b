"""Port parity for RANSAC and the frame pool (`tracker/ransac.py`,
`tracker/pool.py`), JAX package against `bundlesdf_tpu_torch` on the CPU.

RANSAC trial indices are JAX's own threefry draws, injected into the port
(torch draws from a Philox generator instead). The JAX trials fit each
sample by a 20-step power-iteration Kabsch and the port by an exact SVD,
so trial poses differ by that iteration's convergence error. On an exact
rigid transform the inlier sets are identical and scores within 1e-4
relative; on real ORB matches a match lying at the 5 mm gate can flip, so
there at most 0.5 % of the matches may differ and the pairs without a flip
are compared exactly. Both pools hold the same (JAX-preprocessed) maps, so
lifts are compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.config import default_track_config
from bundlesdf_tpu.matcher.classical import OrbMatcher as JaxOrb
from bundlesdf_tpu.ops.preprocess import preprocess_depth_frame
from bundlesdf_tpu.tracker import pool as jpool
from bundlesdf_tpu.tracker.ransac import ransac_pose as jax_ransac
from bundlesdf_tpu_torch.tracker import pool as tpool
from bundlesdf_tpu_torch.tracker.ransac import ransac_pose

torch.set_num_threads(2)
T_TRIALS = 200
COS30 = float(np.cos(np.deg2rad(30.0)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(seed, ok, n_trials):
    """The (P, T, 3) indices `_lift_ransac_core` draws for @seed."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), seed),
                            ok.shape[0])
    count = np.maximum(np.asarray(ok).sum(1), 1).astype(np.int32)
    return np.stack([np.asarray(jax.random.randint(
        keys[p], (n_trials, 3), 0, count[p])) for p in range(ok.shape[0])])


def test_ransac_pose_injected_indices():
    rng = np.random.default_rng(0)
    P, M = 2, 300
    c, s = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.array([0.004, -0.002, 0.003], np.float32)
    A = rng.uniform(-0.05, 0.05, (P, M, 3)).astype(np.float32)
    nA = rng.standard_normal((P, M, 3)).astype(np.float32)
    nA /= np.linalg.norm(nA, axis=-1, keepdims=True)
    B = (A @ R.T + t).astype(np.float32)
    nB = (nA @ R.T).astype(np.float32)
    out = rng.random((P, M)) < 0.3                     # 30 % outliers
    B[out] += rng.uniform(-0.03, 0.03, (int(out.sum()), 3)).astype(np.float32)
    conf = rng.uniform(0.5, 1.0, (P, M)).astype(np.float32)
    valid = np.ones((P, M), bool)
    valid[1, 250:] = False                             # padded rows
    caps_t = np.array([0.02, np.inf], np.float32)
    caps_r = np.array([np.deg2rad(30), np.pi], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), P)
    jres = [jax_ransac(keys[p], A[p], B[p], nA[p], nB[p], conf[p], valid[p],
                       0.005, COS30, caps_t[p], caps_r[p], n_trials=T_TRIALS)
            for p in range(P)]
    count = valid.sum(1)
    idx = np.stack([np.asarray(jax.random.randint(
        keys[p], (T_TRIALS, 3), 0, count[p])) for p in range(P)])
    tres = ransac_pose(_t(A), _t(B), _t(nA), _t(nB), _t(conf), _t(valid),
                       0.005, COS30, _t(caps_t), _t(caps_r),
                       n_trials=T_TRIALS, sample_idx=_t(idx))
    for p in range(P):
        inl = np.asarray(jres[p]["inlier_mask"])
        np.testing.assert_array_equal(tres["inlier_mask"][p].numpy(), inl)
        assert inl.sum() == (~out[p] & valid[p]).sum()
        np.testing.assert_allclose(float(tres["n_inliers"][p]),
                                   float(jres[p]["n_inliers"]), rtol=1e-4)
        np.testing.assert_allclose(tres["best_pose"][p, :3, :3].numpy(), R,
                                   atol=1e-5)
    # the seeded device draw: same seed -> same result, in range
    r1 = ransac_pose(_t(A), _t(B), _t(nA), _t(nB), _t(conf), _t(valid),
                     0.005, COS30, _t(caps_t), _t(caps_r), n_trials=T_TRIALS,
                     seed=3)
    r2 = ransac_pose(_t(A), _t(B), _t(nA), _t(nB), _t(conf), _t(valid),
                     0.005, COS30, _t(caps_t), _t(caps_r), n_trials=T_TRIALS,
                     seed=3)
    assert torch.equal(r1["inlier_mask"], r2["inlier_mask"])
    assert torch.equal(r1["inlier_mask"], tres["inlier_mask"])


def test_pool_lifecycle_and_growth():
    seq = cube_orbit_sequence(n_frames=3, H=32, W=40, full_angle=0.3)
    cfg = default_track_config()["depth_processing"]
    jp_ = jpool.FramePool(32, 40, cap=2)
    tp_ = tpool.FramePool(32, 40, cap=2, device="cpu")
    order = [0, 1, 2, 3, 4]
    for fid in order:                       # grows 2 -> 4 -> 8
        i = fid % 3
        jp_.insert_preprocessed(fid, seq["depths"][i], seq["K"],
                                seq["masks"][i], cfg)
        tp_.insert_preprocessed(fid, seq["depths"][i], seq["K"],
                                seq["masks"][i], cfg)
    assert tp_.cap == jp_.cap == 8
    assert tp_.slot_of == jp_.slot_of
    d0 = tp_.host_maps(0)[0].copy()
    for pool in (jp_, tp_):
        pool.release(3)
        pool.insert_preprocessed(9, seq["depths"][1], seq["K"],
                                 seq["masks"][1], cfg)
    assert tp_.slot_of == jp_.slot_of and 3 not in tp_.slot_of
    # slot reuse leaves other frames alone, and host copies do not alias
    np.testing.assert_array_equal(tp_.host_maps(0)[0], d0)
    for fid in tp_.slot_of:
        for a, b in zip(jp_.host_maps(fid), tp_.host_maps(fid)):
            np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.fixture(scope="module")
def scene():
    """Both pools holding the same maps for 4 orbit frames, plus ORB
    features of each frame."""
    seq = cube_orbit_sequence(n_frames=4, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.4)
    H, W = 120, 160
    jp_ = jpool.FramePool(H, W, cap=4)
    tp_ = tpool.FramePool(H, W, cap=4, device="cpu")
    orb = JaxOrb()
    feats = []
    for i in range(4):
        d, x, n = map(np.asarray, preprocess_depth_frame(
            jnp.asarray(seq["depths"][i]), jnp.asarray(seq["K"], jnp.float32),
            mask=jnp.asarray(seq["masks"][i])))
        valid = (d > 0.1) & (seq["masks"][i] > 0)
        jp_.insert_maps(i, d, x, n, valid)
        tp_.insert_maps(i, d, x, n, valid)
        fr = SimpleNamespace(id=i, color=seq["colors"][i],
                             fg_mask=seq["masks"][i].astype(np.uint8))
        feats.append(orb._frame_feats(fr))
    return seq, jp_, tp_, feats


def test_covis_core(scene):
    seq, jp_, tp_, _ = scene
    P = np.linalg.inv(seq["cam_in_obs"])
    pairs = [(1, 0), (0, 1), (3, 0), (2, 3)]
    slots = np.array([jp_.slot_of[a] for a, _ in pairs], np.int32)
    Ts = np.stack([P[b] @ seq["cam_in_obs"][a] for a, b in pairs]
                  ).astype(np.float32)
    cj = np.asarray(jpool.covis_core(jp_.xyzs_h, jp_.nrms_h, jp_.valids_h,
                                     jnp.asarray(slots), jnp.asarray(Ts),
                                     0.342))
    ct = tpool.covis_core(tp_.xyzs_h, tp_.nrms_h, tp_.valids_h,
                          _t(slots).long(), _t(Ts), 0.342).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-6)
    assert (cj > 0.2).all()


def _orb_args(scene, pairs, seed):
    seq, jp_, tp_, feats = scene
    caps = np.array([[0.02, np.deg2rad(30)] if a == b + 1 else [np.inf, np.pi]
                     for a, b in pairs], np.float32)
    common = dict(
        bitsA=[feats[a][2] for a, _ in pairs],
        bitsB=[feats[b][2] for _, b in pairs],
        uvfA=[feats[a][3] for a, _ in pairs],
        uvfB=[feats[b][3] for _, b in pairs],
        nA=np.array([len(feats[a][0]) for a, _ in pairs], np.int32),
        nB=np.array([len(feats[b][0]) for _, b in pairs], np.int32),
        slots_a=np.array([jp_.slot_of[a] for a, _ in pairs], np.int32),
        slots_b=np.array([jp_.slot_of[b] for _, b in pairs], np.int32),
        TA=seq["cam_in_obs"][[a for a, _ in pairs]].astype(np.float32),
        TB=seq["cam_in_obs"][[b for _, b in pairs]].astype(np.float32),
        cap_t=caps[:, 0], cap_r=caps[:, 1])
    jargs = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, list)
                 else jnp.asarray(v)) for k, v in common.items()}
    targs = {k: (torch.stack([_t(np.asarray(x)) for x in v])
                 if isinstance(v, list) else _t(v))
             for k, v in common.items()}
    static = dict(seed=seed, inlier_dist=0.005, cos_normal_angle=COS30,
                  ratio=0.75, nbits=256, m_cap=1024, n_trials=T_TRIALS)
    return jargs, targs, static


@pytest.mark.parametrize("k_pull", [0, 64])
def test_orb_lift_ransac_slots(scene, k_pull):
    _, jp_, tp_, _ = scene
    pairs = [(1, 0), (2, 1), (2, 0), (3, 2)]
    jargs, targs, st = _orb_args(scene, pairs, seed=5)
    full_j = jpool.orb_lift_ransac_slots(jp_.xyzs, jp_.nrms, **jargs, **st)
    idx = _jax_draws(5, full_j["ok"], T_TRIALS)
    jres = (full_j if k_pull == 0 else jpool.orb_lift_ransac_slots(
        jp_.xyzs, jp_.nrms, **jargs, **st, k_pull=k_pull))
    tres = tpool.orb_lift_ransac_slots(tp_.xyzs, tp_.nrms, **targs, **st,
                                       k_pull=k_pull, sample_idx=_t(idx))
    full_t = tres if k_pull == 0 else tpool.orb_lift_ransac_slots(
        tp_.xyzs, tp_.nrms, **targs, **st, sample_idx=_t(idx))
    mj = np.asarray(full_j["inlier_mask"])
    mt = full_t["inlier_mask"].numpy()
    assert (mj != mt).sum() <= 0.005 * np.asarray(full_j["ok"]).sum()
    same = (mj == mt).all(1)                 # pairs without a gate flip
    assert same.sum() >= 3
    assert set(tres) == set(jres)
    for k in jres:
        a, b = np.asarray(jres[k]), tres[k].numpy()
        assert a.dtype == b.dtype, k
        if k in ("n_raw", "ok", "pA_cam", "pB_cam", "nA_cam", "nB_cam",
                 "uvA", "uvB", "conf") and k_pull == 0:
            np.testing.assert_array_equal(b, a, err_msg=k)  # before RANSAC
        elif k == "n_inliers":
            # a flipped match moves the score by its confidence (<= 1)
            np.testing.assert_allclose(b[same], a[same], rtol=1e-4)
            assert (np.abs(b - a) <= (mj != mt).sum(1) + 1e-4).all()
        else:
            np.testing.assert_array_equal(b[same], a[same], err_msg=k)
    n_in = mj.sum(1)
    assert (n_in[[0, 1, 3]] > 20).all()


def test_procrustes_and_covis(scene):
    """The ref-match extras on the same lifted matches: device procrustes of
    pair 0 from a perturbed pose (the JAX offset is a 50-step power-
    iteration Kabsch, the port's an exact SVD) and the window-selection
    covisibility at the corrected pose."""
    seq, jp_, tp_, _ = scene
    jargs, _, st = _orb_args(scene, [(2, 1)], seed=9)
    TA = seq["cam_in_obs"][1].astype(np.float32)[None]   # ref pose as init
    jargs["TA"] = jnp.asarray(TA)
    out_j = jpool.orb_lift_ransac_slots(jp_.xyzs, jp_.nrms, **jargs, **st)
    out_t = {k: _t(out_j[k]) for k in ("inlier_mask", "ok", "pA_cam",
                                        "pB_cam")}
    kf = np.array([jp_.slot_of[0], jp_.slot_of[1]], np.int32)
    kf_poses = seq["cam_in_obs"][[0, 1]].astype(np.float32)
    ex_slots = np.array([jp_.slot_of[1]], np.int32)
    ex_Ts = (np.linalg.inv(seq["cam_in_obs"][0])
             @ seq["cam_in_obs"][1])[None].astype(np.float32)
    TB = np.asarray(jargs["TB"])
    for gates, use in (([5, 5, 256, 1], True), ([500, 5, 256, 1], False)):
        g = np.array(gates, np.float32)
        rj = jpool._procrustes_and_covis(
            out_j, jnp.asarray(TA), jnp.asarray(TB), jnp.asarray(kf[1:]),
            jp_.xyzs_h, jp_.nrms_h, jp_.valids_h, 0.342,
            jnp.asarray(kf_poses), jnp.asarray(kf), jnp.asarray(ex_slots),
            jnp.asarray(ex_Ts), jnp.asarray(g))
        rt = tpool._procrustes_and_covis(
            out_t, _t(TA), _t(TB), _t(kf[1:]).long(), tp_.xyzs_h, tp_.nrms_h,
            tp_.valids_h, 0.342, _t(kf_poses), _t(kf).long(),
            _t(ex_slots).long(), _t(ex_Ts), _t(g))
        assert bool(rj["proc_use"]) == bool(rt["proc_use"]) == use
        np.testing.assert_allclose(rt["proc_offset"].numpy(),
                                   np.asarray(rj["proc_offset"]), atol=1e-5)
        np.testing.assert_allclose(float(rt["proc_err"]),
                                   float(rj["proc_err"]), rtol=1e-3,
                                   atol=1e-8)
        for k in ("covis_kf", "covis_extra"):
            np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                       atol=1e-6, err_msg=k)
        if use:
            corrected = rt["proc_offset"].numpy() @ TA[0]
            assert np.abs(corrected[:3, 3]
                          - seq["cam_in_obs"][2][:3, 3]).max() < 5e-3
