"""The tracker's bundle adjustment on padded shapes and its graph cache
(`tracker/ba_graph.py`), held on the CPU: the padded call against the
exact-count call and against the JAX package, `optimize_dispatch`'s packed
inputs against the arrays it built from lists before, a tracker run
against the frozen exact-count tracker, and `BAGraphs` driven with a
stand-in graph that records its calls. The graph itself runs on the card
only (`tests/test_torch_cuda.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence
from test_torch_ba import FACTOR, N, problem  # noqa: F401  (the fixture)

from bundlesdf_tpu.tracker import ba as jba
from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.tracker import ba as tba
from bundlesdf_tpu_torch.tracker.ba_graph import (C_MIN, KF_MIN, BAGraphs,
                                                  pack_into, pack_layout,
                                                  pow2_at_least, unpack)
from bundlesdf_tpu_torch.tracker.bundler import corres_arrays
from bundlesdf_tpu_torch.utils import profiling
from perfbench import harness

torch.set_num_threads(2)
ADMISSION_KF = (0, 1, 2)          # keyframes: frames 0-2, frame 1 off-window
LIVE = [0, 1, 2, 4, 5]            # pair rows kept (row 3, (1, 2), pruned)


def _exact(problem, entry):
    """The exact-count call's arrays (int64 indices; the pruned pair row
    and the wide search's pad rows left out) and its admission args."""
    seq, _, tp_, arr = problem
    a = {k: np.asarray(v) for k, v in arr.items()}
    for k in ("slots", "pair_ij", "corr_i", "corr_j", "pair_ij_w",
              "pair_w_dst"):
        a[k] = a[k].astype(np.int64)
    a["src_idx"] = a["src_idx"].astype(np.int64)
    a["pair_ij"] = a["pair_ij"][LIVE]
    a["pair_valid"] = a["pair_valid"][LIVE]
    rows = [r for r, (i, j) in enumerate(a["pair_ij"])
            if N - 1 in (i, j) and i != 1]          # 2 rows, padded to 3
    a["pair_ij_w"] = a["pair_ij"][rows]
    a["pair_w_dst"] = np.array(rows, np.int64)
    if entry != "hybrid":
        del a["pair_ij_w"], a["pair_w_dst"]
    kf = np.array([tp_.slot_of[i] for i in ADMISSION_KF], np.int64)
    adm = dict(nf_idx=N - 1, kf_slots=kf,
               kf_poses=seq["cam_in_obs"][:3].astype(np.float32),
               kf_window_idx=np.array([0, -1, 2], np.int64))
    return a, adm


def _padded(a, adm):
    """The same call padded as `Bundler.optimize_dispatch` pads it."""
    p = dict(a)
    P = N * (N - 1) // 2
    pad = P - len(a["pair_ij"])
    p["pair_ij"] = np.concatenate([a["pair_ij"],
                                   np.tile([[0, 1]], (pad, 1))])
    p["pair_valid"] = np.concatenate([a["pair_valid"], np.zeros(pad,
                                                                np.float32)])
    if "pair_ij_w" in a:
        Pw = N - 1 if len(a["pair_ij_w"]) <= N - 1 else P
        p["pair_ij_w"] = np.zeros((Pw, 2), np.int64)
        p["pair_ij_w"][:len(a["pair_ij_w"])] = a["pair_ij_w"]
        p["pair_w_dst"] = np.full(Pw, P, np.int64)
        p["pair_w_dst"][:len(a["pair_w_dst"])] = a["pair_w_dst"]
    C = len(a["corr_i"])
    Cp = pow2_at_least(C, C_MIN)
    for k in ("corr_i", "corr_j", "corr_pi", "corr_pj", "corr_valid"):
        v = np.zeros((Cp,) + a[k].shape[1:], a[k].dtype)
        v[:C] = a[k]
        p[k] = v
    KF = pow2_at_least(len(adm["kf_slots"]), KF_MIN)
    n = len(adm["kf_slots"])
    q = dict(nf_idx=np.array([adm["nf_idx"]], np.int64),
             kf_slots=np.zeros(KF, np.int64),
             kf_poses=np.tile(np.eye(4, dtype=np.float32), (KF, 1, 1)),
             kf_window_idx=np.full(KF, -1, np.int64))
    for k in ("kf_slots", "kf_poses", "kf_window_idx"):
        q[k][:n] = adm[k]
    p.update(q)
    return p


def _counts_of(a):
    """The real counts a padded call passes with its arrays."""
    return dict(n_corr=len(a["corr_i"]), n_pairs=len(a["pair_ij"]))


def _maps(tp_):
    return dict(pool_xyzs=tp_.xyzs_h, pool_nrms=tp_.nrms_h,
                pool_valids=tp_.valids_h, pool_greys=None)


STATIC = dict(factor=FACTOR, pre_decim=2, covis_thres_cos=0.342)


@pytest.mark.parametrize("entry", ["window", "projective", "hybrid"])
def test_padded_ba_equals_exact_counts(problem, entry):  # noqa: F811
    tp_ = problem[2]
    a, adm = _exact(problem, entry)
    cfg = tba.BAConfig(assoc_entry_mode=entry)
    pe, ce = tba.bundle_adjust_pooled(
        **_maps(tp_), **{k: torch.from_numpy(v) for k, v in a.items()},
        cfg=cfg, **STATIC, **{k: v if k == "nf_idx" else torch.from_numpy(v)
                              for k, v in adm.items()})
    p = _padded(a, adm)
    assert len(p["corr_i"]) == C_MIN and len(p["kf_slots"]) == KF_MIN
    pp, cp = BAGraphs()(p, _maps(tp_), cfg=cfg, **_counts_of(a), **STATIC)
    assert torch.equal(pp, pe)
    assert (pe - torch.from_numpy(a["poses0"])).abs().max() > 1e-4
    assert torch.equal(cp[:len(adm["kf_slots"])], ce)
    # the sums over all the padded rows move the bits, within 1e-6
    pq, _ = BAGraphs()(p, _maps(tp_), cfg=cfg, **STATIC)
    assert (pq - pe).abs().max() <= 1e-6


@pytest.mark.parametrize("cfg_kw,tol", [
    (dict(assoc_entry_mode="window", assoc_dtype="f32",
          early_out_delta=0.0), 1e-5),
    (dict(assoc_entry_mode="projective", assoc_dtype="f32",
          early_out_delta=0.0), 1e-5),
    (dict(assoc_entry_mode="hybrid", assoc_dtype="f32",
          early_out_delta=0.0), 1e-5),
    ({}, 1e-4)])
def test_padded_ba_against_jax(problem, cfg_kw, tol):  # noqa: F811
    """Tolerances of `test_torch_ba.py`: f32 with the early-out off 1e-5,
    the default (bf16 scoring, hybrid, early-out) 1e-4; covisibility
    2e-3."""
    seq, jp_, tp_, _ = problem
    entry = cfg_kw.get("assoc_entry_mode", "hybrid")
    a, adm = _exact(problem, entry)
    pj, cj = jba.bundle_adjust_pooled(
        jp_.xyzs_h, jp_.nrms_h, **{k: jnp.asarray(v) for k, v in a.items()},
        factor=FACTOR, cfg=jba.BAConfig(**cfg_kw), pre_decim=2,
        pool_valids=jp_.valids_h, covis_thres_cos=0.342,
        **{k: v if k == "nf_idx" else jnp.asarray(v)
           for k, v in adm.items()})
    pt, ct = BAGraphs()(_padded(a, adm), _maps(tp_), **_counts_of(a),
                        cfg=tba.BAConfig(**cfg_kw), **STATIC)
    assert np.abs(np.asarray(pj) - pt.numpy()).max() < tol
    np.testing.assert_allclose(ct[:3].numpy(), np.asarray(cj), atol=2e-3)


def test_pack_round_trip_is_bit_equal():
    rng = np.random.default_rng(0)
    arrays = dict(a=rng.integers(-5, 5, (3, 7)).astype(np.int64),
                  b=rng.random((5, 3)).astype(np.float32),
                  c=rng.random(9) > 0.5, d=np.zeros((0, 2), np.int64),
                  e=rng.random((2, 4, 4)).astype(np.float32))
    layout, nbytes = pack_layout(arrays)
    assert [o for *_, o in layout] == [0, 512, 1024, 1536, 1536]
    assert nbytes == 2048
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    pack_into(buf.numpy(), arrays, layout)
    out = unpack(buf, layout)
    for k, v in arrays.items():
        assert out[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(out[k].numpy(), v)
    with pytest.raises(TypeError):
        pack_layout({"x": np.zeros(3, np.int32)})


def test_corres_arrays_equal_the_list_built_ones():
    rng = np.random.default_rng(3)
    blocks = [(j, i, {"conf": np.ones(n), "pA_cam": rng.random((n, 3)),
                      "pB_cam": rng.random((n, 3))})
              for j, i, n in ((1, 0, 7), (2, 0, C_MIN + 4), (2, 1, 1))]
    ci, cj, pi, pj = [], [], [], []
    for j, i, m in blocks:
        n = len(m["conf"])
        cj += [j] * n
        ci += [i] * n
        pj.append(m["pA_cam"])
        pi.append(m["pB_cam"])
    got = corres_arrays(blocks)
    n = C_MIN + 12
    assert {k: v.shape[0] for k, v in got.items()} == dict.fromkeys(
        got, 2 * C_MIN)
    np.testing.assert_array_equal(got["corr_i"][:n], np.array(ci))
    np.testing.assert_array_equal(got["corr_j"][:n], np.array(cj))
    np.testing.assert_array_equal(got["corr_pi"][:n],
                                  np.concatenate(pi).astype(np.float32))
    np.testing.assert_array_equal(got["corr_pj"][:n],
                                  np.concatenate(pj).astype(np.float32))
    np.testing.assert_array_equal(got["corr_valid"],
                                  np.arange(2 * C_MIN) < n)
    for k in ("corr_i", "corr_j", "corr_pi", "corr_pj"):
        assert not got[k][n:].any()
    small = corres_arrays(blocks[:1])
    assert len(small["corr_i"]) == C_MIN and small["corr_valid"].sum() == 7
    assert pow2_at_least(0, 256) == 256 and pow2_at_least(257, 256) == 512
    assert pow2_at_least(3, 1) == 4 and pow2_at_least(8, 8) == 8


def _list_built(b, frames):
    """The arrays `optimize_dispatch` built from lists, at exact counts,
    before the padding (its first scale; admission arrays as uploaded)."""
    idx_of = {f.id: k for k, f in enumerate(frames)}
    corr_i, corr_j, pi, pj = [], [], [], []
    for a in range(len(frames)):
        for c in range(a + 1, len(frames)):
            fA, fB = frames[c], frames[a]
            m = b.matches.get((fA.id, fB.id))
            if m is None or len(m["conf"]) == 0:
                continue
            n = len(m["conf"])
            corr_j += [idx_of[fA.id]] * n
            corr_i += [idx_of[fB.id]] * n
            pj.append(m["pA_cam"])
            pi.append(m["pB_cam"])
    n_f = len(frames)
    update_flags = np.zeros(n_f, np.float32)
    for k, f in enumerate(frames):
        if k > 0 and not f.nerfed:
            update_flags[k] = 1.0
    rot_thres = np.deg2rad(float(b.cfg["bundle"].get("icp_pose_rot_thres",
                                                     60)))

    def rot_ok(i, j):
        R = frames[i].pose_in_model[:3, :3] @ frames[j].pose_in_model[:3, :3].T
        cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        return np.arccos(cos) < rot_thres

    live = [(i, j) for i in range(n_f) for j in range(i + 1, n_f)
            if (update_flags[i] > 0 or update_flags[j] > 0) and rot_ok(i, j)]
    pair_ij = np.asarray(live or [(0, min(1, n_f - 1))], np.int64)
    last_win = getattr(b, "_last_ba_window", {})

    def uncertain(f):
        if f is b.new_frame:
            return True
        p = last_win.get(f.id)
        return p is None or not np.array_equal(p, f.pose_in_model)

    unc = {k for k, f in enumerate(frames) if uncertain(f)}
    rows = [r for r, (i, j) in enumerate(live) if i in unc or j in unc]
    kfs = b.keyframes
    KF = max(len(kfs), 1)
    kf_slots = np.zeros(KF, np.int64)
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (KF, 1, 1))
    kf_window_idx = np.full(KF, -1, np.int64)
    for k, kf in enumerate(kfs):
        kf_slots[k] = kf.slot
        kf_poses[k] = kf.pose_in_model.astype(np.float32)
        kf_window_idx[k] = idx_of.get(kf.id, -1)
    return dict(
        slots=np.array([f.slot for f in frames], np.int64),
        slot_live=np.ones(n_f, np.float32),
        poses0=torch.as_tensor(np.stack([f.pose_in_model for f in frames]),
                               dtype=torch.float32).numpy(),
        K=np.asarray(frames[0].K, np.float32), pair_ij=pair_ij,
        corr_i=np.array(corr_i, np.int64), corr_j=np.array(corr_j, np.int64),
        corr_pi=np.concatenate(pi).astype(np.float32),
        corr_pj=np.concatenate(pj).astype(np.float32),
        corr_valid=np.ones(len(corr_i), np.float32),
        update_flags=update_flags,
        pair_valid=np.full(len(pair_ij), 1.0 if live else 0.0, np.float32),
        pair_ij_w=pair_ij[rows] if rows else np.zeros((1, 2), np.int64),
        pair_w_dst=(np.asarray(rows, np.int64) if rows
                    else np.full(1, len(pair_ij), np.int64)),
        nf_idx=idx_of[b.new_frame.id], kf_slots=kf_slots, kf_poses=kf_poses,
        kf_window_idx=kf_window_idx, n_kf=len(kfs))


class Recorder:
    """Wraps a bundler's `BAGraphs`: keeps each call's arrays beside the
    list-built ones of the same bundler state."""

    def __init__(self, b):
        self.b, self.inner, self.calls = b, b._ba, []

    def __call__(self, arrays, maps, poses_in=None, **static):
        self.calls.append((arrays, _list_built(self.b, self.b.local_frames)))
        return self.inner(arrays, maps, poses_in, **static)


def _cfg(default_track_config, tmp):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp)
    cfg["SPDLOG"] = 0
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 500
    cfg["bundle"]["max_BA_frames"] = 5
    cfg["bundle"]["depth_association_radius"] = 2
    cfg["feature_corres"]["fused_matcher"] = True
    return cfg


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """8 frames of the orbit through the port, its BA calls recorded, and
    through the frozen exact-count tracker of the benchmark."""
    from perfbench.reference.frozen.bundlesdf import BundleSdf as Frozen
    from perfbench.reference.frozen import config as frozen_config
    from perfbench.reference.frozen.matcher.classical import (
        OrbMatcher as FrozenOrb)
    seq = cube_orbit_sequence(n_frames=8, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.35)
    out = {}
    for name in ("port", "frozen"):
        tmp = tmp_path_factory.mktemp(name)
        if name == "port":
            t = BundleSdf(cfg_track=_cfg(default_track_config, tmp),
                          start_nerf_keyframes=10 ** 9,
                          device="cpu", matcher=OrbMatcher(
                              device="cpu", detector=cv2_detector))
            rec = t.bundler._ba = Recorder(t.bundler)
        else:
            t = Frozen(_cfg(frozen_config.default_track_config, tmp),
                       frozen_config.default_nerf_config(),
                       start_nerf_keyframes=10 ** 9, device="cpu",
                       matcher=FrozenOrb(device="cpu", detector=cv2_detector))
        frames = [t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
                  for i in range(8)]
        t.flush_pipeline()
        out[name] = np.array([f.pose_in_model for f in frames])
    return rec.calls, out


def test_packed_inputs_equal_the_list_built_arrays(tracked):
    calls, _ = tracked
    assert len(calls) >= 5
    for arrays, old in calls:
        n_f = len(old["slots"])
        P = n_f * (n_f - 1) // 2
        C = len(old["corr_i"])
        Cp = pow2_at_least(C, C_MIN)
        KF = pow2_at_least(old["n_kf"], KF_MIN)
        live = int(old["pair_valid"].sum())
        Pw = len(old["pair_ij_w"]) if old["pair_w_dst"][0] < len(
            old["pair_ij"]) else 0
        shapes = {k: v.shape for k, v in arrays.items()}
        assert shapes["pair_ij"] == (P, 2) and shapes["corr_i"] == (Cp,)
        assert shapes["pair_ij_w"] == (n_f - 1 if Pw <= n_f - 1 else P, 2)
        assert shapes["kf_slots"] == (KF,) and shapes["nf_idx"] == (1,)
        for k in ("slots", "slot_live", "poses0", "K", "update_flags"):
            np.testing.assert_array_equal(arrays[k], old[k], err_msg=k)
        for k in ("corr_i", "corr_j", "corr_pi", "corr_pj", "corr_valid"):
            np.testing.assert_array_equal(arrays[k][:C], old[k], err_msg=k)
            assert not arrays[k][C:].any(), k
        np.testing.assert_array_equal(arrays["pair_ij"][:live],
                                      old["pair_ij"][:live])
        np.testing.assert_array_equal(arrays["pair_valid"],
                                      np.arange(P) < live)
        assert (arrays["pair_ij"][live:] == [0, 1]).all()
        np.testing.assert_array_equal(arrays["pair_ij_w"][:Pw],
                                      old["pair_ij_w"][:Pw])
        np.testing.assert_array_equal(arrays["pair_w_dst"][:Pw],
                                      old["pair_w_dst"][:Pw])
        assert (arrays["pair_w_dst"][Pw:] == P).all()
        assert arrays["nf_idx"][0] == old["nf_idx"]
        n_kf = old["n_kf"]
        for k in ("kf_slots", "kf_poses", "kf_window_idx"):
            np.testing.assert_array_equal(arrays[k][:n_kf], old[k][:n_kf],
                                          err_msg=k)
        assert (arrays["kf_window_idx"][n_kf:] == -1).all()
        assert (arrays["kf_poses"][n_kf:] == np.eye(4)).all()


def test_tracker_on_padded_shapes_equals_the_frozen_exact_one(tracked):
    _, out = tracked
    assert np.array_equal(out["port"], out["frozen"])


class RecordingGraph:
    """A stand-in for `torch.cuda.CUDAGraph` that records its calls; what
    it "captures" runs at once, and a replay does nothing."""

    made = []

    def __init__(self):
        self.calls = []
        RecordingGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append(("end",))

    def replay(self):
        self.calls.append(("replay",))


def _counts(before):
    after = profiling.snapshot()
    return [after.get(n, (0, 0.0))[0] - before.get(n, (0, 0.0))[0]
            for n in ("ba.graph.captures", "ba.graph.replays",
                      "ba.graph.capture", "ba.graph.replay")]


def test_graph_cache_captures_once_a_key_and_evicts_the_oldest(
        problem):  # noqa: F811
    tp_ = problem[2]
    a, adm = _exact(problem, "hybrid")
    cfg = tba.BAConfig()
    RecordingGraph.made.clear()
    graphs = BAGraphs(new_graph=RecordingGraph)
    graphs.MAX_GRAPHS = 3
    base = _padded(a, adm)

    def call(p, maps=None, n_outer=7):
        return graphs(p, maps or _maps(tp_), cfg=tba.BAConfig(n_outer=n_outer),
                      **_counts_of(a), **STATIC)

    before = profiling.snapshot()
    first = call(base)
    moved = dict(base, poses0=base["poses0"] + 1e-3)
    assert call(moved) is first               # the same key: a replay
    made = RecordingGraph.made
    pieces = 2 * cfg.n_outer + 1              # two a GN iteration, one more
    assert len(made) == pieces and all(m.calls == [
        ("begin", "thread_local"), ("end",), ("replay",), ("replay",)]
        for m in made)
    assert _counts(before) == [1, 2, 1, 2]
    # each bucket that changes makes a new key
    more_c = _padded(dict(a, **{k: np.concatenate([a[k]] * 120) for k in (
        "corr_i", "corr_j", "corr_pi", "corr_pj", "corr_valid")}), adm)
    assert len(more_c["corr_i"]) == 2 * C_MIN
    more_kf = _padded(a, dict(adm, **{k: np.concatenate([adm[k]] * 22)
                                      for k in ("kf_slots", "kf_poses",
                                                "kf_window_idx")}))
    assert len(more_kf["kf_slots"]) == 2 * KF_MIN
    assert len(base["pair_ij_w"]) == 3
    fewer_w = dict(base, pair_ij_w=base["pair_ij_w"][:1],
                   pair_w_dst=base["pair_w_dst"][:1])
    for p in (more_c, more_kf, fewer_w):
        call(p)
    assert len(made) == 4 * pieces and len(graphs) == 3
    # the first key was evicted: it captures again; the newest replays
    call(base)
    call(fewer_w)
    assert len(made) == 5 * pieces and len(graphs) == 3
    assert made[-1].calls[-1] == ("replay",)
    assert _counts(before) == [5, 7, 5, 7]
    # a grown pool keeps the key: the call's frames are gathered from it
    grown = {k: None if t is None else torch.cat([t, t])
             for k, t in _maps(tp_).items()}
    call(base, grown)
    assert _counts(before) == [5, 8, 5, 8]
    # fewer frames (N) and another BA config make new keys
    three = dict(base)
    three.update(slots=base["slots"][:3], slot_live=base["slot_live"][:3],
                 poses0=base["poses0"][:3], update_flags=np.array(
                     [0, 1, 1], np.float32), src_idx=base["src_idx"][:3],
                 src_valid=base["src_valid"][:3],
                 pair_ij=np.array([[0, 1], [0, 2], [1, 2]], np.int64),
                 pair_valid=np.ones(3, np.float32),
                 pair_ij_w=np.array([[0, 2], [1, 2]], np.int64),
                 pair_w_dst=np.array([1, 2], np.int64),
                 nf_idx=np.array([2], np.int64),
                 corr_i=np.minimum(base["corr_i"], 2),
                 corr_j=np.minimum(base["corr_j"], 2))
    graphs(three, _maps(tp_), cfg=cfg, n_corr=len(a["corr_i"]), n_pairs=3,
           **STATIC)
    call(base, n_outer=3)
    assert len(made) == 6 * pieces + 2 * 3 + 1
    assert _counts(before) == [7, 10, 7, 10]


def test_cpu_tensors_run_eagerly(problem):  # noqa: F811
    tp_ = problem[2]
    a, adm = _exact(problem, "hybrid")
    graphs = BAGraphs()
    before = profiling.snapshot()
    graphs(_padded(a, adm), _maps(tp_), cfg=tba.BAConfig(), **_counts_of(a),
           **STATIC)
    assert len(graphs) == 0 and _counts(before) == [0, 0, 0, 0]


def test_ba_constant_is_made_once_a_device():
    old = torch.cos(torch.deg2rad(torch.tensor(20.0, dtype=torch.float32)))
    c = tba._cos_deg(20, torch.device("cpu"))
    assert c.dtype == torch.float32 and torch.equal(c, old)
    assert tba._cos_deg(20.0, "cpu") is c
    assert tba._cos_deg(30, "cpu") is not c


def _ev(name, ts, ms, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": ms * 1e3,
            "name": "stage:" + name, "args": {}}


def test_ba_graph_share_reads_the_dispatches_that_replayed():
    read = harness.load_metric(harness.HERE, "tracker.ba_graph_share.track")
    ev = [_ev("ba_dispatch", 0.0, 10.0), _ev("ba.graph.replay", 2e3, 1.0),
          _ev("ba_dispatch", 20e3, 10.0), _ev("ba.graph.capture", 21e3, 5.0),
          _ev("ba.graph.replay", 27e3, 1.0),
          _ev("ba.graph.replay", 28e3, 1.0),           # a second scale
          _ev("ba_dispatch", 40e3, 1.0),               # zero corres: none
          _ev("ba.graph.replay", 2e3, 1.0, cat="gpu_user_annotation")]
    assert read({"events": ev}) == pytest.approx(200.0 / 3)
    assert read({"events": ev[:2]}) == pytest.approx(100.0)
    assert read({"events": [ev[0], ev[-2]]}) is None
    assert read({"events": None}) is None and read({}) is None


def test_nof_field_draws_only_from_its_generator():
    """A NOF field's layers draw from the field's generator alone: a draw
    from the default generator in the NOF thread, while the tracker's
    thread captures its BA as a CUDA graph, would count as the graph's and
    make the next one fail (`tests/test_torch_cuda.py` runs that race)."""
    from bundlesdf_tpu_torch.nof.models import NofField, NofSpec
    from bundlesdf_tpu_torch.ops.hashgrid import HashGridSpec
    spec = NofSpec(grid=HashGridSpec(n_levels=2, base_res=4, finest_res=8,
                                     log2_hashmap_size=8))
    state = torch.random.get_rng_state()
    a = NofField(spec, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    b = NofField(spec, generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    # the layers hold what their generator drew: U(-1/sqrt(n_in), ..)
    w = a.sigma_net[0].weight
    assert 0 < w.abs().max() <= 1 / np.sqrt(w.shape[1])
