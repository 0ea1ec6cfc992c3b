"""The tracker through the port's LoFTR path (`find_corres`'s predict
branch: `pairing.process_image_pairs` -> `LoftrMatcher.predict` ->
`map_matches_back` -> map points -> lift + RANSAC) held against the JAX
package's run on the same frames, with the tiny golden weights loaded into
both (as `tests/test_loftr_e2e.py` runs JAX):

- every pair the JAX run matched, from the JAX run's own inputs (images,
  ROIs, poses): the port's crops within 1 grey level of the JAX
  package's (cv2's warp), its raw matches equal (uv0 equal, uv1 within
  1e-3 px, conf within 1e-5; a match in one set only must sit on a
  mutual-nearest-neighbour tie within 1e-5), and the matches mapped back
  equal;
- in the two runs themselves, the pairs whose transforms agree (the
  RANSAC draws differ, threefry against Philox, so later poses drift
  apart within the tolerance below) see crops within 1 grey level;
- statuses equal, no FAIL, poses within 2 mm and 1 degree per frame (the
  tolerance of tests/test_torch_tracker.py);
- a torch checkpoint file in `cfg_track["loftr_ckpt"]` makes
  `BundleSdf(device="cpu")` build a bf16 `LoftrMatcher`, and a run goes
  through it.
"""
import os

import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

import bundlesdf_tpu.bundlesdf as jax_bundlesdf
import bundlesdf_tpu_torch.bundlesdf as torch_bundlesdf
from bundlesdf_tpu.config import default_nerf_config
from bundlesdf_tpu.matcher import loftr as jl
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher import loftr as tl
from bundlesdf_tpu_torch.matcher import pairing as tp

torch.set_num_threads(2)
N = 5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "loftr_golden_tiny.npz")
TINY = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16, d_fine=8,
            nhead=2, n_coarse_layers=2, n_fine_layers=1, match_thr=0.0,
            max_matches=64)
TIE = 1e-5


def _cfg(tmp, map_points):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp)
    cfg["bundle"]["max_BA_frames"] = 4
    cfg["bundle"]["depth_association_radius"] = 2
    # the tiny net finds a few mutual matches a pair at 128 px (at 64 px,
    # too few for RANSAC: every frame FAILs)
    cfg["feature_corres"]["resize"] = 128
    cfg["feature_corres"]["min_match_with_ref"] = 3
    cfg["feature_corres"]["map_points"] = map_points
    return cfg


def _spy(obj, name, calls):
    """Record (args, result) of every call of obj.<name>."""
    orig = getattr(obj, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    return spy


def _host(imgs):
    return [np.asarray(torch.as_tensor(a).cpu()) for a in imgs]


@pytest.fixture(scope="module", params=[False, True],
                ids=["pairs", "map_points"])
def runs(request, tmp_path_factory):
    d = np.load(FIXTURE)
    sd = {k[3:]: d[k] for k in d.files if k.startswith("sd/")}
    seq = cube_orbit_sequence(n_frames=N, H=144, W=192, full_angle=0.15)
    out = {}
    for name, mod in (("jax", jax_bundlesdf), ("torch", torch_bundlesdf)):
        tmp = tmp_path_factory.mktemp(name)
        cfg = _cfg(tmp, request.param)
        if name == "jax":
            cfg_l = jl.LoftrConfig(**TINY)
            m = jl.LoftrMatcher(cfg=cfg_l,
                                params=jl.convert_torch_state_dict(sd, cfg_l))
            t = mod.BundleSdf(cfg_track=cfg, cfg_nerf=default_nerf_config(),
                              start_nerf_keyframes=99, matcher=m)
            pairing = "process_image_pair"
        else:
            m = tl.LoftrMatcher(cfg=tl.LoftrConfig(**TINY), device="cpu")
            m.net = tl.load_reference_state_dict(sd, tl.LoftrConfig(**TINY))
            t = mod.BundleSdf(cfg_track=cfg, start_nerf_keyframes=99,
                              matcher=m, device="cpu")
            pairing = "process_image_pairs"
        predicts, pairs = [], []
        m.predict = _spy(m, "predict", predicts)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, pairing, _spy(mod, pairing, pairs))
            frames = [t.run(seq["colors"][i], seq["depths"][i].copy(),
                            seq["K"], seq["id_strs"][i], mask=seq["masks"][i])
                      for i in range(N)]
            t.on_finish()
        del m.predict  # the class's own from here on
        out[name] = dict(frames=frames, predicts=predicts, pairs=pairs, m=m)
    return out


def _assert_same_matches(got, want, conf_matrix, wc):
    """Equal match sets but for mutual-NN ties within TIE in the port's
    coarse confidence; equal coordinates and confidences on the shared
    matches. Returns the number of tied matches."""
    assert got.dtype == np.float32 and got.shape[1] == want.shape[1] == 5
    g = {tuple(r[:2]): r for r in got}
    w = {tuple(r[:2]): r for r in want}
    for key in set(g) ^ set(w):
        i = int(key[1]) // 8 * wc + int(key[0]) // 8
        row = np.sort(conf_matrix[i])
        col = np.sort(conf_matrix[:, conf_matrix[i].argmax()])
        assert row[-1] - row[-2] < TIE or col[-1] - col[-2] < TIE, key
    shared = sorted(set(g) & set(w))
    assert len(shared) >= 0.9 * max(len(g), len(w))
    a = np.array([g[k] for k in shared])
    b = np.array([w[k] for k in shared])
    np.testing.assert_allclose(a[:, 2:4], b[:, 2:4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)
    return len(set(g) ^ set(w))


def test_predict_branch_on_the_jax_inputs(runs):
    jax_pairs, jax_predicts = runs["jax"]["pairs"], runs["jax"]["predicts"]
    m = runs["torch"]["m"]
    jax_out = [o for (_, _, outs) in jax_predicts for o in outs]
    assert len(jax_out) == len(jax_pairs) >= N - 1
    equal = total = n_matches = n_tied = 0
    for (args, kw, (jA, jB, jtA, jtB)), want in zip(jax_pairs, jax_out):
        cA, cB, tfA, tfB = tp.process_image_pair(*args, **kw)
        np.testing.assert_allclose(tfA, jtA, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tfB, jtB, rtol=0, atol=1e-9)
        d = np.abs(np.stack([cA, cB]).astype(int)
                   - np.stack([jA, jB]).astype(int))
        assert d.max() <= 1
        equal += int((d == 0).sum())
        total += d.size
        got = m.predict([cA], [cB])[0]
        with torch.no_grad():
            conf = m.net(torch.from_numpy(cA)[None] / 255.0,
                         torch.from_numpy(cB)[None] / 255.0,
                         debug=True)["conf_matrix"][0].numpy()
        n_tied += _assert_same_matches(got, want, conf, cA.shape[1] // 8)
        n_matches += len(want)
        np.testing.assert_allclose(
            tp.map_matches_back(got, tfA, tfB)[:, :4],
            jax_bundlesdf.map_matches_back(got, jtA, jtB)[:, :4],
            rtol=0, atol=1e-9)
    assert n_matches > 0
    print(f"{len(jax_out)} pairs: crops {100 * equal / total:.4f} % of "
          f"pixels equal to JAX's; {n_matches} raw matches, {n_tied} on a "
          f"tie")


def test_run_crops_where_transforms_agree(runs):
    jax_tfs = [out[2:] for (_, _, out) in runs["jax"]["pairs"]]
    jax_crops = [c for (args, _, _) in runs["jax"]["predicts"]
                 for c in zip(_host(args[0]), _host(args[1]))]
    torch_tfs = [tf for (_, _, out) in runs["torch"]["pairs"]
                 for tf in out[2]]
    torch_crops = [c for (args, _, _) in runs["torch"]["predicts"]
                   for c in zip(_host(args[0]), _host(args[1]))]
    assert len(torch_crops) == len(jax_crops) == len(jax_tfs)
    same = 0
    for tj, tt, cj, ct in zip(jax_tfs, torch_tfs, jax_crops, torch_crops):
        if max(np.abs(a - b).max() for a, b in zip(tj, tt)) > 1e-9:
            continue
        same += 1
        for a, b in zip(cj, ct):
            assert a.shape == b.shape and b.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert same >= 1
    print(f"{same} of {len(jax_tfs)} pairs with equal transforms in the "
          f"two runs")


def test_statuses_and_poses(runs):
    fj, ft = runs["jax"]["frames"], runs["torch"]["frames"]
    assert [f.status.name for f in fj] == [f.status.name for f in ft]
    assert all(f.status.name != "FAIL" for f in ft)
    worst = (0.0, 0.0)
    for a, b in zip(fj, ft):
        Tj, Tt = a.pose_in_model, b.pose_in_model
        assert np.isfinite(Tt).all()
        dt = np.linalg.norm(Tj[:3, 3] - Tt[:3, 3])
        cos = (np.trace(Tj[:3, :3] @ Tt[:3, :3].T) - 1) / 2
        dr = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        assert dt < 0.002 and dr < 1.0, (a.id_str, dt, dr)
        worst = (max(worst[0], dt), max(worst[1], dr))
    print(f"poses: worst {worst[0] * 1e3:.4f} mm, {worst[1]:.4f} deg")


def _reference_layout(net):
    """A reference-layout state_dict of @net: each folded BatchNorm as a
    BatchNorm of unit scale holding the bias."""
    from bundlesdf_tpu_torch.matcher.loftr import _conv_names
    state = net.state_dict()
    sd = {}
    for key, ref, bn, _ in _conv_names():
        sd[f"{ref}.weight"] = state[f"{key}.weight"]
        if bn is not None:
            b = state[f"{key}.bias"]
            sd.update({f"{bn}.weight": torch.ones_like(b), f"{bn}.bias": b,
                       f"{bn}.running_mean": torch.zeros_like(b),
                       f"{bn}.running_var": torch.full_like(b, 1 - 1e-5)})
    sd.update({k: v for k, v in state.items() if not k.startswith(
        "backbone.")})
    return sd


def test_ckpt_in_config_selects_loftr(tmp_path):
    """A torch-format checkpoint at full LoftrConfig() dims in
    cfg_track['loftr_ckpt'] -> LoftrMatcher, bf16 by default, and the
    predict branch runs (as tests/test_loftr_e2e.py checks for JAX)."""
    path = str(tmp_path / "outdoor_ds.ckpt")
    sd = _reference_layout(tl.init_loftr(tl.LoftrConfig(), seed=0))
    torch.save({"state_dict": {f"matcher.{k}": v for k, v in sd.items()}},
               path)
    n = 3
    seq = cube_orbit_sequence(n_frames=n, H=72, W=96, full_angle=0.15)
    cfg = _cfg(tmp_path / "dbg", map_points=True)
    cfg["loftr_ckpt"] = path
    t = torch_bundlesdf.BundleSdf(cfg_track=cfg, start_nerf_keyframes=99,
                                  device="cpu")
    assert isinstance(t.matcher, tl.LoftrMatcher)
    assert {p.dtype for p in t.matcher.net.parameters()} == {torch.bfloat16}
    calls = []
    t.matcher.predict = _spy(t.matcher, "predict", calls)
    for i in range(n):
        t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
              seq["id_strs"][i], mask=seq["masks"][i])
    t.on_finish()
    assert len(calls) >= n - 1
    for i in range(n):
        pose = np.loadtxt(tmp_path / "dbg" / "ob_in_cam" / f"{i:04d}.txt")
        assert pose.shape == (4, 4) and np.isfinite(pose).all()
    cfg["loftr_ckpt"] = str(tmp_path / "missing.ckpt")
    t = torch_bundlesdf.BundleSdf(cfg_track=cfg, start_nerf_keyframes=99,
                                  device="cpu")
    assert type(t.matcher).__name__ == "OrbMatcher"
