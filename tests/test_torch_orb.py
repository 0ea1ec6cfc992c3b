"""The port's ORB detector (`bundlesdf_tpu_torch/matcher/orb.py`) held
against cv2, which the JAX package detects with, stage by stage and whole:

- each stage bit-equal to its cv2 function on seeded random images and on
  orbit frames: RGB -> grey, INTER_LINEAR and INTER_LINEAR_EXACT resizes,
  the 7x7 sigma-2 blur, FAST-9/16 keypoints and scores;
- `fast_atan2` within 1e-3 degrees of cv2.fastAtan2;
- rBRIEF with the recovered pattern: descriptors equal to `orb.compute`'s
  on cv2's own keypoints and angles (given to both);
- the whole detector against `cv2.ORB_create(2000, fastThreshold=5)` on
  the masked crops of orbit frames: >= 95 % of cv2's keypoints found at
  the same octave within 1e-3 px, angles within 1 degree, at most 2 of
  256 descriptor bits different on average;
- the mutual-ratio matches of frame pairs from the port's features and
  from cv2's overlap by >= 90 %;
- a 10-frame tracker-only run of the port with its own detector against
  the JAX package on cv2's features: no FAIL frame, and mean ADD <=
  max(2 x JAX, JAX + 1 mm);
- `OrbMatcher.predict` (whole images, the LoFTR-shaped contract) against
  the JAX package's on four 120x160 orbit pairs and two pairs
  canonicalized to 400x400: with cv2's keypoints injected, the same rows
  in the same order, confidences within 1e-6, at min_strict 0, 5 and 40
  (40 sends a pair to the loose ratio); with the port's own ORB, >= 90 %
  of the matches shared; the empty and < 2 keypoint cases; tensor input
  against list input.
"""
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from orb_cv2 import crop_zoom, cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.matcher import orb
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher

torch.set_num_threads(2)
T = torch.from_numpy


@pytest.fixture(scope="module")
def frames():
    """Six 480x640 frames of the smoke run's orbit (noise 2 mm) and their
    masked crops as the matcher zooms them."""
    seq = cube_orbit_sequence(n_frames=6, H=480, W=640, radius=0.45,
                              obj_size=0.08, full_angle=2 * np.pi * 6 / 120,
                              noise=0.002, seed=0)
    crops = [crop_zoom(c, m) for c, m in zip(seq["colors"], seq["masks"])]
    return seq, crops


def _textures(n=3, H=200, W=230):
    rng = np.random.default_rng(0)
    return [cv2.GaussianBlur(rng.integers(0, 256, (H, W), dtype=np.uint8),
                             (5, 5), 0.8 + 0.4 * i) for i in range(n)]


def test_gray_equals_cv2(frames):
    seq, _ = frames
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (300, 317, 3), dtype=np.uint8)]
    for img in imgs + list(seq["colors"][:2]):
        np.testing.assert_array_equal(
            orb.rgb_to_gray(T(img)).numpy(),
            cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("mode", ["linear", "linear_exact"])
def test_resize_equals_cv2(frames, mode):
    fn, flag = {"linear": (orb.resize_linear, cv2.INTER_LINEAR),
                "linear_exact": (orb.resize_linear_exact,
                                 cv2.INTER_LINEAR_EXACT)}[mode]
    rng = np.random.default_rng(1)
    cases = [(rng.integers(0, 256, (H, W), dtype=np.uint8), (w, h))
             for H, W, h, w in [(300, 317, 400, 380), (37, 23, 400, 249),
                                (612, 480, 400, 314), (13, 400, 9, 290),
                                (400, 400, 333, 333), (11, 9, 50, 37)]]
    seq, _ = frames
    gray = cv2.cvtColor(seq["colors"][0], cv2.COLOR_RGB2GRAY)
    crop = gray[150:330, 220:400]
    cases += [(crop, (400, 400)), (crop, (278, 278))]
    for img, size in cases:
        np.testing.assert_array_equal(
            fn(T(np.ascontiguousarray(img)), size).numpy(),
            cv2.resize(img, size, interpolation=flag), err_msg=str(size))
    # the pyramid's level sizes are cv2's
    assert orb.level_sizes(400, 379)[1:4] == [(333, 316), (278, 263),
                                              (231, 219)]
    assert orb.level_quotas(2000) == [434, 362, 302, 251, 209, 175, 145, 122]


def test_blur_equals_cv2(frames):
    """ORB blurs each pyramid level in place, a sub-matrix with a
    non-isolated border, which takes cv2's float path: that of
    cv2.GaussianBlur on float input, or of sepFilter2D with the Gaussian
    taps (a whole uint8 image takes a fixed-point path instead)."""
    seq, crops = frames
    k = cv2.getGaussianKernel(7, 2)
    imgs = _textures() + [crops[0][0]]
    for img in imgs:
        ours = orb.gaussian_blur7(T(np.pad(img, 3, mode="reflect"))[None])[0]
        np.testing.assert_array_equal(
            ours.numpy(), cv2.sepFilter2D(img, -1, k, k,
                                          borderType=cv2.BORDER_REFLECT_101))
        ref = cv2.GaussianBlur(img.astype(np.float32), (7, 7), 2, sigmaY=2,
                               borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(ours.numpy(),
                                      np.rint(ref).astype(np.uint8))


def test_fast_equals_cv2(frames):
    _, crops = frames
    fd = cv2.FastFeatureDetector_create(5, True,
                                        cv2.FastFeatureDetector_TYPE_9_16)
    for img in _textures() + [c[0] for c in crops[:2]]:
        ref = {(int(k.pt[0]), int(k.pt[1])): k.response
               for k in fd.detect(img)}
        stack, _, sizes = orb.build_pyramid(T(img), n_levels=1)
        scores = orb.fast_scores(stack, sizes, 5)
        ys, xs = orb.fast_keypoints(scores)[0].nonzero(as_tuple=True)
        ours = {(int(x), int(y)): float(scores[0, y, x])
                for y, x in zip(ys, xs)}
        assert len(ref) > 500 and ours == ref


def test_fast_atan2_equals_cv2():
    rng = np.random.default_rng(2)
    y = (rng.normal(size=4000) * 10 ** rng.uniform(0, 4, 4000)).astype(
        np.float32)
    x = (rng.normal(size=4000) * 10 ** rng.uniform(0, 4, 4000)).astype(
        np.float32)
    y[:4], x[:4] = [0, 3, 0, -2], [0, 0, -5, 0]
    ref = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)])
    np.testing.assert_allclose(orb.fast_atan2(T(y), T(x)).numpy(), ref,
                               atol=1e-3, rtol=0)


def test_descriptors_equal_cv2_on_given_keypoints(frames):
    """cv2's own keypoints and angles (plus random angles) given to both
    `orb.compute` and the port's rBRIEF: the descriptors are equal."""
    _, crops = frames
    cv_orb = cv2.ORB_create(nfeatures=2000, fastThreshold=5)
    rng = np.random.default_rng(3)
    for img, mask, *_ in crops[:2]:
        kps = cv_orb.detect(img, mask)
        kps = list(kps) + [cv2.KeyPoint(k.pt[0], k.pt[1], k.size,
                                        float(rng.uniform(0, 360)),
                                        k.response, k.octave)
                           for k in kps[::4]]
        kps, des = cv_orb.compute(img, kps)
        stack, _, _ = orb.build_pyramid(T(img))
        H, W = img.shape
        B = orb.BORDER
        blurred = orb.gaussian_blur7(stack[:, B - 3:B + H + 3,
                                           B - 3:B + W + 3])
        lev = np.array([k.octave for k in kps])
        inv = np.float32(1) / np.array(orb.level_scales(), np.float32)[lev]
        pt = np.array([k.pt for k in kps], np.float32)
        xs = np.rint(pt[:, 0] * inv).astype(np.int64)
        ys = np.rint(pt[:, 1] * inv).astype(np.int64)
        angle = np.array([k.angle for k in kps], np.float32)
        ours = orb.rbrief(blurred, T(lev), T(ys), T(xs), T(angle)).numpy()
        assert len(kps) > 1500
        np.testing.assert_array_equal(ours, des)


def _key(octave, pt):
    return (int(octave), round(float(pt[0]), 3), round(float(pt[1]), 3))


def test_detector_close_to_cv2(frames):
    _, crops = frames
    cv_orb = cv2.ORB_create(nfeatures=2000, fastThreshold=5)
    for img, mask, *_ in crops:
        kps, des = cv_orb.detectAndCompute(img, mask)
        out = orb.detect_and_compute(T(img), T(mask))
        ours = {_key(o, p): i for i, (o, p) in enumerate(
            zip(out["octave"].numpy(), out["pt"].numpy()))}
        hit = [(i, ours[_key(k.octave, k.pt)]) for i, k in enumerate(kps)
               if _key(k.octave, k.pt) in ours]
        assert len(hit) >= 0.95 * len(kps) and len(kps) > 1500
        ri, oi = np.array(hit).T
        for i, j in hit[:200]:          # the 1e-3 px key is a true match
            assert np.abs(np.subtract(kps[i].pt,
                                      out["pt"][j].numpy())).max() <= 1e-3
        d_ang = np.array([kps[i].angle for i in ri]) - out["angle"].numpy()[oi]
        assert np.abs((d_ang + 180) % 360 - 180).max() <= 1.0
        bits = np.unpackbits(des[ri] ^ out["des"].numpy()[oi], axis=1)
        assert bits.sum(1).mean() <= 2.0


def _frame(seq, i):
    return SimpleNamespace(id=i, id_str=seq["id_strs"][i],
                           color=seq["colors"][i],
                           fg_mask=(seq["masks"][i] > 0).astype(np.uint8))


def test_matches_overlap_cv2s(frames):
    seq, _ = frames
    fr = [_frame(seq, i) for i in range(len(seq["colors"]))]
    pairs = [(fr[1], fr[0]), (fr[3], fr[2]), (fr[5], fr[0]), (fr[4], fr[1])]
    ours = OrbMatcher(device="cpu").match_frames(pairs)
    ref = OrbMatcher(device="cpu", detector=cv2_detector).match_frames(pairs)
    for a, b in zip(ours, ref):
        sa = {tuple(np.round(r[:4], 3)) for r in a}
        sb = {tuple(np.round(r[:4], 3)) for r in b}
        assert len(sb) > 50
        assert len(sa & sb) >= 0.9 * max(len(sa), len(sb)), (len(sa),
                                                              len(sb))


def test_short_tracker_run_against_jax(tmp_path):
    """10 frames of the orbit at 120x160, tracker only, fused matcher: the
    port detecting with its own ORB, JAX with cv2."""
    from bundlesdf_tpu.bundlesdf import BundleSdf as JaxBundleSdf
    from bundlesdf_tpu.config import default_nerf_config
    from bundlesdf_tpu_torch.benchmark_synthetic import gt_surface_points
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.eval.metrics import add_err

    n = 10
    seq = cube_orbit_sequence(n_frames=n, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.45)
    model = gt_surface_points(4000)
    gt = np.linalg.inv(seq["cam_in_obs"])
    adds = {}
    for name, cls, kw in (("jax", JaxBundleSdf,
                           {"cfg_nerf": default_nerf_config()}),
                          ("port", BundleSdf, {"device": "cpu"})):
        cfg = default_track_config()
        cfg.update(debug_dir=str(tmp_path / name), SPDLOG=0)
        cfg["ransac"]["max_trans_neighbor"] = 0.05
        cfg["ransac"]["max_iter"] = 500
        cfg["bundle"]["max_BA_frames"] = 5
        cfg["bundle"]["depth_association_radius"] = 2
        cfg["feature_corres"]["fused_matcher"] = True
        t = cls(cfg_track=cfg, start_nerf_keyframes=10 ** 9, **kw)
        if name == "port":
            assert t.matcher.detector is None     # the port's own ORB
        frames_ = [t.run(seq["colors"][i], seq["depths"][i].copy(),
                         seq["K"], seq["id_strs"][i], mask=seq["masks"][i])
                   for i in range(n)]
        t.flush_pipeline()
        assert all(f.status.name != "FAIL" for f in frames_), name
        pred = np.linalg.inv(np.array([f.pose_in_model for f in frames_]))
        pred = pred @ np.linalg.inv(pred[0]) @ gt[0]
        adds[name] = np.mean([add_err(p, g, model)
                              for p, g in zip(pred, gt)])
    assert adds["port"] <= max(2 * adds["jax"], adds["jax"] + 1e-3), adds


def _cv2_whole(frame):
    """cv2's ORB on a whole image, as the JAX `OrbMatcher.predict`
    detects: (uv, des) for `OrbMatcher(detector=...)`."""
    img = np.asarray(frame.color)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
    kps, des = cv2.ORB_create(nfeatures=2000,
                              fastThreshold=5).detectAndCompute(gray, None)
    if des is None:
        return np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8)
    return np.array([k.pt for k in kps], np.float32).reshape(-1, 2), des


@pytest.fixture(scope="module")
def predict_pairs():
    """(A images, B images): four 120x160 RGB orbit pairs, then two pairs
    canonicalized to 400x400 grey as `find_corres`'s predict branch does
    (numpy lists; the canonical crops also as (2,400,400) tensors)."""
    from bundlesdf_tpu_torch.matcher.pairing import process_image_pairs
    seq = cube_orbit_sequence(n_frames=6, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=2 * np.pi * 6 / 120,
                              noise=0.002, seed=0)
    fr = [SimpleNamespace(id=i, color=seq["colors"][i], H=120, W=160,
                          fg_mask=seq["masks"][i],
                          pose_in_model=seq["cam_in_obs"][i])
          for i in range(6)]
    cA, cB, _ = process_image_pairs([(fr[4], fr[0]), (fr[5], fr[2])], 400,
                                    "cpu")
    A = [seq["colors"][i] for i in (1, 3, 5, 4)] + list(cA.numpy())
    B = [seq["colors"][i] for i in (0, 2, 0, 1)] + list(cB.numpy())
    return A, B, (cA, cB)


def _rows(out):
    return [{tuple(np.round(r[:4], 3)) for r in o} for o in out]


@pytest.mark.parametrize("min_strict", [0, 5, 40])
def test_predict_equals_jax_on_cv2_keypoints(predict_pairs, min_strict):
    from bundlesdf_tpu.matcher.classical import OrbMatcher as JaxOrbMatcher
    A, B, _ = predict_pairs
    ref = JaxOrbMatcher(min_strict=min_strict).predict(A, B)
    got = OrbMatcher(device="cpu", detector=_cv2_whole,
                     min_strict=min_strict).predict(A, B)
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape[1] == 5 and len(b) > 20
        np.testing.assert_array_equal(np.round(a[:, :4], 3),
                                      np.round(b[:, :4], 3))
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-6)
    if min_strict == 40:      # the loose ratio took over on some pair
        strict = JaxOrbMatcher().predict(A, B)
        assert any(len(a) > len(s) for a, s in zip(got, strict))


def test_predict_own_orb_overlaps_jax(predict_pairs):
    from bundlesdf_tpu.matcher.classical import OrbMatcher as JaxOrbMatcher
    A, B, _ = predict_pairs
    ours = _rows(OrbMatcher(device="cpu").predict(A, B))
    ref = _rows(JaxOrbMatcher().predict(A, B))
    for sa, sb in zip(ours, ref):
        assert len(sb) > 20
        assert len(sa & sb) >= 0.9 * max(len(sa), len(sb)), (len(sa),
                                                              len(sb))


def test_predict_edge_cases_and_inputs(predict_pairs):
    from bundlesdf_tpu.matcher.classical import OrbMatcher as JaxOrbMatcher
    A, B, (cA, cB) = predict_pairs
    m = OrbMatcher(device="cpu")
    assert m.predict([], []) == []
    flat = np.full((120, 160, 3), 90, np.uint8)         # no keypoint
    out = m.predict([flat, A[0]], [B[0], flat])
    assert [o.shape for o in out] == [(0, 5), (0, 5)]
    assert all(o.dtype == np.float32 for o in out)
    assert [len(o) for o in JaxOrbMatcher().predict([flat], [B[0]])] == [0]

    def one_keypoint(frame):
        uv, des = _cv2_whole(frame)
        return uv[:1], des[:1]
    one = OrbMatcher(device="cpu", detector=one_keypoint).predict(A[:1],
                                                                  B[:1])
    assert one[0].shape == (0, 5)
    kp, des = cv2.ORB_create(2000, fastThreshold=5).detectAndCompute(
        cv2.cvtColor(A[0], cv2.COLOR_RGB2GRAY), None)
    kB, dB = cv2.ORB_create(2000, fastThreshold=5).detectAndCompute(
        cv2.cvtColor(B[0], cv2.COLOR_RGB2GRAY), None)
    assert JaxOrbMatcher()._match_feats(kp[:1], des[:1], kB, dB).shape \
        == (0, 5)
    # a (B,H,W) grey tensor, a list of RGB tensors: as the numpy lists
    for got, ref in ((m.predict(cA, cB), m.predict(A[4:], B[4:])),
                     (m.predict([torch.from_numpy(a) for a in A[:2]],
                                [torch.from_numpy(b) for b in B[:2]]),
                      m.predict(A[:2], B[:2]))):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert len(a) > 20
            np.testing.assert_array_equal(a, b)
