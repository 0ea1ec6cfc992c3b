"""Port parity for the matchers: `orb_match_core` (batched mutual ratio
test over hamming distances) against the JAX package on integer inputs
with ties and with fewer than 2 features — best index, accept mask and
distance identical — then `GtMatcher` on a tiny sequence and the matcher's
per-frame cache against the JAX matcher's, both fed cv2's features (the
port's own detector is held against cv2 in test_torch_orb.py), and the ORB
fixture the GPU smoke run replays against a fresh cv2 detection."""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.config import default_track_config as jax_track_config
from bundlesdf_tpu.matcher.classical import orb_match_core as jax_core
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher, orb_match_core

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tracker_orb_30f.npz")


def _bits_case(P=4, F=96, nbits=256, seed=0):
    """+/-1 bits with planted near-duplicates (distance ties)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 2, (P, F, nbits)).astype(np.int8) * 2 - 1
    B = rng.integers(0, 2, (P, F, nbits)).astype(np.int8) * 2 - 1
    for p in range(P):
        for k in range(F // 2):
            row = A[p, k].copy()
            flip = rng.choice(nbits, rng.integers(0, 40), replace=False)
            row[flip] *= -1
            B[p, k] = row
            if k % 4 == 0:
                # a second candidate at the same distance -> a tie
                B[p, F // 2 + k // 4] = row
    return A, B


@pytest.mark.parametrize("min_strict", [0, 30])
def test_orb_match_core_matches_jax(min_strict):
    A, B = _bits_case()
    nA = np.array([96, 60, 1, 0], np.int32)    # pair 2, 3: < 2 features
    nB = np.array([96, 80, 50, 96], np.int32)
    rj = jax_core(jnp.asarray(A), jnp.asarray(B), jnp.asarray(nA),
                  jnp.asarray(nB), 0.75, 256, 0.85, min_strict)
    rt = orb_match_core(torch.from_numpy(A), torch.from_numpy(B),
                        torch.from_numpy(nA), torch.from_numpy(nB), 0.75, 256,
                        0.85, min_strict)
    ok_j = np.asarray(rj["ok"])
    np.testing.assert_array_equal(rt["ok"].numpy(), ok_j)
    np.testing.assert_array_equal(rt["j"].numpy(), np.asarray(rj["j"]))
    np.testing.assert_array_equal(rt["dist"].numpy(),
                                  np.asarray(rj["dist"], np.float32))
    assert ok_j[0].sum() > 5 and not ok_j[2:].any()


def _port_frames(seq, cfg):
    from bundlesdf_tpu_torch.tracker.frame import Frame
    return [Frame(seq["colors"][i], seq["depths"][i], seq["K"], i,
                  seq["id_strs"][i], cfg, mask=seq["masks"][i], device="cpu")
            for i in range(len(seq["colors"]))]


def test_gt_matcher_matches_jax():
    from orb_cv2 import cv2_keypoints

    from bundlesdf_tpu.matcher.gt import GtMatcher as JaxGt
    from bundlesdf_tpu.tracker.frame import Frame as JaxFrame
    from bundlesdf_tpu_torch.matcher.gt import GtMatcher

    seq = cube_orbit_sequence(n_frames=3, H=120, W=160, full_angle=0.3)
    gt = {s: seq["cam_in_obs"][i] for i, s in enumerate(seq["id_strs"])}
    fj = [JaxFrame(seq["colors"][i], seq["depths"][i], seq["K"], i,
                   seq["id_strs"][i], jax_track_config(), mask=seq["masks"][i])
          for i in range(3)]
    ft = _port_frames(seq, default_track_config())
    pairs = [(1, 0), (2, 0), (2, 1)]
    oj = JaxGt(gt).match_frames([(fj[a], fj[b]) for a, b in pairs])
    ot = GtMatcher(gt, device="cpu",
                   detector=lambda f: cv2_keypoints(f.color)).match_frames(
        [(ft[a], ft[b]) for a, b in pairs])
    for a, b in zip(oj, ot):
        assert len(a) >= 10
        np.testing.assert_array_equal(a, b)


def test_orb_detection_matches_jax():
    from orb_cv2 import detect_cv2

    from bundlesdf_tpu.matcher.classical import OrbMatcher as JaxOrb

    seq = cube_orbit_sequence(n_frames=2, H=120, W=160, full_angle=0.3)
    fr = SimpleNamespace(id=0, color=seq["colors"][1],
                         fg_mask=seq["masks"][1].astype(np.uint8))
    uv_j, des_j, bits_j, uvp_j = JaxOrb(feat_cap=256)._frame_feats(fr)
    orb = OrbMatcher(feat_cap=256, device="cpu",
                     detector=lambda f: detect_cv2(f.color, f.fg_mask,
                                                   feat_cap=256))
    uv_t, des_t, bits_t, uvp_t = [t.numpy() for t in orb._frame_feats(fr)]
    np.testing.assert_array_equal(uv_t, np.asarray(uv_j, np.float32))
    np.testing.assert_array_equal(des_t, des_j)
    np.testing.assert_array_equal(bits_t, np.asarray(bits_j))
    np.testing.assert_array_equal(uvp_t, np.asarray(uvp_j))
    # the detector hook replaces detection and nothing else
    hooked = OrbMatcher(feat_cap=256, device="cpu",
                        detector=lambda f: (uv_t, des_t))
    np.testing.assert_array_equal(hooked._frame_feats(fr)[2].numpy(),
                                  bits_t)


def test_orb_fixture_is_current(tmp_path):
    """Each committed ORB fixture equals a fresh cv2 detection of its first two
    frames (regenerate with tests/fixtures/gen_tracker_orb.py --sequence
    orbit30|easy120): the 30-frame orbit of the GPU smoke run and the
    120-frame easy run of benchmark_synthetic, whose frames go through a
    dataset folder and the driver's mask erosion first."""
    pytest.importorskip("cv2", reason="re-detection needs cv2")
    from fixtures.gen_tracker_orb import OUTS, detect_all, tracker_inputs

    frames = {"orbit30": 30, "easy120": 120}
    for name, n_frames in frames.items():
        fx = np.load(os.path.join(os.path.dirname(FIXTURE), OUTS[name]))
        counts = fx["counts"]
        assert len(counts) == n_frames and counts.min() > 1500, name
        assert counts.max() <= OrbMatcher.FEAT_CAP
        _, colors, masks = tracker_inputs(name, 2, str(tmp_path / name))
        off = 0
        for k, (uv, des) in enumerate(detect_all(colors, masks)):
            n = counts[k]
            np.testing.assert_array_equal(uv, fx["uv"][off:off + n],
                                          err_msg=name)
            np.testing.assert_array_equal(des, fx["des"][off:off + n],
                                          err_msg=name)
            off += n
        assert fx["jax_cam_in_ob"].shape == (n_frames, 4, 4)
        # no FAIL frame in the JAX run
        assert (fx["jax_status"] != 0).all(), name
