"""The port's pair canonicalization (`bundlesdf_tpu_torch/matcher/pairing.py`)
held against the JAX package's (`bundlesdf_tpu/matcher/pairing.py`, which
calls cv2.Rodrigues, cv2.cvtColor and cv2.warpPerspective):

- the 3x3 transforms equal JAX's within 1e-9 for in-plane rotations up to
  170 degrees and for general relative rotations;
- `so3_log_np` equals cv2.Rodrigues, its sign included, up to pi;
- the torch warp against cv2.warpPerspective (INTER_LINEAR, border 0):
  at most 1 grey level on every pixel, the exact share printed;
- the batched `process_image_pairs` equals pair-by-pair calls;
- `mask_roi` equals JAX's (the bounds of the foreground pixels' list) on
  random masks, an empty mask and with a pad;
- `map_matches_back` round-trips and equals JAX's.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bundlesdf_tpu.matcher import pairing as jp
from bundlesdf_tpu_torch.matcher import pairing as tp
from bundlesdf_tpu_torch.utils.se3 import so3_log_np

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return cv2.Rodrigues(axis * np.deg2rad(deg))[0]


def _pose(R, t=(0.0, 0.0, 0.5)):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _image(seed, H=240, W=320):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.0) if seed % 2 else img


def _mask(H, W, v0, v1, u0, u1):
    m = np.zeros((H, W), np.uint8)
    m[v0:v1, u0:u1] = 1
    return m


ANGLES = [0.0, 5.0, -30.0, 90.0, 135.0, -150.0, 170.0, -170.0]


@pytest.mark.parametrize("deg", ANGLES)
def test_transforms_equal_jax(deg):
    rng = np.random.default_rng(int(abs(deg)))
    poseA = _pose(_rot(rng.normal(size=3), rng.uniform(0, 60)))
    # B = A rotated about the camera z axis by @deg, plus a small tilt
    Rz = _rot([0, 0, 1], deg) @ _rot(rng.normal(size=3), 3.0)
    poseB = _pose((Rz @ poseA[:3, :3].T).T)
    img = _image(1)
    roiA = tp.mask_roi(_mask(240, 320, 40, 200, 60, 280))
    roiB = tp.mask_roi(_mask(240, 320, 70, 190, 100, 230))
    np.testing.assert_array_equal(
        roiA, jp.mask_roi(_mask(240, 320, 40, 200, 60, 280)))
    for out_size in (64, 400):
        tfA, tfB = tp.pair_transforms(240, 320, roiA, roiB, poseA, poseB,
                                      out_size)
        *_, jA, jB = jp.process_image_pair(img, img, roiA, roiB, poseA,
                                           poseB, out_size=out_size)
        np.testing.assert_allclose(tfA, jA, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tfB, jB, rtol=0, atol=1e-9)


@pytest.mark.parametrize("deg", [1e-4, 10.0, 90.0, 170.0, 179.9, 179.999,
                                 180.0, -179.999, -90.0])
def test_so3_log_np_equals_rodrigues(deg):
    # at pi the axis comes from square roots of diagonal entries that are
    # 0 up to rounding, where the two SVD projections differ by ~1e-16
    atol = 1e-6 if abs(deg) == 180.0 else 1e-9
    for axis in ([0, 0, 1], [0.3, -0.2, 0.9], [1, 0, 0], [0.2, 0.9, -0.3]):
        R = _rot(axis, deg)
        want = cv2.Rodrigues(R)[0][:, 0]
        got = so3_log_np(R)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert np.sign(got[2]) == np.sign(want[2]) or abs(want[2]) < 1e-12


def test_warp_against_cv2():
    """Every pixel within 1 grey level of cv2.warpPerspective on random
    affine and projective maps, on textures and white noise."""
    rng = np.random.default_rng(0)
    src = np.stack([cv2.cvtColor(_image(s, 120, 160), cv2.COLOR_RGB2GRAY)
                    for s in range(4)])
    mats, want, index = [], [], []
    for k in range(30):
        c, s = np.cos(rng.uniform(-3, 3)), np.sin(rng.uniform(-3, 3))
        sc = rng.uniform(0.5, 2.5)
        tf = np.array([[sc * c, -sc * s, rng.uniform(-150, 150)],
                       [sc * s, sc * c, rng.uniform(-150, 150)], [0, 0, 1]])
        if k % 3 == 2:  # a mild perspective row
            tf[2, :2] = rng.uniform(-4e-4, 4e-4, 2)
        i = k % 4
        want.append(cv2.warpPerspective(src[i], tf.astype(np.float32),
                                        (96, 96)))
        mats.append(tp.warp_matrix(tf))
        index.append(i)
    got = tp.warp_perspective(torch.from_numpy(src), torch.tensor(index),
                              torch.from_numpy(np.stack(mats)), 96).numpy()
    d = np.abs(got.astype(int) - np.stack(want).astype(int))
    print(f"warp vs cv2: {(d == 0).mean() * 100:.4f} % of pixels equal, "
          f"max {d.max()}")
    assert d.max() <= 1


@pytest.mark.parametrize("deg", [0.0, 30.0, 135.0, -170.0])
def test_crops_against_jax(deg):
    """process_image_pair's grey crops against the JAX package's (cv2's
    cvtColor and warpPerspective) at the pipeline's 400 px."""
    img = _image(int(deg) % 7, 480, 640)
    roiA = tp.mask_roi(_mask(480, 640, 100, 380, 150, 500))
    roiB = tp.mask_roi(_mask(480, 640, 130, 360, 200, 470))
    poseA = _pose(np.eye(3))
    poseB = _pose(_rot([0, 0, 1], deg).T)
    gA, gB, tfA, tfB = tp.process_image_pair(img, img[::-1, ::-1].copy(),
                                             roiA, roiB, poseA, poseB)
    jA, jB, jtA, jtB = jp.process_image_pair(img, img[::-1, ::-1].copy(),
                                             roiA, roiB, poseA, poseB)
    np.testing.assert_allclose(tfB, jtB, rtol=0, atol=1e-9)
    d = np.abs(np.stack([gA, gB]).astype(int)
               - np.stack([jA, jB]).astype(int))
    print(f"{deg} deg: crops {(d == 0).mean() * 100:.4f} % equal, "
          f"max {d.max()}")
    assert d.max() <= 1


def _frame(i, color, mask, pose):
    H, W = mask.shape
    return SimpleNamespace(id=i, color=color, fg_mask=mask, H=H, W=W,
                           pose_in_model=pose)


def test_batched_pairs_equal_single_calls():
    frames = [_frame(i, _image(i, 120, 160),
                     _mask(120, 160, 10 + 5 * i, 100, 20, 140 - 7 * i),
                     _pose(_rot([0.1, 0.2, 1], 25.0 * i)))
              for i in range(4)]
    pairs = [(frames[3], frames[2]), (frames[3], frames[0]),
             (frames[1], frames[0])]
    cA, cB, tfs = tp.process_image_pairs(pairs, 64)
    assert cA.shape == cB.shape == (3, 64, 64) and cA.dtype == torch.uint8
    for k, (fA, fB) in enumerate(pairs):
        gA, gB, tfA, tfB = tp.process_image_pair(
            fA.color, fB.color, tp.mask_roi(fA.fg_mask),
            tp.mask_roi(fB.fg_mask), fA.pose_in_model, fB.pose_in_model,
            out_size=64)
        np.testing.assert_array_equal(cA[k].numpy(), gA)
        np.testing.assert_array_equal(cB[k].numpy(), gB)
        np.testing.assert_array_equal(tfs[k][0], tfA)
        np.testing.assert_array_equal(tfs[k][1], tfB)


def test_map_matches_back_roundtrip():
    rng = np.random.default_rng(0)
    roi = tp.mask_roi(_mask(120, 160, 30, 90, 40, 120))
    tfA, tfB = tp.pair_transforms(120, 160, roi, roi, _pose(np.eye(3)),
                                  _pose(_rot([0, 0, 1], 30.0)), 200)
    uv = np.concatenate([rng.uniform(0, 200, (50, 4)),
                         rng.uniform(0, 1, (50, 1))], -1).astype(np.float32)
    back = tp.map_matches_back(uv, tfA, tfB)
    np.testing.assert_array_equal(back, jp.map_matches_back(uv, tfA, tfB))
    fwdA = (tfA @ np.c_[back[:, :2], np.ones(50)].T).T
    fwdB = (tfB @ np.c_[back[:, 2:4], np.ones(50)].T).T
    np.testing.assert_allclose(fwdA[:, :2], uv[:, :2], atol=1e-9)
    np.testing.assert_allclose(fwdB[:, :2], uv[:, 2:4], atol=1e-9)
    np.testing.assert_array_equal(back[:, 4], uv[:, 4])
    assert len(tp.map_matches_back(np.zeros((0, 5)), tfA, tfB)) == 0


@pytest.mark.parametrize("seed", range(4))
def test_mask_roi_equals_jax(seed):
    rng = np.random.default_rng(seed)
    H, W = 48, 64
    masks = [np.zeros((H, W), np.uint8), rng.random((H, W)) > 0.97]
    m = np.zeros((H, W), np.uint8)
    m[rng.integers(0, H // 2):rng.integers(H // 2 + 1, H),
      rng.integers(0, W // 2):rng.integers(W // 2 + 1, W)] = 255
    masks.append(m)
    for mask in masks:
        for pad in (0, 3, 70):
            got, want = tp.mask_roi(mask, pad), jp.mask_roi(mask, pad)
            np.testing.assert_array_equal(got, want)
