"""The port's cv2-free drawing (`bundlesdf_tpu_torch/utils/viz.py`) held
against cv2:

- `draw_line` at thickness 1, 2 and 3 is pixel-equal to cv2.line (LINE_8)
  on random segments, inside the image and leaving it;
- `draw_posed_3d_box` is pixel-equal to the JAX package's (cv2) on random
  poses, and so `run_custom --mode draw_pose` draws what JAX draws;
- the anti-aliased arrows of `draw_xyz_axis` approximate cv2.arrowedLine's
  LINE_AA: over the pixels either draws, the mean |difference| is at most
  16 of 255 and at most 25 % of them differ by more than 64;
- `Bundler.viz_corres_between` writes the match lines cv2 would draw, as
  an RGB PNG.
"""
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from bundlesdf_tpu.utils import viz as jviz
from bundlesdf_tpu_torch.tracker.bundler import Bundler
from bundlesdf_tpu_torch.utils import viz
from bundlesdf_tpu_torch.utils.png import read_png


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_lines_equal_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for t in range(300):
        img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        lo, hi = (-40, 120) if t % 2 else (0, 60)
        p0 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        ref = cv2.line(img.copy(), p0, p1, color, thickness)
        ours = viz.draw_line(img.copy(), p0, p1, color, thickness)
        np.testing.assert_array_equal(ours, ref, err_msg=f"{p0} {p1}")


def _pose(rng):
    a = rng.normal(size=3)
    R = cv2.Rodrigues(a)[0]
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                rng.uniform(0.3, 0.6)]
    return T


def test_posed_box_equals_jax():
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    bbox = np.array([[-0.05, -0.04, -0.03], [0.05, 0.04, 0.03]])
    for _ in range(20):
        img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        T = _pose(rng)
        ours = viz.draw_posed_3d_box(K, img, T, bbox, line_color=(255, 255, 0))
        ref = jviz.draw_posed_3d_box(K, img, T, bbox, line_color=(255, 255, 0))
        np.testing.assert_array_equal(ours, ref)


def test_xyz_axis_arrows_close_to_cv2():
    rng = np.random.default_rng(1)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    for _ in range(10):
        img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        T = _pose(rng)
        ours = viz.draw_xyz_axis(img, T, K)
        ref = jviz.draw_xyz_axis(img, T, K)
        drawn = (ours != img).any(-1) | (ref != img).any(-1)
        assert drawn.sum() > 100
        d = np.abs(ours.astype(int) - ref.astype(int)).max(-1)[drawn]
        assert d.mean() <= 16, d.mean()
        assert (d > 64).mean() <= 0.25, (d > 64).mean()


def test_viz_corres_between_draws_cv2_lines(tmp_path):
    rng = np.random.default_rng(2)
    H, W = 40, 50
    fA = SimpleNamespace(id=0, id_str="0000", W=W,
                         color=rng.integers(0, 256, (H, W, 3), np.uint8))
    fB = SimpleNamespace(id=1, id_str="0001", W=W,
                         color=rng.integers(0, 256, (H, W, 3), np.uint8))
    uvA = rng.uniform(0, [W, H], (12, 2)).astype(np.float32)
    uvB = rng.uniform(0, [W, H], (12, 2)).astype(np.float32)
    fake = SimpleNamespace(cfg={"SPDLOG": 3, "debug_dir": str(tmp_path)},
                           matches={(0, 1): {"uvA": uvA, "uvB": uvB}})
    Bundler.viz_corres_between(fake, fA, fB, "after_ransac")
    got = read_png(str(tmp_path / "0000" / "corres_0000_0001_after_ransac.png"))
    want = np.concatenate([fA.color, fB.color], axis=1).copy()
    seeds = (uvA[:, 0].astype(np.int64) * 7919 + uvA[:, 1].astype(np.int64))
    colors = np.stack([(seeds * p) % 195 + 60
                       for p in (2654435761, 805459861, 40503)], -1)
    for (uA, vA), (uB, vB), c in zip(uvA, uvB, colors):
        cv2.line(want, (int(uA), int(vA)), (int(uB) + W, int(vB)),
                 tuple(int(x) for x in c), 1)
    np.testing.assert_array_equal(got, want)
