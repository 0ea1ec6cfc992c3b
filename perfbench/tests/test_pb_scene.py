"""The benchmark's torch renderer against the repository's numpy fixture,
and its erosion against run_custom's."""
import importlib.util
import os

import numpy as np
from scipy import ndimage

from perfbench import harness, scene


def _fixture():
    path = os.path.join(harness.REPO, "tests", "synthetic.py")
    spec = importlib.util.spec_from_file_location("fixture_synthetic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_render_equals_numpy_fixture_120x160():
    syn = _fixture()
    K = scene.intrinsics(120, 160)
    poses = scene.orbit_poses(4, 0.7, 0.4, 0.45, -0.12)
    box_list = scene.boxes(0.10, ((210, 50, 70), (40, 220, 90),
                                  (70, 60, 230)))
    color, depth, mask = scene.render(poses, K, 120, 160, box_list, "cpu")
    for i, pose in enumerate(poses):
        c, d, m = syn.render_boxes_depth(
            pose, K, 120, 160, [(np.array(a), np.array(b), col)
                                for a, b, col in box_list])
        assert np.array_equal(color[i].numpy(), c)
        assert np.array_equal(depth[i].numpy(), d)
        assert np.array_equal(mask[i].numpy(), m)


def test_orbit_matches_fixture_poses():
    syn = _fixture()
    seq_poses = [syn.look_at(np.array([0.45 * np.sin(a), -0.12,
                                       0.45 * np.cos(a)]), (0, 0, 0))
                 for a in (0.7, 1.1)]
    ours = scene.orbit_poses(2, 0.7, 0.4, 0.45, -0.12)
    np.testing.assert_allclose(ours, np.stack(seq_poses), atol=1e-15)


def test_erode_equals_run_custom():
    rng = np.random.default_rng(0)
    m = (rng.random((3, 30, 40)) > 0.3).astype(np.uint8)
    import torch
    got = scene.erode(torch.as_tensor(m), 3).numpy()
    ref = np.stack([ndimage.minimum_filter(x, size=(3, 3), mode="constant",
                                           cval=255) for x in m])
    assert np.array_equal(got, ref)


def test_seed_moves_the_scene_not_its_sizes():
    p = {"H": 24, "W": 32, "radius": 0.45, "height_range": [-0.16, -0.08],
         "obj_size": 0.10, "color_jitter": 30, "depth_noise_m": 0.002,
         "step_rad": 0.1}
    a = scene.seeded_scene(2 ** 31 + 5, p, 3, "cpu")
    b = scene.seeded_scene(2 ** 31 + 5, p, 3, "cpu")
    c = scene.seeded_scene(2 ** 31 + 6, p, 3, "cpu")
    for k in ("colors", "depths", "masks"):
        assert np.array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert a["angle0"] != c["angle0"]
