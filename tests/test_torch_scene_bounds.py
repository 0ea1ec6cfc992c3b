"""Port parity for `scene/bounds.py`: the port's own DBSCAN gives sklearn's
labels (the JAX package's `find_biggest_cluster` runs sklearn), exactly, on
clouds with several clusters, noise, border points and ties; the scene
bounds of orbit frames equal the JAX package's (sc_factor and translation
within 1e-12, identical clouds)."""
import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.scene import bounds as jb
from bundlesdf_tpu_torch.scene import bounds as tb
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM


def _cloud(seed):
    """A few Gaussian blobs of different sizes plus uniform noise."""
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(rng.uniform(-0.5, 0.5, 3), rng.uniform(0.01, 0.05),
                        (int(rng.integers(5, 150)), 3))
             for _ in range(int(rng.integers(1, 5)))]
    noise = rng.uniform(-0.6, 0.6, (int(rng.integers(0, 60)), 3))
    pts = np.concatenate(blobs + [noise])
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("min_samples", [1, 3, 10])
@pytest.mark.parametrize("eps", [0.03, 0.06])
def test_dbscan_labels_equal_sklearn(min_samples, eps):
    for seed in range(12):
        pts = _cloud(seed)
        ref = DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_
        np.testing.assert_array_equal(tb.dbscan_labels(pts, eps, min_samples),
                                      ref, err_msg=f"seed {seed}")


def test_dbscan_border_point_takes_lowest_cluster():
    """A border point between two clusters goes to the cluster sklearn's
    scan reaches first (the lower label), not to its nearest or
    lowest-index core neighbour; lone points are noise."""
    a = np.array([[0, 0, 0], [0.05, 0, 0], [0.1, 0, 0]])
    b = np.array([[0.3, 0, 0], [0.35, 0, 0], [0.4, 0, 0]])
    border = np.array([[0.2, 0, 0]])
    lone = np.array([[1.0, 1.0, 1.0]])
    # b's points come first, so b is cluster 0; the border point sits
    # within eps of a core point of each cluster
    pts = np.concatenate([b, lone, border, a])
    for eps in (0.1001, 0.12):
        ref = DBSCAN(eps=eps, min_samples=3).fit(pts).labels_
        got = tb.dbscan_labels(pts, eps, 3)
        np.testing.assert_array_equal(got, ref)
        assert got[3] == -1 and got[4] >= 0


@pytest.mark.parametrize("min_samples", [1, 3, 10])
def test_find_biggest_cluster_equals_jax(min_samples):
    for seed in range(8):
        pts = _cloud(100 + seed)
        # a tie: two equal blobs far apart -> the lower label wins
        if seed == 0:
            rng = np.random.default_rng(seed)
            blob = rng.normal(0, 0.01, (20, 3))
            pts = np.concatenate([blob + 0.5, blob - 0.5])
        pj, kj = jb.find_biggest_cluster(pts, eps=0.06,
                                         min_samples=min_samples)
        pt, kt = tb.find_biggest_cluster(pts, eps=0.06,
                                         min_samples=min_samples)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(pt, pj)


def test_noise_as_biggest_group_equals_jax():
    """Scattered points with a high min_samples: noise (-1) is the largest
    group, and both packages keep it."""
    pts = np.random.default_rng(7).uniform(-1, 1, (200, 3))
    pj, kj = jb.find_biggest_cluster(pts, eps=0.06, min_samples=10)
    pt, kt = tb.find_biggest_cluster(pts, eps=0.06, min_samples=10)
    assert kt.all()
    np.testing.assert_array_equal(kt, kj)


@pytest.fixture(scope="module")
def orbit():
    seq = cube_orbit_sequence(n_frames=4, H=120, W=160, radius=0.45,
                              obj_size=0.08)
    return seq, seq["cam_in_obs"] @ GLCAM_IN_CVCAM


def test_compute_scene_bounds_equals_jax(orbit):
    seq, gl = orbit
    args = (seq["colors"], seq["depths"], seq["masks"], gl, seq["K"])
    sj, tj, rj, nj = jb.compute_scene_bounds(*args, use_mask=True)
    st, tt, rt, nt = tb.compute_scene_bounds(*args, use_mask=True)
    assert abs(st - sj) <= 1e-12 * abs(sj)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(nt, nj)
    # the given-normalization branch
    kw = dict(use_mask=True, translation_cvcam=tj, sc_factor=sj)
    for a, b in zip(jb.compute_scene_bounds(*args, **kw),
                    tb.compute_scene_bounds(*args, **kw)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_compute_scene_bounds_frame_equals_jax(orbit):
    seq, gl = orbit
    for i in range(len(gl)):
        a = jb.compute_scene_bounds_frame(seq["depths"][i], seq["masks"][i],
                                          gl[i], seq["K"])
        b = tb.compute_scene_bounds_frame(seq["depths"][i], seq["masks"][i],
                                          gl[i], seq["K"])
        np.testing.assert_array_equal(b, a)
    assert tb.compute_scene_bounds_frame(
        np.zeros_like(seq["depths"][0]), None, gl[0], seq["K"]) is None
