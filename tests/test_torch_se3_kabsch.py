"""Port parity for the SE(3) functions the tracker adds to
`bundlesdf_tpu_torch/utils/se3.py`: `so3_log`, `se3_log`,
`geodesic_distance`, `rot_geodesic_ignore_cam_z` against the JAX package
within 1e-5, and the exact weighted `kabsch` (SVD with the reflection fix)
against the numpy Horn solve `kabsch_np` within 1e-5 — not against the JAX
power-iteration `kabsch`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.utils import se3 as js
from bundlesdf_tpu_torch.utils import se3 as ts

torch.set_num_threads(2)
TOL = 1e-5


def _poses(n, seed, max_angle=2.5):
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = axis * rng.uniform(0.0, max_angle, (n, 1))
    tau = np.concatenate([rng.uniform(-0.3, 0.3, (n, 3)), w], 1)
    return ts.se3_exp_np(tau).astype(np.float32)


def test_logs_match_jax():
    T = _poses(32, 0)
    wj = np.asarray(js.so3_log(jnp.asarray(T[:, :3, :3])))
    wt = ts.so3_log(torch.from_numpy(T[:, :3, :3])).numpy()
    np.testing.assert_allclose(wt, wj, atol=TOL)
    lj = np.asarray(js.se3_log(jnp.asarray(T)))
    lt = ts.se3_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(lt, lj, atol=TOL)
    # round trip through the port's exp
    np.testing.assert_allclose(ts.se3_exp(torch.from_numpy(lt)).numpy(), T,
                               atol=TOL)


def test_geodesics_match_jax():
    A, B = _poses(16, 1), _poses(16, 2)
    for a, b in zip(A, B):
        Ra, Rb = a[:3, :3], b[:3, :3]
        gj = float(js.geodesic_distance(jnp.asarray(Ra), jnp.asarray(Rb)))
        gt = float(ts.geodesic_distance(torch.from_numpy(Ra),
                                        torch.from_numpy(Rb)))
        assert abs(gj - gt) < TOL
        assert abs(float(ts.geodesic_distance(Ra.astype(np.float64),
                                              Rb.astype(np.float64)))
                   - gj) < TOL
        zj = float(js.rot_geodesic_ignore_cam_z(jnp.asarray(Ra),
                                                jnp.asarray(Rb)))
        zt = float(ts.rot_geodesic_ignore_cam_z(torch.from_numpy(Ra),
                                                torch.from_numpy(Rb)))
        assert abs(zj - zt) < TOL
        assert abs(ts.rot_geodesic_ignore_cam_z_np(Ra, Rb)
                   - js.rot_geodesic_ignore_cam_z_np(Ra, Rb)) < 1e-12
    # a pure camera-Z roll is distance 0 in both
    c, s = np.cos(0.4), np.sin(0.4)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    eye = np.eye(3, dtype=np.float32)
    assert float(ts.rot_geodesic_ignore_cam_z(torch.from_numpy(eye),
                                              torch.from_numpy(Rz))) == 0.0


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_kabsch_np(weighted):
    rng = np.random.default_rng(3)
    T = _poses(8, 4)
    src = rng.uniform(-0.1, 0.1, (8, 200, 3)).astype(np.float32)
    dst = (np.einsum("bij,bnj->bni", T[:, :3, :3], src)
           + T[:, None, :3, 3]).astype(np.float32)
    dst += rng.normal(0, 1e-3, dst.shape).astype(np.float32)
    w = (rng.uniform(0, 1, (8, 200)) if weighted
         else np.ones((8, 200))).astype(np.float32)
    out = ts.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(w) if weighted else None).numpy()
    for b in range(8):
        ref = ts.kabsch_np(src[b], dst[b], w[b] if weighted else None)
        np.testing.assert_allclose(out[b], ref, atol=TOL)
        # the JAX package's numpy twin is the same solve
        np.testing.assert_allclose(
            ref, js.kabsch_np(src[b], dst[b], w[b] if weighted else None),
            atol=1e-12)
        assert abs(np.linalg.det(out[b][:3, :3]) - 1) < TOL


def test_kabsch_reflection_fix():
    """A planar cloud admits a reflection that fits as well; the result is
    still a proper rotation, equal to the Horn solve."""
    rng = np.random.default_rng(5)
    src = np.zeros((50, 3), np.float32)
    src[:, :2] = rng.uniform(-0.1, 0.1, (50, 2))
    T = _poses(1, 6)[0]
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    out = ts.kabsch(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    assert abs(np.linalg.det(out[:3, :3]) - 1) < TOL
    np.testing.assert_allclose(out, ts.kabsch_np(src, dst), atol=TOL)
    np.testing.assert_allclose(out, T, atol=TOL)
