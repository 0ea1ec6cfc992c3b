"""Port parity for the depth chain (`ops/preprocess.py`) and the pool's
slot write (`tracker/pool.py::preprocess_into_pool`, `mask_pool_slot`):
the same noisy synthetic depth at 120x160 through the JAX functions and
their torch counterparts, float32 on the CPU.

Maps agree within 1e-5. The one exception is the normal map at the end of
the whole chain: XLA's exp differs from torch's by one ulp, so the
bilateral depth differs by ~1e-7 m, and a normal (the cross product of
one-pixel xyz differences, ~3 mm here) amplifies that to ~4e-5; the chain's
normals are held to 1e-4, while normals from identical xyz are held to
1e-5. A pixel's validity may flip only where a float32 rounding difference
of the order of 1e-6 meets a threshold; such pixels are counted and
bounded at 0.1 % of the image."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu.ops import preprocess as jp
from bundlesdf_tpu.tracker import pool as jpool
from bundlesdf_tpu_torch.ops import preprocess as tp
from bundlesdf_tpu_torch.tracker import pool as tpool

torch.set_num_threads(2)
ATOL = 1e-5
NORMAL_ATOL_CHAIN = 1e-4
MAX_FLIP = 1e-3


@pytest.fixture(scope="module")
def frame():
    seq = cube_orbit_sequence(n_frames=2, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=0.3, noise=0.002)
    depth = seq["depths"][1].astype(np.float32)
    # holes and out-of-range pixels exercise the validity gates
    depth[40:44, 60:70] = 0.0
    depth[80:82, 90:95] = 1.5
    return depth, seq["K"].astype(np.float32), seq["masks"][1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_maps(a, b, valid_a, valid_b, atol=ATOL):
    """Maps equal within @atol where both are valid; validity differs on at
    most MAX_FLIP of the pixels."""
    a, b = np.asarray(a), np.asarray(b)
    flips = int((valid_a != valid_b).sum())
    assert flips <= MAX_FLIP * valid_a.size, flips
    both = valid_a & valid_b
    np.testing.assert_allclose(a[both], b[both], atol=atol, rtol=0)
    return flips


def test_erode_and_bilateral(frame):
    depth = frame[0]
    ej = np.asarray(jp.erode_depth(jnp.asarray(depth)))
    et = tp.erode_depth(_t(depth)).numpy()
    _close_maps(ej, et, ej > 0, et > 0)
    for radius in (1, 2):
        bj = np.asarray(jp.bilateral_filter_depth(jnp.asarray(ej),
                                                  radius=radius))
        bt = tp.bilateral_filter_depth(_t(ej), radius=radius).numpy()
        _close_maps(bj, bt, bj > 0, bt > 0)


def test_xyz_normals_edges(frame):
    depth, K, _ = frame
    d = np.asarray(jp.bilateral_filter_depth(jnp.asarray(depth)))
    xj = np.asarray(jp.depth_to_xyz(jnp.asarray(d), jnp.asarray(K)))
    xt = tp.depth_to_xyz(_t(d), _t(K)).numpy()
    np.testing.assert_allclose(xj, xt, atol=ATOL, rtol=0)
    nj = np.asarray(jp.compute_normals(jnp.asarray(xj)))
    nt = tp.compute_normals(_t(xj)).numpy()
    _close_maps(nj, nt, np.abs(nj).sum(-1) > 0, np.abs(nt).sum(-1) > 0)
    thr = 10.0 * math.pi / 180.0
    fj = np.asarray(jp.filter_depth_edges(jnp.asarray(d), jnp.asarray(nj),
                                          jnp.asarray(K), thr))
    ft = tp.filter_depth_edges(_t(d), _t(nj), _t(K), thr).numpy()
    _close_maps(fj, ft, fj > 0, ft > 0)


@pytest.mark.parametrize("masked", [False, True])
def test_preprocess_depth_frame(frame, masked):
    depth, K, mask = frame
    mj = jnp.asarray(mask) if masked else None
    mt = _t(mask) if masked else None
    dj, xj, nj = map(np.asarray, jp.preprocess_depth_frame(
        jnp.asarray(depth), jnp.asarray(K), mask=mj))
    dt, xt, nt = (a.numpy() for a in tp.preprocess_depth_frame(
        _t(depth), _t(K), mask=mt))
    vj, vt = dj >= 0.1, dt >= 0.1
    _close_maps(dj, dt, vj, vt)
    _close_maps(xj, xt, vj, vt)
    _close_maps(nj, nt, vj, vt, atol=NORMAL_ATOL_CHAIN)


def test_preprocess_into_pool_and_mask(frame):
    depth, K, mask = frame
    H, W = depth.shape
    jarr = [jnp.zeros((2, H, W, 3)), jnp.zeros((2, H, W, 3)),
            jnp.zeros((2, H, W)), jnp.zeros((2, H, W), bool),
            jnp.zeros((2, H // 2, W // 2, 3)),
            jnp.zeros((2, H // 2, W // 2, 3)),
            jnp.zeros((2, H // 2, W // 2), bool)]
    *jarr, nj = jpool.preprocess_into_pool(*jarr, 1, jnp.asarray(depth),
                                           jnp.asarray(K), jnp.asarray(mask))
    pool = tpool.FramePool(H, W, cap=2, device="cpu")
    nt = tpool.preprocess_into_pool(*pool.tensors, 1, _t(depth), _t(K),
                                    _t(mask))
    vj, vt = np.asarray(jarr[3][1]), pool.valids[1].numpy()
    assert abs(int(nj) - int(nt)) <= MAX_FLIP * vj.size
    for a, b, tol in zip(jarr[:3], pool.tensors[:3],
                         (ATOL, NORMAL_ATOL_CHAIN, ATOL)):
        _close_maps(np.asarray(a[1]), b[1].numpy(), vj, vt, atol=tol)
    for a, b, tol in zip(jarr[4:6], pool.tensors[4:6],
                         (ATOL, NORMAL_ATOL_CHAIN)):
        _close_maps(np.asarray(a[1]), b[1].numpy(), vj[::2, ::2],
                    vt[::2, ::2], atol=tol)
    np.testing.assert_array_equal(pool.valids_h[1].numpy(), vt[::2, ::2])
    np.testing.assert_array_equal(pool.xyzs_h[1].numpy(),
                                  pool.xyzs[1].numpy()[::2, ::2])
    assert not pool.valids[0].any()          # other slots untouched

    shrunk = mask.copy()
    shrunk[:, : W // 2] = 0
    *jarr, nj2 = jpool.mask_pool_slot(*jarr, 1, jnp.asarray(shrunk))
    nt2 = tpool.mask_pool_slot(*pool.tensors, 1, _t(shrunk))
    assert int(nt2) == int(pool.valids[1].sum()) < int(nt)
    assert abs(int(nj2) - int(nt2)) <= MAX_FLIP * vj.size
    _close_maps(np.asarray(jarr[0][1]), pool.xyzs[1].numpy(),
                np.asarray(jarr[3][1]), pool.valids[1].numpy())


def test_compute_covisibility(frame):
    depth, K, mask = frame
    d, x, n = jp.preprocess_depth_frame(jnp.asarray(depth), jnp.asarray(K),
                                        mask=jnp.asarray(mask))
    valid = np.asarray(d) > 0.1
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.array([[c, 0, s, 0.05], [0, 1, 0, 0.0], [-s, 0, c, 0.02],
                  [0, 0, 0, 1]], np.float32)
    cj = float(jp.compute_covisibility(x, n, jnp.asarray(valid),
                                       jnp.asarray(T)))
    ct = float(tp.compute_covisibility(_t(np.asarray(x)), _t(np.asarray(n)),
                                       _t(valid), _t(T)))
    assert 0.05 < cj < 1.0
    assert abs(cj - ct) <= 1e-6
