"""The port on the card: the `scatter_rows` CUDA kernel against its plain
PyTorch version (uniform rows, and runs of equal rows at the encoder's
stride, with and without the `group` hint), the hash-grid gradient through
it against PyTorch's own gather backward, the hash-grid encoder's two
kernels against the plain path at the three configurations' grids, the
wrappers' input checks, and the tracker programs
(depth chain into the pool, fused ORB match + lift + RANSAC, bundle
adjustment) and the port's ORB detector (`matcher/orb.py`, with a mask,
through the matcher's stream) on the card against the same calls on the
CPU, at small shapes, the NOF training step replayed as a CUDA graph
against the same steps run eagerly, the Adam kernel (`ops/adam.py`)
against torch's foreach Adam at the three cells' tables, and the tracker's
bundle adjustment replayed as CUDA graphs (`tracker/ba_graph.py`) against
the eager BA on the same padded inputs. Every test needs a CUDA card and
skips without one.

This file imports no jax, so it also runs where jax is not installed:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch.ops import hashgrid as hg
from bundlesdf_tpu_torch.ops.hashgrid import (HashGridSpec, hashgrid_corners,
                                              hashgrid_encode)
from bundlesdf_tpu_torch.ops.scatter import scatter_rows, scatter_rows_torch
from bundlesdf_tpu_torch.utils import profiling
from scatter_cases import runs_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these tests hold programs on the "
                    "card against the CPU, and the scatter_rows kernel has "
                    "no CPU mode")
    return torch.device("cuda")


def _launches(name="scatter_rows.launches"):
    return profiling.snapshot().get(name, (0, 0.0))[0]


def _case(M, D, C, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, D, M).astype(np.int32)
    rows[rng.random(M) < 0.1] = D                     # sentinels
    rows[rng.choice(M, 4096, replace=False)] = D // 3  # one hot row
    vals = rng.standard_normal((M, C)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(rows)


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("C,dtype", [(2, torch.float32), (2, torch.bfloat16),
                                     (16, torch.bfloat16), (3, torch.float32)])
def test_kernel_matches_plain(cuda_device, C, dtype, group):
    vals, rows = _case(1 << 18, 70000, C, seed=C)
    v, r = vals.to(cuda_device, dtype), rows.to(cuda_device)
    before = _launches()
    out = scatter_rows(v, r, 70000, group=group)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert out.dtype == torch.float32 and out.shape == (70000, C)
    # only the order of the f32 atomic adds differs
    torch.testing.assert_close(out, scatter_rows_torch(v, r, 70000),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [2, 3, 16])
@pytest.mark.parametrize("group", [1, 32])
def test_kernel_runs_match_plain(cuda_device, group, C, dtype, shuffle):
    """Runs of equal rows at stride 32 (up to 199 samples: across warps
    and the kernel's 32-sample tiles), sentinels and ids -1 / D + 7 inside
    runs, a ragged last tile; shuffled, the same rows with no layout."""
    D = 5000
    vals, rows = runs_case(9000, 32, D, C, seed=C, shuffle=shuffle)
    v = torch.from_numpy(vals).to(cuda_device, dtype)
    r = torch.from_numpy(rows).to(cuda_device)
    out = scatter_rows(v, r, D, group=group)
    torch.testing.assert_close(out, scatter_rows_torch(v, r, D),
                               rtol=1e-5, atol=1e-4)


def test_kernel_runs_on_unaligned_values(cuda_device):
    """Views that start 1, 2 or 4 bf16 values into the buffer are 2-, 4-
    and 8-byte aligned: the kernel narrows its vector loads and atomics to
    that alignment, with the same sums."""
    vals, rows = runs_case(2000, 32, 3000, 4, seed=9)
    v = torch.from_numpy(vals).to(cuda_device, torch.bfloat16).reshape(-1)
    r = torch.from_numpy(rows).to(cuda_device)[1:]
    for k in (1, 2, 4):
        view = v[k:k + 4 * r.shape[0]].reshape(-1, 4)
        out = scatter_rows(view, r, 3000, group=32)
        torch.testing.assert_close(out, scatter_rows_torch(view, r, 3000),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("table_bf16", [False, True])
def test_hashgrid_gradient_through_kernel(cuda_device, table_bf16):
    """Table and point gradients with the kernel equal those of the same
    graph whose gather backward is PyTorch's index_select backward."""
    spec = HashGridSpec(n_levels=4, level_dim=2, base_res=8, finest_res=48,
                        log2_hashmap_size=14, table_bf16=table_bf16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x0 = torch.rand((8192, 3), generator=g, device=cuda_device) * 1.8 - 0.9
    table0 = torch.rand((spec.total_rows, 2), generator=g,
                        device=cuda_device) * 0.2 - 0.1
    cot = torch.randn((8192, spec.out_dim), generator=g, device=cuda_device)
    dtype = torch.bfloat16 if table_bf16 else torch.float32
    grads = []
    for use_kernel in (True, False):
        table = table0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        if use_kernel:
            enc = hashgrid_encode(table, x, spec)
        else:
            rows, wc = hashgrid_corners(x, spec)
            f = table.index_select(0, rows.reshape(-1).long()).to(dtype)
            f = f.view(-1, spec.n_levels, 8, 2).float()
            enc = torch.sum(f * wc[..., None], dim=2).reshape(8192, -1)
        torch.sum(enc * cot).backward()
        grads.append((table.grad, x.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("table_bf16", [False, True])
def test_hashgrid_gradient_on_rays_through_kernel(cuda_device, table_bf16):
    """Ray-ordered points (samples sorted along each ray, as the renderer
    queries them): the long runs of equal coarse rows that the kernel
    sums at group L*8 give the index_select backward's table gradient."""
    spec = HashGridSpec(table_bf16=table_bf16)            # the online grid
    g = torch.Generator(device=cuda_device).manual_seed(2)
    o = torch.rand((256, 1, 3), generator=g, device=cuda_device) * 0.6 - 0.3
    d = torch.randn((256, 1, 3), generator=g, device=cuda_device)
    t = torch.sort(torch.rand((256, 192, 1), generator=g, device=cuda_device)
                   * 0.6, dim=1).values
    x = (o + d / d.norm(dim=-1, keepdim=True) * t).reshape(-1, 3)
    x = x.clamp(-0.99, 0.99)
    table0 = torch.rand((spec.total_rows, 2), generator=g,
                        device=cuda_device) * 0.2 - 0.1
    cot = torch.randn((x.shape[0], spec.out_dim), generator=g,
                      device=cuda_device)
    dtype = torch.bfloat16 if table_bf16 else torch.float32
    grads = []
    for use_kernel in (True, False):
        table = table0.clone().requires_grad_()
        if use_kernel:
            enc = hashgrid_encode(table, x, spec)
        else:
            rows, wc = hashgrid_corners(x, spec)
            f = table.index_select(0, rows.reshape(-1).long()).to(dtype)
            f = f.view(-1, spec.n_levels, 8, 2).float()
            enc = torch.sum(f * wc[..., None], dim=2).reshape(x.shape[0], -1)
        torch.sum(enc * cot).backward()
        grads.append(table.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    v = torch.ones((8, 2), device=cuda_device)
    r = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        scatter_rows(v.half(), r, 4)
    with pytest.raises(TypeError):
        scatter_rows(v, r.long(), 4)
    with pytest.raises(ValueError):
        scatter_rows(torch.ones((2, 8), device=cuda_device).t(), r, 4)
    with pytest.raises(ValueError):
        scatter_rows(v, r.cpu(), 4)
    with pytest.raises(ValueError):
        scatter_rows(v, r, 4, group=0)


# the three configurations' grids as they run: `custom` online (4 dense
# levels), `custom` refine (16 dense), `ho3d` refine (16, levels 12-15
# hashed into 2^24 rows each)
_GRIDS = {"online": dict(),
          "custom_refine": dict(n_levels=16, finest_res=256,
                                log2_hashmap_size=24),
          "ho3d_refine": dict(n_levels=16, finest_res=512,
                              log2_hashmap_size=24)}


def _encoder_case(spec, device, seed=3, n_rays=128, n_samples=64):
    """Ray-ordered points, some beyond [-1, 1], points on cell faces of
    every level and on the cube's faces; a table; a cotangent."""
    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.rand((n_rays, 1, 3), generator=g, device=device) - 0.5
    d = torch.randn((n_rays, 1, 3), generator=g, device=device)
    t = torch.sort(torch.rand((n_rays, n_samples, 1), generator=g,
                              device=device) * 1.2, dim=1).values
    pts = [(o + d / d.norm(dim=-1, keepdim=True) * t).reshape(-1, 3)]
    for res, _, _, _ in spec.layout():
        k = torch.randint(0, res + 1, (16, 3), generator=g, device=device)
        pts.append(2.0 * k.float() / res - 1.0)
    pts.append(torch.tensor([[-1, 1, 0], [1, -1, 1], [-1.5, 0.2, 2.0]],
                            dtype=torch.float32, device=device))
    x = torch.cat(pts)
    table = torch.rand((spec.total_rows, spec.level_dim), generator=g,
                       device=device) * 0.2 - 0.1
    cot = torch.randn((x.shape[0], spec.out_dim), generator=g, device=device)
    return x, table, cot


def _row_bound(vals, rows, n_rows):
    """Two float32 sums of a row's n_r entries in any orders lie within
    2 n_r u sum|v| of each other (u = 2^-24)."""
    ones = torch.ones((rows.shape[0], 1), device=rows.device)
    n = scatter_rows_torch(ones, rows, n_rows)
    return 2.0 ** -23 * 1.01 * n * scatter_rows_torch(vals.abs(), rows,
                                                      n_rows)


@pytest.mark.parametrize("table_bf16", [False, True])
@pytest.mark.parametrize("grid", list(_GRIDS))
def test_encoder_kernels_match_plain(cuda_device, grid, table_bf16,
                                     monkeypatch):
    """The forward within float32 summation order of the plain path's; the
    scatter's input (values, rows) bit-equal to the plain path's and to
    the backward's torch twin; the table gradient within the atomics'
    order; dx within 1e-5 of autograd's and bit-equal to the twin's; two
    kernel launches, one scatter launch."""
    spec = HashGridSpec(**_GRIDS[grid], table_bf16=table_bf16)
    x0, table0, cot = _encoder_case(spec, cuda_device)
    seen, orig = [], hg.scatter_rows

    def recorder(vals, rows, n_rows, group=1):
        seen.append((vals.clone(), rows.clone(), n_rows, group))
        return orig(vals, rows, n_rows, group=group)

    monkeypatch.setattr(hg, "scatter_rows", recorder)
    got = {}
    for name, encode in (("kernel", hashgrid_encode),
                         ("plain", hg.hashgrid_encode_torch)):
        table = table0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        n0, s0 = _launches("hashgrid.launches"), _launches()
        out = encode(table, x, spec)
        torch.sum(out * cot).backward()
        torch.cuda.synchronize()
        got[name] = (out.detach(), table.grad, x.grad,
                     _launches("hashgrid.launches") - n0, _launches() - s0)
    out_k, dt_k, dx_k, n_k, s_k = got["kernel"]
    out_p, dt_p, dx_p, n_p, s_p = got["plain"]
    assert (n_k, s_k, n_p, s_p) == (2, 1, 0, 1)
    # 8 terms: two orders within 16 u sum|f wc| of each other
    mag = hg.hashgrid_encode_torch(table0.abs(), x0, spec)
    assert torch.all((out_k - out_p).abs()
                     <= 1e-6 * out_p.abs() + 16 * 2.0 ** -24 * mag)
    (v_k, r_k, n_rows, group), (v_p, r_p, _, _) = seen
    assert (n_rows, group) == (spec.total_rows, spec.n_levels * 8)
    assert torch.equal(v_k, v_p) and torch.equal(r_k, r_p)
    v_t, r_t, dx_t = hg.hashgrid_encode_backward_torch(table0, x0, cot, spec)
    assert torch.equal(v_k, v_t) and torch.equal(r_k, r_t)
    assert torch.equal(dx_k, dx_t)
    assert torch.all((dt_k - dt_p).abs() <= _row_bound(v_k, r_k, n_rows))
    torch.testing.assert_close(dx_k, dx_p, rtol=1e-5,
                               atol=1e-5 * float(dx_p.abs().max()))


@pytest.mark.parametrize("table_bf16", [False, True])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_encoder_kernels_at_other_widths(cuda_device, C, table_bf16):
    """The kernels' other feature widths, at a grid with two hashed
    levels: the forward within summation order of the plain path's, the
    backward's values, rows and dx bit-equal to its torch twin's."""
    spec = HashGridSpec(n_levels=4, level_dim=C, base_res=8, finest_res=48,
                        log2_hashmap_size=14, table_bf16=table_bf16)
    x, table, cot = _encoder_case(spec, cuda_device, seed=C)
    out_p = hg.hashgrid_encode_torch(table, x, spec)
    mag = hg.hashgrid_encode_torch(table.abs(), x, spec)
    assert torch.all((hg.hashgrid_encode_cuda(table, x, spec) - out_p).abs()
                     <= 1e-6 * out_p.abs() + 16 * 2.0 ** -24 * mag)
    got = hg.hashgrid_encode_backward_cuda(table, x, cot, spec)
    want = hg.hashgrid_encode_backward_torch(table, x, cot, spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_encoder_kernels_take_only_the_gradients_asked(cuda_device):
    """Without the point gradient, without the table gradient (no scatter)
    and without autograd (the forward alone): the same numbers, one launch
    a kernel run."""
    spec = HashGridSpec(**_GRIDS["ho3d_refine"], table_bf16=True)
    x, table0, cot = _encoder_case(spec, cuda_device, seed=4)
    vals, rows, dx = hg.hashgrid_encode_backward_cuda(table0, x, cot, spec)
    n0, s0 = _launches("hashgrid.launches"), _launches()
    table = table0.clone().requires_grad_()
    torch.sum(hashgrid_encode(table, x, spec) * cot).backward()
    assert torch.all((table.grad - scatter_rows_torch(vals, rows,
                                                      spec.total_rows)).abs()
                     <= _row_bound(vals, rows, spec.total_rows))
    xg = x.clone().requires_grad_()
    torch.sum(hashgrid_encode(table0, xg, spec) * cot).backward()
    assert torch.equal(xg.grad, dx)
    with torch.no_grad():
        out = hashgrid_encode(table0, x, spec)
    assert torch.equal(out, hg.hashgrid_encode_cuda(table0, x, spec))
    assert _launches("hashgrid.launches") - n0 == 2 + 2 + 1 + 1
    assert _launches() - s0 == 1
    v, r, d = hg.hashgrid_encode_backward_cuda(table0, x, cot, spec,
                                               x_grad=False)
    assert d is None and torch.equal(v, vals) and torch.equal(r, rows)
    v, r, d = hg.hashgrid_encode_backward_cuda(table0, x, cot, spec,
                                               table_grad=False)
    assert v is None and r is None and torch.equal(d, dx)


def test_encoder_kernels_reject_what_they_do_not_take(cuda_device):
    spec = HashGridSpec(n_levels=4, level_dim=2, base_res=8, finest_res=48,
                        log2_hashmap_size=14)
    table = torch.zeros((spec.total_rows, 2), device=cuda_device)
    x = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(TypeError):
        hashgrid_encode(table.double(), x, spec)
    with pytest.raises(ValueError):
        hashgrid_encode(table[:-1], x, spec)
    with pytest.raises(ValueError):
        hashgrid_encode(torch.zeros((spec.total_rows, 3), device=cuda_device),
                        x, replace(spec, level_dim=3))
    with pytest.raises(ValueError):
        hashgrid_encode(table, x.cpu(), spec)
    with pytest.raises(ValueError):
        hashgrid_encode(table, torch.zeros((8, 2), device=cuda_device), spec)
    many = HashGridSpec(n_levels=17, base_res=4, finest_res=32,
                        log2_hashmap_size=16)
    with pytest.raises(ValueError):
        hashgrid_encode(torch.zeros((many.total_rows, 2), device=cuda_device),
                        x, many)


# ---------------------------------------------------------------------------
# tracker programs, card vs CPU
# ---------------------------------------------------------------------------

def _orbit(n=4, H=120, W=160):
    from synthetic import cube_orbit_sequence
    return cube_orbit_sequence(n_frames=n, H=H, W=W, radius=0.45,
                               obj_size=0.08, full_angle=0.4, noise=0.002)


def _pools(seq, n):
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.tracker.pool import FramePool
    dp = default_track_config()["depth_processing"]
    H, W = seq["depths"].shape[1:]
    pools = {d: FramePool(H, W, cap=n, device=d) for d in ("cuda", "cpu")}
    for i in range(n):
        for p in pools.values():
            p.insert_preprocessed(i, seq["depths"][i], seq["K"],
                                  seq["masks"][i], dp)
    return pools


def test_depth_chain_into_pool_card_vs_cpu(cuda_device):
    """Maps within 1e-4 m (normals 1e-3: cross products of one-pixel xyz
    differences amplify depth rounding), validity flips <= 0.1 %."""
    seq = _orbit()
    pools = _pools(seq, 4)
    g, c = pools["cuda"], pools["cpu"]
    assert g.slot_of == c.slot_of
    for i, s in g.slot_of.items():
        vg, vc = g.valids[s].cpu(), c.valids[s]
        assert (vg != vc).float().mean() <= 1e-3
        both = vg & vc
        for a, b, tol in ((g.depths, c.depths, 1e-4), (g.xyzs, c.xyzs, 1e-4),
                          (g.nrms, c.nrms, 1e-3)):
            assert (a[s].cpu() - b[s])[both].abs().max() <= tol
        torch.testing.assert_close(g.xyzs_h[s].cpu(), g.xyzs[s, ::2, ::2]
                                   .cpu(), rtol=0, atol=0)


def test_ransac_and_ba_card_vs_cpu(cuda_device):
    """Lift + RANSAC with injected draws: lifts identical, inlier masks
    identical on all but boundary matches (<= 0.1 %); BA poses within
    1e-4 m / 1e-4 rad."""
    from bundlesdf_tpu_torch.tracker.ba import BAConfig, bundle_adjust_pooled
    from bundlesdf_tpu_torch.tracker.pool import lift_ransac_slots
    from bundlesdf_tpu_torch.tracker.ransac import draw_samples
    seq = _orbit()
    pools = _pools(seq, 4)
    g, c = pools["cuda"], pools["cpu"]
    for a, b in zip(c.tensors, g.tensors):
        a.copy_(b.cpu())
    rng = np.random.default_rng(0)
    pairs = [(1, 0), (2, 1), (3, 2), (3, 1)]
    d1 = c.depths[c.slot_of[1]].numpy()
    vs, us = np.nonzero(d1 > 0.1)
    sel = rng.choice(len(vs), 300, replace=False)
    # matches by reprojection of frame B's object pixels into frame A
    uvA, uvB = [], []
    for a, b in pairs:
        p_b = c.xyzs[c.slot_of[b]].numpy()[vs[sel], us[sel]]
        TB, TA = seq["cam_in_obs"][b], seq["cam_in_obs"][a]
        p_a = (p_b @ TB[:3, :3].T + TB[:3, 3] - TA[:3, 3]) @ TA[:3, :3]
        K = seq["K"]
        ua = np.round(p_a[:, 0] / p_a[:, 2] * K[0, 0] + K[0, 2])
        va = np.round(p_a[:, 1] / p_a[:, 2] * K[1, 1] + K[1, 2])
        uvA.append(np.clip(np.stack([ua, va], -1), 0, [159, 119]))
        uvB.append(np.stack([us[sel], vs[sel]], -1))
    host = dict(slots_a=[c.slot_of[a] for a, _ in pairs],
                slots_b=[c.slot_of[b] for _, b in pairs],
                uvA=np.array(uvA, np.int32), uvB=np.array(uvB, np.int32),
                valid=np.ones((4, 300), bool),
                conf=np.ones((4, 300), np.float32),
                TA=seq["cam_in_obs"][[a for a, _ in pairs]].astype(np.float32),
                TB=seq["cam_in_obs"][[b for _, b in pairs]].astype(np.float32),
                cap_t=np.full(4, 0.05, np.float32),
                cap_r=np.full(4, 0.5, np.float32))

    def lift(dev, pool, idx):
        a = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in host.items()}
        return lift_ransac_slots(pool.xyzs, pool.nrms, **a, seed=0,
                                 inlier_dist=0.005, cos_normal_angle=0.866,
                                 n_trials=500, sample_idx=idx)

    first = lift("cpu", c, None)
    idx = draw_samples(first["ok"], 500, seed=3)
    rg = {k: v.cpu() for k, v in lift("cuda", g, idx.cuda()).items()}
    rc = lift("cpu", c, idx)
    for k in ("pA_cam", "pB_cam", "ok"):
        assert torch.equal(rg[k], rc[k]), k
    flips = (rg["inlier_mask"] != rc["inlier_mask"]).sum()
    assert flips <= 1e-3 * rc["ok"].sum()
    assert (rc["inlier_mask"].sum(1) > 100).all()

    N = 4
    poses0 = seq["cam_in_obs"].astype(np.float32).copy()
    poses0[1:, :3, 3] += rng.normal(0, 0.003, (N - 1, 3))
    D = 1024
    src_idx = np.zeros((N, D), np.int64)
    src_valid = np.zeros((N, D), bool)
    for k in range(N):
        f = np.nonzero(seq["masks"][k][::4, ::4].reshape(-1) > 0)[0][:D]
        src_idx[k, :len(f)] = f
        src_valid[k, :len(f)] = True
    pair_ij = np.array([(i, j) for i in range(N) for j in range(i + 1, N)])
    rows_w = np.nonzero((pair_ij == N - 1).any(1))[0]
    keep = rc["inlier_mask"][0].numpy()
    ba_host = dict(slots=[c.slot_of[k] for k in range(N)],
                   slot_live=np.ones(N, np.float32), poses0=poses0,
                   K=seq["K"].astype(np.float32), pair_ij=pair_ij,
                   corr_i=np.full(keep.sum(), 1), corr_j=np.zeros(keep.sum()),
                   corr_pi=rc["pA_cam"][0].numpy()[keep],
                   corr_pj=rc["pB_cam"][0].numpy()[keep],
                   corr_valid=np.ones(keep.sum(), np.float32),
                   update_flags=np.array([0, 1, 1, 1], np.float32),
                   src_idx=src_idx, src_valid=src_valid,
                   pair_ij_w=pair_ij[rows_w], pair_w_dst=rows_w)

    def ba(dev, pool):
        a = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in ba_host.items()}
        a["corr_i"], a["corr_j"] = a["corr_i"].long(), a["corr_j"].long()
        return bundle_adjust_pooled(pool.xyzs_h, pool.nrms_h, **a, factor=4,
                                    cfg=BAConfig(), pre_decim=2)

    pg, pc = ba("cuda", g).cpu().double(), ba("cpu", c).double()
    assert (pg[:, :3, 3] - pc[:, :3, 3]).abs().max() <= 1e-4
    assert ((pg[:, :3, :3] - pc[:, :3, :3]).norm(dim=(1, 2))
            / np.sqrt(2)).max() <= 1e-4


def test_orb_card_equals_cpu(cuda_device):
    """The detector on the card gives the CPU's keypoints, angles,
    responses and descriptors exactly, directly and through the matcher's
    per-frame cache (its own stream)."""
    from types import SimpleNamespace

    from bundlesdf_tpu_torch.matcher import orb
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    rng = np.random.default_rng(0)
    color = np.full((240, 320, 3), 90, np.uint8)
    color[30:210, 50:280] = rng.integers(0, 256, (180, 230, 3), np.uint8)
    mask = np.zeros((240, 320), np.uint8)
    mask[30:210, 50:280] = 1
    gray = orb.rgb_to_gray(torch.from_numpy(color))
    cpu = orb.detect_and_compute(gray, torch.from_numpy(mask))
    card = orb.detect_and_compute(gray.to(cuda_device),
                                  torch.from_numpy(mask).to(cuda_device))
    assert len(cpu["pt"]) > 500
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k]), k
    fr = SimpleNamespace(id=0, color=color, fg_mask=mask)
    want = OrbMatcher(device="cpu")._frame_feats(fr)
    got = OrbMatcher(device=cuda_device)._frame_feats(fr)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_traced_step_gives_device_ms_to_its_phases(cuda_device, tmp_path):
    """Three NOF steps of a new tiny runner on the card under
    `device_trace`: the first runs eagerly, and `device_ms_by_range` gives
    device time to its render, its backward (whose kernels autograd's
    device thread launches, with no range of its own open) and its Adam;
    the other two replay the captured step, whose device time falls under
    `nof.graph.replay`, inside each `nof.step`."""
    from nof_tiny import tiny_runner
    from bundlesdf_tpu_torch.utils.profiling import (device_trace,
                                                     load_trace, trace_path)
    tiny_runner(device=cuda_device).train(n_steps=2)   # the kernel's build
    runner = tiny_runner(device=cuda_device)
    with device_trace(str(tmp_path), device=cuda_device):
        runner.train(n_steps=3)
    got = profiling.device_ms_by_range(load_trace(trace_path(str(tmp_path))))
    for name in ("nof.render", "nof.backward", "nof.adam",
                 "nof.graph.replay"):
        assert got.get(name, 0.0) > 0.0, (name, got)


def _counts(before, *names):
    after = profiling.snapshot()
    return [after.get(n, (0, 0.0))[0] - before.get(n, (0, 0.0))[0]
            for n in names]


@pytest.mark.parametrize("t", [0.01, 0.015, 0.0123, 1 / 3])
def test_device_truncation_gives_the_float_truncations_bits(cuda_device, t):
    """`raw2outputs` at a device truncation with its host-made reciprocal
    (a captured step's) gives the outputs and gradients a float
    truncation gives, bit for bit: CUDA divides by a host scalar as a
    product with float32(1 / t)."""
    from bundlesdf_tpu_torch.nof.render import RenderConfig, raw2outputs
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=cuda_device)

    z = torch.sort(rand(256, 32), dim=-1).values.requires_grad_()
    depth = rand(256) * 0.8 + 0.1
    rgb = (rand(256, 32, 3) * 4 - 2).requires_grad_()
    sdf = rand(256, 32) * 2 - 1
    valid = rand(256, 32) > 0.1
    cot_rgb, cot_w = rand(256, 3), rand(256, 32)
    got = []
    for trunc, inv in ((t, None), (
            torch.tensor(t, dtype=torch.float32, device=cuda_device),
            torch.tensor(1.0 / t, dtype=torch.float32, device=cuda_device))):
        rgb_map, w = raw2outputs(rgb, sdf, z, depth, RenderConfig(), valid,
                                 trunc=trunc, trunc_inv=inv)
        loss = (rgb_map * cot_rgb).sum() + (w * cot_w).sum()
        got.append((rgb_map, w) + torch.autograd.grad(loss, (rgb, z)))
    for a, b in zip(*got):
        assert torch.equal(a, b)


def _copy_state(dst, src):
    """@dst's parameters, Adam state and generator state <- @src's."""
    named = dict(src.field.named_parameters())
    with torch.no_grad():
        for n, p in dst.field.named_parameters():
            p.copy_(named[n])
            for k, v in src.optimizer.state.get(named[n], {}).items():
                dst.optimizer.state[p][k].copy_(v)
    dst.generator.set_state(src.generator.get_state())


@pytest.mark.parametrize("frame_features", [0, 2])
def test_graph_replays_equal_eager_steps(cuda_device, frame_features):
    """Ten steps of a tiny runner through its `StepGraph` (one eager step,
    then replays of the captured step) against the same runner's eager
    steps (its graph taken away: every step `train_step`), each eager step
    from the graph runner's state before it. The losses, the generator's
    state, every gradient and every parameter and Adam moment come out
    bit-equal, but the hash table's: its gradient is summed by the
    `scatter_rows` kernel's atomics, in another order on every run (two
    eager runs differ there too), so it is held within float32's
    summation-order error and the table's update is not compared. With
    frame features, `feature_array` is held bit-equal too: its backward
    (a dense sum over each ray's samples, an index backward over the
    rays) has no atomics."""
    from nof_tiny import tiny_runner
    graph, eager = (tiny_runner(device=cuda_device,
                                frame_features=frame_features)
                    for _ in range(2))
    assert ("feature_array" in dict(graph.field.named_parameters())) \
        == (frame_features > 0)
    eager._step_graph = None
    pg = dict(graph.field.named_parameters())
    before = profiling.snapshot()
    for i in range(10):
        _copy_state(eager, graph)
        m_g = graph.train(n_steps=1)
        m_e = eager.train(n_steps=1)
        for k in m_e:
            np.testing.assert_array_equal(m_g[k], m_e[k], err_msg=k)
        torch.cuda.synchronize()
        for name, p in eager.field.named_parameters():
            if name == "table":
                torch.testing.assert_close(
                    pg[name].grad, p.grad, rtol=1e-4,
                    atol=1e-6 * float(p.grad.abs().max()))
                continue
            assert torch.equal(pg[name].grad, p.grad), (i, name)
            assert torch.equal(pg[name], p), (i, name)
            sg, se = graph.optimizer.state[pg[name]], eager.optimizer.state[p]
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sg[k], se[k]), (i, name, k)
        assert torch.equal(graph.generator.get_state(),
                           eager.generator.get_state()), i
    assert _counts(before, "nof.graph.capture", "nof.graph.replay",
                   "nof.step") == [1, 9, 20]


def test_graph_recaptures_when_its_tensors_are_rebound(cuda_device):
    """A keyframe batch (`add_new_frames`) and an occupancy rebuild each
    rebind tensors the captured step reads: the next step runs eagerly and
    the one after recaptures, so of 1 + 2 + 7 steps after each, the last
    nine are replays; in-place writes (a pose sync) keep the graph."""
    from nof_tiny import tiny_runner
    r = tiny_runner(device=cuda_device)
    r.train(n_steps=5)
    before = profiling.snapshot()
    with r._on_stream(), torch.no_grad():
        r.field.pose_array.add_(1e-3)
    r.train(n_steps=5)
    assert _counts(before, "nof.graph.capture", "nof.graph.replay") == [0, 5]
    r.add_new_frames(r.images[:1], r.depths[:1], r.masks[:1], None,
                     list(r.poses) + [r.poses[0]])
    for n in (1, 2, 7):
        r.train(n_steps=n)
    with r._on_stream():
        r.occ_grid = r._build_occupancy()
    for n in (1, 2, 7):
        r.train(n_steps=n)
    assert _counts(before, "nof.graph.capture", "nof.graph.replay",
                   "nof.step") == [2, 5 + 2 * 9, 5 + 2 * 10]
    assert np.all(np.isfinite(r.train(n_steps=3)["loss"]))


def test_replayed_steps_count_their_kernel_launches(cuda_device):
    """`scatter_rows.launches` and `hashgrid.launches` count launches on
    the card: none for a capture, one scatter and two encoder kernels (the
    forward and the backward) for each step, eager or replayed."""
    from nof_tiny import tiny_runner
    r = tiny_runner(device=cuda_device)
    n0, h0 = _launches(), _launches("hashgrid.launches")
    r.train(n_steps=1)
    assert _launches() - n0 == 1
    assert _launches("hashgrid.launches") - h0 == 2
    r.train(n_steps=6)
    assert _launches() - n0 == 7
    assert _launches("hashgrid.launches") - h0 == 14


def test_steps_count_two_adam_launches(cuda_device):
    """`adam.launches` counts the Adam kernel's launches: one for each of
    the two parameter groups a step, eager or after a replay."""
    from nof_tiny import tiny_runner
    r = tiny_runner(device=cuda_device)
    before = profiling.snapshot()
    r.train(n_steps=1)
    r.train(n_steps=6)
    assert _counts(before, "nof.graph.replay", "adam.launches") == [6, 14]


# the three cells' tables (rows x 2 features) and, beside them, the MLPs
# of the refine configs, `feature_array` and `pose_array` (40 frames)
_ADAM_TABLES = {"custom.online": 2_462_164, "custom.refine": 39_601_891,
                "ho3d.refine": 84_133_278}
_ADAM_SHAPES = [(64, 32), (64,), (16, 64), (16,), (64, 26), (64,), (64, 64),
                (64,), (3, 64), (3,), (40, 2), (40, 6)]


def _adam_pair(shapes, device, g, betas=(0.9, 0.999), lrs=(0.01, 0.001)):
    """Parameters of @shapes and a copy, the kernel Adam over the first and
    torch's foreach Adam over the copy, each with two groups (the last
    tensor alone, as `pose_array`)."""
    from bundlesdf_tpu_torch.ops.adam import Adam
    init = [torch.randn(s, generator=g, device=device) * 0.1 for s in shapes]
    mine = [torch.nn.Parameter(t.clone()) for t in init]
    ref = [torch.nn.Parameter(t) for t in init]

    def groups(ps):
        return [{"params": ps[:-1], "lr": lrs[0], "base_lr": lrs[0]},
                {"params": ps[-1:], "lr": lrs[1], "base_lr": lrs[1]}]
    return (mine, Adam(groups(mine), betas=betas, eps=1e-15), ref,
            torch.optim.Adam(groups(ref), betas=betas, eps=1e-15,
                             foreach=True))


def _adam_grad(shape, device, g):
    """Sparse like the table's gradient, magnitudes over decades."""
    grad = torch.randn(shape, generator=g, device=device)
    grad *= torch.exp(3 * torch.randn(shape, generator=g, device=device))
    return grad * (torch.rand(shape, generator=g, device=device) < 0.4)


def _ulp_gaps(mine, opt, ref, ref_opt):
    """{(tensor index, p | m | v | step): largest gap in units in the last
    place} where the two optimizers' results differ."""
    gaps = {}
    for i, (p, q) in enumerate(zip(mine, ref)):
        a, b = opt.state.get(p, {}), ref_opt.state.get(q, {})
        assert a.keys() == b.keys(), i
        pairs = [("p", p.detach(), q.detach())] + [
            (n, a[k], b[k]) for n, k in (("m", "exp_avg"), ("v", "exp_avg_sq"))
            if k in a]
        for name, x, y in pairs:
            gap = int((x.view(torch.int32).long()
                       - y.view(torch.int32).long()).abs().max())
            if gap:
                gaps[(i, name)] = gap
        if "step" in a and not torch.equal(a["step"], b["step"]):
            gaps[(i, "step")] = float(a["step"] - b["step"])
    return gaps


@pytest.mark.parametrize("cell", list(_ADAM_TABLES))
def test_adam_kernel_equals_foreach_adam(cuda_device, cell):
    """50 steps of the kernel Adam and of torch's foreach Adam, two groups,
    the staircase lr, at the cell's table plus the MLPs and per-frame
    arrays: every parameter, moment and step count bit-equal (on failure
    the message gives the largest gap in ulps by tensor), two launches a
    step."""
    from bundlesdf_tpu_torch.nof.train import TrainConfig, lr_factor_at
    g = torch.Generator(device=cuda_device).manual_seed(7)
    mine, opt, ref, ref_opt = _adam_pair(
        [(_ADAM_TABLES[cell], 2)] + _ADAM_SHAPES, cuda_device, g)
    tcfg, before = TrainConfig(), profiling.snapshot()
    for step in range(50):
        for p, q in zip(mine, ref):
            p.grad = q.grad = _adam_grad(p.shape, cuda_device, g)
        f = lr_factor_at(step, tcfg, 50)
        for o in (opt, ref_opt):
            for group in o.param_groups:
                group["lr"] = group["base_lr"] * f
            o.step()
    torch.cuda.synchronize()
    assert _counts(before, "adam.launches") == [100]
    assert _ulp_gaps(mine, opt, ref, ref_opt) == {}


def test_adam_kernel_on_unaligned_ragged_and_missing_gradients(cuda_device):
    """The kernel's element-wise tail and its unaligned path (a parameter
    and gradient 4 bytes off a 16-byte boundary), lerp's large-weight
    form (beta1 0.3), and gradients that are None on every other step for
    one parameter (so the tensors' step counts, and with them the bias
    corrections, differ within a group): bit-equal to torch's foreach
    Adam over 20 steps."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = [(1027,), (5, 3), (4099, 2), (7,)]
    mine, opt, ref, ref_opt = _adam_pair(shapes, cuda_device, g,
                                         betas=(0.3, 0.99), lrs=(0.05, 0.02))
    for ps in (mine, ref):     # 4 bytes into a fresh allocation
        base = torch.zeros(1028, device=cuda_device)
        base[1:] = ps[0].detach()
        ps[0].data = base[1:]
    assert mine[0].data_ptr() % 16 == 4 and mine[0].is_contiguous()
    for step in range(20):
        for i, (p, q) in enumerate(zip(mine, ref)):
            if i == 1 and step % 2:
                p.grad = q.grad = None
                continue
            grad = _adam_grad(p.shape, cuda_device, g)
            if i == 0:
                gbase = torch.zeros(1028, device=cuda_device)
                gbase[1:] = grad
                grad = gbase[1:]
            p.grad = q.grad = grad
        opt.step()
        ref_opt.step()
    torch.cuda.synchronize()
    assert float(opt.state[mine[1]]["step"]) == 10.0
    assert _ulp_gaps(mine, opt, ref, ref_opt) == {}


def test_adam_rejects_what_the_kernel_does_not_take(cuda_device):
    from bundlesdf_tpu_torch.ops.adam import Adam
    cases = [
        (torch.zeros(8, dtype=torch.float64, device=cuda_device),
         torch.ones(8, dtype=torch.float64, device=cuda_device), TypeError),
        (torch.zeros(4, 8, device=cuda_device),
         torch.ones(8, 4, device=cuda_device).t(), ValueError)]
    for p, grad, error in cases:
        p = torch.nn.Parameter(p)
        p.grad = grad
        with pytest.raises(error):
            Adam([p], lr=0.1).step()
    p = torch.nn.Parameter(torch.zeros(4, device=cuda_device))
    q = torch.nn.Parameter(torch.zeros(4))
    p.grad, q.grad = torch.ones_like(p), torch.ones_like(q)
    with pytest.raises(ValueError, match="one CUDA device"):
        Adam([p, q], lr=0.1).step()


# custom.refine's frame-feature gather: 2,048 rays x (64 + 256) samples,
# 40 keyframes, 2 features, bf16 compute
_REFINE_RAYS, _REFINE_SAMPLES, _REFINE_FRAMES = 2048, 320, 40


def test_frame_feature_gradient_at_the_refine_shape(cuda_device):
    """At `custom.refine`'s shape the per-ray gather's `feature_array`
    gradient (one index backward row a ray after a float32 sum over its
    samples) agrees with the per-sample gather's (~16,000 samples piled
    on each frame row) within float32 summation-order error: 1e-6 of the
    row's sum of |cotangent|."""
    from bundlesdf_tpu_torch.nof.models import NofField, NofSpec
    spec = NofSpec(grid=HashGridSpec(n_levels=2, base_res=4, finest_res=8,
                                     log2_hashmap_size=8),
                   frame_features=2, n_frames=_REFINE_FRAMES)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    field = NofField(spec, generator=torch.Generator().manual_seed(0)).to(
        cuda_device)
    ids = torch.randint(0, _REFINE_FRAMES, (_REFINE_RAYS,), generator=g,
                        device=cuda_device)
    rows = torch.repeat_interleave(ids, _REFINE_SAMPLES)
    cot = torch.randn((rows.shape[0], 2), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    got = []
    for frame_ids, s in ((ids, _REFINE_SAMPLES), (rows, None)):
        field.zero_grad(set_to_none=True)
        f = field._frame_features(frame_ids, s, torch.bfloat16)
        assert f.shape == (rows.shape[0], 2) and f.dtype == torch.bfloat16
        f.backward(cot)
        got.append(field.feature_array.grad.double())
    abs_sums = torch.zeros_like(got[0]).index_add_(0, rows,
                                                   cot.abs().double())
    assert torch.all((got[0] - got[1]).abs() <= 1e-6 * abs_sums)


def test_replayed_refine_step_counts_its_feature_rows(cuda_device):
    """A runner at `custom.refine`'s rays, samples, keyframes and frame
    features: each replayed step adds 2,048 to `nof.feature_rows`."""
    from nof_tiny import tiny_runner
    r = tiny_runner(device=cuda_device, n_frames=_REFINE_FRAMES,
                    frame_features=2, N_rand=_REFINE_RAYS, N_samples=64,
                    N_samples_around_depth=256)
    r.train(n_steps=2)                     # one eager step, then a capture
    before = profiling.snapshot()
    r.train(n_steps=3)
    assert _counts(before, "nof.graph.replay", "nof.feature_rows") == [
        3, 3 * _REFINE_RAYS]


def test_host_pull_wait_is_its_span(cuda_device):
    """`HostPull.get()` on the card: the wait for the copies is the span
    `pull.<site>`, once; a second `get` waits for nothing."""
    from bundlesdf_tpu_torch.utils.transfer import HostPull
    x = torch.arange(1 << 20, device=cuda_device, dtype=torch.float32)
    before = profiling.snapshot()
    pull = HostPull({"x": x * 2}, "track.test")
    assert pull.get()["x"][-1] == 2 * ((1 << 20) - 1)
    pull.get()
    n = profiling.snapshot()["pull.track.test"][0]
    assert n - before.get("pull.track.test", (0, 0.0))[0] == 1


def _eager_ba(arrays, maps, poses_in=None, **static):
    """The tracker's BA on the padded inputs, eagerly: each array uploaded
    on its own."""
    from bundlesdf_tpu_torch.tracker.ba import bundle_adjust_pooled
    dev = maps["pool_xyzs"].device
    ins = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    if poses_in is not None:
        ins["poses0"] = poses_in
    return bundle_adjust_pooled(**maps, **ins, **static)


class _ReplayAgainstEager:
    """Wraps a bundler's `BAGraphs`: each call (capture or replay) runs with
    the sync check on, and its result is compared with an eager run on the
    same padded inputs."""

    def __init__(self, inner):
        self.inner, self.calls, self.unequal, self.syncs = inner, 0, [], []

    def __call__(self, arrays, maps, poses_in=None, **static):
        import warnings
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.inner(arrays, maps, poses_in, **static)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # each synchronising call warns; the mode's own notice does not count
        self.syncs += [str(w.message) for w in seen
                       if "synchroniz" in str(w.message).lower()
                       and "prototype" not in str(w.message)]
        want = _eager_ba(arrays, maps, poses_in, **static)
        out_t = out if isinstance(out, tuple) else (out,)
        want_t = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(out_t, want_t)):
            self.unequal.append(self.calls)
        self.calls += 1
        return out


@pytest.fixture(scope="module")
def ba_graph_runs(tmp_path_factory):
    """30 frames of an orbit (~2.3 degrees a frame, so the window, the
    correspondences and the keyframes change the BA's padded shapes)
    tracked on the card with the port's ORB: once through the BA's graphs,
    each call checked against an eager run, and once with the eager BA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the BA's CUDA graphs")
    from synthetic import cube_orbit_sequence

    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.tracker.ba import _cos_deg
    seq = cube_orbit_sequence(n_frames=30, H=120, W=160, radius=0.45,
                              obj_size=0.08, full_angle=1.2)
    # the BA's one upload, made once a device before any capture
    _cos_deg(default_track_config()["p2p"]["max_normal_angle"],
             torch.device("cuda", torch.cuda.current_device()))
    out = {}
    for name in ("graph", "eager"):
        cfg = default_track_config()
        cfg["debug_dir"] = str(tmp_path_factory.mktemp(name))
        cfg["SPDLOG"] = 0
        cfg["ransac"]["max_trans_neighbor"] = 0.05
        cfg["ransac"]["max_iter"] = 500
        cfg["bundle"]["max_BA_frames"] = 5
        cfg["bundle"]["depth_association_radius"] = 2
        cfg["feature_corres"]["fused_matcher"] = True
        t = BundleSdf(cfg_track=cfg, start_nerf_keyframes=10 ** 9,
                      device="cuda")
        b = t.bundler
        wrap = b._ba = (_ReplayAgainstEager(b._ba) if name == "graph"
                        else _eager_ba)
        before = profiling.snapshot()
        frames = [t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
                  for i in range(30)]
        t.flush_pipeline()
        out[name] = dict(poses=np.array([f.pose_in_model for f in frames]),
                         wrap=wrap, n_kf=len(b.keyframes),
                         counts=_counts(before, "ba.graph.captures",
                                        "ba.graph.replays"))
    return out


def test_ba_replays_equal_eager_runs(ba_graph_runs):
    """Every BA call of the run, replayed, is bit-equal to the eager BA on
    the same padded inputs; the run's keys changed, each capture was one
    key's first call, and every call replayed."""
    g = ba_graph_runs["graph"]
    wrap = g["wrap"]
    assert wrap.calls >= 20 and wrap.unequal == []
    captures, replays = g["counts"]
    assert replays == wrap.calls and 2 <= captures <= len(wrap.inner)
    assert g["n_kf"] > 8                   # the keyframe bucket changed too


def test_ba_graph_tracker_equals_eager_tracker(ba_graph_runs):
    """The tracker through the BA's graphs against the same tracker with
    the eager BA on the same padded shapes: poses within 1e-6."""
    gap = np.abs(ba_graph_runs["graph"]["poses"]
                 - ba_graph_runs["eager"]["poses"]).max()
    assert gap <= 1e-6
    assert ba_graph_runs["eager"]["counts"] == [0, 0]


def test_ba_capture_and_replay_wait_on_nothing(ba_graph_runs):
    """No call of the graphs, captures included, synchronises with the
    card (`torch.cuda.set_sync_debug_mode`); a capture that waited would
    have failed."""
    wrap = ba_graph_runs["graph"]["wrap"]
    assert wrap.syncs == []


def test_nof_field_is_made_while_another_thread_captures(cuda_device):
    """The threaded online loop builds a NOF field (each keyframe batch)
    while the tracker's thread may capture its BA as a CUDA graph; the
    field's layers draw from the field's generator alone, so neither the
    capture nor the field fails."""
    import threading

    from bundlesdf_tpu_torch.nof.models import NofField, NofSpec
    spec = NofSpec(grid=HashGridSpec(n_levels=2, base_res=4, finest_res=8,
                                     log2_hashmap_size=8))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    made, errors = [], []

    def build():
        try:
            made.append(NofField(spec, generator=gen, device=cuda_device))
        except RuntimeError as e:
            errors.append(e)

    x = torch.zeros(8, device=cuda_device)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        x.add_(1.0)
        t = threading.Thread(target=build)
        t.start()
        t.join()
        graph.capture_end()
    build()                    # the first field made after the capture
    graph.replay()
    torch.cuda.synchronize()
    assert errors == [] and len(made) == 2
    assert torch.equal(x, torch.ones_like(x))
