"""The port on the card: the `scatter_rows` CUDA kernel against its plain
PyTorch version (uniform rows, and runs of equal rows at the encoder's
stride, with and without the `group` hint), the hash-grid gradient through
it against PyTorch's own gather backward, the wrapper's input checks, and the tracker programs
(depth chain into the pool, fused ORB match + lift + RANSAC, bundle
adjustment) and the port's ORB detector (`matcher/orb.py`, with a mask,
through the matcher's stream) on the card against the same calls on the
CPU, at small shapes. Every test needs a CUDA card and skips without one.

This file imports no jax, so it also runs where jax is not installed:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

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


def _launches():
    return profiling.snapshot().get("scatter_rows.launches", (0, 0.0))[0]


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
    """Three NOF steps of a tiny runner on the card under `device_trace`:
    `device_ms_by_range` gives device time to the render, the backward
    (whose kernels autograd's device thread launches, with no range of
    its own open) and Adam."""
    from nof_tiny import tiny_runner
    from bundlesdf_tpu_torch.utils.profiling import (device_trace,
                                                     load_trace, trace_path)
    runner = tiny_runner(device=cuda_device)
    runner.train(n_steps=2)            # warm-up: the kernel's build
    with device_trace(str(tmp_path), device=cuda_device):
        runner.train(n_steps=3)
    got = profiling.device_ms_by_range(load_trace(trace_path(str(tmp_path))))
    for name in ("nof.render", "nof.backward", "nof.adam"):
        assert got.get(name, 0.0) > 0.0, (name, got)


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
