"""Port parity: the PyTorch hash-grid encoder against the numpy golden
(forward) and `jax.grad` of the JAX encoder (table and point gradients).
The spec hashes its two finest levels into 2 x 16,384 rows, so the JAX
backward of those levels runs the Pallas sorted-tile scatter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops import hashgrid as jhg
from bundlesdf_tpu_torch.ops import hashgrid as thg

torch.set_num_threads(2)

# base 8 -> finest 48 over 4 levels: res 8, 14, 26, 48; levels 2-3 hash
_SPEC = dict(n_levels=4, level_dim=2, base_res=8, finest_res=48,
             log2_hashmap_size=14)


def _ray_points(n_rays=64, n_samples=24, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.4, 0.4, (n_rays, 3))
    d = rng.standard_normal((n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.8, (n_rays, n_samples)), axis=1)
    pts = o[:, None] + d[:, None] * t[..., None]
    return np.clip(pts.reshape(-1, 3), -0.99, 0.99).astype(np.float32)


def _table(spec, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1e-1, 1e-1, (spec.total_rows, spec.level_dim)
                       ).astype(np.float32)


@pytest.mark.parametrize("kw", [_SPEC, dict(n_levels=4, level_dim=2,
                                            base_res=16, finest_res=128,
                                            log2_hashmap_size=22)])
def test_layout_matches_jax(kw):
    assert thg.HashGridSpec(**kw).layout() == jhg.HashGridSpec(**kw).layout()


def test_online_layout_rows():
    """The online config: four dense levels, 2,462,164 rows."""
    spec = thg.HashGridSpec()
    assert [d for _, d, _, _ in spec.layout()] == [True] * 4
    assert spec.total_rows == 17 ** 3 + 33 ** 3 + 65 ** 3 + 129 ** 3 == 2462164


@pytest.mark.parametrize("table_bf16", [False, True])
def test_forward_matches_numpy_golden(table_bf16):
    spec = thg.HashGridSpec(**_SPEC, table_bf16=table_bf16)
    x = np.random.default_rng(2).uniform(-1, 1, (512, 3)).astype(np.float32)
    table = _table(spec)
    out = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x),
                              spec)
    assert out.shape == (512, spec.out_dim) and out.dtype == torch.float32
    ref_table = (torch.from_numpy(table).bfloat16().float().numpy()
                 if table_bf16 else table)
    ref = thg.hashgrid_encode_np(ref_table, x, spec)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # the port's golden is a copy of the JAX package's
    np.testing.assert_array_equal(
        ref, jhg.hashgrid_encode_np(ref_table, x, jhg.HashGridSpec(**_SPEC)))


def test_gradients_match_jax():
    x = _ray_points()
    jspec = jhg.HashGridSpec(**_SPEC, scatter_bf16=False, table_bf16=False)
    tspec = thg.HashGridSpec(**_SPEC)
    table = _table(tspec)
    cot = np.random.default_rng(3).standard_normal(
        (x.shape[0], tspec.out_dim)).astype(np.float32)

    def jloss(tab, pts):
        return jnp.sum(jhg.hashgrid_encode(tab, pts, jspec) * cot)

    gt_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(x))
    tab_t = torch.tensor(table, requires_grad=True)
    x_t = torch.tensor(x, requires_grad=True)
    torch.sum(thg.hashgrid_encode(tab_t, x_t, tspec)
              * torch.from_numpy(cot)).backward()
    # f32 both sides; sums of the same terms in another order
    np.testing.assert_allclose(tab_t.grad.numpy(), np.asarray(gt_j),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(gt_j)[jspec.layout()[2][3]:]).max() > 0


def test_hash_rows_match_uint32_arithmetic():
    """The hashed rows reproduce the reference's uint32 prime hash
    (products wrap mod 2^32) for corner coordinates large enough to wrap:
    a level of res 2048 hashed into 2^31 rows keeps 31 of the 32 bits."""
    spec = thg.HashGridSpec(n_levels=2, level_dim=2, base_res=16,
                            finest_res=2048, log2_hashmap_size=31)
    res, dense, _, off = spec.layout()[1]
    assert not dense
    x = np.random.default_rng(4).uniform(-1, 1, (256, 3)).astype(np.float32)
    rows, _ = thg.hashgrid_corners(torch.from_numpy(x), spec)
    x01 = np.clip((x + 1.0) * 0.5, 0.0, 1.0)
    x0 = np.clip(np.floor(x01 * np.float32(res)).astype(np.int64), 0, res - 1)
    c = (x0[:, None, :] + thg._CORNERS[None]).astype(np.uint32)     # (N,8,3)
    with np.errstate(over="ignore"):
        h = ((c[..., 0] * np.uint32(thg._PRIMES[0]))
             ^ (c[..., 1] * np.uint32(thg._PRIMES[1]))
             ^ (c[..., 2] * np.uint32(thg._PRIMES[2])))
    want = (h & np.uint32(spec.table_size - 1)).astype(np.int64) + off
    np.testing.assert_array_equal(rows[:, 1].numpy().astype(np.int64), want)


def test_gather_rows_sentinel_gathers_zero_and_drops_gradient():
    table = torch.arange(8, dtype=torch.float32).reshape(4, 2).requires_grad_()
    rows = torch.tensor([1, 4, 1, 3], dtype=torch.int32)
    got = thg.GatherRows.apply(table, rows, torch.float32)
    assert torch.equal(got[1], torch.zeros(2))
    got.sum().backward()
    assert torch.equal(table.grad[:, 0], torch.tensor([0.0, 2.0, 0.0, 1.0]))


def test_gather_rows_hands_the_scatter_group_l8(monkeypatch):
    """hashgrid_encode tells the scatter that a point's L*8 rows repeat at
    that stride (the kernel sums runs along it); the gradient is the same
    as without the hint."""
    spec = thg.HashGridSpec(**_SPEC)
    orig = thg.scatter_rows
    seen = []

    def recorder(vals, rows, n_rows, group=1):
        seen.append(group)
        return orig(vals, rows, n_rows, group=group)

    x = torch.from_numpy(_ray_points(8, 16))
    grads = []
    for hook in (recorder, orig):
        monkeypatch.setattr(thg, "scatter_rows", hook)
        table = torch.from_numpy(_table(spec)).requires_grad_()
        thg.hashgrid_encode(table, x, spec).square().sum().backward()
        grads.append(table.grad)
    assert seen == [spec.n_levels * 8]
    assert torch.equal(grads[0], grads[1])


def test_ray_points_repeat_rows_at_stride_l8():
    """The layout the scatter kernel relies on: for ray-ordered points
    (samples sorted along each ray, as the renderer queries them) a
    (level, corner) column of consecutive samples repeats its row, so the
    flat rows repeat at a stride of L*8 entries -- in runs longer than one
    sample at the coarse levels -- and never at stride 1."""
    spec = thg.HashGridSpec()                      # the online grid
    rng = np.random.default_rng(5)
    n_rays, n_samples = 32, 192
    o = rng.uniform(-0.3, 0.3, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.6, (n_rays, n_samples, 1)), axis=1)
    x = np.clip((o + d * t).reshape(-1, 3), -0.99, 0.99).astype(np.float32)
    rows, _ = thg.hashgrid_corners(torch.from_numpy(x), spec)
    flat = rows.reshape(-1)
    g = spec.n_levels * 8
    assert not torch.any(flat[1:] == flat[:-1])
    assert torch.any(flat[g:] == flat[:-g])
    per_ray = rows.reshape(n_rays, n_samples, spec.n_levels, 8)
    new_run = torch.ones_like(per_ray, dtype=torch.bool)
    new_run[:, 1:] = per_ray[:, 1:] != per_ray[:, :-1]
    mean_run = n_rays * n_samples * 8 / new_run.sum(dim=(0, 1, 3)).double()
    assert mean_run[0] > 1.0
    # coarser levels, longer runs
    assert torch.all(mean_run[:-1] > mean_run[1:])


# The three configurations' grids: the online one as it is, and the two
# refines' level counts and pattern of dense and hashed levels at small
# tables (`custom`: 16 dense levels; `ho3d`: levels 12-15 hashed).
_GRIDS = {
    "online": dict(),
    "refine_dense16": dict(n_levels=16, level_dim=2, base_res=4,
                           finest_res=32, log2_hashmap_size=16),
    "refine_hashed4": dict(n_levels=16, level_dim=2, base_res=4,
                           finest_res=64, log2_hashmap_size=15),
}


def test_the_grids_have_the_configurations_patterns():
    dense = {k: [d for _, d, _, _ in thg.HashGridSpec(**kw).layout()]
             for k, kw in _GRIDS.items()}
    assert dense == {"online": [True] * 4, "refine_dense16": [True] * 16,
                     "refine_hashed4": [True] * 12 + [False] * 4}
    full = {"refine_dense16": dict(n_levels=16, finest_res=256,
                                   log2_hashmap_size=24),
            "refine_hashed4": dict(n_levels=16, finest_res=512,
                                   log2_hashmap_size=24)}
    for k, kw in full.items():
        assert [d for _, d, _, _ in thg.HashGridSpec(**kw).layout()] \
            == dense[k]


def _edge_points(spec, n_rays=48, n_samples=32, seed=6):
    """Ray-ordered points, some beyond [-1, 1], plus points on cell faces
    of every level and on the cube's faces: where floor, clamp and the
    clamp's gradient mask decide."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 1.2, (n_rays, n_samples, 1)), axis=1)
    pts = [(o + d * t).reshape(-1, 3)]
    for res, _, _, _ in spec.layout():
        k = rng.integers(0, res + 1, (16, 3))
        pts.append(2.0 * k / res - 1.0)                  # on cell faces
    pts.append(np.array([[-1, 1, 0], [1, -1, 1], [-1.0, -1.0, -1.0],
                         [1.0, 1.0, 1.0], [-1.5, 0.2, 2.0]]))
    return np.concatenate(pts).astype(np.float32)


def _record_scatter(monkeypatch):
    seen, orig = [], thg.scatter_rows

    def recorder(vals, rows, n_rows, group=1):
        seen.append((vals.clone(), rows.clone(), n_rows, group))
        return orig(vals, rows, n_rows, group=group)

    monkeypatch.setattr(thg, "scatter_rows", recorder)
    return seen


def _launches():
    from bundlesdf_tpu_torch.utils import profiling
    return profiling.snapshot().get("hashgrid.launches", (0, 0.0))[0]


@pytest.mark.parametrize("table_bf16", [False, True])
@pytest.mark.parametrize("grid", list(_GRIDS))
def test_backward_twin_matches_autograd(grid, table_bf16, monkeypatch):
    """`hashgrid_encode_backward_torch`, the kernels' backward written out,
    against autograd through the plain path: the scatter's input (values
    rounded to the gather's type, rows) bit-equal, hence the same table
    gradient; dx within float32 summation order, zero where the clamp
    holds a coordinate."""
    spec = thg.HashGridSpec(**_GRIDS[grid], table_bf16=table_bf16)
    x = torch.from_numpy(_edge_points(spec)).requires_grad_()
    table = torch.from_numpy(_table(spec)).requires_grad_()
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (x.shape[0], spec.out_dim)).astype(np.float32))
    seen = _record_scatter(monkeypatch)
    torch.sum(thg.hashgrid_encode(table, x, spec) * cot).backward()
    vals, rows, dx = thg.hashgrid_encode_backward_torch(
        table.detach(), x.detach(), cot, spec)
    (v_ag, r_ag, n_rows, group), = seen
    assert vals.dtype == (torch.bfloat16 if table_bf16 else torch.float32)
    assert torch.equal(vals, v_ag) and torch.equal(rows, r_ag)
    assert (n_rows, group) == (spec.total_rows, spec.n_levels * 8)
    assert torch.equal(thg.scatter_rows(vals, rows, n_rows, group=group),
                       table.grad)
    scale = float(x.grad.abs().max())
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-6 * scale)
    outside = ((x.detach() < -1) | (x.detach() > 1))
    assert outside.any() and torch.all(dx[outside] == 0)
    assert torch.all(x.grad[outside] == 0)
    assert torch.all(dx[~outside] != 0)


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_backward_twin_table_gradient_matches_jax(grid):
    """The twin's table gradient (its values and rows through the scatter)
    against `jax.grad` of the JAX encoder, float32 both sides."""
    kw = _GRIDS[grid]
    spec = thg.HashGridSpec(**kw)
    jspec = jhg.HashGridSpec(**kw, scatter_bf16=False, table_bf16=False)
    x = _ray_points(n_rays=32, n_samples=24, seed=8)
    table = _table(spec, seed=9)
    cot = np.random.default_rng(10).standard_normal(
        (x.shape[0], spec.out_dim)).astype(np.float32)
    g_j = jax.grad(lambda tab: jnp.sum(
        jhg.hashgrid_encode(tab, jnp.asarray(x), jspec) * cot))(
        jnp.asarray(table))
    vals, rows, _ = thg.hashgrid_encode_backward_torch(
        torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(cot),
        spec)
    got = thg.scatter_rows(vals, rows, spec.total_rows,
                           group=spec.n_levels * 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(g_j)).max() > 0


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_encode_on_the_cpu_takes_the_plain_path(grid):
    """On CPU tensors `hashgrid_encode` is `hashgrid_encode_torch`, bit for
    bit, its gradient through `GatherRows`; no kernel is launched."""
    spec = thg.HashGridSpec(**_GRIDS[grid], table_bf16=True)
    x = torch.from_numpy(_edge_points(spec))
    table = torch.from_numpy(_table(spec)).requires_grad_()
    n0 = _launches()
    out = thg.hashgrid_encode(table, x, spec)
    assert out.grad_fn is not None and "HashGridKernels" not in \
        type(out.grad_fn).__name__
    assert torch.equal(out, thg.hashgrid_encode_torch(table, x, spec))
    out.sum().backward()
    assert table.grad.abs().sum() > 0
    assert _launches() == n0


@pytest.mark.parametrize("grid", list(_GRIDS) + ["refine_custom",
                                                 "refine_ho3d"])
def test_kernel_layout_is_the_spec_layout(grid):
    """What the kernels get of a spec: per-level resolutions and offsets,
    the dense levels as bits, the hash mask; the configurations' refine
    grids fit the kernels' 16 levels and int32 rows."""
    kw = {"refine_custom": dict(n_levels=16, finest_res=256,
                                log2_hashmap_size=24),
          "refine_ho3d": dict(n_levels=16, finest_res=512,
                              log2_hashmap_size=24)}.get(grid, _GRIDS.get(grid))
    spec = thg.HashGridSpec(**kw)
    res, offs, dense, mask = thg.kernel_layout(spec)
    layout = spec.layout()
    assert list(res) == [r for r, _, _, _ in layout]
    assert list(offs) == [o for _, _, _, o in layout]
    assert [bool(dense >> lvl & 1) for lvl in range(len(layout))] \
        == [d for _, d, _, _ in layout]
    assert mask == spec.table_size - 1
    assert spec.n_levels <= thg.MAX_LEVELS and spec.total_rows < 2 ** 31


def test_points_and_table_on_two_devices_raise():
    """Tensors that are not both on the CPU go to the kernels, which take
    only CUDA tensors: no silent fallback to the plain path."""
    spec = thg.HashGridSpec(**_SPEC)
    table = torch.from_numpy(_table(spec))
    with pytest.raises(ValueError, match="CUDA device"):
        thg.hashgrid_encode(table, torch.zeros((4, 3), device="meta"), spec)
