"""Port parity: `bundlesdf_tpu_torch.ops.scatter.scatter_rows` (its plain
path, taken for CPU tensors) against the JAX package's Pallas sorted-tile
scatter (interpret mode on the CPU) and its plain XLA scatter. The CUDA
kernel itself is tested on the card by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.ops.scatter import scatter_rows_sorted_tiles, scatter_rows_xla
from bundlesdf_tpu_torch.ops.scatter import scatter_rows
from bundlesdf_tpu_torch.utils import profiling
from scatter_cases import runs_case

torch.set_num_threads(2)


def _case(M, D, C, frac_sentinel=0.1, hot=0, seed=0):
    """rows with ~frac_sentinel sentinels (== D) and @hot copies of one row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, D, M).astype(np.int32)
    rows[rng.random(M) < frac_sentinel] = D
    if hot:
        rows[rng.choice(M, hot, replace=False)] = D // 3
    vals = rng.standard_normal((M, C)).astype(np.float32)
    return rows, vals


@pytest.mark.parametrize("C", [2, 16])
@pytest.mark.parametrize("D,M", [(5000, 4096), (70000, 8192)])
def test_scatter_rows_matches_jax(D, M, C):
    rows, vals = _case(M, D, C, hot=M // 8, seed=D + C)
    # f32 accumulation in both stacks; only the summation order differs
    tiles = np.asarray(scatter_rows_sorted_tiles(
        jnp.asarray(vals), jnp.asarray(rows), D, bf16=False))
    xla = np.asarray(scatter_rows_xla(jnp.asarray(vals), jnp.asarray(rows), D))
    out = scatter_rows(torch.from_numpy(vals), torch.from_numpy(rows), D)
    assert out.dtype == torch.float32 and out.shape == (D, C)
    np.testing.assert_allclose(out.numpy(), tiles, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), xla, rtol=1e-5, atol=1e-5)


def test_scatter_rows_bf16_vals_accumulate_in_f32():
    rows, vals = _case(4096, 300, 2, hot=2048, seed=3)
    v16 = torch.from_numpy(vals).bfloat16()
    out = scatter_rows(v16, torch.from_numpy(rows), 300)
    # the reference sums the same bf16 values in float64: only f32
    # rounding of a ~2k-term sum separates them
    ref = np.zeros((300, 2))
    keep = rows < 300
    np.add.at(ref, rows[keep], v16.float().numpy()[keep].astype(np.float64))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_scatter_rows_drops_out_of_range_rows():
    rows = torch.tensor([0, 3, 4, -1, 2, 3], dtype=torch.int32)
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    out = scatter_rows(vals, rows, 4)
    want = torch.tensor([[0, 1], [0, 0], [8, 9], [2 + 10, 3 + 11]],
                        dtype=torch.float32)
    assert torch.equal(out, want)


@pytest.mark.parametrize("group", [1, 8, 32])
def test_scatter_rows_group_changes_no_result(group):
    """`group` is a layout hint: on the CPU, runs of equal rows at that
    stride sum to what group=1 and the JAX sorted-tile scatter give."""
    vals, rows = runs_case(6400 // group, group, 3000, 2, seed=group,
                           negative=False)
    v, r = torch.from_numpy(vals), torch.from_numpy(rows)
    out = scatter_rows(v, r, 3000, group=group)
    assert torch.equal(out, scatter_rows(v, r, 3000))
    tiles = np.asarray(scatter_rows_sorted_tiles(
        jnp.asarray(vals), jnp.asarray(rows), 3000, bf16=False))
    np.testing.assert_allclose(out.numpy(), tiles, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [0, -3, 2.0, None])
def test_scatter_rows_rejects_a_bad_group(group):
    with pytest.raises(ValueError, match="group"):
        scatter_rows(torch.ones(4, 2), torch.zeros(4, dtype=torch.int32), 2,
                     group=group)


def _launches():
    return profiling.snapshot().get("scatter_rows.launches", (0, 0.0))[0]


def test_cpu_path_launches_nothing_and_other_devices_raise():
    before = _launches()
    scatter_rows(torch.ones(3, 2), torch.zeros(3, dtype=torch.int32), 2)
    assert _launches() == before
    assert not hasattr(scatter_rows, "launches")
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows(torch.ones(3, 2, device="meta"),
                     torch.zeros(3, dtype=torch.int32, device="meta"), 2)
