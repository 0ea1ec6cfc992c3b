"""The port's CUDA kernel on the card: `scatter_rows` against its plain
PyTorch version, the hash-grid gradient through it against PyTorch's own
gather backward, and the wrapper's input checks. Every test needs a CUDA
card and skips without one.

This file imports no jax, so it also runs where jax is not installed:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch.ops.hashgrid import (HashGridSpec, hashgrid_corners,
                                              hashgrid_encode)
from bundlesdf_tpu_torch.ops.scatter import scatter_rows, scatter_rows_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scatter_rows kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _case(M, D, C, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, D, M).astype(np.int32)
    rows[rng.random(M) < 0.1] = D                     # sentinels
    rows[rng.choice(M, 4096, replace=False)] = D // 3  # one hot row
    vals = rng.standard_normal((M, C)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(rows)


@pytest.mark.parametrize("C,dtype", [(2, torch.float32), (2, torch.bfloat16),
                                     (16, torch.bfloat16), (3, torch.float32)])
def test_kernel_matches_plain(cuda_device, C, dtype):
    vals, rows = _case(1 << 18, 70000, C, seed=C)
    v, r = vals.to(cuda_device, dtype), rows.to(cuda_device)
    before = scatter_rows.launches
    out = scatter_rows(v, r, 70000)
    torch.cuda.synchronize()
    assert scatter_rows.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (70000, C)
    # only the order of the f32 atomic adds differs
    torch.testing.assert_close(out, scatter_rows_torch(v, r, 70000),
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
