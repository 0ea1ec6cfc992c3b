"""Multiresolution hash-grid encoder (instant-NGP style) in PyTorch.

Port of `bundlesdf_tpu/ops/hashgrid.py` with the SAME flat table layout
(`HashGridSpec.layout`: exact rows per level, level resolution
`floor(base * b**l)`, no +0.5 offset), so tables move between the two
packages unchanged. Dense levels index (res+1)^3 rows directly; levels
larger than the table size use the NGP prime hash.

The encoder gathers the 8 corner rows of every (point, level) straight
from the flat table through `GatherRows`, an autograd Function whose
backward is the CUDA row scatter-add (`ops/scatter.py`): one gather and
one scatter launch per call. This is the exact gradient -- what the JAX
encoder computes with `ray_mode=False`, or in ray mode with a run budget
that never clamps. The JAX package's TPU machinery (packed-corner rolls,
run dedup with two-tier budgets, the 12-bit id-split einsum, scatter
engine choice and `lax.cond` fallbacks) is deliberately not carried over.

The point gradient flows through the trilinear weights in autograd (the
pose gradient of the NOF step depends on it).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bundlesdf_tpu_torch.ops.scatter import scatter_rows
from bundlesdf_tpu_torch.utils.profiling import span

# NGP spatial hash primes (must match gridencoder.cu for weight ports).
_PRIMES = (1, 2654435761, 805459861)

# the 8 unit-cube corner offsets, fixed order
_CORNERS = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.int32)


@dataclass(frozen=True)
class HashGridSpec:
    n_levels: int = 4
    level_dim: int = 2
    base_res: int = 16
    finest_res: int = 128
    log2_hashmap_size: int = 22
    # gather the corner features in bfloat16 (the table and its Adam state
    # stay float32; interpolation runs in float32). The reference stores
    # its whole table in fp16 under AMP.
    table_bf16: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.level_dim

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(np.exp((np.log(self.finest_res) - np.log(self.base_res))
                            / (self.n_levels - 1)))

    def level_res(self) -> np.ndarray:
        b = self.per_level_scale
        return np.floor(self.base_res * b ** np.arange(self.n_levels)).astype(np.int64)

    def layout(self):
        """Per-level (res, is_dense, n_rows, offset) into the flat table."""
        out = []
        off = 0
        for r in self.level_res():
            r = int(r)
            dense = (r + 1) ** 3 <= self.table_size
            n_rows = (r + 1) ** 3 if dense else self.table_size
            out.append((r, dense, n_rows, off))
            off += n_rows
        return out

    @property
    def total_rows(self) -> int:
        return sum(n for _, _, n, _ in self.layout())


def init_hashgrid_params(spec: HashGridSpec, generator=None, device=None,
                         dtype=torch.float32):
    """Uniform(-1e-4, 1e-4) init, as in torch-ngp. Shape (total_rows, C)."""
    table = torch.empty((spec.total_rows, spec.level_dim), dtype=dtype,
                        device=device)
    return table.uniform_(-1e-4, 1e-4, generator=generator)


class GatherRows(torch.autograd.Function):
    """`table[clamp(rows)] * (rows < n_rows)`, cast to @dtype, with the
    table gradient accumulated in float32 by `scatter_rows` (the
    counterpart of the JAX `_packed_gather` custom VJP). @rows: (M,) int32;
    the sentinel `table.shape[0]` gathers zeros and drops out of the
    backward. @group: the stride at which rows tend to repeat, handed to
    the scatter (`hashgrid_encode` passes L*8: one sample's corners)."""

    @staticmethod
    def forward(ctx, table, rows, dtype, group=1):
        n_rows = table.shape[0]
        got = table.index_select(0, rows.clamp(max=n_rows - 1)).to(dtype)
        ctx.save_for_backward(rows)
        ctx.n_rows = n_rows
        ctx.group = group
        ctx.table_dtype = table.dtype
        return got * (rows < n_rows).to(dtype)[:, None]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        d_table = scatter_rows(g.contiguous(), rows, ctx.n_rows,
                               group=ctx.group)
        return d_table.to(ctx.table_dtype), None, None, None


def hashgrid_corners(x, spec: HashGridSpec):
    """Flat-table rows and trilinear weights of every (point, level,
    corner). @x: (N,3) in [-1,1]. Returns rows (N,L,8) int32 and weights
    (N,L,8) float32 (differentiable in x)."""
    layout = spec.layout()
    dev = x.device
    all_dense = all(dense for _, dense, _, _ in layout)
    # the layout's constants: host->device copies, each of which waits for
    # the stream's queued work
    with span("pull.nof.hashgrid"):
        res_i = torch.tensor([r for r, _, _, _ in layout],
                             dtype=torch.int64, device=dev)
        corners = torch.as_tensor(_CORNERS, device=dev)           # (8,3)
        dense = None if all_dense else torch.tensor(
            [d for _, d, _, _ in layout], device=dev)
        offs = torch.tensor([o for _, _, _, o in layout], dtype=torch.int64,
                            device=dev)
    x01 = torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0)
    xl = x01[:, None, :] * res_i.float()[None, :, None]          # (N,L,3)
    x0 = torch.minimum(torch.floor(xl).long().clamp(min=0),
                       (res_i - 1)[None, :, None])
    w = xl - x0.float()                                           # (N,L,3)
    cb = corners.bool()[None, None]                               # (1,1,8,3)
    f = torch.where(cb, w[:, :, None, :], 1.0 - w[:, :, None, :])  # (N,L,8,3)
    # the product written out: torch.prod's backward is a cumprod scan
    # that ran ~145 ms a step on the H100 at the online workload
    wc = f[..., 0] * f[..., 1] * f[..., 2]                        # (N,L,8)

    c = x0[:, :, None, :] + corners.long()[None, None]            # (N,L,8,3)
    S = (res_i + 1)[None, :, None]
    rows = (c[..., 0] * S + c[..., 1]) * S + c[..., 2]            # dense ids
    if not all_dense:
        # int64 products keep the low 32 bits of the reference's uint32
        # arithmetic exact; the mask reproduces its wraparound
        h = ((c[..., 0] * _PRIMES[0]) ^ (c[..., 1] * _PRIMES[1])
             ^ (c[..., 2] * _PRIMES[2])) & 0xFFFFFFFF
        rows = torch.where(dense[None, :, None], rows,
                           h & (spec.table_size - 1))
    return (rows + offs[None, :, None]).to(torch.int32), wc


def hashgrid_encode(table, x, spec: HashGridSpec):
    """Encode points with the multires hash grid.

    @table: (total_rows, C) flat parameters (see HashGridSpec.layout).
    @x: (N, 3) points in [-1, 1].
    Returns (N, L*C) float32 features, differentiable in both arguments.
    """
    N = x.shape[0]
    C = table.shape[1]
    rows, wc = hashgrid_corners(x, spec)
    dtype = torch.bfloat16 if spec.table_bf16 else torch.float32
    # points come ray-major with samples sorted along each ray, so a
    # (level, corner) of consecutive samples often hits the same row: the
    # rows of one point repeat at a stride of L*8 entries
    f = GatherRows.apply(table, rows.reshape(-1), dtype, spec.n_levels * 8)
    f = f.view(N, spec.n_levels, 8, C).float()
    return torch.sum(f * wc[..., None], dim=2).reshape(N, spec.out_dim)


def hashgrid_encode_np(table, x, spec: HashGridSpec):
    """Pure-numpy golden reference for tests (flat table layout)."""
    table = np.asarray(table, np.float64)
    x = np.asarray(x, np.float64)
    C = table.shape[-1]
    x01 = np.clip((x + 1.0) * 0.5, 0.0, 1.0)
    L = spec.n_levels
    out = np.zeros((x.shape[0], L, C))
    for li, (res, dense, n_rows, off) in enumerate(spec.layout()):
        xl = x01 * res
        x0 = np.clip(np.floor(xl).astype(np.int64), 0, res - 1)
        w = xl - x0
        block = table[off:off + n_rows]
        for c in range(8):
            coff = _CORNERS[c]
            corner = x0 + coff
            if dense:
                stride = res + 1
                idx = (corner[:, 0] * stride + corner[:, 1]) * stride + corner[:, 2]
            else:
                idx = ((corner[:, 0] * _PRIMES[0])
                       ^ (corner[:, 1] * _PRIMES[1])
                       ^ (corner[:, 2] * _PRIMES[2])) & (spec.table_size - 1)
            wc = np.prod(np.where(coff.astype(bool), w, 1.0 - w), axis=-1)
            out[:, li] += block[idx] * wc[:, None]
    return out.reshape(x.shape[0], L * C)
