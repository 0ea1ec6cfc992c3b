"""Multiresolution hash-grid encoder (instant-NGP style) in PyTorch.

Port of `bundlesdf_tpu/ops/hashgrid.py` with the SAME flat table layout
(`HashGridSpec.layout`: exact rows per level, level resolution
`floor(base * b**l)`, no +0.5 offset), so tables move between the two
packages unchanged. Dense levels index (res+1)^3 rows directly; levels
larger than the table size use the NGP prime hash.

`hashgrid_encode` on CUDA tensors runs two hand-written kernels
(`csrc/hashgrid.cu`, whose header says what bounds them) through the
autograd Function `HashGridKernels`: the forward gathers and interpolates
each (point, level) in registers; the backward recomputes the cells from
the points, writes the per-corner values and rows that the row
scatter-add (`ops/scatter.py::scatter_rows`) turns into the table
gradient, and the point gradient. CUDA tensors take the kernels or raise.
CPU tensors take the plain version, `hashgrid_encode_torch`: the corner
rows and weights as tensors (`hashgrid_corners`) and `GatherRows`, an
autograd Function whose backward is the same scatter. Both give the exact
gradient -- what the JAX encoder computes with `ray_mode=False`, or in ray
mode with a run budget that never clamps; `hashgrid_encode_backward_torch`
writes the kernels' backward out in plain torch. The JAX package's TPU
machinery (packed-corner rolls, run dedup with two-tier budgets, the
12-bit id-split einsum, scatter engine choice and `lax.cond` fallbacks) is
deliberately not carried over.

The point gradient flows through the trilinear weights (the pose gradient
of the NOF step depends on it).
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from bundlesdf_tpu_torch.ops.scatter import scatter_rows
from bundlesdf_tpu_torch.utils.build import build_cuda
from bundlesdf_tpu_torch.utils.profiling import count

# NGP spatial hash primes (must match gridencoder.cu for weight ports).
_PRIMES = (1, 2654435761, 805459861)

# the 8 unit-cube corner offsets, fixed order
_CORNERS = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.int32)

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "hashgrid.cu")
# levels the kernels take (kMaxLevels in the .cu, checked when the library
# loads) and feature widths they are built for
MAX_LEVELS = 16
KERNEL_WIDTHS = (1, 2, 4, 8)


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


@functools.cache
def _layout_constants(spec: HashGridSpec, device: torch.device):
    """The layout's constants on @device, made once per (spec, device):
    each is a host->device copy that waits for the stream's queued work,
    which a training step must not do (and a CUDA graph cannot capture).
    Returns (res float (L,), res - 1 (L,), res + 1 (L,), corners bool
    (1,1,8,3), corners int64 (1,1,8,3), dense bool (L,) or None when every
    level is dense, offsets int64 (L,))."""
    layout = spec.layout()
    res_i = torch.tensor([r for r, _, _, _ in layout], dtype=torch.int64,
                         device=device)
    corners = torch.as_tensor(_CORNERS, device=device)           # (8,3)
    dense = None if all(d for _, d, _, _ in layout) else torch.tensor(
        [d for _, d, _, _ in layout], device=device)
    offs = torch.tensor([o for _, _, _, o in layout], dtype=torch.int64,
                        device=device)
    return (res_i.float(), res_i - 1, res_i + 1, corners.bool()[None, None],
            corners.long()[None, None], dense, offs)


def _cells(x, spec: HashGridSpec):
    """Each (point, level)'s cell: its low corner x0 (N,L,3) int64 and the
    position w (N,L,3) float32 inside it (differentiable in x)."""
    res_f, res_m1 = _layout_constants(spec, x.device)[:2]
    x01 = torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0)
    xl = x01[:, None, :] * res_f[None, :, None]                   # (N,L,3)
    x0 = torch.minimum(torch.floor(xl).long().clamp(min=0),
                       res_m1[None, :, None])
    return x0, xl - x0.float()


def hashgrid_corners(x, spec: HashGridSpec):
    """Flat-table rows and trilinear weights of every (point, level,
    corner). @x: (N,3) in [-1,1]. Returns rows (N,L,8) int32 and weights
    (N,L,8) float32 (differentiable in x)."""
    _, _, res_p1, cb, corners, dense, offs = _layout_constants(spec, x.device)
    x0, w = _cells(x, spec)
    f = torch.where(cb, w[:, :, None, :], 1.0 - w[:, :, None, :])  # (N,L,8,3)
    # the product written out: torch.prod's backward is a cumprod scan
    # that ran ~145 ms a step on the H100 at the online workload
    wc = f[..., 0] * f[..., 1] * f[..., 2]                        # (N,L,8)

    c = x0[:, :, None, :] + corners                               # (N,L,8,3)
    S = res_p1[None, :, None]
    rows = (c[..., 0] * S + c[..., 1]) * S + c[..., 2]            # dense ids
    if dense is not None:
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
    CPU tensors take `hashgrid_encode_torch`; CUDA tensors the kernels
    (`HashGridKernels`), or raise on what they do not take.
    """
    if table.device.type == "cpu" and x.device.type == "cpu":
        return hashgrid_encode_torch(table, x, spec)
    return HashGridKernels.apply(table, x.float().contiguous(), spec)


def hashgrid_encode_torch(table, x, spec: HashGridSpec):
    """The plain version of `hashgrid_encode`: corner rows and weights as
    tensors, the gather through `GatherRows`."""
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


def hashgrid_encode_backward_torch(table, x, g, spec: HashGridSpec):
    """The kernels' backward written out in plain torch, op for op in the
    kernel's order: for the cotangent @g (N, L*C) of `hashgrid_encode`
    returns (vals (N*L*8, C), rows (N*L*8,) int32, dx (N, 3)). vals and
    rows are the scatter's input in (point, level, corner) order, vals[e]
    = g * wc rounded to the gather's type, so the table gradient is
    `scatter_rows(vals, rows, total_rows, group=L*8)`; dx is dL/dx, the
    levels summed in order."""
    with torch.no_grad():
        N, L, C = x.shape[0], spec.n_levels, table.shape[1]
        rows, wc = hashgrid_corners(x, spec)
        _, w = _cells(x, spec)
        dtype = torch.bfloat16 if spec.table_bf16 else torch.float32
        g = g.float().reshape(N, L, 1, C)
        vals = (g * wc[..., None]).to(dtype).reshape(N * L * 8, C)
        f = table.index_select(0, rows.reshape(-1)).to(dtype).float()
        f = f.view(N, L, 8, C)
        d = g[..., 0] * f[..., 0]                          # dL/dwc (N,L,8)
        for k in range(1, C):
            d = d + g[..., k] * f[..., k]
        gw = [torch.zeros_like(w[..., 0]) for _ in range(3)]
        for j, b in enumerate(_CORNERS):
            fk = [w[..., k] if b[k] else 1.0 - w[..., k] for k in range(3)]
            d01 = d[..., j] * fk[2]
            df = (d01 * fk[1], d01 * fk[0], d[..., j] * (fk[0] * fk[1]))
            gw = [gw[k] + df[k] if b[k] else gw[k] - df[k] for k in range(3)]
        res_f = _layout_constants(spec, x.device)[0]
        gxl = torch.stack(gw, dim=-1) * res_f[None, :, None]     # (N,L,3)
        acc = torch.zeros((N, 3), dtype=torch.float32, device=x.device)
        for level in range(L):
            acc = acc + gxl[:, level]
        u = (x.float() + 1.0) * 0.5
        dx = torch.where((u >= 0.0) & (u <= 1.0), acc * 0.5,
                         torch.zeros_like(acc))
    return vals, rows.reshape(-1), dx


def build_library() -> tuple[str, str]:
    """Compile `csrc/hashgrid.cu` into `csrc/build/` unless a build of the
    same source is already there. Returns (path, compiler output)."""
    return build_cuda("hashgrid", _SOURCE)


@functools.cache
def _library():
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    ints = ctypes.POINTER(ctypes.c_int)
    fwd, bwd = lib.bsdf_hashgrid_forward, lib.bsdf_hashgrid_backward
    fwd.argtypes = [ptr, ptr, ptr, ctypes.c_int64, i32, i32, i32, ints, ints,
                    u32, u32, ptr]
    bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int64, i32, i32,
                    i32, ints, ints, u32, u32, ptr]
    fwd.restype = bwd.restype = ctypes.c_int
    lib.bsdf_hashgrid_max_levels.restype = ctypes.c_int
    if lib.bsdf_hashgrid_max_levels() != MAX_LEVELS:
        raise RuntimeError(f"{path}: kMaxLevels "
                           f"{lib.bsdf_hashgrid_max_levels()} != "
                           f"ops/hashgrid.py MAX_LEVELS {MAX_LEVELS}")
    return fwd, bwd


@functools.cache
def kernel_layout(spec: HashGridSpec):
    """The layout as the kernels take it, made once per spec: per-level
    resolutions and row offsets (ctypes int arrays, copied into each
    launch's arguments), the dense levels as a bit mask, and the hash
    mask table_size - 1."""
    layout = spec.layout()
    res = (ctypes.c_int * len(layout))(*[r for r, _, _, _ in layout])
    offs = (ctypes.c_int * len(layout))(*[o for _, _, _, o in layout])
    dense = sum(1 << lvl for lvl, (_, d, _, _) in enumerate(layout) if d)
    return res, offs, dense, spec.table_size - 1


def _check_kernel_inputs(table, x, spec: HashGridSpec):
    if table.device.type != "cuda" or x.device != table.device:
        raise ValueError(f"hashgrid_encode: table on {table.device}, points "
                         f"on {x.device}; both must be on one CUDA device "
                         f"(or both on the CPU)")
    if table.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"hashgrid_encode: the kernels take a float32 table "
                        f"and points, got {table.dtype} and {x.dtype}")
    if table.dim() != 2 or table.shape[0] != spec.total_rows \
            or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"hashgrid_encode: need table ({spec.total_rows}, C)"
                         f" and points (N, 3), got {tuple(table.shape)} and "
                         f"{tuple(x.shape)}")
    C = table.shape[1]
    if C not in KERNEL_WIDTHS or not 0 < spec.n_levels <= MAX_LEVELS \
            or spec.total_rows >= 2 ** 31:
        raise ValueError(f"hashgrid_encode: the kernels take C in "
                         f"{KERNEL_WIDTHS}, 1-{MAX_LEVELS} levels and fewer "
                         f"than 2^31 rows; got C={C}, {spec.n_levels} levels, "
                         f"{spec.total_rows} rows")
    if not (table.is_contiguous() and x.is_contiguous()) \
            or table.data_ptr() % 16:
        raise ValueError("hashgrid_encode: table and points must be "
                         "contiguous, the table 16-byte aligned")


def _launch(fn, spec: HashGridSpec, device, n_points, C, *ptrs):
    res, offs, dense, mask = kernel_layout(spec)
    with torch.cuda.device(device):
        err = fn(*ptrs, n_points, C, int(spec.table_bf16), spec.n_levels, res,
                 offs, dense, mask, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hashgrid kernel launch failed: CUDA error {err}")
    # each launch, read from `profiling.snapshot()`: two an encoder call
    # with a backward, one without
    count("hashgrid.launches")


def _ptr(t):
    return None if t is None else t.data_ptr()


def hashgrid_encode_cuda(table, x, spec: HashGridSpec):
    """The forward kernel: (N, L*C) float32 features of the float32 points
    @x (N, 3) on the card, no autograd."""
    _check_kernel_inputs(table, x, spec)
    N, C = x.shape[0], table.shape[1]
    out = torch.empty((N, spec.n_levels * C), dtype=torch.float32,
                      device=x.device)
    if N:
        _launch(_library()[0], spec, x.device, N, C, x.data_ptr(),
                table.data_ptr(), out.data_ptr())
    return out


def hashgrid_encode_backward_cuda(table, x, g, spec: HashGridSpec,
                                  table_grad=True, x_grad=True):
    """The backward kernel, the card's `hashgrid_encode_backward_torch`:
    (vals, rows, dx) for the cotangent @g, vals and rows None without
    @table_grad, dx None without @x_grad."""
    _check_kernel_inputs(table, x, spec)
    N, L, C = x.shape[0], spec.n_levels, table.shape[1]
    g = g.float().contiguous()
    if g.shape != (N, L * C):
        raise ValueError(f"hashgrid_encode: cotangent {tuple(g.shape)} for "
                         f"features {(N, L * C)}")
    if g.data_ptr() % 16:
        g = g.clone()
    vals = rows = dx = None
    if table_grad:
        dtype = torch.bfloat16 if spec.table_bf16 else torch.float32
        vals = torch.empty((N * L * 8, C), dtype=dtype, device=x.device)
        rows = torch.empty(N * L * 8, dtype=torch.int32, device=x.device)
    if x_grad:
        dx = torch.empty((N, 3), dtype=torch.float32, device=x.device)
    if N and (table_grad or x_grad):
        _launch(_library()[1], spec, x.device, N, C, x.data_ptr(),
                table.data_ptr(), g.data_ptr(), _ptr(vals), _ptr(rows),
                _ptr(dx))
    return vals, rows, dx


class HashGridKernels(torch.autograd.Function):
    """`hashgrid_encode` on CUDA tensors (see the module docstring). Saves
    the table and the points; the backward (not differentiable again: no
    caller builds a double backward) hands the scatter its input through
    this module's `scatter_rows` name, with group L*8."""

    @staticmethod
    def forward(ctx, table, x, spec):
        out = hashgrid_encode_cuda(table, x, spec)
        ctx.save_for_backward(table, x)
        ctx.spec = spec
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        spec = ctx.spec
        need_table, need_x = ctx.needs_input_grad[:2]
        vals, rows, dx = hashgrid_encode_backward_cuda(
            table, x, g, spec, table_grad=need_table, x_grad=need_x)
        d_table = None
        if need_table:
            d_table = scatter_rows(vals, rows, table.shape[0],
                                   group=spec.n_levels * 8)
        return d_table, dx, None


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
