"""Row scatter-add for the hash-grid backward: a CUDA kernel and its plain
PyTorch twin.

Port of `bundlesdf_tpu/ops/scatter.py`. The JAX package rebuilds this
scatter from sorted tiles, one-hot matmuls and a Pallas kernel because a
TPU scatters row by row; on Hopper the same function is one pass of f32
vector atomics, with runs of equal rows summed in registers first
(`csrc/scatter_rows.cu`, whose header says what bounds it).

Contract (as `scatter_rows_sorted_tiles` / `scatter_rows_xla`):
`scatter_rows(vals, rows, n_rows, group=1)` returns an (n_rows, C) float32
tensor `out[r] = sum of vals[m] over rows[m] == r`; a row id outside
[0, n_rows) (the sentinel `n_rows`) is dropped; the sum accumulates in
float32 and `vals` may be float32 or bfloat16. `group` is a hint that
changes no result: the stride between entries whose rows tend to repeat
(the hash-grid encoder's L*8 corners of one sample; 1 for no such
structure). The kernel then sums each run of equal rows along that stride
before one atomic.

The kernel is built at first use with `nvcc` from the `.cu` in this
package into `csrc/build/` (`utils/build.py`) and bound through ctypes: a
plain C entry point builds in seconds, where a PyTorch C++ extension takes
minutes.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from bundlesdf_tpu_torch.utils.build import build_so
from bundlesdf_tpu_torch.utils.profiling import count

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "scatter_rows.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# samples one thread walks along a column when group > 1 (kSamples in the
# .cu, checked when the library loads): a run of equal rows costs one
# atomic per RUN_SAMPLES samples at most
RUN_SAMPLES = 32


def scatter_rows_torch(vals, rows, n_rows: int):
    """Plain PyTorch version: `index_add_` over the in-range rows."""
    keep = (rows >= 0) & (rows < n_rows)
    out = torch.zeros((n_rows, vals.shape[-1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, rows[keep].long(), vals[keep].float())


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "scatter_rows CUDA kernel cannot be built")
    return nvcc


def build_library() -> tuple[str, str]:
    """Compile `csrc/scatter_rows.cu` into `csrc/build/` unless a build of
    the same source is already there. Returns (path, compiler output).
    Raises if the build fails."""
    def command(tmp):
        out = os.path.join(tmp, "libscatter_rows.so")
        return [_find_nvcc(), *NVCC_FLAGS, "-o", out, _SOURCE], out

    return build_so("scatter_rows", [_SOURCE], command, NVCC_FLAGS)


@functools.cache
def _library():
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    fn = lib.bsdf_scatter_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bsdf_scatter_rows_samples.restype = ctypes.c_int
    if lib.bsdf_scatter_rows_samples() != RUN_SAMPLES:
        raise RuntimeError(f"{path}: kSamples {lib.bsdf_scatter_rows_samples()}"
                           f" != ops/scatter.py RUN_SAMPLES {RUN_SAMPLES}")
    return fn


def scatter_rows(vals, rows, n_rows: int, group: int = 1):
    """Row scatter-add (see module docstring). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise -- never a fallback."""
    if not (isinstance(group, int) and 0 < group < 2 ** 31):
        raise ValueError(f"scatter_rows: group must be a positive int, got "
                         f"{group!r}")
    if vals.device.type == "cpu" and rows.device.type == "cpu":
        return scatter_rows_torch(vals, rows, n_rows)
    if vals.device.type != "cuda" or rows.device != vals.device:
        raise ValueError(f"scatter_rows: vals on {vals.device}, rows on "
                         f"{rows.device}; both must be on one CUDA device")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_rows: vals must be float32 or bfloat16, "
                        f"got {vals.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"scatter_rows: rows must be int32, got {rows.dtype}")
    if vals.dim() != 2 or rows.dim() != 1 or rows.shape[0] != vals.shape[0]:
        raise ValueError(f"scatter_rows: need vals (M, C) and rows (M,), got "
                         f"{tuple(vals.shape)} and {tuple(rows.shape)}")
    if not (vals.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_rows: vals and rows must be contiguous")
    if not 0 < n_rows < 2 ** 31:
        raise ValueError(f"scatter_rows: n_rows {n_rows} out of int32 range")
    M, C = vals.shape
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=vals.device)
    if M == 0:
        return out
    fn = _library()
    with torch.cuda.device(vals.device):
        err = fn(vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                 rows.data_ptr(), out.data_ptr(), M, C, n_rows, group,
                 torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error "
                           f"{err}")
    # the launches, read from `profiling.snapshot()` (chip_smoke.py checks
    # that the training step went through the kernel)
    count("scatter_rows.launches")
    return out
