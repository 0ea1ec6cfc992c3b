"""A frozen copy of the modules of `bundlesdf_tpu_torch` that the
benchmark's cells drive, as of the commit that added the benchmark: the
reference that decides `correct`. It imports nothing of the port. It is a
snapshot of the port, not an independent implementation: it computes
what the port computed then, so it catches what a later change breaks,
and what the port got wrong then it shares. What holds the port itself to
an independent reference is the repository's CPU tests against the JAX
package (`tests/test_torch_*.py`; `PERF.md` section 2 names them). Two
pieces differ from the port: the hash-grid backward runs the plain
`index_add_` (`ops/scatter.py`), never the port's CUDA kernel; and only
the synchronous path is kept: no worker thread, asynchronous batches,
CUDA streams, data parallelism, artifacts, meshes or YAML, which no cell's
comparison reaches.

The port's own docstring follows.

bundlesdf_tpu_torch — the PyTorch + CUDA port of `bundlesdf_tpu`.

The JAX package `bundlesdf_tpu` is the reference; this package keeps its
module layout and names (`ops/scatter.py`, `ops/hashgrid.py`,
`nof/render.py`, ...) so each module's counterpart is found by path. It
imports torch and never jax.

Ported so far: the Neural Object Field training step (`nof.runner.NofRunner`
→ `train()`), with the hash-grid table gradient running through a
hand-written CUDA kernel (`csrc/scatter_rows.cu`, bound in
`ops/scatter.py`); and the per-frame tracker, tracker-only
(`bundlesdf.BundleSdf.run` over `tracker/`, `matcher/`,
`ops/preprocess.py`).

The entry points (`NofRunner`, `BundleSdf` and the tracker parts they
build) run on the CUDA card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose/geometry math must not silently round through TF32: float32 matmuls
# and convolutions run in full precision (the JAX package forces "highest"
# matmul precision for the same reason). Speed-critical NOF matmuls opt
# into bf16 via explicit dtypes under `amp`.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> _torch.device:
    """`torch.device(device)`; raises if it names CUDA and no card is
    visible, so an entry point never falls back to the CPU by itself."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is visible; pass "
                           f"device='cpu' to run on the CPU")
    return dev
