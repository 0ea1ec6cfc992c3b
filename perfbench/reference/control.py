"""The control of the comparison, and the faults it must catch, planted in
the frozen reference put in the port's place.

- `tf32`: float32 matmuls and convolutions through TF32, the precision
  below the tracker's float32 with TF32 off (the port turns it off).
- `fp8`: the NOF's MLPs in float8 (e4m3, one scale a tensor) where the
  configuration states bfloat16 (`amp`).
- `half_batch`: each NOF step trains on the first half of its ray batch,
  the mean taken over the rest.

Each is a context manager that changes the frozen reference's modules for
its block and restores them after.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def quantize_e4m3(x):
    """@x rounded to float8 e4m3 with one scale for the tensor (its
    absolute maximum onto e4m3's largest value), back in @x's dtype; the
    gradient passes the rounding unchanged, as in fp8 training."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float()
         * scale).to(x.dtype)
    return x + (q - x).detach()


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def fp8():
    from perfbench.reference.frozen.nof import models
    plain = models._mlp

    def mlp_fp8(layers, x, dtype):
        for i, layer in enumerate(layers):
            x = F.linear(quantize_e4m3(x.to(dtype)),
                         quantize_e4m3(layer.weight.to(dtype)),
                         layer.bias.to(dtype))
            if i != len(layers) - 1:
                x = F.relu(x)
        return x

    models._mlp = mlp_fp8
    try:
        yield
    finally:
        models._mlp = plain


@contextlib.contextmanager
def half_batch():
    from perfbench.reference.frozen.nof import train
    plain = train.train_step

    def train_step_half(field, optimizer, batch, *args, **kw):
        n = next(iter(batch.values())).shape[0] // 2
        return plain(field, optimizer, {k: v[:n] for k, v in batch.items()},
                     *args, **kw)

    train.train_step = train_step_half
    try:
        yield
    finally:
        train.train_step = plain


KINDS = {"tf32": tf32, "fp8": fp8, "half_batch": half_batch}
