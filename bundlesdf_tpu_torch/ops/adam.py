"""Adam's step as one hand-written CUDA pass a parameter group, and the
optimizer that `nof/train.py::make_optimizer` returns.

`Adam` is `torch.optim.Adam` (the plain one: no amsgrad, weight decay,
maximize, capturable or fused) whose `step()` on CUDA tensors launches the
kernel of `csrc/adam.cu` once for each parameter group, in place of the
seven foreach ops (`_multi_tensor_adam`) that torch issues. The kernel
repeats those ops' float32 arithmetic, op for op and with the same fused
multiply-adds, so it gives the foreach Adam's parameters and moments bit
for bit (the `.cu` header lists the ops). CPU tensors take
`torch.optim.Adam.step` itself, which is the kernel's plain twin.

The optimizer keeps torch's state exactly: `state[p]["step"]` a CPU
float32 tensor (the default scalar dtype) incremented by one a step,
`exp_avg` and `exp_avg_sq` tensors beside the parameter, each created at
the parameter's first step; a parameter whose `.grad` is None is skipped.
So `state_dict`, checkpoints and code that reads the moments work as with
the torch optimizer. Each bias correction is computed on the host in
double from the tensor's step count, as torch computes it, and handed to
the kernel as a float. On CUDA tensors the step launches the kernel or
raises: for a tensor that is not float32, dense and contiguous, for
parameters on more than one device, and (on any device) for a group that
asks for an option the kernel does not compute.

The kernel is built at first use with `nvcc` into `csrc/build/`
(`utils/build.py`) and bound through ctypes. Counter `adam.launches`: one
a launch on the card (one a group and step).
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.optim.optimizer import _get_scalar_dtype

from bundlesdf_tpu_torch.utils.build import build_cuda
from bundlesdf_tpu_torch.utils.profiling import count

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "adam.cu")
# the group options of torch.optim.Adam and the values the kernel computes
PLAIN_OPTIONS = {"amsgrad": False, "weight_decay": 0, "maximize": False,
                 "foreach": None, "capturable": False,
                 "differentiable": False, "fused": None,
                 "decoupled_weight_decay": False}


class AdamTensor(ctypes.Structure):
    """One tensor of a launch (`AdamTensor` in the .cu): the pointers of
    the parameter, its gradient and its two moments, its element count and
    its two bias-corrected scalars."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("step_size", ctypes.c_float),
                ("bc2_sqrt", ctypes.c_float)]


def build_library() -> tuple[str, str]:
    """Compile `csrc/adam.cu` into `csrc/build/` unless a build of the same
    source is already there. Returns (path, compiler output)."""
    return build_cuda("adam", _SOURCE)


@functools.cache
def _library():
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    fn = lib.bsdf_adam_step
    fn.argtypes = [ctypes.POINTER(AdamTensor), ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bsdf_adam_max_tensors.restype = ctypes.c_int
    lib.bsdf_adam_tensor_bytes.restype = ctypes.c_int
    if lib.bsdf_adam_tensor_bytes() != ctypes.sizeof(AdamTensor):
        raise RuntimeError(f"{path}: sizeof(AdamTensor) "
                           f"{lib.bsdf_adam_tensor_bytes()} != ops/adam.py's "
                           f"{ctypes.sizeof(AdamTensor)}")
    return fn, lib.bsdf_adam_max_tensors()


def check_group(group: dict):
    """Raise ValueError unless @group asks for the plain Adam: the options
    at `PLAIN_OPTIONS` and a float lr and betas."""
    for key, plain in PLAIN_OPTIONS.items():
        if group.get(key, plain) != plain:
            raise ValueError(f"Adam: {key}={group[key]!r} is not computed "
                             f"here; only the plain Adam ({key}={plain!r})")
    if not all(isinstance(x, float | int)
               for x in (group["lr"], group["eps"], *group["betas"])):
        raise ValueError("Adam: lr, betas and eps must be Python numbers")


def check_tensors(params, grads, exp_avgs, exp_avg_sqs):
    """Raise unless the kernel takes these tensors: every one float32,
    dense and contiguous, all on one CUDA device, and each parameter's
    gradient and moments of its shape."""
    dev = params[0].device
    for quad in zip(params, grads, exp_avgs, exp_avg_sqs, strict=True):
        shape = quad[0].shape
        for t in quad:
            if t.device != dev:
                raise ValueError(f"Adam: tensors on {t.device} and {dev}; "
                                 f"all must be on one CUDA device")
            if t.dtype != torch.float32:
                raise TypeError(f"Adam: the kernel takes float32, got "
                                f"{t.dtype}")
            if t.layout != torch.strided or not t.is_contiguous():
                raise ValueError("Adam: the kernel takes dense contiguous "
                                 "tensors")
            if t.shape != shape:
                raise ValueError(f"Adam: shapes {tuple(t.shape)} and "
                                 f"{tuple(shape)} of one parameter differ")
    if dev.type != "cuda":
        raise ValueError(f"Adam: the kernel takes CUDA tensors, got {dev}")


def adam_step_cuda(params, grads, exp_avgs, exp_avg_sqs, step_sizes,
                   bc2_sqrts, beta1: float, beta2: float, eps: float):
    """One parameter group's update on the card, in place, on the current
    stream: one launch (more only past the kernel's tensor limit). Each
    tensor's @step_sizes entry is -lr / (1 - beta1^t), its @bc2_sqrts
    entry sqrt(1 - beta2^t), both Python floats (see the module
    docstring). Raises where `check_tensors` does or the launch fails."""
    check_tensors(params, grads, exp_avgs, exp_avg_sqs)
    rows = [AdamTensor(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                       v.data_ptr(), p.numel(), s, b)
            for p, g, m, v, s, b in zip(params, grads, exp_avgs, exp_avg_sqs,
                                        step_sizes, bc2_sqrts, strict=True)
            if p.numel() > 0]
    fn, max_tensors = _library()
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(rows), max_tensors):
            chunk = rows[i:i + max_tensors]
            err = fn((AdamTensor * len(chunk))(*chunk), len(chunk),
                     1 - beta1, beta2, 1 - beta2, eps, stream)
            if err != 0:
                raise RuntimeError(f"adam kernel launch failed: CUDA error "
                                   f"{err}")
            count("adam.launches")


class Adam(torch.optim.Adam):
    """`torch.optim.Adam(params, lr, betas, eps)` whose step on CUDA
    tensors is one kernel launch a group (see the module docstring)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work = []
        for group in self.param_groups:
            check_group(group)
            work.append((group, [p for p in group["params"]
                                 if p.grad is not None]))
        devices = {p.device for _, params in work for p in params}
        if all(d.type == "cpu" for d in devices):
            super().step()
            return loss
        if len(devices) > 1:
            raise ValueError(f"Adam: parameters on {sorted(map(str, devices))}"
                             f"; the kernel takes one CUDA device")
        for group, params in work:
            if params:
                self._step_group(group, params)
        return loss

    def _step_group(self, group, params):
        """torch's `_multi_tensor_adam` on one group, the foreach ops being
        one launch: the state made at a parameter's first step, the step
        counts incremented, the bias corrections in double."""
        grads, exp_avgs, exp_avg_sqs, steps = [], [], [], []
        for p in params:
            state = self.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=_get_scalar_dtype())
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            if state["step"].device.type != "cpu":
                raise ValueError("Adam: the step count must be a CPU tensor, "
                                 "as the plain Adam keeps it")
            grads.append(p.grad)
            exp_avgs.append(state["exp_avg"])
            exp_avg_sqs.append(state["exp_avg_sq"])
            steps.append(state["step"])
        lr, (beta1, beta2), eps = group["lr"], group["betas"], group["eps"]
        step_sizes, bc2_sqrts = [], []
        for s in steps:
            t = s.item() + 1       # the count after this step's increment
            step_sizes.append((lr / (1 - beta1 ** t)) * -1)
            bc2_sqrts.append((1 - beta2 ** t) ** 0.5)
        adam_step_cuda(params, grads, exp_avgs, exp_avg_sqs, step_sizes,
                       bc2_sqrts, beta1, beta2, eps)
        torch._foreach_add_(steps, 1)
