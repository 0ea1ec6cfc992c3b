"""The NOF's Adam kernel (`csrc/adam.cu`, two launches a step: one a
parameter group) against its least time: `adam_bytes.adam_bound_s` a step
over the traced device time of the kernel's launches a step. The window
carries no frame count, so the per-frame arrays (320 of 79-168 million
elements) are left out of the bound. None where the trace holds no such
launch (torch's foreach Adam runs no kernel of that name)."""
from perfbench import adam_bytes, trace


def _is_kernel(name):
    return "adam_step_kernel" in name


def read(window):
    ev, cfg = window.get("events"), window.get("cfg")
    steps = window.get("trace_units")
    if not ev or not cfg or not steps:
        return None
    k_us, n = trace.kernel_us(ev, _is_kernel)
    if n == 0 or k_us <= 0:
        return None
    return 100.0 * adam_bytes.adam_bound_s(cfg) * 1e6 * steps / k_us
