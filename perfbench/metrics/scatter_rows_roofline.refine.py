"""The hash-grid backward's scatter kernel (`csrc/scatter_rows.cu`) against
its least time: `roofline.scatter_bound_s` for each launch, over the
device time of the kernel and of its output's zero fill (the device event
just before it on its stream), from the trace."""
from perfbench import roofline, trace


def _is_kernel(name):
    return "scatter_rows" in name


def _is_fill(name):
    n = name.lower()
    return "fill" in n or "memset" in n


def read(window):
    ev, cfg = window.get("events"), window.get("cfg")
    if not ev or not cfg:
        return None
    k_us, n = trace.kernel_us(ev, _is_kernel)
    if n == 0 or k_us <= 0:
        return None
    fill_us = trace.preceding_us(ev, _is_kernel, _is_fill)
    return 100.0 * roofline.scatter_bound_s(cfg) * 1e6 * n / (k_us + fill_us)
