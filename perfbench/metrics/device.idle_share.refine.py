"""The device's idle share in the window: 1 minus the device-busy time of
the window's work over its wall time. The busy time of one unit of work (a
step) is the union of the device intervals on all streams over the traced
slice, which runs just before the window, divided by its units; the
window's units and wall time come from the untraced window, so the
profiler's host cost does not count as idle."""
from perfbench import trace


def read(window):
    ev, n_tr = window.get("events"), window.get("trace_units")
    units, wall = window.get("units"), window.get("window_s")
    if not ev or not n_tr or not units or not wall:
        return None
    busy_s = trace.union_us(trace.device_events(ev)) / 1e6
    if busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / n_tr * units / wall)
