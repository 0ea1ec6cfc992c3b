"""Device-busy ms of one NOF step: the union of the device intervals on
all streams over the traced steps, divided by their count."""
from perfbench import trace


def read(window):
    ev, n = window.get("events"), window.get("trace_units")
    if not ev or not n:
        return None
    busy_us = trace.union_us(trace.device_events(ev))
    return busy_us / 1e3 / n if busy_us > 0 else None
