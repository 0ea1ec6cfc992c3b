"""Share of the traced frames' bundle-adjustment dispatches that replayed
a captured CUDA graph: 100 x the program's `ba_dispatch` ranges that hold
a `ba.graph.replay` range, over all its `ba_dispatch` ranges in the traced
slice. None where the slice holds no replay (a program without the
graph)."""
from perfbench import spans


def _intervals(events, name):
    out = []
    for e in events or ():
        if e.get("name") == spans.PREFIX + name and spans._host(e):
            t = float(e.get("ts", 0.0))
            out.append((t, t + float(e.get("dur", 0.0))))
    return out


def read(window):
    events = window.get("events")
    replays = _intervals(events, "ba.graph.replay")
    dispatches = _intervals(events, "ba_dispatch")
    if not replays or not dispatches:
        return None
    held = sum(any(a <= s and e <= b for s, e in replays)
               for a, b in dispatches)
    return 100.0 * held / len(dispatches)
