"""Host ms a frame in the LoFTR matcher: the seconds of the program's
`loftr.pairing` (the pairs' canonicalising warp) and `loftr.predict` (the
batched forwards and the one host pull, waits included) spans in the
traced slice, over its frames. None where the slice holds no such span."""
from perfbench import spans


def read(window):
    n = window.get("trace_units")
    if not n:
        return None
    secs = spans.ranges(window.get("events"),
                        lambda s: s in ("loftr.pairing", "loftr.predict"))
    return 1e3 * sum(secs) / n if secs else None
