"""Host ms a frame that the tracker waits on the card: the seconds of the
program's `pull.track.*` spans (each a wait for a device->host copy, a
`HostPull.get()` or a marked synchronising call) in the traced slice, a
unit of it (a frame in `custom.track`, a NOF batch period in
`custom.online`) times the window's units over its frames, as
`device.idle_share.online` scales the traced slice. None where the slice
holds no such span."""
from perfbench import spans


def read(window):
    n_tr, units, frames = (window.get("trace_units"), window.get("units"),
                           window.get("frames"))
    if not n_tr or not units or not frames:
        return None
    waited = spans.ranges(window.get("events"),
                          lambda n: n.startswith("pull.track."))
    if not waited:
        return None
    return 1e3 * sum(waited) / n_tr * units / frames
