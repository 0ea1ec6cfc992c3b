"""Host ms of one NOF batch's prep in the online loop: the program's span
`nof.prep` (scene bounds, the ray store and the occupancy grid, the
runner's construction or `add_new_frames`), one a batch, over the traced
batch period, which runs under the profiler just before the window. None
where the program has no such span."""
from perfbench import spans


def read(window):
    return spans.mean_ms(window.get("events"), "nof.prep")
