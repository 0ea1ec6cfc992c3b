"""The share of the window the tracker thread spent in NOF batches: the
growth of the orchestrator's `pipeline_stats` `nerf_prep/dispatch/poll/
sync/post_s` over the window, over the window's wall time."""


def read(window):
    wall, nof_s = window.get("window_s"), window.get("nof_s")
    if not wall or not nof_s:
        return None
    return 100.0 * nof_s / wall
