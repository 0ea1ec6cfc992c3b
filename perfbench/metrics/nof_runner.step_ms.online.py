"""Wall ms a NOF step in the online loop: the tracker thread's NOF-batch
seconds in the window (`pipeline_stats`' `nerf_*_s`) over the
`nof_steps_total` steps the window's batches added."""


def read(window):
    nof_s, steps = window.get("nof_s"), window.get("nof_steps")
    if not nof_s or not steps:
        return None
    return 1e3 * nof_s / steps
