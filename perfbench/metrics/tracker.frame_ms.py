"""The tracker's own wall ms a frame: the mean, over the window's frames,
of the sum of the port's `stage_stats` stages other than `detect`, less
the NOF batches' time that the orchestrator's counters show inside those
stages (`pipeline_stats`' `nerf_*_s`, which the `ba_finish_prev` and
`finalize` stages enclose in the online loop)."""


def read(window):
    stages, n = window.get("stages"), window.get("frames")
    if not stages or not n:
        return None
    total = sum(v for d in stages for k, v in d.items() if k != "detect")
    return 1e3 * (total - window.get("nof_s", 0.0)) / n
