"""ORB detection's wall ms a frame: the mean `detect` stage of the port's
`stage_stats` over the window's frames."""


def read(window):
    stages, n = window.get("stages"), window.get("frames")
    if not stages or not n:
        return None
    total = sum(d.get("detect", 0.0) for d in stages)
    return 1e3 * total / n if total > 0 else None
