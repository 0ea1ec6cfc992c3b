"""The program's spans as the traced slice shows them.

While a profiler records, each span of `bundlesdf_tpu_torch.utils.
profiling` (`span(name)`) is also the host range `stage:<name>` on the
trace's clock, and `trace.slim` keeps it. The span readers read those
ranges from the slice that `--trace 1` runs before the window, so what
they report is host time under the profiler. A program without such
spans leaves no such range, and the readers report nothing.
"""
from __future__ import annotations

PREFIX = "stage:"


def _host(e) -> bool:
    """A host range: the device's copy of an annotation (Kineto's
    `gpu_user_annotation`) and device work are left out."""
    cat = str(e.get("cat", "")).lower()
    return e.get("ph") == "X" and not cat.startswith("gpu") \
        and cat not in ("kernel", "gpu_memcpy", "gpu_memset")


def ranges(events, match) -> list[float]:
    """Seconds of every host range `stage:<name>` in @events whose <name>
    satisfies @match."""
    out = []
    for e in events or ():
        name = str(e.get("name", ""))
        if name.startswith(PREFIX) and _host(e) \
                and match(name[len(PREFIX):]):
            out.append(float(e.get("dur", 0.0)) / 1e6)
    return out


def mean_ms(events, name: str):
    """Mean ms of the span @name over the traced slice, or None where the
    slice holds none."""
    secs = ranges(events, lambda n: n == name)
    return 1e3 * sum(secs) / len(secs) if secs else None
