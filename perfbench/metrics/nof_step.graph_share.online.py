"""Share of the online loop's NOF steps that replayed the captured CUDA
graph: 100 x the program's `nof.graph.replay` ranges over its `nof.step`
ranges in the traced batch period (a batch's first step runs eagerly and
the next captures). None where the slice holds no replay (a program
without the graph)."""
from perfbench import spans


def read(window):
    events = window.get("events")
    replays = spans.ranges(events, lambda n: n == "nof.graph.replay")
    steps = spans.ranges(events, lambda n: n == "nof.step")
    if not replays or not steps:
        return None
    return 100.0 * len(replays) / len(steps)
