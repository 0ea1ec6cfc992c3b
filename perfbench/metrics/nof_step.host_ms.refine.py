"""Host ms of one NOF step in the refine: the program's span `nof.step`
(the ray draw and gather, render, loss, backward and Adam, as the host
dispatches them; the waits inside included) over the traced steps, which
run under the profiler just before the window. None where the program has
no such span."""
from perfbench import spans


def read(window):
    return spans.mean_ms(window.get("events"), "nof.step")
