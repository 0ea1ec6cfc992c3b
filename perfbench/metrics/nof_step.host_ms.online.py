"""Host ms of one NOF step in the online loop: the program's span
`nof.step` (the ray draw and gather, render, loss, backward and Adam, as
the host dispatches them; the waits inside included) over the traced batch
period, which runs under the profiler just before the window. With
`nof_runner.prep_ms.online` it splits `nof_runner.step_ms.online` into
step dispatch and batch prep. None where the program has no such span."""
from perfbench import spans


def read(window):
    return spans.mean_ms(window.get("events"), "nof.step")
