"""The whole NOF step's share of the card's peak: the step's model FLOPs
(`roofline.nof_step_flops`, the MLPs' and the hash-grid interpolation's
forward and backward, counted from the configuration's shapes) times the
window's steps, over the window's wall time and the dense peak at the
step's precision (bf16 under amp). Nothing on the CPU: it is a share of
the card's peak."""
from perfbench import roofline


def read(window):
    cfg, steps, wall = window.get("cfg"), window.get("steps"), \
        window.get("window_s")
    if not cfg or not steps or not wall \
            or window.get("device_kind", "cpu") == "cpu":
        return None
    return 100.0 * roofline.nof_step_flops(cfg) * steps / wall \
        / roofline.step_peak_flops(cfg)
