"""The bytes of the NOF's Adam a step, counted from the configuration's
shapes: each element that Adam updates is read once as parameter,
gradient and two moments and written once as parameter and two moments,
float32, 28 bytes. The elements are the hash-grid table
(`roofline.grid_layout`'s rows x `feature_grid_dim`), the two MLPs'
weights and biases (`roofline.step_shapes`' widths) and, where the frame
count is given, `pose_array` (6 a frame) and `feature_array`
(`frame_features` a frame), which at 40 frames add 320 of 79-168 million
elements."""
from __future__ import annotations

from perfbench import roofline

BYTES_PER_ELEMENT = 7 * 4


def adam_elements(cfg: dict, n_frames: int = 0) -> int:
    """Elements Adam updates a step under the NOF config @cfg (config.yml's
    keys) with @n_frames frames."""
    s = roofline.step_shapes(cfg)
    mlp = sum(a * b + b for net in (s["sigma"], s["color"])
              for a, b in zip(net, net[1:]))
    return (s["rows"] * s["channels"] + mlp
            + n_frames * (6 + int(cfg["frame_features"])))


def adam_bytes(cfg: dict, n_frames: int = 0) -> int:
    return BYTES_PER_ELEMENT * adam_elements(cfg, n_frames)


def adam_bound_s(cfg: dict, n_frames: int = 0) -> float:
    """Least time of Adam's step on one H100: its bytes at the HBM rate."""
    return adam_bytes(cfg, n_frames) / roofline.HBM_BYTES_S
