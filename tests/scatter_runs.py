"""Atomics of the `scatter_rows` kernel on the rows of one real NOF
training step, counted on the CPU at a reduced size:

    python tests/scatter_runs.py [n_rays]

Builds the runner `chip_smoke.py::make_runner` builds (the online
configuration: 4 dense levels, 128 + 64 samples a ray), at 120x160 images
and @n_rays rays a step (default 256) on the CPU, records the (vals, rows)
one step hands the kernel, and prints by hash-grid level the in-range
row-adds and the vector atomics the kernel issues at group L*8 (runs of
equal rows along a column, cut every RUN_SAMPLES samples). Run lengths
are per ray, so the counts scale with the number of rays."""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
from synthetic import cube_orbit_sequence  # noqa: E402
from bundlesdf_tpu_torch.config import default_nerf_config  # noqa: E402
from bundlesdf_tpu_torch.nof.runner import (NofRunner,  # noqa: E402
                                            preprocess_frame_data)
from bundlesdf_tpu_torch.ops.scatter import RUN_SAMPLES  # noqa: E402
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM  # noqa: E402


def main(n_rays=256):
    torch.manual_seed(0)
    seq = cube_orbit_sequence(n_frames=5, H=120, W=160, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(sc_factor=sc, translation=[0.0] * 3, N_rand=n_rays))
    data = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    runner = NofRunner(cfg, *data, seq["K"], device="cpu")
    vals, rows, n_rows, group = chip_smoke.record_step(runner)
    L = runner.spec.grid.n_levels
    print(f"{rows.shape[0]} entries ({n_rays} rays), C={vals.shape[1]}, "
          f"group {group}, sentinel share "
          f"{float((rows >= n_rows).float().mean()):.4f}")
    for name, s in (("in-range row-adds", 1),
                    (f"atomics, {RUN_SAMPLES}-sample tiles", RUN_SAMPLES),
                    ("runs, uncut", rows.shape[0])):
        by_level = chip_smoke.run_atomics(rows, n_rows, group, s).view(
            L, 8).sum(1)
        print(f"{name}: by level {by_level.tolist()}, sum "
              f"{int(by_level.sum())}")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:2]))
