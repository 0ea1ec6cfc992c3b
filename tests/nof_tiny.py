"""A `NofRunner` of the port on the CPU at a size whose steps take a few
hundredths of a second: three frames of the synthetic orbit, two hash-grid
levels, 64 rays of 8 + 8 samples."""
import numpy as np

from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.config import default_nerf_config
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM


def tiny_runner(seed=0, device="cpu", **cfg_over):
    seq = cube_orbit_sequence(n_frames=3, H=40, W=48, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=20, N_rand=64,
        N_samples=8, N_samples_around_depth=8, num_levels=2, finest_res=16,
        base_res=8, log2_hashmap_size=10, n_trace_steps=32,
        octree_smallest_voxel_size=2.0 / 32 / sc,
        octree_dilate_size=2.0 / 32 / sc), **cfg_over)
    data = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    return NofRunner(cfg, *data, seq["K"], device=device, seed=seed)
