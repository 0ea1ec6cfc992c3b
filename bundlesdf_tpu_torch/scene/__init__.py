"""Scene normalization: fused object cloud -> translation/scale into [-1,1]
(ref `tool.py:18-132`)."""
from bundlesdf_tpu_torch.scene.bounds import (compute_scene_bounds,
                                              compute_scene_bounds_frame,
                                              compute_translation_scales,
                                              dbscan_labels,
                                              find_biggest_cluster,
                                              voxel_downsample)
