"""Evaluation: ADD/ADD-S pose errors, AUC, Chamfer after ICP
(ref `Utils.py:82-273`, `benchmark_ho3d.py`)."""
from bundlesdf_tpu_torch.eval.metrics import (add_err, adi_err,
                                              chamfer_distance_mutual,
                                              compute_auc,
                                              icp_point_to_point)
from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
