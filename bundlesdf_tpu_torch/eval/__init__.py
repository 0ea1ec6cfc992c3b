"""Evaluation: ADD/ADD-S pose errors and AUC (ref `Utils.py:82-198`)."""
from bundlesdf_tpu_torch.eval.metrics import add_err, adi_err, compute_auc
