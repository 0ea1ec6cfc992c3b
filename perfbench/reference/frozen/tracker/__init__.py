"""Pose-graph tracker (port of `bundlesdf_tpu/tracker`)."""
