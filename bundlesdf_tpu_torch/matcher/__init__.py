"""Feature matching between frame pairs.

Backends (the frame-keyed `match_frames(frame_pairs)` contract):
  - `classical.OrbMatcher` — host ORB detection + batched device hamming
    matching, weight-free
  - `gt.GtMatcher` — GT-oracle debug matcher (ref
    FeatureManager.cpp:990-1039 findCorresbyGroundtruth)
"""
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.matcher.gt import GtMatcher
