"""Feature matching between frame pairs.

Backends:
  - `classical.OrbMatcher` — ORB detection + batched device hamming
    matching, weight-free (the frame-keyed `match_frames(frame_pairs)`
    contract)
  - `gt.GtMatcher` — GT-oracle debug matcher (ref
    FeatureManager.cpp:990-1039 findCorresbyGroundtruth)
  - `loftr.LoftrMatcher` — the LoFTR network (`predict(rgbAs, rgbBs)` on
    pairs canonicalized by `pairing.process_image_pairs`)
"""
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.matcher.gt import GtMatcher
from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
from bundlesdf_tpu_torch.matcher.pairing import (map_matches_back, mask_roi,
                                                 process_image_pair,
                                                 process_image_pairs)
