"""What the online and tracking drivers share: the frames, the protocol
that feeds them to a `BundleSdf` and records each frame's answer, and the
frozen reference's replay of the same frames.

The protocol is the same for the port and the reference: frame i is fed
with `run` (colour, depth, K, id, mask), and the pose a frame answers with
is read once the next `run` has returned, when its bundle adjustment has
been pulled and its keyframe and NOF bookkeeping done; the last frame's
after `flush_pipeline`.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from perfbench import scene
from perfbench.drivers import common


def frames(cell):
    """The orbit's frames (one revolution, `orbit_frames` of them, that
    the feed walks round as often as it needs)."""
    p = cell.traffic
    sp = dict(p["scene"],
              erode_mask=int(cell.config["track"].get("erode_mask", 0)))
    return scene.seeded_scene(cell.seed, sp, int(p["orbit_frames"]),
                              cell.device)


def program():
    from bundlesdf_tpu_torch import config
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    return SimpleNamespace(config=config, BundleSdf=BundleSdf)


def reference():
    from perfbench.reference.frozen import config
    from perfbench.reference.frozen.bundlesdf import BundleSdf
    return SimpleNamespace(config=config, BundleSdf=BundleSdf)


def make_tracker(mod, cell, debug_dir, quiet=False, **kw):
    """A `BundleSdf` of @mod at the cell's configuration; @quiet (the
    reference) writes no artifacts and times no stages, which changes
    nothing it computes. @kw: further arguments of `BundleSdf`."""
    track, nerf, _ = common.configs(cell, mod.config.default_track_config,
                                    mod.config.default_nerf_config,
                                    debug_dir)
    if quiet:
        track["SPDLOG"] = 0
        track["stage_timing"] = False
    os.makedirs(debug_dir, exist_ok=True)
    common.seed_host_rngs(0)
    return mod.BundleSdf(
        cfg_track=track, cfg_nerf=nerf,
        start_nerf_keyframes=int(cell.traffic["start_nerf_keyframes"]),
        device=cell.device, **kw)


class Feed:
    """Feeds frame after frame of @sc to @tracker and keeps each frame's
    answer (its cam-in-object pose and whether it failed)."""

    def __init__(self, tracker, sc):
        self.tracker = tracker
        self.sc = sc
        self.n = len(sc["id_strs"])
        self.i = 0
        self.prev = None
        self.poses: dict[int, np.ndarray] = {}
        self.failed: dict[int, bool] = {}

    def _keep(self, frame):
        self.poses[frame.id] = np.array(frame.pose_in_model, np.float64)
        self.failed[frame.id] = frame.status.name == "FAIL"

    def step(self):
        """Track the next frame; returns nothing."""
        j = self.i % self.n
        sc = self.sc
        frame = self.tracker.run(sc["colors"][j], sc["depths"][j].copy(),
                                 sc["K"], f"{self.i:05d}",
                                 mask=sc["masks"][j])
        if self.prev is not None:
            self._keep(self.prev)
        self.prev = frame
        self.i += 1

    def flush(self):
        """Finish the last frame (its bundle adjustment) and keep it."""
        self.tracker.flush_pipeline()
        if self.prev is not None:
            self._keep(self.prev)


def replay(cell, sc, n_frames: int, flush: bool, mod=None):
    """The reference's answers to the first @n_frames frames of @sc, fed
    by the same protocol; {id: pose}."""
    mod = mod or reference()
    tracker = make_tracker(mod, cell, os.path.join(cell.scratch, "ref"),
                           quiet=True)
    feed = Feed(tracker, sc)
    while feed.i < n_frames:
        feed.step()
    if flush:
        feed.flush()
    poses = feed.poses
    del feed, tracker
    common.release(cell.device)
    return poses


def pose_comparison(cell, prog_poses, ref_poses, ids):
    """The numbers compared for a tracking cell: the worst translation and
    rotation gaps between the port's and the reference's answers over the
    window's frames @ids."""
    t, r = common.pose_gaps(prog_poses, ref_poses, ids)
    lim = cell.limits
    return [("pose_gap_mm", t, lim.get("pose_gap_mm", 0.0)),
            ("pose_gap_deg", r, lim.get("pose_gap_deg", 0.0))]
