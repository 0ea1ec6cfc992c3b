"""The tracker || NOF semantics of tests/test_async_nerf.py, on the port
(`bundlesdf_tpu_torch.bundlesdf.BundleSdf` on the CPU): strict sync at
`sync_max_delay=0`; tracking continues while a batch is in flight and the
sync-back still lands; keyframes accumulate during a batch; the
`async_host` worker thread drives whole batches; a worker error surfaces
on the tracker thread. The tracker is fed cv2's features, as the JAX
package's tests see them."""
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch import bundlesdf
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.config import (default_nerf_config,
                                        default_track_config)
from bundlesdf_tpu_torch.nof import runner as runner_mod

torch.set_num_threads(2)


class BundleSdf(bundlesdf.BundleSdf):
    """The port's orchestrator, fed cv2's features."""

    def __init__(self, **kw):
        super().__init__(matcher=OrbMatcher(device="cpu",
                                            detector=cv2_detector), **kw)


def _cfgs(tmp_path, sync_max_delay):
    cfg_t = default_track_config()
    cfg_t["debug_dir"] = str(tmp_path / "dbg")
    cfg_t["SPDLOG"] = 0
    cfg_t["ransac"]["max_trans_neighbor"] = 0.05
    cfg_t["ransac"]["max_iter"] = 500
    cfg_t["bundle"]["max_BA_frames"] = 5
    cfg_t["bundle"]["depth_association_radius"] = 2
    cfg_n = default_nerf_config()
    cfg_n.update(dict(
        n_step=20, N_rand=128, N_samples=8, N_samples_around_depth=8,
        num_levels=2, finest_res=32, base_res=8, log2_hashmap_size=12,
        # the polling path (deterministic batch/poll interleaving); the
        # threaded one has its own tests below
        n_trace_steps=32, sync_max_delay=sync_max_delay, async_host=False))
    return cfg_t, cfg_n


def _track(b, n_frames, seq, after=None):
    for i in range(n_frames):
        b.run(seq["colors"][i], seq["depths"][i], seq["K"], f"{i:04d}",
              mask=seq["masks"][i])
        if after is not None:
            after(b)
    b.on_finish()


def _seq(n):
    return cube_orbit_sequence(n_frames=n, H=90, W=120, radius=0.45,
                               obj_size=0.08)


def _run(tmp_path, sync_max_delay, n_frames=8):
    cfg_t, cfg_n = _cfgs(tmp_path, sync_max_delay)
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, start_nerf_keyframes=2,
                  device="cpu")
    in_flight = []
    _track(b, n_frames, _seq(n_frames), lambda b: in_flight.append(
        b.nerf is not None and b.nerf.training_in_flight))
    return b, in_flight


def test_strict_sync_when_delay_zero(tmp_path):
    """sync_max_delay=0: each batch completes and syncs within the frame
    that started it."""
    b, in_flight = _run(tmp_path, sync_max_delay=0)
    assert not any(in_flight)
    assert any(kf.nerfed for kf in b.bundler.keyframes)
    assert b.pipeline_stats["nof_steps_total"] == \
        21 * b.pipeline_stats["n_batches"]
    assert b.mesh is not None and len(b.mesh.faces) > 0


def test_overlap_keeps_tracking_and_syncs_back(tmp_path, monkeypatch):
    """With a large delay budget, frames keep processing while the batch
    is in flight (readiness held False for a few polls), and the sync-back
    still lands with optimized poses."""
    polls = {"n": 0}
    orig = runner_mod.NofRunner._chunk_ready

    def slow_ready(pull):
        polls["n"] += 1
        if polls["n"] < 4:
            return False
        return orig(pull)

    monkeypatch.setattr(runner_mod.NofRunner, "_chunk_ready",
                        staticmethod(slow_ready))
    b, in_flight = _run(tmp_path, sync_max_delay=99)
    assert any(in_flight)
    assert b.nerf is not None and not b.nerf.training_in_flight
    assert any(kf.nerfed for kf in b.bundler.keyframes)


def test_inflight_batch_accumulates_keyframes(tmp_path, monkeypatch):
    """Keyframes arriving while a batch trains accumulate and the freed NOF
    takes the whole list as its next batch (ref run_nerf loop
    bundlesdf.py:96-129)."""
    polls = {"n": 0}
    orig = runner_mod.NofRunner._chunk_ready

    def slow_ready(pull):
        polls["n"] += 1
        if polls["n"] % 5 != 0:
            return False
        return orig(pull)

    monkeypatch.setattr(runner_mod.NofRunner, "_chunk_ready",
                        staticmethod(slow_ready))
    cfg_t, cfg_n = _cfgs(tmp_path, sync_max_delay=99)
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, start_nerf_keyframes=2,
                  device="cpu")
    batch_sizes = []
    orig_run = BundleSdf._run_nerf_batch

    def spy_run(self):
        batch_sizes.append(len(self.kf_to_nerf_list))
        return orig_run(self)

    monkeypatch.setattr(BundleSdf, "_run_nerf_batch", spy_run)
    _track(b, 10, _seq(10))
    n_kf = len(b.bundler.keyframes)
    assert b.nerf_num_frames == n_kf
    assert b.pipeline_stats["n_batches"] < n_kf
    assert max(batch_sizes) > 1


def test_async_host_thread_overlap(tmp_path):
    """async_host (the default when sync_max_delay > 0): a worker thread
    owns each batch; every keyframe is consumed, poses sync back, and the
    tracker never polls."""
    cfg_t, cfg_n = _cfgs(tmp_path, sync_max_delay=4)
    cfg_n["async_host"] = None
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, start_nerf_keyframes=2,
                  device="cpu")
    assert b._async_host
    _track(b, 10, _seq(10))
    assert b._nerf_thread is None
    assert b.nerf_num_frames == len(b.bundler.keyframes)
    assert any(kf.nerfed for kf in b.bundler.keyframes)
    assert b.pipeline_stats["n_batches"] >= 1
    assert b.pipeline_stats["nerf_poll_s"] == 0.0
    assert b.pipeline_stats["nerf_worker_s"] > 0.0
    assert b.pipeline_stats["nof_steps_total"] == \
        21 * b.pipeline_stats["n_batches"]
    assert b.mesh is not None


def test_async_host_read_from_nerf_config(tmp_path):
    """async_host and sync_max_delay come from the NOF config the object
    holds, also when it was loaded from a YAML path (the JAX constructor
    reads its cfg_nerf parameter there, which is None on that path)."""
    pytest.importorskip("yaml")
    from bundlesdf_tpu_torch.config import dump_config
    cfg_t, cfg_n = _cfgs(tmp_path, sync_max_delay=3)
    cfg_n["async_host"] = None
    path = str(tmp_path / "nerf.yml")
    dump_config(cfg_n, path)
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf_dir=path, device="cpu")
    assert b._async_host and b.cfg_nerf["sync_max_delay"] == 3


def test_async_host_worker_error_surfaces(tmp_path, monkeypatch):
    """An exception on the NOF worker thread surfaces on the tracker
    thread at the next sync point."""
    def boom(self, *a, **k):
        raise RuntimeError("worker exploded")

    monkeypatch.setattr(runner_mod.NofRunner, "start_training", boom)
    cfg_t, cfg_n = _cfgs(tmp_path, sync_max_delay=4)
    cfg_n["async_host"] = True
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, start_nerf_keyframes=2,
                  device="cpu")
    with pytest.raises(RuntimeError, match="worker exploded"):
        _track(b, 6, _seq(6))
    assert b._nerf_thread is None
