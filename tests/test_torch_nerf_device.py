"""Where the port's NOF runner lives (`nof/runner.py::nof_devices`), the
counterpart of tests/test_nerf_device.py: cfg `nerf_device: k` puts the
runner on card k while the tracker keeps its device; `dp_devices` (a
count, or an explicit list) takes precedence; too few cards warn and keep
the given device. The mapping is held with an injected card count; the
runner and a whole CPU `BundleSdf` with `nerf_device` / `dp_devices` set
still train, track and sync poses back."""
import logging

import numpy as np
import pytest
import torch

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import (default_nerf_config,
                                        default_track_config)
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.nof.runner import (NofRunner, nof_devices,
                                            preprocess_frame_data)
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

torch.set_num_threads(2)

CPU, CUDA0, CUDA1 = (torch.device("cpu"), torch.device("cuda", 0),
                     torch.device("cuda", 1))


@pytest.mark.parametrize("cfg,n_visible,want", [
    ({}, 4, (CUDA0, None)),
    ({"nerf_device": -1}, 4, (CUDA0, None)),
    ({"nerf_device": 1}, 2, (CUDA1, None)),
    ({"nerf_device": 0}, 1, (CUDA0, None)),
    # DP takes precedence over nerf_device
    ({"dp_devices": 2, "nerf_device": 1}, 2, (CUDA0, [CUDA0, CUDA1])),
    ({"dp_devices": 1, "nerf_device": 1}, 2, (CUDA1, None)),
])
def test_mapping_in_range(cfg, n_visible, want):
    assert nof_devices(cfg, CUDA0, n_visible=n_visible) == want


@pytest.mark.parametrize("cfg,want,warned", [
    ({"nerf_device": 2}, (CUDA0, None), "nerf_device=2"),
    ({"nerf_device": 64}, (CUDA0, None), "nerf_device=64"),
    # too few cards for DP: single device, and nerf_device applies
    ({"dp_devices": 4}, (CUDA0, None), "dp_devices=4"),
    ({"dp_devices": 4, "nerf_device": 1}, (CUDA1, None), "dp_devices=4"),
])
def test_mapping_out_of_range_warns(cfg, want, warned, caplog):
    with caplog.at_level(logging.WARNING):
        assert nof_devices(cfg, CUDA0, n_visible=2) == want
    assert warned in caplog.text and "visible" in caplog.text


def test_mapping_explicit_list_and_cpu(caplog):
    # an explicit list overrides both keys and may repeat a card
    assert nof_devices({"dp_devices": 4, "nerf_device": 1}, CUDA0,
                       dp_devices=["cuda:0", "cuda:0"],
                       n_visible=1) == (CUDA0, [CUDA0, CUDA0])
    with pytest.raises(ValueError):
        nof_devices({}, CUDA0, dp_devices=["cuda:0"])
    # on the CPU: any replica count shares it, the CPU is device 0
    assert nof_devices({"dp_devices": 3, "nerf_device": 0}, CPU) == \
        (CPU, [CPU] * 3)
    assert nof_devices({"nerf_device": 0}, CPU) == (CPU, None)
    with caplog.at_level(logging.WARNING):
        assert nof_devices({"nerf_device": 1}, CPU) == (CPU, None)
    assert "nerf_device=1" in caplog.text


def _tiny_runner(**over):
    seq = cube_orbit_sequence(n_frames=3, H=48, W=64, radius=0.45,
                              obj_size=0.08)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(
        sc_factor=sc, translation=[0.0, 0.0, 0.0], n_step=6, N_rand=64,
        N_samples=8, N_samples_around_depth=8, num_levels=2, finest_res=32,
        base_res=8, log2_hashmap_size=12, n_trace_steps=32,
        octree_smallest_voxel_size=2.0 / 32 / sc,
        octree_dilate_size=2.0 / 32 / sc))
    cfg.update(over)
    rgbs, depths, masks, normals, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(),
        None, (seq["cam_in_obs"] @ GLCAM_IN_CVCAM).copy(), sc, np.zeros(3))
    return NofRunner(cfg, rgbs, depths, masks, normals, poses, seq["K"],
                     device="cpu")


def test_nerf_device_out_of_range_falls_back(caplog):
    """tests/test_nerf_device.py's fallback: warn, stay on the given
    device, still train -- and placement does not change the math."""
    with caplog.at_level(logging.WARNING):
        r = _tiny_runner(nerf_device=64)
    assert "nerf_device=64" in caplog.text
    assert r.device == CPU and r.dp_devices is None
    assert all(p.device == CPU for p in r.field.parameters())
    m = r.train(n_steps=2)
    ref = _tiny_runner()
    m_ref = ref.train(n_steps=2)
    np.testing.assert_array_equal(m["loss"], m_ref["loss"])
    for p, q in zip(r.field.parameters(), ref.field.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("over", [{"nerf_device": 0},
                                  {"dp_devices": 2, "sync_max_delay": 4}])
def test_pipeline_with_nof_placement(tmp_path, over):
    """tests/test_nerf_device.py's end-to-end run on the port's CPU
    orchestrator: the NOF placed by `nerf_device` (strict sync) or trained
    by two DP replicas (threaded, `sync_max_delay` 4); tracking goes on,
    batches land and poses sync back into the keyframes."""
    seq = cube_orbit_sequence(n_frames=8, H=90, W=120, radius=0.45,
                              obj_size=0.08)
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
        n_trace_steps=32, sync_max_delay=0), **over)
    b = BundleSdf(cfg_track=cfg_t, cfg_nerf=cfg_n, start_nerf_keyframes=2,
                  device="cpu",
                  matcher=OrbMatcher(device="cpu", detector=cv2_detector))
    for i in range(8):
        b.run(seq["colors"][i], seq["depths"][i], seq["K"], f"{i:04d}",
              mask=seq["masks"][i])
    b.on_finish()
    assert b.nerf is not None and b.nerf.device == CPU
    assert b.nerf.dp_devices == ([CPU] * 2 if "dp_devices" in over else None)
    assert all(p.device == CPU for p in b.nerf.field.parameters())
    assert any(kf.nerfed for kf in b.bundler.keyframes)
    assert b.pipeline_stats["n_batches"] >= 1
    assert b.pipeline_stats["nof_steps_total"] == \
        21 * b.pipeline_stats["n_batches"]
    assert all(np.isfinite(kf.pose_in_model).all()
               for kf in b.bundler.keyframes)
