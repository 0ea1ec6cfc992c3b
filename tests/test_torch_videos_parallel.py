"""The port's multi-video sweep (`bundlesdf_tpu_torch/parallel/videos.py`,
the port of `test_videos_parallel.py`): two videos interleaved frame by
frame on the CPU (`devices=[cpu, cpu]`, as one card runs two) track
correctly, and each video's poses equal its run alone, bit for bit."""
import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import default_nerf_config, default_track_config
from bundlesdf_tpu_torch.parallel.videos import run_videos_parallel

torch.set_num_threads(2)
N = 5


class _SeqReader:
    def __init__(self, seq):
        self.seq = seq
        self.K = seq["K"]
        self.id_strs = seq["id_strs"]

    def __len__(self):
        return len(self.id_strs)

    def get_video_name(self):
        return "synthetic"

    def get_color(self, i):
        return self.seq["colors"][i]

    def get_depth(self, i):
        return self.seq["depths"][i].copy()

    def get_mask(self, i):
        return self.seq["masks"][i]


def _make_tracker(out_dir, device):
    cfg = default_track_config()
    cfg["debug_dir"] = str(out_dir)
    cfg["ransac"]["max_trans_neighbor"] = 0.05
    cfg["ransac"]["max_iter"] = 300
    cfg["bundle"]["max_BA_frames"] = 4
    cfg["bundle"]["depth_association_radius"] = 2
    return BundleSdf(cfg_track=cfg, cfg_nerf=default_nerf_config(),
                     start_nerf_keyframes=99, device=device)


def _poses(d):
    return np.array([np.loadtxt(d / "ob_in_cam" / f"{i:04d}.txt")
                     for i in range(N)])


def test_two_videos_interleaved_equal_sequential(tmp_path):
    seqs = [cube_orbit_sequence(n_frames=N, H=72, W=96, full_angle=0.2,
                                seed=s) for s in (0, 1)]
    made = []

    def make_tracker(out_dir, device):
        made.append(device)
        return _make_tracker(out_dir, device)

    cpu = torch.device("cpu")
    jobs = [(_SeqReader(seqs[k]), tmp_path / f"v{k}") for k in range(2)]
    trackers = run_videos_parallel(jobs, make_tracker, devices=[cpu, cpu])
    assert len(trackers) == 2 and made == [cpu, cpu]
    assert all(t.device == cpu for t in trackers)
    for k, seq in enumerate(seqs):
        # each video alone, through the same entry point
        alone = tmp_path / f"alone{k}"
        run_videos_parallel([(_SeqReader(seq), alone)], make_tracker,
                            devices=[cpu])
        np.testing.assert_array_equal(_poses(tmp_path / f"v{k}"),
                                      _poses(alone))
        gt = seq["cam_in_obs"]
        est = np.linalg.inv(_poses(tmp_path / f"v{k}"))
        est = np.einsum("ij,njk->nik", gt[0] @ np.linalg.inv(est[0]), est)
        errs = [np.linalg.norm(est[i][:3, 3] - gt[i][:3, 3])
                for i in range(N)]
        assert np.mean(errs) < 0.01


def test_too_few_devices_is_an_error(tmp_path):
    """No silent fallback to fewer devices than asked for."""
    with pytest.raises(AssertionError, match="need 2 devices"):
        run_videos_parallel([], _make_tracker, n_devices=2,
                            devices=[torch.device("cpu")])
