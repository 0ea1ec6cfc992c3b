"""The port must run where jax, cv2, PyYAML, sklearn, Pillow, imageio,
pandas and dearpygui are not installed (the GPU machine has none of
them): every module of `bundlesdf_tpu_torch`, and chip_smoke.py, import
with all eight blocked; with them blocked the port's ORB (`matcher/orb.py`,
through the matcher's `detect_features`) detects a frame and
`OrbMatcher.predict` matches a pair, its LoFTR path (`matcher/pairing.py`,
`matcher/loftr.py`) canonicalizes and matches a pair, its JPEG decoder
decodes a fixture frame, `Ho3dReader` reads an HO3D-layout folder,
`benchmark_ho3d` writes its CSV, the GUI factory gives `HeadlessGui` and
that writes its panel; no source of the port imports any of them but
dearpygui, which `gui.py` imports only if it is there."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "cv2", "yaml", "sklearn", "PIL", "imageio",
                "pandas", "dearpygui"):
    sys.modules[blocked] = None    # any import of it now raises ImportError
sys.path.insert(0, sys.argv[1])
import bundlesdf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bundlesdf_tpu_torch.__path__,
                                               "bundlesdf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the measurement harness: profiling and the protocol driver
assert {"bundlesdf_tpu_torch.utils.profiling",
        "bundlesdf_tpu_torch.benchmark_synthetic"} <= set(names)
import chip_smoke
# ORB detection with cv2 blocked: a textured square on a flat background
import numpy as np
from types import SimpleNamespace
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
rng = np.random.default_rng(0)
color = np.full((240, 320, 3), 90, np.uint8)
color[40:200, 60:260] = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
mask = np.zeros((240, 320), np.uint8)
mask[40:200, 60:260] = 1
uv, des = OrbMatcher(device="cpu").detect_features(
    SimpleNamespace(color=color, fg_mask=mask))
assert len(uv) == len(des) > 500, len(uv)
# the LoFTR-shaped contract on whole images: a pair and its shifted copy
shifted = np.roll(color, (3, 5), axis=(0, 1))
rows = OrbMatcher(device="cpu").predict([color], [shifted])[0]
assert rows.dtype == np.float32 and rows.shape[1] == 5 and len(rows) > 100
assert np.median(rows[:, 2] - rows[:, 0]) == 5
# LoFTR with cv2 blocked: a pair canonicalized and matched by a tiny net
assert {"bundlesdf_tpu_torch.matcher.loftr",
        "bundlesdf_tpu_torch.matcher.pairing"} <= set(names)
from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
from bundlesdf_tpu_torch.matcher.pairing import mask_roi, process_image_pair
pose = np.eye(4)
cA, cB, tfA, tfB = process_image_pair(color, color, mask_roi(mask),
                                      mask_roi(mask), pose, pose, 64)
tiny = LoftrConfig(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16,
                   d_fine=8, nhead=2, n_coarse_layers=1, match_thr=0.0)
out = LoftrMatcher(cfg=tiny, device="cpu").predict([cA], [cB])
assert out[0].ndim == 2 and out[0].shape[1] == 5
# HO3D with Pillow, imageio and pandas blocked: a fixture JPEG decoded to
# its stored hash, a layout folder read back, its rows written as CSV, a
# GUI panel written
import os, tempfile
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import ho3d_layout
from bundlesdf_tpu_torch.benchmark_ho3d import write_results_csv
from bundlesdf_tpu_torch.datasets import Ho3dReader
from bundlesdf_tpu_torch import gui
from bundlesdf_tpu_torch.gui import HeadlessGui
assert not gui.HAS_DPG
from bundlesdf_tpu_torch.utils.jpeg import read_jpeg
seq = ho3d_layout.orbit_sequence(2)
img = read_jpeg(ho3d_layout.fixture_jpegs(1)[0])
assert ho3d_layout.pixel_sha256(img) == ho3d_layout.load_hashes()["0000"]
with tempfile.TemporaryDirectory() as tmp:
    video = ho3d_layout.write_ho3d_video(tmp, seq,
                                         jpegs=ho3d_layout.fixture_jpegs(2))
    r = Ho3dReader(video)
    assert np.array_equal(r.get_color(1), read_jpeg(r.color_files[1]))
    assert np.abs(r.get_depth(0) - seq["depths"][0]).max() < 1e-4
    assert r.get_occ_mask(1) is None and r.get_mask(0).shape == (480, 640)
    assert np.abs(r.get_gt_pose(1) - np.linalg.inv(seq["cam_in_obs"][1])
                  ).max() < 1e-12
    write_results_csv({"ours/SYN1/ADD(cm)": 0.5}, os.path.join(tmp, "r.csv"))
    g = gui.BundleSdfGui(os.path.join(tmp, "gui"), every_n=1)
    assert type(g) is HeadlessGui
    g.update_frame(r.get_color(0), r.get_mask(0), r.get_gt_pose(0), "0000",
                   r.K, 1)
    assert os.path.exists(os.path.join(tmp, "gui", "gui_0000.png"))
assert {"bundlesdf_tpu_torch.run_ho3d", "bundlesdf_tpu_torch.benchmark_ho3d",
        "bundlesdf_tpu_torch.parallel.videos", "bundlesdf_tpu_torch.gui",
        "bundlesdf_tpu_torch.utils.jpeg"} <= set(names)
# ray data parallelism (parallel/dp.py), imported by the runner as well
assert "bundlesdf_tpu_torch.parallel.dp" in names
from bundlesdf_tpu_torch.parallel import dp
assert dp.make_ray_devices(n_dev=2, base="cpu") == [dp.torch.device("cpu")] * 2
assert not any(k in ("jax", "cv2", "yaml", "sklearn", "PIL", "imageio",
                     "pandas", "dearpygui")
               or k.startswith(("jax.", "bundlesdf_tpu.", "sklearn.", "PIL.",
                                "imageio.", "pandas.", "dearpygui."))
               for k in sys.modules if sys.modules[k] is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE, ROOT],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    # ops, nof, utils, tracker, matcher, eval with their modules, the
    # orchestrator, the drivers and the measurement harness
    assert int(proc.stdout.split()[-1]) >= 30


def test_no_jax_import_in_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bundlesdf_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, f
                for mod in ("cv2", "PIL", "imageio", "pandas"):
                    assert f"import {mod}" not in src \
                        and f"from {mod}" not in src, (f, mod)
