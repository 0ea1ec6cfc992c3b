"""The port must run where jax, cv2, PyYAML and sklearn are not installed
(the GPU machine has none of them): every module of `bundlesdf_tpu_torch`,
and chip_smoke.py, import with all four blocked, and the port's ORB
(`matcher/orb.py`, through the matcher's `detect_features`) detects a
frame and its LoFTR path (`matcher/pairing.py`, `matcher/loftr.py`)
canonicalizes and matches a pair with them blocked; no source of the port
imports jax or cv2."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "cv2", "yaml", "sklearn"):
    sys.modules[blocked] = None    # any import of it now raises ImportError
sys.path.insert(0, sys.argv[1])
import bundlesdf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bundlesdf_tpu_torch.__path__,
                                               "bundlesdf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the measurement harness: profiling, the bench and the protocol driver
assert {"bundlesdf_tpu_torch.utils.profiling", "bundlesdf_tpu_torch.bench",
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
# LoFTR with cv2 blocked: a pair canonicalized and matched by a tiny net
assert {"bundlesdf_tpu_torch.matcher.loftr",
        "bundlesdf_tpu_torch.matcher.pairing",
        "bundlesdf_tpu_torch.bench_loftr"} <= set(names)
from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
from bundlesdf_tpu_torch.matcher.pairing import mask_roi, process_image_pair
pose = np.eye(4)
cA, cB, tfA, tfB = process_image_pair(color, color, mask_roi(mask),
                                      mask_roi(mask), pose, pose, 64)
tiny = LoftrConfig(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16,
                   d_fine=8, nhead=2, n_coarse_layers=1, match_thr=0.0)
out = LoftrMatcher(cfg=tiny, device="cpu").predict([cA], [cB])
assert out[0].ndim == 2 and out[0].shape[1] == 5
assert not any(k in ("jax", "cv2", "yaml", "sklearn")
               or k.startswith(("jax.", "bundlesdf_tpu.", "sklearn."))
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
                assert "import cv2" not in src and "from cv2" not in src, f
