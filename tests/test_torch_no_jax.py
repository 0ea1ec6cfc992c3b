"""The port must run where jax, cv2, PyYAML and sklearn are not installed
(the GPU machine has none of them): every module of `bundlesdf_tpu_torch`,
and chip_smoke.py, import with all four blocked."""
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
