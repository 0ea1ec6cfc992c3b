"""Run one cell of the benchmark of `bundlesdf_tpu_torch` on this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with `--trace
1`), `device`, with `--trace 1` also `breakdown`, and last `compared`, each
number of the comparison with the reference beside its limit; the same
numbers are the last lines of standard error. Exits with another code than
0, printing no result, where no CUDA card is visible, and where JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernels into its own `csrc/build/`, also inside it)
CACHE = os.path.join(ROOT, ".perfbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load, compared whole
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "bundlesdf_tpu", "chip_smoke",
                 "synthetic", "conftest")
FORBIDDEN = ("bundlesdf_tpu_torch.bench",)


def forbidden_modules() -> list[str]:
    found = sorted({m.split(".")[0] for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN_TOP})
    return found + [m for m in FORBIDDEN if m in sys.modules]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness

    bench, cell = harness.prepare(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t_start=T_START)
    need = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {need} CUDA card(s), {n} visible",
              file=sys.stderr)
        return 3
    try:
        res, err = harness.run_cell(bench, cell)
    finally:
        shutil.rmtree(cell.scratch, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
