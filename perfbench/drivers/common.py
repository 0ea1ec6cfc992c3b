"""What the drivers share: configurations as run, the device's name and
power limit, the comparison's arithmetic and the release of the program's
state before the reference runs."""
from __future__ import annotations

import copy
import gc
import math
import random
import statistics
import subprocess
import time

import numpy as np
import torch


class Parts:
    """The set-up's parts: seconds from the process start to each mark."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks: list[tuple[str, float]] = []

    def mark(self, name: str) -> float:
        """Close the part @name now; returns the seconds since the start."""
        self.marks.append((name, time.perf_counter()))
        return self.marks[-1][1] - self.t_start

    def line(self) -> str:
        out, prev = [], self.t_start
        for name, t in self.marks:
            out.append(f"{name} {t - prev:.3f}")
            prev = t
        return "setup parts (s): " + ", ".join(out)


def deep_merge(base: dict, over: dict) -> dict:
    """@base with @over's values on top, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def configs(cell, defaults_track, defaults_nerf, debug_dir: str):
    """(tracker config, online NOF config, refine NOF config) as the cell
    runs them: the package's defaults (@defaults_*: its
    `default_track_config` / `default_nerf_config`) under the configuration
    file's values, then the traffic's overrides. The file holds every
    published value; defaults only fill keys it does not name."""
    cfg = cell.config
    track = deep_merge(defaults_track(), cfg["track"])
    track = deep_merge(track, cell.traffic.get("track_overrides", {}))
    track["debug_dir"] = debug_dir + "/"
    nerf = deep_merge(defaults_nerf(), cfg["nerf"])
    nerf = deep_merge(nerf, cell.traffic.get("nerf_overrides", {}))
    nerf["datadir"] = nerf["save_dir"] = debug_dir + \
        "/nerf_with_bundletrack_online"
    refine = deep_merge(nerf, cfg.get("refine", {}))
    refine = deep_merge(refine, cell.traffic.get("refine_overrides", {}))
    return track, nerf, refine


def seed_host_rngs(seed: int = 0):
    """The drivers' `set_seed(0)` (run_custom.py): numpy's and Python's
    global generators, for whatever host code draws from them."""
    np.random.seed(seed)
    random.seed(seed)


def device_label() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_kind(device: str) -> str:
    if device.startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "cpu"


def sync(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    if device.startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device: str):
    """Collect the program's freed objects and hand their device memory
    back, before the reference runs."""
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def p95(values) -> float:
    """The 95th percentile (`statistics.quantiles`, inclusive method)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def pose_gaps(poses_a: dict, poses_b: dict, ids) -> tuple[float, float]:
    """(worst translation gap in mm, worst rotation gap in degrees) between
    two {id: cam-in-object 4x4} over @ids; an id that one side lacks
    counts as an infinite gap."""
    worst_t, worst_r = 0.0, 0.0
    for i in ids:
        a, b = poses_a.get(i), poses_b.get(i)
        if a is None or b is None or not (np.all(np.isfinite(a))
                                          and np.all(np.isfinite(b))):
            return math.inf, math.inf
        worst_t = max(worst_t, float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                      * 1e3)
        # the chordal distance, as an angle: exactly 0 for equal matrices
        # even where a pose has drifted off orthonormal by round-off
        chord = float(np.linalg.norm(a[:3, :3] - b[:3, :3]))
        worst_r = max(worst_r, math.degrees(
            2.0 * math.asin(min(1.0, chord / (2.0 * math.sqrt(2.0))))))
    return worst_t, worst_r


def leaf_norms(named) -> dict:
    """{name: float64 norm} of a {name: tensor} dict."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in named.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The training comparison's measure by the worst leaf: |norm_prog -
    norm_ref| over the larger of the reference's norm of that leaf and of
    the median leaf. @keep: the leaves compared (all by default)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names])) if names else 0.0
    worst, which = 0.0, ""
    for k in names:
        gap = abs(prog.get(k, math.inf) - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, which = gap, k
    return worst, which
