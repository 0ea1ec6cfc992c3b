"""The offline global refine: `NofRunner` at the configuration's refine
settings over seeded keyframes, as `BundleSdf.run_global_nerf` builds it.

Set-up renders the keyframes on the card (`traffic` gives their count and
the orbit), quantizes depth to millimetres as the refine's PNG artifacts
do, perturbs every pose but the first by seeded noise of about the online
tracker's error, and builds the runner through the port's scene bounds,
`preprocess_frame_data` and `NofRunner`. The runner's first three steps go
through `train`, the window's own call; the comparison reads the losses
of those steps, the first gradient as Adam holds it after one step and
each parameter's change after three. One more `train` call fills the
first chunk (warm-up). With `--trace 1` the profiler then traces
`traced_steps` steps before the window opens. The window calls `train(n_steps=chunk)` until
`--seconds` have passed; each call ends with the runner's host pull, so
all device work is inside the window. Once it has closed, the program's
state is released and the frozen reference (`reference/frozen`) builds
the same runner from the same keyframes and seed and takes the same three
steps.
"""
from __future__ import annotations

import copy
import gc
import math
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import scene, trace
from perfbench.harness import Outcome
from perfbench.drivers import common

ADAM_BETA1 = 0.9


def keyframes(cell):
    """Keyframe images, depths, masks, noisy poses and K, host numpy."""
    p = cell.traffic
    n = int(p["keyframes"])
    sp = dict(p["scene"], step_rad=2.0 * math.pi / n,
              erode_mask=int(cell.config["track"].get("erode_mask", 0)))
    sc = scene.seeded_scene(cell.seed, sp, n, cell.device)
    rng = np.random.default_rng([cell.seed, 1])
    poses = sc["cam_in_obs"].copy()
    for i in range(1, n):
        rot = rng.normal(0.0, math.radians(p["pose_noise_deg"]), 3)
        th = float(np.linalg.norm(rot))
        k = rot / max(th, 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx
        poses[i, :3, :3] = R @ poses[i, :3, :3]
        poses[i, :3, 3] += rng.normal(0.0, p["pose_noise_m"], 3)
    # depth as the refine reads it back: uint16 millimetres
    depths = (sc["depths"] * 1000).astype(np.uint16).astype(np.float32) / 1000
    masks = (sc["masks"] > 0).astype(np.uint8)
    return {"rgbs": sc["colors"], "depths": depths, "masks": masks,
            "cam_in_obs": poses, "K": sc["K"]}


def program():
    from bundlesdf_tpu_torch import config
    from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
    from bundlesdf_tpu_torch.scene.bounds import compute_scene_bounds
    from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM
    return SimpleNamespace(config=config, NofRunner=NofRunner,
                           preprocess_frame_data=preprocess_frame_data,
                           compute_scene_bounds=compute_scene_bounds,
                           GLCAM_IN_CVCAM=GLCAM_IN_CVCAM)


def reference():
    from perfbench.reference.frozen import config
    from perfbench.reference.frozen.nof.runner import (NofRunner,
                                                       preprocess_frame_data)
    from perfbench.reference.frozen.scene.bounds import compute_scene_bounds
    from perfbench.reference.frozen.utils.common import GLCAM_IN_CVCAM
    return SimpleNamespace(config=config, NofRunner=NofRunner,
                           preprocess_frame_data=preprocess_frame_data,
                           compute_scene_bounds=compute_scene_bounds,
                           GLCAM_IN_CVCAM=GLCAM_IN_CVCAM)


def refine_config(cell, mod):
    _, _, cfg = common.configs(cell, mod.config.default_track_config,
                               mod.config.default_nerf_config,
                               os.path.join(cell.scratch, "out"))
    return cfg


def build(mod, cfg, kf, seed, device):
    """The runner as `run_global_nerf` builds it (scene bounds, then
    `preprocess_frame_data`, then `NofRunner`), seeded with @seed."""
    cfg = copy.deepcopy(cfg)
    glcam = kf["cam_in_obs"] @ mod.GLCAM_IN_CVCAM
    sc, tr, _, pcd_norm = mod.compute_scene_bounds(
        kf["rgbs"], kf["depths"], kf["masks"], glcam, kf["K"], use_mask=True,
        eps=cfg["dbscan_eps"], min_samples=cfg["dbscan_eps_min_samples"])
    cfg["sc_factor"] = float(sc)
    cfg["translation"] = np.asarray(tr)
    rgbs, depths, masks, normals, poses = mod.preprocess_frame_data(
        kf["rgbs"], kf["depths"], kf["masks"], None, glcam.copy(), float(sc),
        np.asarray(tr))
    return mod.NofRunner(cfg, rgbs, depths, masks, normals, poses, kf["K"],
                         build_octree_pts=pcd_norm, device=device, seed=seed)


def first_steps(runner):
    """The losses of steps 1-3, each leaf's first gradient as Adam holds it
    after step 1 (exp_avg / (1 - beta1)) and each leaf's change after step
    3, as norms."""
    named = dict(runner.field.named_parameters())
    p0 = {k: v.detach().clone() for k, v in named.items()}
    m1 = runner.train(n_steps=1)
    st = runner.optimizer.state
    grads = common.leaf_norms({k: st[v]["exp_avg"] / (1.0 - ADAM_BETA1)
                               for k, v in named.items() if v in st})
    m2 = runner.train(n_steps=2)
    change = common.leaf_norms({k: named[k].detach() - p0[k] for k in named})
    del p0
    losses = [float(m1["loss"][0]), float(m2["loss"][0]),
              float(m2["loss"][1])]
    return {"losses": losses, "grads": grads, "change": change}


def compare(prog, ref, grad_floor: float = 1e-3):
    """The training comparison: (loss gap, gradient gap, change gap) and
    the leaves compared. A leaf whose reference gradient lies under
    @grad_floor of the median leaf's moves under Adam by round-off alone
    and is left out of the change."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, _ = common.worst_leaf_gap(prog["grads"], ref["grads"])
    med = float(np.median(list(ref["grads"].values())))
    moved = {k for k, v in ref["grads"].items() if v >= grad_floor * med}
    change_gap, _ = common.worst_leaf_gap(prog["change"], ref["change"],
                                          keep=moved)
    if not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    return loss_gap, grad_gap, change_gap, sorted(moved)


def run(cell):
    dev = cell.device
    parts = common.Parts(cell.t_start)
    mod = program()
    cfg = refine_config(cell, mod)
    parts.mark("imports")
    kf = keyframes(cell)
    parts.mark("render")
    common.seed_host_rngs(0)
    runner = build(mod, cfg, kf, cell.seed, dev)
    parts.mark("build")
    prog = first_steps(runner)
    chunk = runner.scan_chunk
    with torch.profiler.record_function("bench:warmup"):
        runner.train(n_steps=max(chunk - 3, 1))
    common.sync(dev)
    setup_s = parts.mark("warmup")
    cell.note(parts.line())

    window = {"cfg": runner.cfg, "device_kind": common.device_kind(dev)}
    events = None
    if cell.trace:
        # the traced slice runs before the window, so the profiler's host
        # cost stays out of the window that the counters read
        n_tr = int(cell.traffic["traced_steps"])
        path = os.path.join(cell.scratch, "trace", "trace.json")
        with trace.device_trace(path):
            with torch.profiler.record_function("bench:train"):
                runner.train(n_steps=n_tr)
        events = trace.slim(path)
        gc.collect()
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        window["trace_units"] = n_tr
    t0 = time.perf_counter()
    steps, losses = 0, []
    while True:
        with torch.profiler.record_function("bench:train"):
            losses.append(runner.train(n_steps=chunk)["loss"])
        steps += chunk
        if time.perf_counter() - t0 >= cell.seconds:
            break
    wall = time.perf_counter() - t0
    losses = np.concatenate(losses)
    peak = common.memory_peak(dev)
    window.update(steps=steps, units=steps, window_s=wall, events=events)
    del runner
    common.release(dev)

    ref_mod = reference()
    common.seed_host_rngs(0)
    ref_runner = build(ref_mod, refine_config(cell, ref_mod), kf, cell.seed,
                       dev)
    ref = first_steps(ref_runner)
    del ref_runner
    common.release(dev)
    loss_gap, grad_gap, change_gap, _ = compare(prog, ref)
    lim = cell.limits
    compared = [("loss_gap", loss_gap, lim.get("loss_gap", 0.0)),
                ("grad_gap", grad_gap, lim.get("grad_gap", 0.0)),
                ("change_gap", change_gap, lim.get("change_gap", 0.0))]
    cell.note(f"card {common.device_label()}" if dev.startswith("cuda")
              else "device cpu")
    cell.note(f"setup_s {setup_s!r} window_s {wall!r} steps {steps}")
    out = Outcome(
        end_to_end={"refine_steps_per_s": steps / wall, "setup_s": setup_s},
        window=window, compared=compared, attempted=steps,
        failed=int(np.sum(~np.isfinite(losses))), memory_peak_bytes=peak,
        busy_s=None, window_s=None, breakdown=None)
    if events is not None:
        busy, span = trace.busy_and_window_s(events)
        out.busy_s, out.window_s = busy, span
        out.breakdown = {"device_ops": trace.top_ops(events),
                         "idle_gaps": trace.idle_gaps(events)}
    return out
