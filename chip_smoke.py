#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`bundlesdf_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one printed line each (or a few), any failure exits non-zero:
  1. the card: torch/CUDA versions, `nvidia-smi` name and power limit;
  2. build the `scatter_rows` CUDA kernel from `bundlesdf_tpu_torch/csrc`;
  3. kernel vs plain PyTorch scatter at the training step's shapes
     (12.58M rows into the 2,462,164-row table): uniform random rows, and
     the rows and values of one real training step, recorded on their way
     into the kernel, each row within the bound that float32 sums in
     another order obey (on a real step's rows, per level, a planted
     fault -- dropped atomics -- must fail that check); times of the
     kernel (group 32 and group 1), of `index_add_` and of the plain
     version, in turns, beside the bound, and the atomics the kernel
     issues by hash-grid level;
  4. hash-grid table/point gradients through the kernel vs the same graph
     with PyTorch's own scatter; one small training step on the card vs
     the same step on the CPU (the CPU path is the one held against the
     JAX package by tests/test_torch_*.py);
  5. the NOF main path: `NofRunner` (built without `device`: the card is
     the default) at the online workload (bench.py's configuration) trains
     10 + 50 steps; steps/s, memory, losses, and the kernel's launches
     (one a step, with group L*8);
     (before phase 6, the host reads a frame of the orbit written as a
     dataset folder through `YcbineoatReader`, Up and Paeth rows, timed);
  6. tracker components on the card vs the CPU at the steady 480x640
     shapes: the depth chain into the pool, `orb_lift_ransac_slots` (16
     pairs, 2048 features, injected RANSAC draws), `bundle_adjust_pooled`
     (10 frames, 4096 points, factor 4, hybrid entry), with times;
  7. the tracker main path: tracker-only `BundleSdf.run` over the first 30
     frames of the 120-frame easy orbit at 480x640 (default track config,
     ORB features replayed from tests/fixtures/tracker_orb_30f.npz),
     frames/s, stage times, memory, FAILs, keyframes, ADD/ADD-S against
     the ground truth and the stored JAX trajectory's;
  8. the full online loop, strict sync: `BundleSdf.run` with the NOF on
     over the first 15 of those frames (phase 7's track config and features; the
     NOF config of `run_custom.py --mode run_video`, `n_step` 500,
     `start_nerf_keyframes` 5, `sync_max_delay` 0): frames/s, NOF batches,
     steps and steps/s, the stall anatomy (`pipeline_stats`), memory, the
     scatter kernel's launches (= NOF steps) and the stream it ran on,
     ADD/ADD-S/AUC and the mesh Chamfer by `eval/benchmark.py`; then the
     final runner's `extract_mesh` against a CPU runner with its weights;
  9. the same run threaded (`sync_max_delay` 4, `async_host`), at
     `SPDLOG` 1: every frame writes its PNGs and `keyframes.yml` (timed
     as the `artifacts` stage) into a temporary folder;
 10. the offline refine: `run_custom.run_one_video_global_nerf` (the
     `--mode global_refine` entry point) on phase 9's artifacts at the
     refine config of `run_custom.py` (16 levels, finest 256, T=2^24,
     2048 rays x (64 + 256) samples, n_step cut from 2000 to 1000,
     mesh_resolution 0.002,
     texture 512): steps/s, memory, the kernel's launches (= steps) and
     stream, every artifact, the marching and rasterizer paths (native),
     the refined mesh's Chamfer and the optimized poses' ADD beside the
     online run's, the texture's filled share; then the kernel against
     its plain version on the rows of one refine step (83,886,080
     entries into 39,601,891 rows), timed as in phase 3;
 11. the bench (`bundlesdf_tpu_torch/bench.py`, the port of `bench.py`):
     its NOF line at full length, its tracking and pipeline lines on the
     first 30 of their 70 frames with a warm-up of 15 (ORB features from
     tests/fixtures/tracker_orb_bench70.npz); each record printed, device
     times from profiler unions, the kernel's launches in the NOF and
     pipeline lines (= that line's NOF steps, on the runner's stream),
     the pipeline's frame rate at most its device floor;
 12. the protocol driver (`bundlesdf_tpu_torch/benchmark_synthetic.py`)
     on the whole 120-frame easy orbit, `--no_nerf --skip_refine`, ORB
     features replayed from tests/fixtures/tracker_orb_easy120.npz: its
     `metrics.json` against the JAX driver's run stored in that file (no
     new FAIL frame, mean ADD at most max(2 x JAX, JAX + 1 mm));
 13. the port's ORB detector (`bundlesdf_tpu_torch/matcher/orb.py`, no
     cv2) on the 30 frames of phase 7, as the matcher crops them: wall
     and device ms a frame, host syncs a frame, its share of phase 7's
     tracked frame; its keypoints against its own CPU run of the same
     frames (>= 99 % the same) and against cv2's stored in
     tracker_orb_30f.npz (>= 95 % found, <= 2 of 256 bits apart on
     average);
 14. phase 12 with live detection (no `--orb_features`), gated the same
     way, its tracked frames/s beside phase 12's; then
     `run_custom.draw_pose` on three frames of its output and a two-frame
     `run_one_video(use_segmenter=True)`; fails if cv2 was imported;
 15. LoFTR (`matcher/pairing.py`, `matcher/loftr.py`, no hand kernel):
     the pairing warp card = CPU exactly and the full-width net
     (LoftrConfig(), seeded, match_thr 0) card = CPU at f32 on 4 pairs of
     the orbit at 400x400, bf16 against f32 on the card;
     `bench_loftr`'s four `loftr_pairs_per_sec` lines; then the tracker
     through LoFTR: run_custom's track config over the 30 frames, NOF off
     (frames/s, pairs a frame, device ms of the warp and the net, peak
     memory, FAILs, finite poses);
 16. the HO3D path: the 30 committed JPEGs of tests/fixtures/ho3d_orbit30
     decoded on the host by `utils/jpeg.py` (each frame's pixel SHA-256
     equal to imageio's, ms a frame by stage); the orbit written as an
     HO3D folder (tests/ho3d_layout.py) and read back through
     `Ho3dReader`; `run_ho3d.run_one_video` over its first 20 frames with
     the NOF on (0 FAIL, ADD against phase 9's on those frames, online
     Chamfer, launches = NOF steps); `run_ho3d.run_one_video_global_nerf`
     at HO3D's refine config (finest 512, 16 levels, four of them hashed,
     84,133,278 rows, n_step cut to 400) and the kernel on one such
     step's rows, timed and checked as in phase 10; `benchmark_ho3d`'s
     rows and results.csv; `run_videos_parallel` with two 10-frame
     videos interleaved on one card against each alone; a `use_gui` run;
 17. ray data parallelism (`parallel/dp.py`, `NofRunner(dp_devices=...)`)
     at phase 5's width with two replicas sharing the card ([cuda:0,
     cuda:0]): the DP gradient on one fixed 2048-ray batch against the
     single-device one, f32 and amp; 10 + 100 DP steps against 10 + 100
     single-device steps (steps/s, host and device ms a step, the
     gradient reduction's device ms), the replicas bit-equal, the
     kernel's launches (= steps x replicas, each on its replica's
     stream) and the kernel against its plain version on one DP step's
     rows; `add_new_frames` then 20 DP steps; a `BundleSdf` with
     `nerf_device: 0` over 10 frames (strict sync, NOF batches of 101
     steps), and `nerf_device: 1` and DP over every card where there is
     more than one;
 18. the last public names (no new kernel): `OrbMatcher.predict` on 8
     pairs of the orbit canonicalized to 400x400 by
     `matcher/pairing.py::process_image_pairs`, as `find_corres`'s
     predict branch does, card = CPU (the rows as sets, confidences
     within 1e-6), rows a pair, pairs/s over 5 calls and device ms a
     pair; `sample_occupied_steps` on the (t0, t1, occ, t_cap) that one
     training step of phase 5's runner hands the occupied sampler (2048
     rays), card = CPU within 1e-5 relative at `perturb=False`, and
     bit-equal to `occupied_sampler_state` + `draw_occupied_samples`
     under one seeded CUDA generator when perturbed;
 19. a JSON line of per-kernel results, then the final status line.
--profile adds torch.profiler tables of 5 NOF steps, of 5 tracked frames,
of 20 refine steps, of the online loop's first NOF batch and of one LoFTR
predict of 8 pairs (f32 and bf16). Needs a CUDA
card, nvcc, g++ (the native library) and cc (the JPEG decoder); refuses
to run on the CPU, and fails if jax, cv2, PIL, imageio or pandas was
imported.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# main-path shapes of the online workload (config.py defaults)
N_RAND, N_SAMPLES, N_LEVELS = 2048, 128 + 64, 4
M_ROWS = N_RAND * N_SAMPLES * N_LEVELS * 8        # 12,582,912 gathered rows
WARMUP_STEPS, TIMED_STEPS = 10, 50
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_S, F32_FLOPS = 3.35e12, 67e12


def _cuda_ms(fn, reps=10):
    """Median of @reps CUDA-event timings of fn() (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _queued_ms(fn, n=20):
    """Device ms of one fn() call: @n calls queued behind a ~10 ms device
    sleep, CUDA events around the n calls. The host enqueues the calls
    while the device sleeps, so its launch cost stays off the clock
    unless fn itself waits for the device."""
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _in_turns(fns, reps=5):
    """Median device ms of each of @fns (name -> fn), timed in turns:
    every fn in order, then in reverse order, @reps `_queued_ms` each."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k] += [_queued_ms(fns[k]) for _ in range(reps)]
    return {k: float(np.median(v)) for k, v in times.items()}


def _bound(vals, rows, n_rows):
    """Least time of the scatter on this card, ms, and what sets it: each
    input byte read once, the float32 output written once, against the
    M*C float32 adds at the float32 peak."""
    M, C = vals.shape
    nbytes = (vals.numel() * vals.element_size()
              + rows.numel() * rows.element_size() + n_rows * C * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, M * C / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _index_add(vals, rows, n_rows):
    """The library yardstick: one `index_add_` on inputs whose sentinels
    were filtered out (and values widened to float32) beforehand."""
    keep = (rows >= 0) & (rows < n_rows)
    idx, src = rows[keep].long(), vals[keep].float()
    C = vals.shape[1]
    return lambda: torch.zeros((n_rows, C), dtype=torch.float32,
                               device=vals.device).index_add_(0, idx, src)


def _smi():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_card():
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(_smi(), flush=True)


def phase_build():
    from bundlesdf_tpu_torch.ops.scatter import build_library
    t0 = time.perf_counter()
    path, log = build_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s {os.path.relpath(path, ROOT)}"
          f" | {' | '.join(ptxas)}", flush=True)


def _scatter_case(n_rows, C, dtype, gen):
    rows = torch.randint(0, n_rows, (M_ROWS,), generator=gen, device="cuda",
                         dtype=torch.int32)
    drop = torch.rand(M_ROWS, generator=gen, device="cuda") < 0.1
    rows[drop] = n_rows                                   # ~10% sentinels
    hot = torch.randperm(M_ROWS, generator=gen, device="cuda")[:8192]
    rows[hot] = n_rows // 3                               # one hot row
    vals = torch.randn((M_ROWS, C), generator=gen, device="cuda").to(dtype)
    return vals, rows


def _row_tolerance(vals, rows, n_rows):
    """How far two float32 sums of each row's entries, taken in different
    orders, may lie apart: a sum of n terms in any order is within
    (n - 1) u sum|terms| of the exact sum (u = 2^-24), so two such sums
    are within 2 n_r u S_r, with n_r the row's entries and S_r the sum of
    their magnitudes (per channel). A row with one entry must match
    exactly; an entry lost or sent to another row shows unless it is
    below ~1e-7 n_r of its row's magnitude."""
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows_torch
    ones = torch.ones((rows.shape[0], 1), device=rows.device)
    n = scatter_rows_torch(ones, rows, n_rows)
    return 2.0 ** -23 * 1.01 * n * scatter_rows_torch(vals.abs(), rows, n_rows)


def _check_scatter(name, vals, rows, n_rows, group, tol=None):
    """Kernel vs plain, each row within `_row_tolerance`. Returns the max
    abs error and the kernel's output."""
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows, scatter_rows_torch
    out = scatter_rows(vals, rows, n_rows, group=group)
    ref = scatter_rows_torch(vals, rows, n_rows)
    tol = _row_tolerance(vals, rows, n_rows) if tol is None else tol
    diff = (out - ref).abs()
    err, bad = float(diff.max()), int((diff > tol).sum())
    if bad:
        raise AssertionError(f"scatter {name} group {group}: kernel != "
                             f"plain in {bad} row-channels beyond the "
                             f"summation-order bound, max abs err {err}")
    return err, out


def check_by_level(name, vals, rows, n_rows, group, out, tol, layout,
                   every=1000):
    """The check's power on a real step, level by level: the rows' value
    range (max and median |plain| of the nonzero rows), the kernel's worst
    error against the tolerance, and a planted fault that must fail the
    check -- every @every-th sample's 8 corner entries of the level
    dropped from the kernel's output, as a kernel losing those atomics
    would. Returns one dict a level."""
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows_torch
    ref = scatter_rows_torch(vals, rows, n_rows)
    n_samples = rows.shape[0] // group
    base = torch.arange(0, n_samples, every, device=rows.device) * group
    levels = []
    for lvl, (_, _, n, off) in enumerate(layout):
        sl = slice(off, off + n)
        r, d, t = ref[sl], (out[sl] - ref[sl]).abs(), tol[sl]
        nz = r[r != 0].abs()
        m = (base[:, None] + lvl * 8
             + torch.arange(8, device=rows.device)).reshape(-1)
        lost = scatter_rows_torch(vals[m], rows[m], n_rows)[sl]
        caught = int(((out[sl] - lost - r).abs() > t).sum())
        levels.append({
            "max_ref": float(nz.max()) if nz.numel() else 0.0,
            "median_ref": float(nz.median()) if nz.numel() else 0.0,
            "max_err": float(d.max()),
            "err_over_tol": float((d / t.clamp_min(1e-38)).max()),
            "fault_row_channels": caught})
    print(f"scatter {name} check by level (max|plain| / median|plain| of "
          f"nonzero rows, max err, max err/tol, row-channels failing with "
          f"every {every}th sample's corners dropped): " + "; ".join(
              f"L{i} {v['max_ref']:.3e}/{v['median_ref']:.3e} "
              f"{v['max_err']:.1e} {v['err_over_tol']:.3f} "
              f"{v['fault_row_channels']}" for i, v in enumerate(levels)),
          flush=True)
    blind = [i for i, v in enumerate(levels) if not v["fault_row_channels"]]
    if blind:
        raise AssertionError(f"scatter {name}: the check misses dropped "
                             f"atomics on levels {blind}")
    return levels


def phase_scatter(n_rows):
    """Kernel vs plain on uniform random rows at the main-path shapes (no
    runs: group 1), timed in turns with index_add_ and the plain version."""
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows, scatter_rows_torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, C, dtype in (("c2_f32", 2, torch.float32),
                           ("c2_bf16", 2, torch.bfloat16),
                           ("c16_bf16", 16, torch.bfloat16)):
        vals, rows = _scatter_case(n_rows, C, dtype, gen)
        err, _ = _check_scatter(name, vals, rows, n_rows, 1)
        t = _in_turns({
            "ms": lambda: scatter_rows(vals, rows, n_rows),
            "library_ms": _index_add(vals, rows, n_rows),
            "plain_ms": lambda: scatter_rows_torch(vals, rows, n_rows)})
        bound_ms, _ = _bound(vals, rows, n_rows)
        results[name] = {"max_abs_err": err, **t, "bound_ms": bound_ms}
        print(f"scatter uniform {name}: M={M_ROWS} n_rows={n_rows} C={C} "
              f"max_abs_err={err:.3e} kernel {t['ms']:.4f} ms, index_add_ "
              f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_ms / t['ms']:.1%})",
              flush=True)
        del vals, rows
    return results


def record_step(runner):
    """The (vals, rows, n_rows, group) that one real training step of
    @runner hands the scatter kernel, recorded on their way in."""
    from bundlesdf_tpu_torch.ops import hashgrid
    orig, seen = hashgrid.scatter_rows, []

    def recorder(vals, rows, n_rows, group=1):
        seen.append((vals.clone(), rows.clone(), n_rows, group))
        return orig(vals, rows, n_rows, group=group)

    hashgrid.scatter_rows = recorder
    try:
        runner.train(n_steps=1)
    finally:
        hashgrid.scatter_rows = orig
    if len(seen) != 1:
        raise AssertionError(f"one training step made {len(seen)} scatter "
                             f"calls, expected 1")
    return seen[0]


def record_sampler_inputs(runner):
    """(t0, t1, occ, t_cap, n_samples) that one real training step of
    @runner hands the occupied sampler, recorded on their way in."""
    from bundlesdf_tpu_torch.nof import render
    orig, seen = render.occupied_sampler_state, []

    def recorder(t0, t1, occ, t_cap=None):
        seen.append(tuple(x.detach().clone() for x in (t0, t1, occ, t_cap)))
        return orig(t0, t1, occ, t_cap=t_cap)

    render.occupied_sampler_state = recorder
    try:
        runner.train(n_steps=1)
    finally:
        render.occupied_sampler_state = orig
    if len(seen) != 1:
        raise AssertionError(f"one training step made {len(seen)} occupied "
                             f"sampler calls, expected 1")
    return seen[0] + (runner.rcfg.n_samples,)


def run_atomics(rows, n_rows, group, samples):
    """Vector atomics the kernel issues for each of the @group columns
    (per channel chunk): one per run of equal in-range rows along the
    column, a run cut every @samples samples (1: one per entry)."""
    n = rows.shape[0] // group
    r = rows[:n * group].view(n, group)
    new = torch.ones_like(r, dtype=torch.bool)
    new[1:] = r[1:] != r[:-1]
    new[::samples] = True
    return (new & (r >= 0) & (r < n_rows)).sum(0)


def phase_scatter_real(runner, name="real step"):
    """The kernel on the rows of one real training step of @runner: group
    L*8 (runs summed in registers) and group 1 (one atomic per entry),
    index_add_ and the plain version, in turns; the bound and the atomics
    by level."""
    from bundlesdf_tpu_torch.ops.scatter import (RUN_SAMPLES, scatter_rows,
                                                 scatter_rows_torch)
    vals, rows, n_rows, group = record_step(runner)
    L = runner.spec.grid.n_levels
    m_rows = runner.tcfg.n_rand * (runner.rcfg.n_samples
                                   + runner.rcfg.n_samples_around_depth) * L * 8
    if group != L * 8 or vals.shape != (m_rows, 2) \
            or n_rows != runner.spec.grid.total_rows:
        raise AssertionError(f"{name}: group {group}, vals "
                             f"{tuple(vals.shape)}, {n_rows} rows; expected "
                             f"{L * 8}, ({m_rows}, 2), "
                             f"{runner.spec.grid.total_rows}")
    tol = _row_tolerance(vals, rows, n_rows)
    err_g, out = _check_scatter(name, vals, rows, n_rows, group, tol)
    err_1, _ = _check_scatter(name, vals, rows, n_rows, 1, tol)
    errs = [err_g, err_1]
    by_level = check_by_level(name, vals, rows, n_rows, group, out, tol,
                              runner.spec.grid.layout())
    del out, tol
    adds = run_atomics(rows, n_rows, group, 1).view(L, 8).sum(1)
    runs = run_atomics(rows, n_rows, group, RUN_SAMPLES).view(L, 8).sum(1)
    t = _in_turns({
        "real_step_ms": lambda: scatter_rows(vals, rows, n_rows, group=group),
        "group1_ms": lambda: scatter_rows(vals, rows, n_rows),
        "library_ms": _index_add(vals, rows, n_rows),
        "plain_ms": lambda: scatter_rows_torch(vals, rows, n_rows),
        # the output's zero fill alone: part of every variant above
        "zero_fill_ms": lambda: torch.zeros((n_rows, vals.shape[1]),
                                            device=vals.device)})
    bound_ms, bound_by = _bound(vals, rows, n_rows)
    res = {"max_abs_err": max(errs), **t, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_share": bound_ms / t["real_step_ms"],
           "row_adds": adds.tolist(), "atomics": runs.tolist(),
           "check_by_level": by_level,
           "m_rows": m_rows, "n_rows": n_rows, "group": group}
    print(f"scatter {name}: M={rows.shape[0]} C={vals.shape[1]} "
          f"{vals.dtype} n_rows={n_rows} group={group} max_abs_err "
          f"{max(errs):.3e}; kernel group {group} "
          f"{t['real_step_ms']:.4f} ms, group 1 {t['group1_ms']:.4f} ms, "
          f"index_add_ {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
          f"ms (each with the output's zero fill, {t['zero_fill_ms']:.4f} "
          f"ms alone); bound {bound_ms:.4f} ms ({bound_by}), "
          f"{res['bound_share']:.1%} of it reached", flush=True)
    print(f"scatter {name} by level: in-range row-adds "
          f"{adds.tolist()} (sum {int(adds.sum())}); vector atomics at group "
          f"{group} {runs.tolist()} (sum {int(runs.sum())}, "
          f"{RUN_SAMPLES}-sample tiles)", flush=True)
    return res


def _ray_points(n_rays, n_samples, gen):
    o = torch.rand((n_rays, 1, 3), generator=gen, device="cuda") * 0.6 - 0.3
    d = torch.randn((n_rays, 1, 3), generator=gen, device="cuda")
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.sort(torch.rand((n_rays, n_samples, 1), generator=gen,
                              device="cuda") * 0.6, dim=1).values
    return (o + d * t).reshape(-1, 3).clamp(-0.99, 0.99)


def phase_hashgrid_grad(spec):
    """Table and point gradients through GatherRows (the kernel) vs the same
    graph whose gather backward is PyTorch's index_select backward."""
    from bundlesdf_tpu_torch.ops.hashgrid import (hashgrid_corners,
                                                  hashgrid_encode,
                                                  init_hashgrid_params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x0 = _ray_points(N_RAND, N_SAMPLES, gen)
    table0 = init_hashgrid_params(spec, generator=gen, device="cuda")
    cot = torch.randn((x0.shape[0], spec.out_dim), generator=gen,
                      device="cuda")
    errs = []
    for bf16 in (False, True):
        s = replace(spec, table_bf16=bf16)
        dtype = torch.bfloat16 if bf16 else torch.float32
        grads = []
        for use_kernel in (True, False):
            table = table0.clone().requires_grad_()
            x = x0.clone().requires_grad_()
            if use_kernel:
                enc = hashgrid_encode(table, x, s)
            else:
                rows, wc = hashgrid_corners(x, s)
                f = table.index_select(0, rows.reshape(-1).long()).to(dtype)
                f = f.view(x.shape[0], s.n_levels, 8, -1).float()
                enc = torch.sum(f * wc[..., None], dim=2).reshape(x.shape[0], -1)
            torch.sum(enc * cot).backward()
            grads.append((table.grad, x.grad))
        torch.cuda.synchronize()
        for what, a, b in zip(("table", "x"), grads[0], grads[1]):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, atol=1e-4, rtol=1e-5):
                raise AssertionError(f"hashgrid {what} grad (bf16={bf16}): "
                                     f"kernel != plain, max abs err {err}")
            errs.append(err)
        print(f"hashgrid grad bf16={bf16}: {x0.shape[0]} points, table/x "
              f"max abs err {errs[-2]:.3e}/{errs[-1]:.3e}", flush=True)
    return max(errs)


def phase_step_vs_cpu(runner):
    """One f32 training step (perturb off) of 256 rays on the card and on
    the CPU from the same state; rtol 1e-4 on losses, 1e-3 * max|g| on
    gradients (float32 sums in other orders, device math libraries)."""
    from bundlesdf_tpu_torch.nof.losses import nof_loss
    from bundlesdf_tpu_torch.nof.models import NofField
    from bundlesdf_tpu_torch.nof.render import render_rays
    from bundlesdf_tpu_torch.ops.occupancy import OccupancyGrid
    spec = replace(runner.spec, grid=replace(runner.spec.grid,
                                             table_bf16=False))
    rcfg = replace(runner.rcfg, compute_bf16=False)
    idx = torch.arange(0, runner.n_rays_valid, runner.n_rays_valid // 256,
                       device="cuda")[:256]
    out = {}
    for dev in ("cuda", "cpu"):
        field = NofField(spec, device=dev)
        field.load_state_dict({k: v.to(dev) for k, v in
                               runner.field.state_dict().items()})
        occ = runner.occ_grid
        occ = OccupancyGrid(occ.grid.to(dev), occ.res, occ.trace.to(dev),
                            occ.trace_res)
        batch = {k: v[idx].to(dev) for k, v in runner.rays.items()}
        o = render_rays(field, rcfg, batch, runner.c2w.to(dev), occ,
                        perturb=False, trunc=runner.tcfg.trunc)
        loss, metrics = nof_loss(o, batch, field, runner.tcfg.trunc,
                                 runner.lcfg)
        loss.backward()
        out[dev] = ({k: float(v.detach()) for k, v in metrics.items()},
                    {n: p.grad.cpu() for n, p in field.named_parameters()})
    (m_g, g_g), (m_c, g_c) = out["cuda"], out["cpu"]
    for k in m_c:
        if not np.isclose(m_g[k], m_c[k], rtol=1e-4, atol=0):
            raise AssertionError(f"step metric {k}: cuda {m_g[k]} cpu {m_c[k]}")
    worst = 0.0
    for n in g_c:
        scale = float(g_c[n].abs().max())
        err = float((g_g[n] - g_c[n]).abs().max())
        if err > 1e-3 * scale:
            raise AssertionError(f"step grad {n}: max abs err {err} "
                                 f"(max |g| {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"step cuda vs cpu: loss {m_g['loss']:.6f} vs {m_c['loss']:.6f}, "
          f"worst grad err {worst:.2e} of max|g|", flush=True)


def runner_inputs(n_frames=5):
    """The online workload's NofRunner inputs, as bench.py builds them, on
    the first @n_frames frames of the 480x640 orbit: (cfg, rgbs, depths,
    masks, poses, K)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import cube_orbit_sequence
    from bundlesdf_tpu_torch.config import default_nerf_config
    from bundlesdf_tpu_torch.nof.runner import preprocess_frame_data
    from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

    seq = cube_orbit_sequence(n_frames=n_frames, H=480, W=640, radius=0.45,
                              obj_size=0.08)
    translation = np.zeros(3)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(sc_factor=sc, translation=translation.tolist()))
    poses_gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    rgbs, depths, masks, _, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        poses_gl.copy(), sc, translation)
    return cfg, rgbs, depths, masks, poses, seq["K"]


def make_runner(n_frames=5, inputs=None, **kw):
    """NofRunner at the online workload (built without `device`: the card
    is the default) on the first @n_frames of @inputs (`runner_inputs`);
    @kw go to NofRunner."""
    from bundlesdf_tpu_torch.nof.runner import NofRunner
    cfg, rgbs, depths, masks, poses, K = inputs or runner_inputs(n_frames)
    runner = NofRunner(dict(cfg), rgbs[:n_frames], depths[:n_frames],
                       masks[:n_frames], None, poses[:n_frames], K, **kw)
    if runner.device.type != "cuda":
        raise AssertionError(f"NofRunner's default device is {runner.device}")
    return runner


def phase_main(runner):
    from bundlesdf_tpu_torch.ops import hashgrid
    # the group of every scatter call, counted on the way in
    groups, orig = collections.Counter(), hashgrid.scatter_rows

    def counted(vals, rows, n_rows, group=1):
        groups[group] += 1
        return orig(vals, rows, n_rows, group=group)

    hashgrid.scatter_rows = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches0 = scatter_launches()
        m0 = runner.train(n_steps=WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m1 = runner.train(n_steps=TIMED_STEPS)   # pulls metrics: a host sync
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = scatter_launches() - launches0
    finally:
        hashgrid.scatter_rows = orig
    peak = torch.cuda.max_memory_allocated()
    loss = np.concatenate([m0["loss"], m1["loss"]])
    sdf = np.concatenate([m0["sdf_loss"], m1["sdf_loss"]])
    print(f"main path: {runner.n_rays_valid} rays in store, "
          f"{TIMED_STEPS / dt:.3f} steps/s, {1e3 * dt / TIMED_STEPS:.3f} ms/step "
          f"({TIMED_STEPS} steps after {WARMUP_STEPS} warm-up), peak "
          f"{peak / 2 ** 30:.3f} GiB, loss {loss[0]:.5f} -> {loss[-1]:.5f}, "
          f"sdf_loss {sdf[0]:.5f} -> {sdf[-1]:.5f}, scatter_rows launches "
          f"{launches} (calls by group {dict(groups)})", flush=True)
    if not np.isfinite(loss).all():
        raise AssertionError("main path: non-finite loss")
    if not sdf[-5:].mean() < sdf[:5].mean():
        raise AssertionError(f"main path: sdf_loss did not fall "
                             f"({sdf[:5].mean()} -> {sdf[-5:].mean()})")
    n_steps = WARMUP_STEPS + TIMED_STEPS
    group = runner.spec.grid.n_levels * 8
    if launches != n_steps or dict(groups) != {group: n_steps}:
        raise AssertionError(f"main path: {launches} scatter_rows launches, "
                             f"calls by group {dict(groups)}, for {n_steps} "
                             f"steps; expected one a step with group {group}")
    return launches


def phase_profile(runner, n_steps=5):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.train(n_steps=n_steps)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    table = ka.table(sort_by="cuda_time_total", row_limit=30)
    print(f"profile of {n_steps} steps, {torch.cuda.get_device_name(0)}\n"
          f"{table}", flush=True)
    for e in ka:
        if "scatter_rows_kernel" in e.key:
            print(f"profile: {e.key}: {e.count} launches, "
                  f"{e.device_time_total / e.count:.3f} us device time "
                  f"each", flush=True)


# ---------------------------------------------------------------------------
# the tracker (phases 6-7)
# ---------------------------------------------------------------------------
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tracker_orb_30f.npz")
N_TRACK = 30
N_STRICT = 15           # phase 8's frames: the first 15 of the 30
# stated tolerances of the card-vs-CPU component checks
MAP_TOL_M = 1e-4        # depth / xyz maps, meters
NORMAL_TOL = 1e-3       # unit normals: cross products of one-pixel xyz
#                         differences amplify depth rounding ~1/spacing
MAX_FLIP = 1e-3         # share of pixels / matches whose gate may flip
POSE_TOL = 1e-4         # BA poses: radians and meters


def tracker_inputs():
    """The 30 card frames (first 30 of the 120-frame easy orbit) and the
    replayed ORB features + JAX trajectory of the fixture."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import cube_orbit_sequence
    t0 = time.perf_counter()
    seq = cube_orbit_sequence(n_frames=N_TRACK, H=480, W=640, radius=0.45,
                              obj_size=0.08,
                              full_angle=2 * np.pi * N_TRACK / 120,
                              noise=0.002, seed=0)
    fx = dict(np.load(FIXTURE))
    offs = np.concatenate([[0], np.cumsum(fx["counts"])])
    feats = {seq["id_strs"][i]: (fx["uv"][offs[i]:offs[i + 1]],
                                 fx["des"][offs[i]:offs[i + 1]])
             for i in range(N_TRACK)}
    print(f"tracker inputs: {N_TRACK} frames 480x640 generated in "
          f"{time.perf_counter() - t0:.2f} s, {int(fx['counts'].min())}-"
          f"{int(fx['counts'].max())} ORB features a frame", flush=True)
    return seq, feats, fx


def phase_reader(seq, n=5):
    """Host ms a frame of `YcbineoatReader.get_color + get_depth +
    get_mask` (what `run_custom.run_one_video` reads a frame with) on @n
    frames of the orbit written as a dataset folder, every PNG row Up (the
    port's own writer) and then Paeth (the slowest rows to decode, which
    libpng's adaptive filter choice favours); the frames read back equal."""
    from bundlesdf_tpu_torch.datasets import YcbineoatReader
    from bundlesdf_tpu_torch.utils.png import write_png
    res = {}
    with tempfile.TemporaryDirectory(prefix="bsdf_reader_") as tmp:
        for filt, name in ((2, "up"), (4, "paeth")):
            root = os.path.join(tmp, name)
            for sub in ("rgb", "depth", "masks"):
                os.makedirs(os.path.join(root, sub))
            np.savetxt(os.path.join(root, "cam_K.txt"), seq["K"])
            depth_mm = np.round(seq["depths"][:n] * 1e3).astype(np.uint16)
            for i in range(n):
                f = f"{seq['id_strs'][i]}.png"
                write_png(os.path.join(root, "rgb", f), seq["colors"][i], filt)
                write_png(os.path.join(root, "depth", f), depth_mm[i], filt)
                write_png(os.path.join(root, "masks", f),
                          (seq["masks"][i] > 0).astype(np.uint8) * 255, filt)
            reader = YcbineoatReader(root)
            t0 = time.perf_counter()
            frames = [(reader.get_color(i), reader.get_depth(i),
                       reader.get_mask(i)) for i in range(n)]
            res[name] = (time.perf_counter() - t0) / n * 1e3
            for i, (c, d, m) in enumerate(frames):
                if not (np.array_equal(c, seq["colors"][i])
                        and np.array_equal(d, (depth_mm[i] / 1e3).astype(np.float32))
                        and np.array_equal(m > 0, seq["masks"][i] > 0)):
                    raise AssertionError(f"reader ({name} rows): frame {i} "
                                         f"does not read back as written")
    print(f"reader: YcbineoatReader color + depth + mask of a 480x640 frame "
          f"(host, {n} frames): Up rows {res['up']:.3f} ms, Paeth rows "
          f"{res['paeth']:.3f} ms", flush=True)
    return res


def _angle(Ra, Rb):
    """Rotation angle between float32-rounded rotations: ||Ra - Rb||_F /
    sqrt(2) (arccos of the trace loses ~1e-4 rad to rounding there)."""
    return np.linalg.norm(Ra - Rb, axis=(1, 2)) / np.sqrt(2)


def phase_tracker_components(seq, feats):
    """Each tracker program on the card against the same call on the CPU,
    from the same inputs."""
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    from bundlesdf_tpu_torch.tracker.ba import BAConfig, bundle_adjust_pooled
    from bundlesdf_tpu_torch.tracker.pool import (FramePool,
                                                  orb_lift_ransac_slots,
                                                  preprocess_into_pool)
    from bundlesdf_tpu_torch.tracker.ransac import draw_samples
    cfg = default_track_config()
    dp = cfg["depth_processing"]
    n_fr = 10
    pools = {d: FramePool(480, 640, cap=n_fr, device=d)
             for d in ("cuda", "cpu")}
    # depth chain into the pool: every frame on both devices
    flips = worst = worst_n = 0.0
    for i in range(n_fr):
        for pool in pools.values():
            pool.insert_preprocessed(i, seq["depths"][i], seq["K"],
                                     seq["masks"][i], dp)
        g, c = pools["cuda"], pools["cpu"]
        s = g.slot_of[i]
        vg, vc = g.valids[s].cpu(), c.valids[s]
        flips = max(flips, float((vg != vc).float().mean()))
        both = vg & vc
        for a, b in ((g.depths, c.depths), (g.xyzs, c.xyzs)):
            worst = max(worst, float((a[s].cpu() - b[s])[both].abs().max()))
        worst_n = max(worst_n, float((g.nrms[s].cpu()
                                      - c.nrms[s])[both].abs().max()))
    if flips > MAX_FLIP or worst > MAP_TOL_M or worst_n > NORMAL_TOL:
        raise AssertionError(f"depth chain cuda vs cpu: maps {worst:.3e} m, "
                             f"normals {worst_n:.3e}, valid flips {flips}")
    g = pools["cuda"]
    # timed: frame 0 rewritten into its own slot (the same values again)
    dep = torch.as_tensor(seq["depths"][0], device="cuda")
    Kc = torch.as_tensor(seq["K"], dtype=torch.float32, device="cuda")
    mc = torch.as_tensor(seq["masks"][0], device="cuda")
    ms_pre = _cuda_ms(lambda: preprocess_into_pool(
        *g.tensors, g.slot_of[0], dep, Kc, mc))
    print(f"tracker depth chain 480x640 cuda vs cpu: maps max err "
          f"{worst:.3e} m, normals {worst_n:.3e}, valid flips {flips:.2e}; "
          f"{ms_pre:.3f} ms a frame on the card", flush=True)
    # the CPU pool takes the card's maps, so the programs below start from
    # identical inputs
    c = pools["cpu"]
    for a, b in zip(c.tensors, g.tensors):
        a.copy_(b.cpu())

    # fused match + lift + RANSAC: 16 pairs, injected draws
    pairs = [(i, j) for i in range(1, n_fr) for j in (i - 1, i - 2)
             if j >= 0][:16]
    orb = OrbMatcher(detector=lambda f: feats[f.id_str])
    fr = [type("F", (), {"id": i, "id_str": seq["id_strs"][i]})()
          for i in range(n_fr)]
    ent = [orb._frame_feats(f) for f in fr]
    T_gt = seq["cam_in_obs"].astype(np.float32)
    caps = np.array([[0.02, np.deg2rad(30)] if a == b + 1 else [999, np.pi]
                     for a, b in pairs], np.float32)
    host = dict(nA=[len(ent[a][0]) for a, _ in pairs],
                nB=[len(ent[b][0]) for _, b in pairs],
                slots_a=[g.slot_of[a] for a, _ in pairs],
                slots_b=[g.slot_of[b] for _, b in pairs],
                TA=T_gt[[a for a, _ in pairs]], TB=T_gt[[b for _, b in pairs]],
                cap_t=caps[:, 0], cap_r=caps[:, 1])
    st = dict(seed=0, inlier_dist=0.005,
              cos_normal_angle=float(np.cos(np.deg2rad(30))), ratio=0.75,
              nbits=256, m_cap=1024, n_trials=2000)

    def args(dev, pool):
        a = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in host.items()}
        a.update(bitsA=torch.stack([ent[i][2] for i, _ in pairs]).to(dev),
                 bitsB=torch.stack([ent[j][2] for _, j in pairs]).to(dev),
                 uvfA=torch.stack([ent[i][3] for i, _ in pairs]).to(dev),
                 uvfB=torch.stack([ent[j][3] for _, j in pairs]).to(dev))
        return (pool.xyzs, pool.nrms), a

    (xc, nc), ac = args("cpu", c)
    first = orb_lift_ransac_slots(xc, nc, **ac, **st)
    idx = draw_samples(first["ok"], 2000, seed=7)
    res = {}
    for dev, pool in (("cuda", g), ("cpu", c)):
        (x, n), a = args(dev, pool)
        res[dev] = {k: v.cpu() for k, v in orb_lift_ransac_slots(
            x, n, **a, **st, sample_idx=idx.to(dev)).items()}
    rg, rc = res["cuda"], res["cpu"]
    for k in ("uvA", "uvB", "conf", "n_raw", "ok"):
        if not torch.equal(rg[k], rc[k]):
            raise AssertionError(f"orb_lift_ransac_slots {k}: cuda != cpu")
    lift_err = float((rg["pA_cam"] - rc["pA_cam"]).abs().max())
    n_ok = int(rc["ok"].sum())
    mflip = int((rg["inlier_mask"] != rc["inlier_mask"]).sum())
    pairs_same = int((rg["inlier_mask"] == rc["inlier_mask"]).all(1).sum())
    if lift_err > 0 or mflip > MAX_FLIP * n_ok or pairs_same < len(pairs) - 1:
        raise AssertionError(f"orb_lift_ransac_slots: lift err {lift_err}, "
                             f"{mflip} inlier flips of {n_ok}, "
                             f"{pairs_same}/{len(pairs)} pairs identical")
    (xg, ng), ag = args("cuda", g)
    ms_orb = _cuda_ms(lambda: orb_lift_ransac_slots(
        xg, ng, **ag, **st, k_pull=256), reps=5)
    print(f"tracker orb_lift_ransac_slots P={len(pairs)} F=2048 M=1024 "
          f"T=2000 cuda vs cpu: match indices + lifts identical, inlier "
          f"masks {pairs_same}/{len(pairs)} pairs identical ({mflip} flips "
          f"of {n_ok} matches), {int(rc['inlier_mask'].sum())} inliers; "
          f"{ms_orb:.3f} ms a call on the card", flush=True)

    # bundle adjustment: 10 frames, D=4096 at factor 4, hybrid entry
    rng = np.random.default_rng(2)
    poses0 = T_gt[:n_fr].copy()
    poses0[1:, :3, 3] += rng.normal(0, 0.003, (n_fr - 1, 3))
    pts = rng.uniform(-0.06, 0.06, (40, 3))
    ci, cj, pi, pj = [], [], [], []
    for a in range(n_fr - 1):
        for b in (a + 1,):
            Ta, Tb = (np.linalg.inv(seq["cam_in_obs"][k]) for k in (a, b))
            ci += [a] * len(pts)
            cj += [b] * len(pts)
            pi.append(pts @ Ta[:3, :3].T + Ta[:3, 3])
            pj.append(pts @ Tb[:3, :3].T + Tb[:3, 3])
    D = 4096
    src_idx = np.zeros((n_fr, D), np.int64)
    src_valid = np.zeros((n_fr, D), bool)
    for k in range(n_fr):
        f = np.nonzero(seq["masks"][k][::4, ::4].reshape(-1) > 0)[0]
        f = f[np.linspace(0, len(f) - 1, min(len(f), D)).astype(int)]
        src_idx[k, :len(f)] = f
        src_valid[k, :len(f)] = True
    pair_ij = np.array([(i, j) for i in range(n_fr)
                        for j in range(i + 1, n_fr)], np.int64)
    rows_w = np.nonzero((pair_ij == n_fr - 1).any(1))[0]
    host_ba = dict(slots=[g.slot_of[k] for k in range(n_fr)],
                   slot_live=np.ones(n_fr, np.float32), poses0=poses0,
                   K=seq["K"].astype(np.float32), pair_ij=pair_ij,
                   corr_i=np.array(ci), corr_j=np.array(cj),
                   corr_pi=np.concatenate(pi).astype(np.float32),
                   corr_pj=np.concatenate(pj).astype(np.float32),
                   corr_valid=np.ones(len(ci), np.float32),
                   update_flags=np.r_[0, np.ones(n_fr - 1)].astype(np.float32),
                   src_idx=src_idx, src_valid=src_valid,
                   pair_valid=np.ones(len(pair_ij), np.float32),
                   pair_ij_w=pair_ij[rows_w], pair_w_dst=rows_w)
    cfg_ba = BAConfig()          # hybrid entry, bf16 scoring, early-out

    def ba(dev, pool):
        a = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in host_ba.items()}
        return bundle_adjust_pooled(pool.xyzs_h, pool.nrms_h, **a, factor=4,
                                    cfg=cfg_ba, pre_decim=2)

    pg, pc = ba("cuda", g).cpu().double().numpy(), ba("cpu", c).double(
    ).numpy()
    dt = float(np.abs(pg[:, :3, 3] - pc[:, :3, 3]).max())
    dr = float(_angle(pg[:, :3, :3], pc[:, :3, :3]).max())
    gt_t = seq["cam_in_obs"][:n_fr, :3, 3]
    err0 = float(np.linalg.norm(poses0[:, :3, 3] - gt_t, axis=1).mean())
    gt_err = float(np.linalg.norm(pg[:, :3, 3] - gt_t, axis=1).mean())
    if dt > POSE_TOL or dr > POSE_TOL or not gt_err < err0:
        raise AssertionError(f"bundle_adjust_pooled cuda vs cpu: {dt:.3e} m "
                             f"{dr:.3e} rad; error to GT {err0:.3e} -> "
                             f"{gt_err:.3e} m")
    ms_ba = _cuda_ms(lambda: ba("cuda", g), reps=5)
    print(f"tracker bundle_adjust_pooled N={n_fr} P={len(pair_ij)} "
          f"Pw={len(rows_w)} D={D} factor 4 cuda vs cpu: poses {dt:.3e} m "
          f"{dr:.3e} rad; mean translation error to GT {err0 * 1e3:.3f} -> "
          f"{gt_err * 1e3:.3f} mm; {ms_ba:.3f} ms a call on the card",
          flush=True)
    return {"preprocess_ms": ms_pre, "orb_lift_ransac_ms": ms_orb,
            "bundle_adjust_ms": ms_ba}


def _track(seq, feats, n_frames, profile_from=None):
    """Tracker-only BundleSdf over @n_frames frames on the card. Returns
    (tracker, frames, seconds from frame 5 to the end)."""
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_track_config
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    cfg = default_track_config()
    cfg.update(stage_timing=True, SPDLOG=0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg["debug_dir"] = tmp
        # built without `device`: the card is the default
        matcher = OrbMatcher(detector=lambda f: feats[f.id_str])
        t = BundleSdf(cfg_track=cfg, start_nerf_keyframes=10 ** 9,
                      matcher=matcher)
        if t.device.type != "cuda" or matcher.device.type != "cuda":
            raise AssertionError(f"BundleSdf's default device is {t.device}")
        frames, prof = [], None
        for i in range(n_frames):
            if i == 5:
                torch.cuda.synchronize()
                t5 = time.perf_counter()
            if i == profile_from:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                tp = time.perf_counter()
            frames.append(t.run(seq["colors"][i], seq["depths"][i].copy(),
                                seq["K"], seq["id_strs"][i],
                                mask=seq["masks"][i]))
        t.on_finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t5
        if prof is not None:
            wall = time.perf_counter() - tp
            prof.__exit__(None, None, None)
            return t, frames, dt, (prof, wall)
    return t, frames, dt, None


def phase_tracker_main(seq, feats, fx):
    from bundlesdf_tpu_torch.eval.metrics import add_err, adi_err
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t, frames, dt, _ = _track(seq, feats, N_TRACK)
    peak = torch.cuda.max_memory_allocated()
    status = np.array([f.status.value for f in frames])
    cam_in_ob = np.array([f.pose_in_model for f in frames])
    pred = np.linalg.inv(cam_in_ob)
    gt = np.linalg.inv(seq["cam_in_obs"])
    pred = pred @ np.linalg.inv(pred[0]) @ gt[0]
    mp = fx["model_pts"]
    add = np.array([add_err(p, q, mp) for p, q in zip(pred, gt)])
    adds = np.array([adi_err(p, q, mp) for p, q in zip(pred, gt)])
    jax_add, jax_adds = float(fx["jax_add"].mean()), float(fx["jax_adds"].mean())
    stages = {}
    for st in t.stage_stats[5:]:
        for k, v in st.items():
            stages.setdefault(k, []).append(v * 1e3)
    med = {k: float(np.median(v)) for k, v in sorted(stages.items())}
    n = N_TRACK - 5
    print(f"tracker main path: {N_TRACK} frames 480x640, frames 5-29 "
          f"{n / dt:.3f} frames/s {1e3 * dt / n:.3f} ms/frame; median stage "
          f"ms {json.dumps({k: round(v, 3) for k, v in med.items()})}; peak "
          f"{peak / 2 ** 30:.3f} GiB; FAIL {int((status == 0).sum())} "
          f"(JAX {int((fx['jax_status'] == 0).sum())}); keyframes "
          f"{len(t.bundler.keyframes)} (JAX {len(fx['jax_keyframes'])}); "
          f"mean ADD {add.mean() * 1e3:.4f} mm ADD-S {adds.mean() * 1e3:.4f} "
          f"mm; JAX mean ADD {jax_add * 1e3:.4f} mm ADD-S "
          f"{jax_adds * 1e3:.4f} mm", flush=True)
    new_fail = np.nonzero((status == 0) & (fx["jax_status"] != 0))[0]
    if len(new_fail):
        raise AssertionError(f"tracker: frames {new_fail.tolist()} FAIL that "
                             f"did not FAIL in the JAX run")
    if not np.isfinite(cam_in_ob).all():
        raise AssertionError("tracker: non-finite poses")
    if add.mean() > max(2 * jax_add, jax_add + 1e-3):
        raise AssertionError(f"tracker: mean ADD {add.mean()} m above "
                             f"max(2 x JAX, JAX + 1 mm), JAX {jax_add} m")
    return {"frames_per_s": n / dt, "ms_per_frame": 1e3 * dt / n,
            "stage_ms": med, "peak_gib": peak / 2 ** 30,
            "add_mm": add.mean() * 1e3, "adds_mm": adds.mean() * 1e3}


def phase_tracker_profile(seq, feats):
    _, _, _, (prof, wall) = _track(seq, feats, 10, profile_from=5)
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # device-side events only, as the table's own "Self CUDA time total"
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    for e in ka:
        if e.key.startswith("stage:"):
            print(f"{e.key} ({e.device_type.name} event): calls {e.count}, "
                  f"host {e.cpu_time_total / 1e3:.3f} ms, device "
                  f"{e.device_time_total / 1e3:.3f} ms", flush=True)
    print(f"profile of 5 tracked frames (5-9), "
          f"{torch.cuda.get_device_name(0)}: wall {wall * 1e3:.3f} ms, "
          f"device-busy {dev_us / 1e3:.3f} ms ({dev_us / 1e4 / wall:.1f} % "
          f"of wall)\n"
          f"{ka.table(sort_by='self_cuda_time_total', row_limit=40)}",
          flush=True)


# ---------------------------------------------------------------------------
# the full online loop: tracker + NOF (phases 8-9)
# ---------------------------------------------------------------------------
NOF_STEPS = 500         # n_step of every NOF batch (config.py default)
SDF_TOL = 1e-4          # card vs CPU SDF grid (float32 MLP sums, TF32 off)
FACE_TOL = 0.005        # card vs CPU face count, relative
CHAMFER_MAX_CM = 2.0


def online_nerf_config(cfg_track, **over):
    """The NOF config of `run_custom.py --mode run_video` (its online
    changes to the defaults, run_custom.py:58-67) plus @over."""
    from bundlesdf_tpu_torch.config import default_nerf_config
    cfg = default_nerf_config()
    cfg.update(continual=True, trunc_start=0.01, trunc=0.01,
               mesh_resolution=0.005, down_scale_ratio=1, fs_sdf=0.1,
               far=cfg_track["depth_processing"]["zfar"], n_step=NOF_STEPS)
    cfg.update(over)
    return cfg


def visible_gt_points(seq, model_pts, n_frames):
    """The GT model points the frames saw: within 5 mm of a masked depth
    map lifted with its GT pose."""
    from scipy.spatial import cKDTree
    from bundlesdf_tpu_torch.utils.common import depth2xyzmap
    pts = []
    for i in range(n_frames):
        d = seq["depths"][i].astype(np.float64)
        xyz = depth2xyzmap(d, seq["K"])[(d >= 0.1) & (seq["masks"][i] > 0)]
        T = seq["cam_in_obs"][i]
        pts.append(xyz[::4] @ T[:3, :3].T + T[:3, 3])
    dist, _ = cKDTree(np.concatenate(pts)).query(model_pts, k=1)
    return model_pts[dist < 0.005]


def scatter_launches() -> int:
    """The scatter kernel's launches so far in this process (the counter
    `scatter_rows.launches` of the port's span registry)."""
    from bundlesdf_tpu_torch.utils import profiling
    return profiling.snapshot().get("scatter_rows.launches", (0, 0.0))[0]


def count_streams():
    """Wrap the hash-grid backward's scatter so each call counts the CUDA
    stream it was issued on; returns (counter, undo)."""
    from bundlesdf_tpu_torch.ops import hashgrid
    streams, orig = collections.Counter(), hashgrid.scatter_rows

    def on_stream(vals, rows, n_rows, group=1):
        streams[torch.cuda.current_stream().cuda_stream] += 1
        return orig(vals, rows, n_rows, group=group)

    hashgrid.scatter_rows = on_stream

    def undo():
        hashgrid.scatter_rows = orig
    return streams, undo


def run_video(seq, feats, cfg_nerf, n_frames, profile_from=None,
              out_dir=None):
    """`BundleSdf.run` over @n_frames with the NOF on (built without
    `device`: the card is the default), then `on_finish`. Returns the
    tracker, its frames, the wall seconds from a device sync to the end of
    on_finish, the scatter kernel's launches over the run, and the CUDA
    streams the kernel was launched on. With @profile_from, a
    torch.profiler of the card's activity runs from that frame to the end
    and is returned with its wall seconds as a 6th item. With @out_dir the
    run writes its artifacts there (`SPDLOG` 1, with the two config files
    `run_custom.run_one_video` dumps), for the offline refine."""
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_track_config, dump_config
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    cfg = default_track_config()
    cfg.update(stage_timing=True, SPDLOG=0 if out_dir is None else 1)

    with (tempfile.TemporaryDirectory() if out_dir is None
          else contextlib.nullcontext(out_dir)) as tmp:
        cfg["debug_dir"] = tmp
        cfg_nerf = dict(cfg_nerf, save_dir=os.path.join(tmp, "nerf"))
        if out_dir is not None:
            dump_config(cfg, os.path.join(tmp, "config_bundletrack.yml"))
            dump_config(cfg_nerf, os.path.join(tmp, "config_nerf.yml"))
        matcher = OrbMatcher(detector=lambda f: feats[f.id_str])
        t = BundleSdf(cfg_track=cfg, cfg_nerf=cfg_nerf,
                      start_nerf_keyframes=5, matcher=matcher)
        if t.device.type != "cuda":
            raise AssertionError(f"BundleSdf's default device is {t.device}")
        streams, undo = count_streams()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches0 = scatter_launches()
            t0 = time.perf_counter()
            frames, prof = [], None
            for i in range(n_frames):
                if i == profile_from:
                    from torch.profiler import ProfilerActivity, profile
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    tp = time.perf_counter()
                frames.append(t.run(seq["colors"][i], seq["depths"][i].copy(),
                                    seq["K"], seq["id_strs"][i],
                                    mask=seq["masks"][i]))
            t.on_finish()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = scatter_launches() - launches0
            if prof is not None:
                wall = time.perf_counter() - tp
                prof.__exit__(None, None, None)
                return t, frames, dt, launches, streams, (prof, wall)
        finally:
            undo()
    return t, frames, dt, launches, streams


def phase_video(seq, feats, fx, name, cfg_nerf, n_frames=N_TRACK,
                strict_ref=None, out_dir=None):
    """The full online loop (tracker + NOF) on the card, scored by
    `eval/benchmark.py` against the ground truth and gated against the
    JAX package's tracker-only run of the same frames (the fixture). With
    @out_dir it leaves its artifacts there (see `run_video`)."""
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra
    t, frames, dt, launches, streams = run_video(seq, feats, cfg_nerf,
                                                 n_frames, out_dir=out_dir)
    # the artifact writes (SPDLOG 1), a stage of their own
    art_s = sum(st.get("artifacts", 0.0) for st in t.stage_stats)
    peak = torch.cuda.max_memory_allocated()
    st = t.pipeline_stats
    steps = st.get("nof_steps_total", 0)
    # NOF wall inside batches: the worker's whole batches when threaded,
    # else dispatch + tracker polls + the blocking drain
    batch_s = st.get("nerf_worker_s") or (st["nerf_dispatch_s"]
                                          + st["nerf_poll_s"]
                                          + st["nerf_sync_s"])
    status = np.array([f.status.value for f in frames])
    pred = np.linalg.inv(np.array([f.pose_in_model for f in frames]))
    gt = np.linalg.inv(seq["cam_in_obs"][:n_frames])
    mp = fx["model_pts"]
    scores = benchmark_video(None, gt, mp, visible_gt_points(seq, mp, n_frames),
                             pred_poses=pred, pred_mesh=t.mesh)
    jax_add = float(fx["jax_add"][:n_frames].mean())
    nerf_stream = t.nerf.stream.cuda_stream
    res = {"frames_per_s": n_frames / dt, "ms_per_frame": 1e3 * dt / n_frames,
           "n_batches": st["n_batches"], "nof_steps_total": steps,
           "nof_steps_per_s": steps / max(batch_s, 1e-9),
           "pipeline_stats": st, "peak_gib": peak / 2 ** 30,
           "launches": launches,
           "add_mm": scores["ADD(cm)"] * 10, "adds_mm": scores["ADDS(cm)"] * 10,
           "add_auc": scores["ADD_AUC(%)"], "adds_auc": scores["ADDS_AUC(%)"],
           "chamfer_cm": scores["chamfer(cm)"],
           "mesh_vertices": 0 if t.mesh is None else len(t.mesh.vertices),
           "mesh_faces": 0 if t.mesh is None else len(t.mesh.faces),
           "marching": marching_tetrahedra.last_path, "artifacts_s": art_s,
           "pred_poses": pred}
    vs = "" if strict_ref is None else (
        f" (strict sync {strict_ref['frames_per_s']:.4f} frames/s, "
        f"{strict_ref['ms_per_frame']:.3f} ms/frame)")
    print(f"run_video {name}: {n_frames} frames 480x640, "
          f"{res['frames_per_s']:.4f} frames/s {res['ms_per_frame']:.3f} "
          f"ms/frame{vs}; NOF batches {st['n_batches']}, steps {steps} "
          f"({res['nof_steps_per_s']:.3f} steps/s inside batches); "
          f"scatter_rows launches {launches}; kernel streams "
          f"{ {('nof' if k == nerf_stream else k): v for k, v in streams.items()} }; "
          f"peak {res['peak_gib']:.3f} GiB", flush=True)
    if out_dir is not None:
        print(f"run_video {name} artifacts (SPDLOG 1, PNGs + keyframes.yml "
              f"of every frame): {art_s:.3f} s of stage time; "
              f"{n_frames / max(dt - art_s, 1e-9):.4f} frames/s without "
              f"them", flush=True)
    print(f"run_video {name} pipeline_stats "
          f"{json.dumps({k: round(v, 6) for k, v in st.items()})}",
          flush=True)
    print(f"run_video {name} accuracy: FAIL {int((status == 0).sum())} (JAX "
          f"{int((fx['jax_status'][:n_frames] == 0).sum())}); keyframes "
          f"{len(t.bundler.keyframes)} (JAX "
          f"{int((fx['jax_keyframes'] < n_frames).sum())}); "
          f"nerfed {sum(kf.nerfed for kf in t.bundler.keyframes)}; mean ADD "
          f"{res['add_mm']:.4f} mm ADD-S {res['adds_mm']:.4f} mm (AUC "
          f"{res['add_auc']:.2f} / {res['adds_auc']:.2f} %), JAX tracker-only "
          f"ADD {jax_add * 1e3:.4f} mm; mesh {res['mesh_vertices']} vertices "
          f"{res['mesh_faces']} faces, {res['marching']} marching, Chamfer "
          f"{res['chamfer_cm']:.4f} cm", flush=True)
    new_fail = np.nonzero((status == 0) & (fx["jax_status"][:n_frames] != 0))[0]
    if len(new_fail):
        raise AssertionError(f"run_video {name}: frames {new_fail.tolist()} "
                             f"FAIL that did not FAIL in the JAX run")
    if not np.isfinite(pred).all():
        raise AssertionError(f"run_video {name}: non-finite poses")
    if res["add_mm"] > max(2 * jax_add * 1e3, jax_add * 1e3 + 1):
        raise AssertionError(f"run_video {name}: mean ADD {res['add_mm']} mm "
                             f"above max(2 x JAX, JAX + 1 mm), JAX "
                             f"{jax_add * 1e3} mm")
    if t.mesh is None or not res["chamfer_cm"] < CHAMFER_MAX_CM:
        raise AssertionError(f"run_video {name}: mesh {res['mesh_faces']} "
                             f"faces, Chamfer {res['chamfer_cm']} cm (gate "
                             f"{CHAMFER_MAX_CM} cm)")
    if not (steps > 0 and launches == steps):
        raise AssertionError(f"run_video {name}: {launches} scatter_rows "
                             f"launches for {steps} NOF steps")
    if set(streams) != {nerf_stream} or \
            nerf_stream == torch.cuda.default_stream().cuda_stream:
        raise AssertionError(f"run_video {name}: scatter kernel launched on "
                             f"streams {dict(streams)}, the runner's is "
                             f"{nerf_stream}")
    if not all(kf.nerfed for kf in t.bundler.keyframes):
        raise AssertionError(f"run_video {name}: a keyframe was never synced "
                             f"from the NOF")
    return t, res


def phase_video_profile(seq, feats, n_frames=10, profile_from=5):
    """Device busy share of the online loop (strict sync): the card's
    kernels from frame @profile_from through `on_finish` of a
    @n_frames-frame run, which holds the first NOF batch (501 steps)."""
    from torch.autograd import DeviceType
    from bundlesdf_tpu_torch.config import default_track_config
    cfg = online_nerf_config(default_track_config(), sync_max_delay=0)
    t, _, _, launches, _, (prof, wall) = run_video(
        seq, feats, cfg, n_frames, profile_from=profile_from)
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA)
    print(f"profile of the online loop, frames {profile_from}-"
          f"{n_frames - 1} + on_finish ({t.pipeline_stats['n_batches']} NOF "
          f"batch(es), {t.pipeline_stats.get('nof_steps_total', 0)} steps, "
          f"{launches} scatter launches), {torch.cuda.get_device_name(0)}: "
          f"wall {wall:.3f} s, device-busy {dev_us / 1e6:.3f} s "
          f"({dev_us / 1e4 / wall:.1f} % of wall)\n"
          f"{ka.table(sort_by='self_cuda_time_total', row_limit=15)}",
          flush=True)


def phase_mesh_vs_cpu(runner):
    """The card runner's `extract_mesh` against a CPU runner built from the
    same keyframes and given the same trained weights: SDF grid within
    SDF_TOL, face count within FACE_TOL."""
    from bundlesdf_tpu_torch.nof import runner as runner_mod
    cpu = runner_mod.NofRunner(
        runner.cfg, runner.images, runner.depths, runner.masks,
        runner.normal_maps, runner.poses, runner.K,
        occ_masks=runner.occ_masks, build_octree_pts=runner.build_octree_pts,
        device="cpu")
    with torch.cuda.stream(runner.stream):
        cpu.field.load_state_dict({k: v.cpu() for k, v in
                                   runner.field.state_dict().items()})
    if not torch.equal(cpu.occ_grid.grid, runner.occ_grid.grid.cpu()):
        raise AssertionError("mesh vs cpu: occupancy grids differ")
    grids, orig = [], runner_mod.marching_tetrahedra

    def spy(field, isolevel=0.0):
        grids.append(np.array(field))
        return orig(field, isolevel)

    runner_mod.marching_tetrahedra = spy
    try:
        t0 = time.perf_counter()
        mg = runner.extract_mesh()
        t_card = time.perf_counter() - t0
        mc = cpu.extract_mesh()
    finally:
        runner_mod.marching_tetrahedra = orig
    err = float(np.abs(grids[0] - grids[1]).max())
    nf = (len(mg.faces), len(mc.faces))
    print(f"extract_mesh card vs cpu: grid {grids[0].shape}, "
          f"{int((grids[0] < 1).sum())} occupied cells queried, SDF max abs "
          f"err {err:.3e}, faces {nf[0]} vs {nf[1]}; {t_card:.3f} s on the "
          f"card (query + marching)", flush=True)
    if err > SDF_TOL or abs(nf[0] - nf[1]) > FACE_TOL * nf[1]:
        raise AssertionError(f"extract_mesh card vs cpu: SDF err {err}, "
                             f"faces {nf}")
    return err


# ---------------------------------------------------------------------------
# the offline refine (phase 10)
# ---------------------------------------------------------------------------
REFINE_STEPS = 1000      # phase 10's n_step, cut from 2000 to make room
#                          for phase 17 (the kernel's rows stay one full
#                          refine step's)
ARTIFACTS = ("nerf_with_bundletrack_online/mesh_cleaned.obj",
             "nerf_with_bundletrack_online/mesh_real_world.obj",
             "nerf_with_bundletrack_online/optimized_poses.txt",
             "nerf_with_bundletrack_online/config.yml",
             "textured_mesh.obj", "textured_mesh.mtl", "textured_mesh.png")


def _keyframe_add(seq, mp, ids, cam_in_obs, gt_vis, mesh=None):
    """ADD/ADD-S/AUC (and the mesh Chamfer) of keyframe poses @cam_in_obs
    (ids @ids) by eval/benchmark.py, against the ground truth."""
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    idx = [seq["id_strs"].index(i) for i in ids]
    gt = np.linalg.inv(seq["cam_in_obs"][idx])
    return benchmark_video(None, gt, mp, gt_vis,
                           pred_poses=np.linalg.inv(cam_in_obs),
                           pred_mesh=mesh)


def phase_refine(seq, fx, out_dir, online, profile=False):
    """`run_custom.run_one_video_global_nerf` (the `--mode global_refine`
    entry point) on phase 9's artifacts at the refine config: steps/s,
    memory, the kernel's launches (= steps) and stream, the artifacts, the
    refined mesh and poses against the ground truth beside the online
    run's, the texture; then the kernel at the refine step's rows."""
    from bundlesdf_tpu_torch import run_custom
    from bundlesdf_tpu_torch.config import load_yaml
    from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra
    from bundlesdf_tpu_torch.mesh.render import rasterize
    from bundlesdf_tpu_torch.utils.png import read_png
    streams, undo = count_streams()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches0 = scatter_launches()
        t0 = time.perf_counter()
        t = run_custom.run_one_video_global_nerf(
            out_folder=out_dir, refine_overrides={"n_step": REFINE_STEPS})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = scatter_launches() - launches0
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    st, cfg, runner = t.refine_stats, t.nerf.cfg, t.nerf
    nerf_stream = runner.stream.cuda_stream
    print(f"refine: {st['keyframes']} keyframes 480x640, {st['steps']} steps "
          f"(n_step {cfg['n_step']}), {cfg['num_levels']} levels finest "
          f"{cfg['finest_res']} T=2^{cfg['log2_hashmap_size']} "
          f"({runner.spec.grid.total_rows} rows), {cfg['N_rand']} rays x "
          f"({cfg['N_samples']} + {cfg['N_samples_around_depth']}) samples; "
          f"{st['steps_per_s']:.3f} steps/s ({1e3 / st['steps_per_s']:.3f} "
          f"ms/step) over {st['timed_steps']} steps after a first chunk of "
          f"{st['steps'] - st['timed_steps']} in {st['first_chunk_s']:.3f} s; read + scene bounds + ray store "
          f"{st['read_prep_s']:.3f} s, mesh {st['mesh_s']:.3f} s, texture "
          f"{st['texture_s']:.3f} s, wall {wall:.3f} s; peak "
          f"{peak / 2 ** 30:.3f} GiB; scatter_rows launches {launches}; "
          f"kernel streams "
          f"{ {('nof' if k == nerf_stream else k): v for k, v in streams.items()} }; "
          f"marching {marching_tetrahedra.last_path}, rasterizer "
          f"{rasterize.last_path}", flush=True)
    missing = [a for a in ARTIFACTS
               if not os.path.exists(os.path.join(out_dir, a))]
    if missing:
        raise AssertionError(f"refine: artifacts missing: {missing}")
    if launches != st["steps"] or set(streams) != {nerf_stream} or \
            nerf_stream == torch.cuda.default_stream().cuda_stream:
        raise AssertionError(f"refine: {launches} scatter_rows launches for "
                             f"{st['steps']} steps, on streams "
                             f"{dict(streams)} (the runner's: {nerf_stream})")
    if (marching_tetrahedra.last_path, rasterize.last_path) != \
            ("native", "native"):
        raise AssertionError(f"refine: marching {marching_tetrahedra.last_path}"
                             f", rasterizer {rasterize.last_path}; the native "
                             f"library should have run both")
    poses = np.loadtxt(os.path.join(out_dir, ARTIFACTS[2])).reshape(-1, 4, 4)
    R = poses[:, :3, :3]
    orth = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
    if not np.isfinite(poses).all() or orth > 1e-3:
        raise AssertionError(f"refine: optimized poses not finite and "
                             f"orthonormal (max |R R^T - I| {orth})")
    # keyframe poses before (online, keyframes.yml) and after the refine
    stamps = sorted(d for d in os.listdir(out_dir) if os.path.exists(
        os.path.join(out_dir, d, "keyframes.yml")))
    reg = load_yaml(os.path.join(out_dir, stamps[-1], "keyframes.yml"))
    ids = sorted(reg)
    if len(ids) != len(poses):
        raise AssertionError(f"refine: {len(poses)} optimized poses for "
                             f"{len(ids)} keyframes")
    before = np.array([np.reshape(reg[i]["cam_in_ob"], (4, 4)) for i in ids])
    mp = fx["model_pts"]
    gt_vis = visible_gt_points(seq, mp, N_TRACK)
    s_on = _keyframe_add(seq, mp, ids, before, gt_vis)
    s_ref = _keyframe_add(seq, mp, ids, poses.astype(np.float64), gt_vis,
                          mesh=t.mesh)
    tex = read_png(os.path.join(out_dir, "textured_mesh.png"))
    filled = float((tex != 128).any(-1).mean())
    res = {"steps": st["steps"], "steps_per_s": st["steps_per_s"],
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "wall_s": wall, "stats": st,
           "mesh_faces": len(t.mesh.faces), "chamfer_cm": s_ref["chamfer(cm)"],
           "add_mm": s_ref["ADD(cm)"] * 10, "adds_mm": s_ref["ADDS(cm)"] * 10,
           "online_kf_add_mm": s_on["ADD(cm)"] * 10, "texture_filled": filled}
    print(f"refine accuracy: mesh {len(t.mesh.vertices)} vertices "
          f"{len(t.mesh.faces)} faces, Chamfer {res['chamfer_cm']:.4f} cm "
          f"(online mesh of phase 9: {online['mesh_faces']} faces, Chamfer "
          f"{online['chamfer_cm']:.4f} cm); optimized_poses.txt mean ADD "
          f"{res['add_mm']:.4f} mm ADD-S {res['adds_mm']:.4f} mm (AUC "
          f"{s_ref['ADD_AUC(%)']:.2f} %) over {len(ids)} keyframes, the same "
          f"keyframes online {res['online_kf_add_mm']:.4f} mm; texture "
          f"{tex.shape[1]}x{tex.shape[0]}, {filled:.1%} of texels filled",
          flush=True)
    if not res["chamfer_cm"] < CHAMFER_MAX_CM:
        raise AssertionError(f"refine: Chamfer {res['chamfer_cm']} cm (gate "
                             f"{CHAMFER_MAX_CM} cm)")
    if profile:
        phase_refine_profile(runner)
    res["kernel"] = phase_scatter_real(runner, name="refine step")
    return res


def phase_refine_profile(runner, n_steps=20):
    """Device-busy share of @n_steps more refine steps of @runner."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.train(n_steps=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA)
    print(f"profile of {n_steps} refine steps, "
          f"{torch.cuda.get_device_name(0)}: wall {wall * 1e3:.3f} ms "
          f"({wall * 1e3 / n_steps:.3f} ms/step), device-busy "
          f"{dev_us / 1e3:.3f} ms ({dev_us / 1e4 / wall:.1f} % of wall)\n"
          f"{ka.table(sort_by='self_cuda_time_total', row_limit=15)}",
          flush=True)


# ---------------------------------------------------------------------------
# the bench and the protocol driver (phases 11-12)
# ---------------------------------------------------------------------------
BENCH_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "tracker_orb_bench70.npz")
EASY_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "tracker_orb_easy120.npz")
BENCH_FRAMES, BENCH_WARMUP = 30, 15


def _counted(fn):
    """fn() with the scatter kernel's launches counted and the CUDA
    streams they were issued on; returns (result, launches, streams)."""
    streams, undo = count_streams()
    try:
        launches0 = scatter_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, scatter_launches() - launches0, streams
    finally:
        undo()


def _check_launches(line, launches, streams, steps, stream):
    if not (steps > 0 and launches == steps):
        raise AssertionError(f"bench {line}: {launches} scatter_rows launches "
                             f"for {steps} NOF steps")
    if set(streams) != {stream.cuda_stream} or \
            stream.cuda_stream == torch.cuda.default_stream().cuda_stream:
        raise AssertionError(f"bench {line}: scatter kernel launched on "
                             f"streams {dict(streams)}, the runner's is "
                             f"{stream.cuda_stream}")


def phase_bench():
    """The bench's three lines through its own functions: the NOF line as
    `python -m bundlesdf_tpu_torch.bench` runs it, the tracking and
    pipeline lines on the first 30 frames (warm-up 15)."""
    from bundlesdf_tpu_torch import bench
    t0 = time.perf_counter()
    (nof, runner), nof_launches, nof_streams = _counted(
        lambda: bench.bench_nof("cuda"))
    print(json.dumps(nof), flush=True)
    _check_launches("nof_train_steps_per_sec", nof_launches, nof_streams,
                    runner.global_step, runner.stream)
    nof_steps = runner.global_step
    del runner
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    seq = bench.tracking_sequence()
    t2 = time.perf_counter()
    trk, _ = bench.bench_tracking("cuda", BENCH_FIXTURE,
                                  n_frames=BENCH_FRAMES, warmup=BENCH_WARMUP,
                                  seq=seq)
    print(json.dumps(trk), flush=True)
    t3 = time.perf_counter()
    (pipe, t), pipe_launches, pipe_streams = _counted(
        lambda: bench.bench_pipeline(
            "cuda", BENCH_FIXTURE, n_frames=BENCH_FRAMES,
            warmup=BENCH_WARMUP,
            device_ms_per_step=nof["device_ms_per_step"],
            device_ms_per_frame=trk["device_ms_per_frame"], seq=seq))
    print(json.dumps(pipe), flush=True)
    _check_launches("pipeline_fps", pipe_launches, pipe_streams,
                    pipe["nof_steps_trained"], t.nerf.stream)
    del t
    torch.cuda.empty_cache()
    for rec, keys in ((nof, ("device_ms_per_step", "util")),
                      (trk, ("device_ms_per_frame", "device_fps",
                             "device_ms_by_program", "util")),
                      (pipe, ("device_floor_fps_single_chip",
                              "overlap_efficiency"))):
        missing = [k for k in keys if k not in rec]
        if missing or not np.isfinite(rec["value"]) or rec["value"] <= 0:
            raise AssertionError(f"bench {rec['metric']}: value "
                                 f"{rec['value']}, missing {missing}")
    # the floor bounds the frame rate over the same frames and steps
    if pipe["overlap_efficiency"] > 1:
        raise AssertionError(f"bench pipeline_fps: {pipe['value']} frames/s "
                             f"beats its device floor "
                             f"{pipe['device_floor_fps_single_chip']} "
                             f"({pipe['floor_window']})")
    secs = time.perf_counter() - t0
    print(f"bench phase: {secs:.1f} s (NOF line {t1 - t0:.1f} s, 70 frames "
          f"rendered {t2 - t1:.1f} s, tracking line {t3 - t2:.1f} s, "
          f"pipeline line {time.perf_counter() - t3:.1f} s); scatter_rows "
          f"launches: NOF line "
          f"{nof_launches} for {nof_steps} steps, pipeline line "
          f"{pipe_launches} for {pipe['nof_steps_trained']} steps, all on "
          f"the runners' streams", flush=True)
    return {"nof": nof, "tracking": trk, "pipeline": pipe,
            "nof_launches": nof_launches, "nof_steps": nof_steps,
            "pipeline_launches": pipe_launches, "seconds": secs}


def phase_protocol():
    """`python -m bundlesdf_tpu_torch.benchmark_synthetic --protocol easy
    --n_frames 120 --no_nerf --skip_refine --orb_features ...` (through
    its `main`), gated against the JAX driver's run in the fixture."""
    from bundlesdf_tpu_torch import benchmark_synthetic as driver
    fx = np.load(EASY_FIXTURE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bsdf_protocol_") as out:
        m = driver.main(["--out", out, "--protocol", "easy", "--n_frames",
                         "120", "--no_nerf", "--skip_refine",
                         "--orb_features", EASY_FIXTURE])
        ids = [f"{i:04d}" for i in range(120)]
        status = driver.collect_frame_statuses(os.path.join(out, "run"), ids)
    secs = time.perf_counter() - t0
    jax_add_cm = float(fx["jax_add"].mean()) * 100
    jax_fail = fx["jax_status"] == 0
    fail = np.array([s == "FAIL" for s in status])
    print(f"protocol easy, 120 frames 480x640, tracker only: {secs:.1f} s "
          f"(wall_s {m['wall_s']}), FAIL {int(fail.sum())} (JAX "
          f"{int(jax_fail.sum())}), ADD {m['ADD(cm)']:.4f} cm ADD-S "
          f"{m['ADDS(cm)']:.4f} cm AUC {m['ADD_AUC(%)']:.2f} / "
          f"{m['ADDS_AUC(%)']:.2f} %; JAX driver ADD {jax_add_cm:.4f} cm "
          f"ADD-S {float(fx['jax_adds'].mean()) * 100:.4f} cm, keyframes "
          f"{len(fx['jax_keyframes'])}", flush=True)
    if "MISSING" in status:
        raise AssertionError("protocol easy: a frame wrote no frame.txt")
    new_fail = np.nonzero(fail & ~jax_fail)[0]
    if len(new_fail):
        raise AssertionError(f"protocol easy: frames {new_fail.tolist()} "
                             f"FAIL that did not FAIL in the JAX run")
    if not m["ADD(cm)"] <= max(2 * jax_add_cm, jax_add_cm + 0.1):
        raise AssertionError(f"protocol easy: mean ADD {m['ADD(cm)']} cm "
                             f"above max(2 x JAX, JAX + 1 mm), JAX "
                             f"{jax_add_cm} cm")
    return {**m, "seconds": secs}


def _orb_frames(seq):
    """The frames as the tracker's Frame hands them to the matcher."""
    from types import SimpleNamespace
    return [SimpleNamespace(id=i, id_str=seq["id_strs"][i],
                            color=seq["colors"][i],
                            fg_mask=(seq["masks"][i] > 0).astype(np.uint8))
            for i in range(len(seq["colors"]))]


def _feature_overlap(uv_a, des_a, uv_b, des_b, k=4):
    """(share of b's keypoints that a holds at the same position within
    1e-3 px, mean differing descriptor bits over those). Keypoints of two
    octaves can land on one position, so each is held to the closest
    descriptor among a's (up to @k) keypoints there."""
    from scipy.spatial import cKDTree
    d, j = cKDTree(uv_a).query(uv_b, k=k, distance_upper_bound=1e-3)
    near = np.isfinite(d)
    hit = near.any(1)
    j = np.where(near, j, 0)
    bits = np.unpackbits(des_a[j] ^ des_b[:, None], axis=2).sum(2)
    bits = np.where(near, bits, 256).min(1)[hit]
    return float(hit.mean()), float(bits.mean()) if hit.any() else 256.0


def phase_orb(seq, fx, tracked_ms):
    """The port's ORB on the card over phase 7's frames: times, host
    syncs, and its keypoints against its CPU run and against cv2's."""
    import warnings

    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    from bundlesdf_tpu_torch.utils.profiling import (device_events,
                                                     device_trace,
                                                     interval_union_ms,
                                                     load_trace, trace_path)
    frames = _orb_frames(seq)
    card = OrbMatcher()                     # the card, as the tracker's
    card.detect_features(frames[0])
    torch.cuda.synchronize()
    walls, syncs, got = [], 0, []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for f in frames:
                torch.cuda.synchronize()
                n0 = len(caught)
                t0 = time.perf_counter()
                uv, des = card.detect_features(f)
                syncs += sum("synchroniz" in str(w.message)
                             for w in caught[n0:])
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                got.append((uv, des))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [(uv.cpu().numpy(), des.cpu().numpy()) for uv, des in got]
    with tempfile.TemporaryDirectory(prefix="bsdf_orb_") as tmp:
        with device_trace(tmp, "cuda"):
            for f in frames:
                card.detect_features(f)
        dev_ms = interval_union_ms(device_events(
            load_trace(trace_path(tmp)))) / len(frames)
    t0 = time.perf_counter()
    cpu = OrbMatcher(device="cpu")
    ref = [tuple(t.numpy() for t in cpu.detect_features(f)) for f in frames]
    cpu_ms = 1e3 * (time.perf_counter() - t0) / len(frames)
    offs = np.concatenate([[0], np.cumsum(fx["counts"])])
    same, same_bits, cv_hit, cv_bits = [], [], [], []
    for k, ((uv, des), (uv_c, des_c)) in enumerate(zip(got, ref)):
        s1, b1 = _feature_overlap(uv, des, uv_c, des_c)
        s2, _ = _feature_overlap(uv_c, des_c, uv, des)
        same.append(min(s1, s2))
        same_bits.append(b1)
        s, b = _feature_overlap(uv, des, fx["uv"][offs[k]:offs[k + 1]],
                                fx["des"][offs[k]:offs[k + 1]])
        cv_hit.append(s)
        cv_bits.append(b)
    wall = float(np.median(walls))
    counts = [len(uv) for uv, _ in got]
    res = {"frames": len(frames), "wall_ms": wall,
           "wall_ms_mean": float(np.mean(walls)), "device_ms": dev_ms,
           "host_syncs_per_frame": syncs / len(frames),
           "cpu_ms": cpu_ms, "share_of_tracked_frame": wall / tracked_ms,
           "tracked_ms": tracked_ms, "card_eq_cpu_min": min(same),
           "card_cpu_bits_max": max(same_bits),
           "vs_cv2_found_min": min(cv_hit),
           "vs_cv2_bits_mean": float(np.mean(cv_bits))}
    print(f"orb: {len(frames)} frames 480x640, mask crops zoomed to 400 px, "
          f"{min(counts)}-{max(counts)} keypoints a frame; wall "
          f"{wall:.3f} ms a frame (median; mean {res['wall_ms_mean']:.3f}), "
          f"device {dev_ms:.3f} ms a frame (profiler union), host syncs "
          f"{res['host_syncs_per_frame']:.2f} a frame, CPU {cpu_ms:.1f} ms a "
          f"frame; {100 * wall / tracked_ms:.1f} % of phase 7's tracked "
          f"frame ({tracked_ms:.3f} ms, replayed features); card = CPU: "
          f"keypoints {100 * min(same):.2f} % (worst frame), descriptor bits "
          f"apart {max(same_bits):.4f}; against cv2 (fixture): found "
          f"{100 * min(cv_hit):.2f} % (worst frame), bits apart "
          f"{res['vs_cv2_bits_mean']:.4f} on average", flush=True)
    if min(same) < 0.99:
        raise AssertionError(f"orb: card and CPU keypoints agree on "
                             f"{min(same):.4f} < 0.99 of a frame")
    if min(cv_hit) < 0.95 or res["vs_cv2_bits_mean"] > 2:
        raise AssertionError(f"orb: against cv2, found {min(cv_hit):.4f} "
                             f"(>= 0.95), bits {res['vs_cv2_bits_mean']:.3f} "
                             f"(<= 2)")
    if res["host_syncs_per_frame"] > 1:
        raise AssertionError(f"orb: {res['host_syncs_per_frame']} host "
                             f"syncs a frame (at most 1)")
    return res


def _draw_pose_check(out, ids):
    """`run_custom.draw_pose` on frames @ids of a run in @out: the GT mesh
    placed in the run's model frame (by the first frame's tracked and
    annotated poses), the run's tracked poses; returns the box pixels
    drawn a frame."""
    from bundlesdf_tpu_torch import run_custom
    from bundlesdf_tpu_torch.benchmark_synthetic import gt_mesh
    from bundlesdf_tpu_torch.utils.png import read_png
    pose_dir = os.path.join(out, "pose")
    for sub in ("color", "ob_in_cam"):
        os.makedirs(os.path.join(pose_dir, sub))
    shutil.copy(os.path.join(out, "video", "cam_K.txt"), pose_dir)
    pred0 = np.loadtxt(os.path.join(out, "run", "ob_in_cam", "0000.txt"))
    gt0 = np.loadtxt(os.path.join(out, "video", "annotated_poses",
                                  "0000.txt"))
    for i in ids:
        shutil.copy(os.path.join(out, "video", "rgb", f"{i}.png"),
                    os.path.join(pose_dir, "color"))
        shutil.copy(os.path.join(out, "run", "ob_in_cam", f"{i}.txt"),
                    os.path.join(pose_dir, "ob_in_cam"))
    mesh = gt_mesh(0.08)
    mesh.apply_transform(np.linalg.inv(pred0) @ gt0)
    mesh.export(os.path.join(pose_dir, "textured_mesh.obj"))
    run_custom.draw_pose(pose_dir)
    drawn = []
    for i in ids:
        vis = read_png(os.path.join(pose_dir, "pose_vis", f"{i}.png"))
        src = read_png(os.path.join(pose_dir, "color", f"{i}.png"))[..., :3]
        changed = (vis != src).any(-1)
        if not (vis[changed] == (255, 255, 0)).all():
            raise AssertionError("draw_pose: a changed pixel is not the "
                                 "box colour")
        drawn.append(int(changed.sum()))
    if min(drawn) < 200:
        raise AssertionError(f"draw_pose: box pixels a frame {drawn}")
    return drawn


def _segmenter_check(out, n=2):
    """`run_one_video(use_segmenter=True)` on the first @n frames of the
    dataset folder in @out; returns the statuses of its frames."""
    from bundlesdf_tpu_torch import run_custom
    from bundlesdf_tpu_torch.benchmark_synthetic import collect_frame_statuses
    video = os.path.join(out, "seg_video")
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(video, sub))
        for i in range(n):
            shutil.copy(os.path.join(out, "video", sub, f"{i:04d}.png"),
                        os.path.join(video, sub))
    shutil.copy(os.path.join(out, "video", "cam_K.txt"), video)
    run = os.path.join(out, "seg_run")
    run_custom.run_one_video(video, run, use_segmenter=True, debug_level=1,
                             skip_refine=True, start_nerf_keyframes=10 ** 9)
    ids = [f"{i:04d}" for i in range(n)]
    status = collect_frame_statuses(run, ids)
    for i in ids:
        pose = np.loadtxt(os.path.join(run, "ob_in_cam", f"{i}.txt"))
        if not np.isfinite(pose).all():
            raise AssertionError(f"use_segmenter: frame {i} pose not finite")
    if any(s in ("FAIL", "MISSING") for s in status):
        raise AssertionError(f"use_segmenter: statuses {status}")
    return status


def phase_live(replay):
    """Phase 12 with the port's ORB detecting live on the card, gated the
    same way against the JAX driver's run; then draw_pose and the
    segmenter on its output."""
    from bundlesdf_tpu_torch import benchmark_synthetic as driver
    fx = np.load(EASY_FIXTURE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bsdf_live_") as out:
        m = driver.main(["--out", out, "--protocol", "easy", "--n_frames",
                         "120", "--no_nerf", "--skip_refine"])
        ids = [f"{i:04d}" for i in range(120)]
        status = driver.collect_frame_statuses(os.path.join(out, "run"), ids)
        t1 = time.perf_counter()
        drawn = _draw_pose_check(out, ["0000", "0060", "0119"])
        seg = _segmenter_check(out)
    secs = time.perf_counter() - t0
    jax_add_cm = float(fx["jax_add"].mean()) * 100
    jax_fail = fx["jax_status"] == 0
    fail = np.array([s == "FAIL" for s in status])
    fps, fps_replay = 120 / m["wall_s"], 120 / replay["wall_s"]
    print(f"live protocol easy, 120 frames 480x640, tracker only, ORB "
          f"detected on the card: {t1 - t0:.1f} s (wall_s {m['wall_s']}, "
          f"{fps:.3f} frames/s; phase 12's replay wall_s "
          f"{replay['wall_s']}, {fps_replay:.3f} frames/s), FAIL "
          f"{int(fail.sum())} (JAX {int(jax_fail.sum())}), ADD "
          f"{m['ADD(cm)']:.4f} cm ADD-S {m['ADDS(cm)']:.4f} cm AUC "
          f"{m['ADD_AUC(%)']:.2f} / {m['ADDS_AUC(%)']:.2f} % (replay ADD "
          f"{replay['ADD(cm)']:.4f} cm; JAX driver ADD {jax_add_cm:.4f} cm); "
          f"draw_pose box pixels {drawn}; use_segmenter statuses {seg}; "
          f"{secs - (t1 - t0):.1f} s for both", flush=True)
    if "MISSING" in status:
        raise AssertionError("live protocol: a frame wrote no frame.txt")
    new_fail = np.nonzero(fail & ~jax_fail)[0]
    if len(new_fail):
        raise AssertionError(f"live protocol: frames {new_fail.tolist()} "
                             f"FAIL that did not FAIL in the JAX run")
    if not m["ADD(cm)"] <= max(2 * jax_add_cm, jax_add_cm + 0.1):
        raise AssertionError(f"live protocol: mean ADD {m['ADD(cm)']} cm "
                             f"above max(2 x JAX, JAX + 1 mm), JAX "
                             f"{jax_add_cm} cm")
    if "cv2" in sys.modules:
        raise AssertionError("the port imported cv2")
    return {**m, "frames_per_s": fps, "replay_frames_per_s": fps_replay,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phase 15: the LoFTR matcher path
LOFTR_PAIRS = ((5, 0), (12, 5), (20, 12), (29, 20))   # (A, B) frame ids
LOFTR_SIZE = 400          # feature_corres.resize of run_custom's config
LOFTR_CONF_TOL = 1e-4     # card vs CPU coarse confidence at f32
LOFTR_UV1_TOL = 0.05      # card vs CPU fine match, px
LOFTR_SET_SHARE = 0.99    # card vs CPU: matches in both sets
LOFTR_GAIN = 4.0          # coarse feature gain of the seeded nets (_peaked)


def _loftr_frames(seq, ids):
    """Tracker frames as the pairing reads them: color, mask, size and the
    ground-truth cam-in-object pose."""
    from types import SimpleNamespace
    H, W = seq["colors"][0].shape[:2]
    return {i: SimpleNamespace(id=i, color=seq["colors"][i], H=H, W=W,
                               fg_mask=seq["masks"][i],
                               pose_in_model=seq["cam_in_obs"][i])
            for i in ids}


def _matches(out, k):
    keep = out["conf"][k] > 0
    return {tuple(u): (v, c) for u, v, c in zip(
        out["uv0"][k][keep].tolist(), out["uv1"][k][keep].cpu().numpy(),
        out["conf"][k][keep].tolist())}


def _compare_matches(ref, got):
    """(shared keys, max |uv1| and |conf| differences on them)."""
    shared = set(ref) & set(got)
    du = max([float(np.abs(ref[k][0] - got[k][0]).max()) for k in shared]
             or [0.0])
    dc = max([abs(ref[k][1] - got[k][1]) for k in shared] or [0.0])
    return shared, du, dc


def _margin(conf, key, wc):
    """The mutual-nearest-neighbour margin of the match at coarse cell
    @key: the smaller of its row's and its best column's gaps between the
    top two entries of the coarse confidence @conf (L,S)."""
    i = int(key[1]) // 8 * wc + int(key[0]) // 8
    row = conf[i]
    col = conf[:, int(row.argmax())]
    return min(float(row.topk(2).values.diff().abs()),
               float(col.topk(2).values.diff().abs()))


def _peaked(net, gain=LOFTR_GAIN):
    """@net with its coarse output conv and every coarse layer's second
    LayerNorm weight scaled by @gain, in place. With the unit gains of the
    seeded init the coarse features are nearly flat under the dual
    softmax: a few mutual matches a 400x400 pair of the orbit, most of
    them on ties. At 4 the similarity peaks as a trained net's does (a
    crop shifted by 8 px is matched back at its shift on most of several
    hundred matches), so the tracker gets a matcher's load of matches.
    The net's compute does not change."""
    with torch.no_grad():
        net.backbone.layer3_outconv.weight.mul_(gain)
        for layer in net.loftr_coarse.layers:
            layer.norm2.weight.mul_(gain)
    return net


def _amp_check(f32, bf16, k, wc):
    """bf16 against f32 outputs of pair @k: matches, the coarse confidence
    difference and correlation, and the f32 matches whose margin exceeds
    twice that difference ("decided") that bf16 finds too."""
    ref, half = _matches(f32, k), _matches(bf16, k)
    shared, du_all, dc = _compare_matches(ref, half)
    c32 = f32["conf_matrix"][k].flatten().float()
    c16 = bf16["conf_matrix"][k].flatten().float()
    err = float((c32 - c16).abs().max())
    conf32 = f32["conf_matrix"][k]
    decided = [q for q in ref if _margin(conf32, q, wc) > 2 * err]
    found = set(decided) & shared
    du = _compare_matches({q: ref[q] for q in found},
                          {q: half[q] for q in found})[1]
    return dict(matches=len(ref), bf16_matches=len(half), shared=len(shared),
                conf_matrix_err=err,
                corr=float(torch.corrcoef(torch.stack([c32, c16]))[0, 1]),
                decided=len(decided), decided_found=len(found), uv1_err=du,
                uv1_err_shared=du_all, conf_err=dc)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_loftr_vs_cpu(seq, size=LOFTR_SIZE, device="cuda"):
    """The pairing warp and the full-width net (LoftrConfig(), seeded
    weights, match_thr 0) on 4 pairs of the orbit at 400x400.

    Card = CPU: the warp exactly; the net at f32, both as seeded and with
    `_peaked`'s gain (the tracker's net, a hundred matches a pair): coarse
    confidence within 1e-3 of its largest entry (and within 1e-4 for the
    seeded net, whose entries are ~1e-5), >= 99 % of the matches in both
    sets unless every difference sits on a mutual-NN tie, uv1 within 0.05
    px on the shared ones.

    bf16 against f32, both on the card, on the seeded net: the amp
    tolerance of tests/test_loftr.py:234-281 (coarse confidence within
    0.05, correlation above 0.99; uv1 within 1 px, conf within 0.05), on
    the matches whose margin exceeds twice the largest bf16 confidence
    difference, all of which both must find: its coarse confidence is
    nearly flat, so most of its few mutual matches sit on margins that
    bf16 rounding crosses. The peaked net's bf16 numbers are printed,
    not gated: its gain amplifies the rounding through the transformer."""
    from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, init_loftr
    from bundlesdf_tpu_torch.matcher.pairing import process_image_pairs
    t0 = time.perf_counter()
    frames = _loftr_frames(seq, {i for p in LOFTR_PAIRS for i in p})
    pairs = [(frames[a], frames[b]) for a, b in LOFTR_PAIRS]
    gA, gB, _ = process_image_pairs(pairs, size, device)
    hA, hB, _ = process_image_pairs(pairs, size, "cpu")
    if not (torch.equal(gA.cpu(), hA) and torch.equal(gB.cpu(), hB)):
        n = int((gA.cpu() != hA).sum() + (gB.cpu() != hB).sum())
        raise AssertionError(f"loftr: warp card != CPU on {n} pixels")
    cfg = LoftrConfig(match_thr=0.0)
    a, b = hA.float() / 255.0, hB.float() / 255.0
    out = {}
    with torch.inference_mode():
        for peaked in (False, True):
            net = init_loftr(cfg, seed=0)
            out["cpu", peaked] = (_peaked(net) if peaked else net)(
                a, b, debug=True)
        a, b = a.to(device), b.to(device)
        for amp in (False, True):
            for peaked in (False, True):
                net = init_loftr(replace(cfg, amp=amp), seed=0)
                net = (_peaked(net) if peaked else net).to(device)
                out[amp, peaked] = net(a, b, debug=True)
    wc = size // 8
    res = {"warp_equal": True, "nets": {}}
    for peaked in (False, True):
        conf_cpu = out["cpu", peaked]["conf_matrix"]
        conf_card = out[False, peaked]["conf_matrix"].cpu()
        err = float((conf_card - conf_cpu).abs().max())
        res["nets"]["peaked" if peaked else "seeded"] = r = {
            "conf_err": err, "conf_rel_err": err / float(conf_cpu.max()),
            "pairs": []}
        for k in range(len(pairs)):
            ref = _matches(out["cpu", peaked], k)
            got = _matches(out[False, peaked], k)
            shared, du, dc = _compare_matches(ref, got)
            tie = 1e-5 * float(conf_card[k].max())
            ties = [q for q in set(ref) ^ set(got)
                    if _margin(conf_card[k], q, wc) <= tie]
            r["pairs"].append(dict(
                matches=len(ref), card_matches=len(got),
                share=len(shared) / max(len(set(ref) | set(got)), 1),
                unshared=len(set(ref) ^ set(got)), unshared_on_tie=len(ties),
                uv1_err=du, conf_err=dc,
                amp=_amp_check(out[False, peaked], out[True, peaked], k, wc)))
    secs = time.perf_counter() - t0

    def amp_text(p):
        return (f"{p['matches']} / {p['bf16_matches']} matches, "
                f"{p['shared']} shared, conf matrix err "
                f"{p['conf_matrix_err']:.3g} corr {p['corr']:.4f}, "
                f"{p['decided_found']} of {p['decided']} decided matches "
                f"found, uv1 err {p['uv1_err']:.3g} px on them "
                f"({p['uv1_err_shared']:.3g} on all shared)")

    text = []
    for name, r in res["nets"].items():
        text.append(
            f"{name} net, f32: coarse confidence max err {r['conf_err']:.3g}"
            f", {r['conf_rel_err']:.3g} of its largest entry; per pair "
            + "; ".join(f"{p['matches']} matches (card {p['card_matches']})"
                        f", {100 * p['share']:.2f} % in both "
                        f"({p['unshared']} not, {p['unshared_on_tie']} on a "
                        f"tie), uv1 err {p['uv1_err']:.3g} px, conf err "
                        f"{p['conf_err']:.3g} | bf16 vs f32 on the card"
                        f"{'' if name == 'seeded' else ' (not gated)'}: "
                        f"{amp_text(p['amp'])}" for p in r["pairs"]))
    print(f"loftr card vs CPU: {len(pairs)} pairs of the 480x640 orbit "
          f"{LOFTR_PAIRS} at {size}x{size}, LoftrConfig(), match_thr 0: "
          f"warp card = CPU on every pixel; " + " || ".join(text)
          + f"; {secs:.1f} s", flush=True)
    for name, r in res["nets"].items():
        if r["conf_rel_err"] > 1e-3 or (name == "seeded"
                                        and r["conf_err"] > LOFTR_CONF_TOL):
            raise AssertionError(f"loftr: {name} coarse confidence card vs "
                                 f"CPU {r['conf_err']}")
        for p in r["pairs"]:
            if (p["matches"] == 0 or p["uv1_err"] > LOFTR_UV1_TOL
                    or (p["share"] < LOFTR_SET_SHARE
                        and p["unshared_on_tie"] < p["unshared"])):
                raise AssertionError(f"loftr: {name} card vs CPU {p}")
            q = p["amp"]
            if name == "seeded" and (
                    q["conf_matrix_err"] >= 0.05 or q["corr"] <= 0.99
                    or q["decided_found"] < q["decided"]
                    or q["uv1_err"] >= 1.0 or q["conf_err"] >= 0.05):
                raise AssertionError(f"loftr: bf16 vs f32 on the card {q}")
    return res


def phase_loftr_bench():
    """bench_loftr's four lines (amp off / on x batch 8 / 64)."""
    from bundlesdf_tpu_torch import bench_loftr
    t0 = time.perf_counter()
    recs = bench_loftr.main([])
    print(f"loftr bench: {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def phase_loftr_profile(batch=8):
    """torch.profiler tables of one `predict` of @batch 400x400 pairs,
    f32 and amp (seeded LoftrConfig()), sorted by device time."""
    from torch.profiler import ProfilerActivity, profile

    from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (batch + 1, LOFTR_SIZE, LOFTR_SIZE)).astype(
        np.uint8)
    for amp in (False, True):
        m = LoftrMatcher(cfg=LoftrConfig(amp=amp), seed=0)
        m.predict(list(imgs[:batch]), list(imgs[1:]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.predict(list(imgs[:batch]), list(imgs[1:]))
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25)
        print(f"profile of one LoFTR predict, {batch} pairs 400x400, amp "
              f"{amp}, {torch.cuda.get_device_name(0)}\n{table}", flush=True)
        del m
        torch.cuda.empty_cache()


def phase_loftr_tracker(seq, n_frames=N_TRACK, traced=range(20, 25),
                        size=LOFTR_SIZE, device="cuda"):
    """The tracker through LoFTR: BundleSdf with run_custom's track
    config (SPDLOG 0, NOF off) and a full-width seeded LoftrMatcher (bf16,
    `_peaked`'s gain, match_thr 0: each pair carries up to 1,024 mutual
    matches into map points, the lift and RANSAC) over the 480x640 orbit: frames/s over the
    untraced frames 5-19, pairs per frame, the device ms of the pairing
    warp and of the net per frame (profiler union over frames 20-24),
    peak memory, FAILs, one finite pose per frame."""
    from bundlesdf_tpu_torch import bundlesdf as bsdf
    from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
    from bundlesdf_tpu_torch.run_custom import make_configs
    from bundlesdf_tpu_torch.utils.profiling import (device_ms_by_range,
                                                     device_trace,
                                                     load_trace, trace_path)
    t0 = time.perf_counter()
    pairs_per_call = []
    matcher = LoftrMatcher(cfg=LoftrConfig(match_thr=0.0, amp=True), seed=0,
                           device=device)
    _peaked(matcher.net)
    predict, pairing = matcher.predict, bsdf.process_image_pairs

    def ranged_predict(a, b):
        pairs_per_call.append(len(a))
        with torch.profiler.record_function("loftr:predict"):
            return predict(a, b)

    def ranged_pairing(*args, **kw):
        with torch.profiler.record_function("loftr:pairing"):
            return pairing(*args, **kw)

    matcher.predict = ranged_predict
    bsdf.process_image_pairs = ranged_pairing
    tmp = tempfile.mkdtemp(prefix="bsdf_loftr_")
    trace_dir = os.path.join(tmp, "trace")
    try:
        cfg, _ = make_configs(tmp, debug_level=0)
        cfg["stage_timing"] = True
        cfg["feature_corres"]["resize"] = size
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = bsdf.BundleSdf(cfg_track=cfg, start_nerf_keyframes=10 ** 9,
                           matcher=matcher, device=device)
        frames, calls_at = [], []
        with contextlib.ExitStack() as trace:
            for i in range(n_frames):
                if i == 5:
                    _sync(device)
                    t5 = time.perf_counter()
                if i == traced.start:
                    _sync(device)
                    dt = time.perf_counter() - t5
                    trace.enter_context(device_trace(trace_dir, device))
                calls_at.append(len(pairs_per_call))
                frames.append(t.run(seq["colors"][i], seq["depths"][i].copy(),
                                    seq["K"], seq["id_strs"][i],
                                    mask=seq["masks"][i]))
                if i == traced.stop - 1:
                    trace.close()
        t.on_finish()
        _sync(device)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
        by_range = device_ms_by_range(load_trace(trace_path(trace_dir)),
                                      prefix="loftr:")
    finally:
        bsdf.process_image_pairs = pairing
        shutil.rmtree(tmp, ignore_errors=True)
    calls_at.append(len(pairs_per_call))
    per_frame = [sum(pairs_per_call[calls_at[i]:calls_at[i + 1]])
                 for i in range(n_frames)]
    status = [f.status.name for f in frames]
    poses = np.array([f.pose_in_model for f in frames])
    stages = {}
    for st in t.stage_stats[5:]:
        for k, v in st.items():
            stages.setdefault(k, []).append(v * 1e3)
    med = {k: round(float(np.median(v)), 3) for k, v in sorted(stages.items())}
    n = traced.start - 5
    dev = {k: v / len(traced) for k, v in by_range.items() if k != "OUTSIDE"}
    res = {"frames_per_s": n / dt, "ms_per_frame": 1e3 * dt / n,
           "pairs_per_frame": float(np.mean(per_frame[1:])),
           "pairs_by_frame": per_frame, "device_ms_per_frame": dev,
           "stage_ms": med, "peak_gib": peak / 2 ** 30,
           "fail": status.count("FAIL"),
           "seconds": time.perf_counter() - t0}
    print(f"loftr tracker: {n_frames} frames 480x640, run_custom track "
          f"config (map_points, max_BA_frames 10, resize {size}), LoftrConfig"
          f"(match_thr=0, amp) seeded, NOF off: frames 5-{traced.start - 1} "
          f"{res['frames_per_s']:.3f} frames/s {res['ms_per_frame']:.3f} "
          f"ms/frame; pairs a frame {res['pairs_per_frame']:.2f} "
          f"({per_frame}); device ms a frame over frames {traced.start}-"
          f"{traced.stop - 1}: {json.dumps({k: round(v, 3) for k, v in dev.items()})}; "
          f"median stage ms {json.dumps(med)}; peak {res['peak_gib']:.3f} "
          f"GiB; FAIL {res['fail']}; statuses {status}; "
          f"{res['seconds']:.1f} s", flush=True)
    if not np.isfinite(poses).all() or poses.shape != (n_frames, 4, 4):
        raise AssertionError("loftr tracker: a pose is not finite")
    if sum(pairs_per_call) == 0 or (torch.device(device).type == "cuda"
                                    and "predict" not in dev):
        raise AssertionError("loftr tracker: the predict branch never ran")
    return res


# ---------------------------------------------------------------------------
# phase 16: the HO3D path
# ---------------------------------------------------------------------------
HO3D_FRAMES = 20          # run_ho3d's frames: the first 20 of the fixture's 30
HO3D_REFINE_STEPS = 400   # the HO3D refine's n_step, cut from 2000
HO3D_PAR_FRAMES = 10      # frames of each of the two interleaved videos


def _ho3d_layout():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import ho3d_layout
    return ho3d_layout


def phase_ho3d_decode():
    """The 30 committed JPEGs (tests/fixtures/ho3d_orbit30) decoded on the
    host by `utils/jpeg.py`: each frame's pixel SHA-256 equals the one
    imageio decoded when the fixture was made; ms a frame by stage."""
    from bundlesdf_tpu_torch.utils import jpeg
    lay = _ho3d_layout()
    t0 = time.perf_counter()
    lib = jpeg.build_library()
    build_s = time.perf_counter() - t0
    hashes, files = lay.load_hashes(), lay.fixture_jpegs()
    jpeg.read_jpeg(files[0])
    times, bad = {}, []
    t0 = time.perf_counter()
    for path in files:
        img = jpeg.read_jpeg(path, times)
        key = os.path.basename(path)[:-4]
        if img.shape != (480, 640, 3) or \
                lay.pixel_sha256(img[..., :3]) != hashes[key]:
            bad.append(key)
    n = len(files)
    res = {"ms_per_frame": 1e3 * (time.perf_counter() - t0) / n,
           **{f"{k}_ms": times.get(k, 0.0) / n for k in jpeg.STAGES},
           "build_s": build_s}
    print(f"HO3D decode: {n} baseline JPEGs 480x640 4:2:0 q95 "
          f"({os.path.relpath(lib, ROOT)} built in {build_s:.2f} s), "
          f"{res['ms_per_frame']:.3f} ms a frame on the host: "
          + ", ".join(f"{k} {res[f'{k}_ms']:.3f}" for k in jpeg.STAGES)
          + f" ms; SHA-256 equal to imageio's for {n - len(bad)} of {n}",
          flush=True)
    if bad:
        raise AssertionError(f"HO3D decode: frames {bad} differ from "
                             f"imageio's pixels")
    return res


def phase_ho3d_reader(root, seq, n):
    """Write the first @n frames of the orbit as HO3D lays them out (the
    committed JPEGs, packed depth, meta pickles, XMem masks with frame 1's
    hand mask absent, visible_mesh.ply) and read them back through
    `Ho3dReader`. Returns the video dir."""
    from bundlesdf_tpu_torch.datasets import Ho3dReader
    lay = _ho3d_layout()
    t0 = time.perf_counter()
    video = lay.write_ho3d_video(root, seq, n_frames=n,
                                 jpegs=lay.fixture_jpegs(n))
    write_s = time.perf_counter() - t0
    r = Ho3dReader(video)
    t0 = time.perf_counter()
    frames = [(r.get_color(i), r.get_depth(i), r.get_mask(i),
               r.get_occ_mask(i)) for i in range(len(r))]
    read_ms = 1e3 * (time.perf_counter() - t0) / len(r)
    depth_err = max(float(np.abs(d - seq["depths"][i]).max())
                    for i, (_, d, _, _) in enumerate(frames))
    pose_err = max(float(np.abs(r.get_gt_pose(i) - np.linalg.inv(
        seq["cam_in_obs"][i])).max()) for i in range(len(r)))
    ok = (len(r) == n and r.id_strs == seq["id_strs"][:n]
          and np.array_equal(r.K, seq["K"])
          and r.get_video_name() == "SYN1"
          and depth_err <= lay.DEPTH_SCALE / 2 + 1e-6 and pose_err <= 1e-12
          and all(np.array_equal(m > 0, seq["masks"][i] > 0)
                  for i, (_, _, m, _) in enumerate(frames))
          and frames[1][3] is None
          and all(o is not None and not o.any()
                  for i, (_, _, _, o) in enumerate(frames) if i != 1))
    print(f"HO3D reader: {n} frames written in {write_s:.2f} s; "
          f"Ho3dReader color + depth + mask + hand mask {read_ms:.3f} ms a "
          f"frame; depth max err {depth_err:.3e} m (pack step "
          f"{lay.DEPTH_SCALE:.3e}), GT pose max err {pose_err:.3e}, K "
          f"equal, hand mask of frame 1 absent -> None: {ok}", flush=True)
    if not ok:
        raise AssertionError("HO3D reader: the layout does not read back as "
                             "written")
    return video, read_ms


def phase_ho3d_run(video, out_dir, seq, fx, ref_add_mm, n):
    """`run_ho3d.run_one_video` with the NOF on (`_make_tracker`'s configs,
    the port's live ORB) on the card: frames/s, `pipeline_stats`, launches
    (= NOF steps, on the runner's stream), FAILs, ADD against the ground
    truth beside phase 9's on the same frames, the online mesh Chamfer."""
    from bundlesdf_tpu_torch import run_ho3d
    from bundlesdf_tpu_torch.benchmark_synthetic import collect_frame_statuses
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t, launches, streams = _counted(
        lambda: run_ho3d.run_one_video(video, out_dir))
    dt = time.perf_counter() - t0
    st = t.pipeline_stats
    steps = st.get("nof_steps_total", 0)
    folder = os.path.join(out_dir, "SYN1")
    ids = seq["id_strs"][:n]
    status = collect_frame_statuses(folder, ids)
    pred = np.array([np.loadtxt(os.path.join(folder, "ob_in_cam",
                                             f"{i}.txt")) for i in ids])
    gt = np.linalg.inv(seq["cam_in_obs"][:n])
    mp = fx["model_pts"]
    sc = benchmark_video(None, gt, mp, visible_gt_points(seq, mp, n),
                         pred_poses=pred, pred_mesh=t.mesh)
    nerf_stream = t.nerf.stream.cuda_stream
    res = {"frames_per_s": n / dt, "ms_per_frame": 1e3 * dt / n,
           "launches": launches, "nof_steps_total": steps,
           "n_batches": st["n_batches"], "fail": status.count("FAIL"),
           "add_mm": sc["ADD(cm)"] * 10, "adds_mm": sc["ADDS(cm)"] * 10,
           "chamfer_cm": sc["chamfer(cm)"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "artifacts_s": sum(s.get("artifacts", 0.0)
                              for s in t.stage_stats),
           "pipeline_stats": st}
    print(f"run_ho3d run_video: {n} frames 480x640 from JPEG, NOF on "
          f"(start 5 keyframes, n_step {t.cfg_nerf['n_step']}, sync_max_"
          f"delay {t.cfg_nerf.get('sync_max_delay', 0)}), SPDLOG 2, live "
          f"ORB: {res['frames_per_s']:.4f} frames/s "
          f"{res['ms_per_frame']:.3f} ms/frame; NOF batches "
          f"{st['n_batches']}, steps {steps}; scatter_rows launches "
          f"{launches}; kernel streams "
          f"{ {('nof' if k == nerf_stream else k): v for k, v in streams.items()} }; "
          f"peak {res['peak_gib']:.3f} GiB; FAIL {res['fail']}; mean ADD "
          f"{res['add_mm']:.4f} mm ADD-S {res['adds_mm']:.4f} mm (phase 9 "
          f"on these frames {ref_add_mm:.4f} mm); online mesh "
          f"{0 if t.mesh is None else len(t.mesh.faces)} faces, Chamfer "
          f"{res['chamfer_cm']:.4f} cm", flush=True)
    print(f"run_ho3d pipeline_stats "
          f"{json.dumps({k: round(v, 6) for k, v in st.items()})}",
          flush=True)
    if "MISSING" in status or res["fail"]:
        raise AssertionError(f"run_ho3d: statuses {status}")
    if res["add_mm"] > max(2 * ref_add_mm, ref_add_mm + 1):
        raise AssertionError(f"run_ho3d: mean ADD {res['add_mm']} mm above "
                             f"max(2 x phase 9, phase 9 + 1 mm), phase 9 "
                             f"{ref_add_mm} mm")
    if t.mesh is None or not res["chamfer_cm"] < CHAMFER_MAX_CM:
        raise AssertionError(f"run_ho3d: online mesh Chamfer "
                             f"{res['chamfer_cm']} cm")
    if not (steps > 0 and launches == steps) or set(streams) != {
            nerf_stream} or \
            nerf_stream == torch.cuda.default_stream().cuda_stream:
        raise AssertionError(f"run_ho3d: {launches} scatter_rows launches "
                             f"for {steps} NOF steps on streams "
                             f"{dict(streams)} (the runner's: {nerf_stream})")
    return res


def phase_ho3d_bench(video, out_dir, log_dir):
    """`python -m bundlesdf_tpu_torch.benchmark_ho3d` on the run and its
    refine: its rows (the refined mesh's Chamfer among them) and
    `results.csv`."""
    from bundlesdf_tpu_torch import benchmark_ho3d
    rows = benchmark_ho3d.main(["--video_dirs", video, "--out_dir", out_dir,
                                "--log_dir", log_dir])
    with open(os.path.join(log_dir, "results.csv")) as f:
        lines = f.read().splitlines()
    print(f"benchmark_ho3d rows {json.dumps(rows)}; results.csv "
          f"{len(lines)} lines", flush=True)
    if lines[0] != "key,value" or len(lines) != len(rows) + 1 or \
            not np.isfinite(rows["ours/SYN1/ADD(cm)"]) or \
            not rows["ours/SYN1/chamfer(cm)"] < CHAMFER_MAX_CM:
        raise AssertionError(f"benchmark_ho3d: rows {rows}, csv {lines}")
    return rows


def phase_ho3d_refine(video, out_dir, seq, fx, n):
    """`run_ho3d.run_one_video_global_nerf` (`--mode global_refine`) at
    HO3D's refine config, n_step cut: launches (= steps, the runner's
    stream), native marching at mesh_resolution 0.003, the refined mesh's
    Chamfer; then the kernel on the rows of one HO3D refine step, the
    four hashed levels marked."""
    from bundlesdf_tpu_torch import run_ho3d
    from bundlesdf_tpu_torch.config import load_yaml
    from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t, launches, streams = _counted(
        lambda: run_ho3d.run_one_video_global_nerf(
            video, out_dir, refine_overrides={"n_step": HO3D_REFINE_STEPS}))
    wall = time.perf_counter() - t0
    st, cfg, runner = t.refine_stats, t.nerf.cfg, t.nerf
    folder = os.path.join(out_dir, "SYN1")
    stamps = sorted(d for d in os.listdir(folder) if os.path.exists(
        os.path.join(folder, d, "keyframes.yml")))
    reg = load_yaml(os.path.join(folder, stamps[-1], "keyframes.yml"))
    ids = sorted(reg)
    poses = np.loadtxt(os.path.join(
        folder, "nerf_with_bundletrack_online",
        "optimized_poses.txt")).reshape(-1, 4, 4)
    mp = fx["model_pts"]
    sc = _keyframe_add(seq, mp, ids, poses, visible_gt_points(seq, mp, n),
                       mesh=t.mesh)
    nerf_stream = runner.stream.cuda_stream
    layout = runner.spec.grid.layout()
    res = {"steps": st["steps"], "steps_per_s": st["steps_per_s"],
           "launches": launches, "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "n_rows": runner.spec.grid.total_rows,
           "chamfer_cm": sc["chamfer(cm)"], "add_mm": sc["ADD(cm)"] * 10,
           "mesh_faces": len(t.mesh.faces),
           "hashed_levels": [i for i, (_, dense, _, _) in enumerate(layout)
                             if not dense]}
    print(f"run_ho3d global_refine: {st['keyframes']} keyframes, "
          f"{st['steps']} steps (n_step {cfg['n_step']}, cut from 2000), "
          f"{cfg['num_levels']} levels finest {cfg['finest_res']} "
          f"T=2^{cfg['log2_hashmap_size']} ({res['n_rows']} rows; levels "
          f"{res['hashed_levels']} hashed), {cfg['N_rand']} rays x "
          f"({cfg['N_samples']} + {cfg['N_samples_around_depth']}) samples, "
          f"mesh_resolution {cfg['mesh_resolution']}: "
          f"{st['steps_per_s']:.3f} steps/s, wall {wall:.3f} s, peak "
          f"{res['peak_gib']:.3f} GiB; scatter_rows launches {launches}; "
          f"kernel streams "
          f"{ {('nof' if k == nerf_stream else k): v for k, v in streams.items()} }; "
          f"marching {marching_tetrahedra.last_path}; mesh "
          f"{res['mesh_faces']} faces, Chamfer {res['chamfer_cm']:.4f} cm; "
          f"optimized poses ADD {res['add_mm']:.4f} mm over {len(ids)} "
          f"keyframes", flush=True)
    if launches != st["steps"] or set(streams) != {nerf_stream} or \
            nerf_stream == torch.cuda.default_stream().cuda_stream:
        raise AssertionError(f"HO3D refine: {launches} scatter_rows launches "
                             f"for {st['steps']} steps, on streams "
                             f"{dict(streams)} (the runner's: {nerf_stream})")
    if marching_tetrahedra.last_path != "native" or \
            cfg["mesh_resolution"] != 0.003:
        raise AssertionError(f"HO3D refine: marching "
                             f"{marching_tetrahedra.last_path} at "
                             f"{cfg['mesh_resolution']}")
    if not res["chamfer_cm"] < CHAMFER_MAX_CM:
        raise AssertionError(f"HO3D refine: Chamfer {res['chamfer_cm']} cm "
                             f"(gate {CHAMFER_MAX_CM} cm)")
    if len(res["hashed_levels"]) != 4:
        raise AssertionError(f"HO3D refine: hashed levels "
                             f"{res['hashed_levels']}, expected 4")
    k = res["kernel"] = phase_scatter_real(runner, name="HO3D refine step")
    print("scatter HO3D refine step by level (rows, vector atomics at group "
          f"{k['group']}): " + "; ".join(
              f"L{i} r{r} {n_rows}{' hashed' if not dense else ''} "
              f"{k['atomics'][i]}"
              for i, (r, dense, n_rows, _) in enumerate(layout)), flush=True)
    return res


def _sub_sequence(seq, sl):
    per_frame = ("colors", "depths", "masks", "cam_in_obs", "id_strs")
    return {k: (v[sl] if k in per_frame else v) for k, v in seq.items()}


def phase_ho3d_parallel(root, out_dir, seq, n=HO3D_PAR_FRAMES):
    """`parallel/videos.py::run_videos_parallel` on one card: two
    HO3D-layout videos (frames 0-9 and 10-19) tracked interleaved with
    devices [cuda:0, cuda:0], tracker only, against each video tracked
    alone; videos an hour both ways. Then one video with `use_gui`."""
    import functools
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import (default_nerf_config,
                                            default_track_config)
    from bundlesdf_tpu_torch.datasets import Ho3dReader
    from bundlesdf_tpu_torch.parallel.videos import run_videos_parallel
    lay = _ho3d_layout()
    jpegs = lay.fixture_jpegs(2 * n)
    videos = [lay.write_ho3d_video(
        root, _sub_sequence(seq, slice(k * n, (k + 1) * n)), name=name,
        jpegs=jpegs[k * n:(k + 1) * n], hand_absent=())
        for k, name in enumerate(("PAR1", "PAR2"))]

    def make_tracker(out, device, use_gui=False):
        cfg = default_track_config()
        cfg["SPDLOG"] = 1
        cfg["depth_processing"]["zfar"] = 1
        cfg["debug_dir"] = out
        return BundleSdf(cfg_track=cfg, cfg_nerf=default_nerf_config(),
                         start_nerf_keyframes=10 ** 9, use_gui=use_gui,
                         device=device)

    card = torch.device("cuda", 0)
    outs = {m: [os.path.join(out_dir, f"{m}{k}") for k in range(2)]
            for m in ("alone", "interleaved")}
    t0 = time.perf_counter()
    for v, o in zip(videos, outs["alone"]):
        run_videos_parallel([(Ho3dReader(v), o)], make_tracker,
                            devices=[card])
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_videos_parallel([(Ho3dReader(v), o) for v, o in
                         zip(videos, outs["interleaved"])], make_tracker,
                        devices=[card, card])
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    errs, equal = [], True
    for k in range(2):
        ids = Ho3dReader(videos[k]).id_strs
        a, b = (np.array([np.loadtxt(os.path.join(outs[m][k], "ob_in_cam",
                                                  f"{i}.txt")) for i in ids])
                for m in ("alone", "interleaved"))
        equal &= bool(np.array_equal(a, b))
        errs.append(float(np.abs(a - b).max()))
    gui_out = os.path.join(out_dir, "gui")
    t0 = time.perf_counter()
    tr = run_videos_parallel([(Ho3dReader(videos[0]), gui_out)],
                             functools.partial(make_tracker, use_gui=True),
                             devices=[card])[0]
    gui_s = time.perf_counter() - t0
    every = tr.gui.every_n
    written = sorted(os.listdir(os.path.join(gui_out, "gui")))
    want = [f"gui_{i}.png" for i in Ho3dReader(videos[0]).id_strs[
        every - 1::every]]
    res = {"videos_per_hour_interleaved": 2 * 3600 / par_s,
           "videos_per_hour_sequential": 2 * 3600 / seq_s,
           "interleaved_s": par_s, "sequential_s": seq_s,
           "bit_equal": equal, "max_pose_diff": max(errs),
           "gui_images": len(written), "gui_s": gui_s}
    print(f"run_videos_parallel: 2 HO3D videos x {n} frames, tracker only, "
          f"devices [cuda:0, cuda:0]: interleaved {par_s:.3f} s "
          f"({res['videos_per_hour_interleaved']:.1f} videos/hour), one "
          f"after the other {seq_s:.3f} s "
          f"({res['videos_per_hour_sequential']:.1f} videos/hour); poses "
          f"interleaved vs alone bit-equal {equal}, max diff "
          f"{res['max_pose_diff']:.3e}; use_gui run of {n} frames "
          f"{gui_s:.3f} s, {len(written)} panel(s) {written} (every_n "
          f"{every})", flush=True)
    # bit-equal is what the host loop promises: each tracker sees the same
    # inputs in the same order, and the tracker's programs are
    # deterministic on the card
    if not equal:
        raise AssertionError(f"run_videos_parallel: interleaved poses differ "
                             f"from each video alone by {errs}")
    if written != want:
        raise AssertionError(f"HO3D GUI: wrote {written}, expected {want}")
    return res


def phase_ho3d(seq, fx, online):
    """Phase 16 in a temporary folder; @online: phase 9's result, whose
    poses give the ADD gate on the same frames."""
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    n = HO3D_FRAMES
    gt = np.linalg.inv(seq["cam_in_obs"][:n])
    ref = benchmark_video(None, gt, fx["model_pts"],
                          pred_poses=online["pred_poses"][:n])
    res = {"decode": phase_ho3d_decode()}
    with tempfile.TemporaryDirectory(prefix="bsdf_ho3d_") as tmp:
        video, res["reader_ms"] = phase_ho3d_reader(tmp, seq, n)
        out = os.path.join(tmp, "out")
        res["run"] = phase_ho3d_run(video, out, seq, fx,
                                    ref["ADD(cm)"] * 10, n)
        torch.cuda.empty_cache()
        res["refine"] = phase_ho3d_refine(video, out, seq, fx, n)
        torch.cuda.empty_cache()
        res["bench"] = phase_ho3d_bench(video, out, os.path.join(tmp, "log"))
        res["parallel"] = phase_ho3d_parallel(
            os.path.join(tmp, "par"), os.path.join(tmp, "par_out"), seq)
    return res


# ---------------------------------------------------------------------------
# ray data parallelism and NOF placement (phase 17)
# ---------------------------------------------------------------------------
DP_WARMUP, DP_STEPS, DP_MORE_STEPS = 10, 100, 20
DP_PROFILE_STEPS = 10
DP_LOSS_RATIO = 1.35      # tests/test_dp_runner.py's quality bound
PLACE_FRAMES, PLACE_STEPS = 10, 100


def _loss_grads(field, batch, runner, rcfg):
    """{name: gradient} of the mean loss of @field over @batch, perturb
    off, on the current stream."""
    from bundlesdf_tpu_torch.nof.losses import nof_loss
    from bundlesdf_tpu_torch.nof.render import render_rays
    trunc = runner.tcfg.trunc
    out = render_rays(field, rcfg, batch, runner.c2w, runner.occ_grid,
                      perturb=False, trunc=trunc)
    loss = nof_loss(out, batch, field, trunc, runner.lcfg)[0]
    field.zero_grad(set_to_none=True)
    loss.backward()
    g = {n: p.grad.clone() for n, p in field.named_parameters()}
    field.zero_grad(set_to_none=True)
    return g


def phase_dp_grads(runner, devices, amp):
    """grads_on_batch_dp over @devices against the single-device gradient
    of one fixed 2048-ray batch, from @runner's weights. Returns (the
    worst error over its tolerance, whether the replicas' gradients are
    bit-equal).

    f32 (TF32 off): |dp - single| <= 1e-5 |single| + 1e-6 max|single|,
    tests/test_dp_runner.py's tolerance (the same terms summed in another
    order). Under amp each MLP weight and bias gradient is a bf16 output
    (unit roundoff u = 2^-8) of an f32 sum over the samples: the single
    device rounds the whole batch's sum S once, DP rounds each shard's
    partial P_s once and averages them in f32, so |dp - single| <=
    u (|S| + mean_s |P_s|); the gate takes 2u for the f32 sums' order and
    the shards' separate forwards, plus the f32 term 1e-6 max|single|.
    The table and pose gradients are f32 sums in both (within the f32
    term)."""
    from bundlesdf_tpu_torch.nof.models import NofField
    from bundlesdf_tpu_torch.parallel import dp
    spec, rcfg = runner.spec, runner.rcfg
    if not amp:
        spec = replace(spec, grid=replace(spec.grid, table_bf16=False))
        rcfg = replace(rcfg, compute_bf16=False)
    field = NofField(spec, device=devices[0])
    field.load_state_dict(runner.field.state_dict())
    n = runner.tcfg.n_rand
    idx = torch.arange(0, runner.n_rays_valid, runner.n_rays_valid // n,
                       device=devices[0])[:n]
    batch = {k: v[idx] for k, v in runner.rays.items()}
    g_sd = _loss_grads(field, batch, runner, rcfg)
    shards = dp.shard_batch(batch, devices)
    parts = ([_loss_grads(field, {k: v.to(devices[0]) for k, v in
                                  sh.items()}, runner, rcfg)
              for sh in shards] if amp else None)
    reps = dp.make_replicas(field, devices)
    g_dp = dp.grads_on_batch_dp(reps, shards, runner.c2w, runner.occ_grid,
                                runner.tcfg.trunc, rcfg, runner.lcfg)
    worst, where = 0.0, None
    for name, a in g_sd.items():
        b = g_dp[name]
        atol = 1e-6 * max(1.0, float(a.abs().max()))
        if amp:
            u = 2.0 ** -8
            part = sum(p[name].abs() for p in parts) / len(parts)
            tol = 2 * u * (a.abs() + part) + atol
        else:
            tol = 1e-5 * a.abs() + atol
        r = float(((b - a).abs() / tol).max())
        if r > worst:
            worst, where = r, name
    same = all(torch.equal(p.grad, q.grad) for rep in reps[1:] for p, q in
               zip(reps[0].field.parameters(), rep.field.parameters()))
    print(f"dp grads {'amp' if amp else 'f32'}: {len(devices)} replicas on "
          f"{[str(d) for d in devices]}, {n} rays, worst |dp - single| / "
          f"tolerance {worst:.4f} ({where}); replicas' gradients bit-equal "
          f"{same}", flush=True)
    return worst, same


def _replicas_equal(runner):
    """The replicas' parameters bit-equal to the master's, as the last
    chunk left them."""
    reps = runner.dp_replicas
    return all(torch.equal(p, q) for rep in reps[1:] for p, q in
               zip(runner.field.parameters(), rep.field.parameters()))


def _train_timed(runner, n_steps):
    """(metrics, wall seconds) of @n_steps of runner.train, from a device
    sync to its final host pull."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = runner.train(n_steps=n_steps)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def _device_ms_a_step(runner, n_steps):
    from bundlesdf_tpu_torch.utils.profiling import (device_events,
                                                     device_trace,
                                                     interval_union_ms,
                                                     load_trace, trace_path)
    with tempfile.TemporaryDirectory(prefix="bsdf_dp_") as tmp:
        with device_trace(tmp, "cuda"):
            runner.train(n_steps=n_steps)
        return interval_union_ms(device_events(
            load_trace(trace_path(tmp)))) / n_steps


def _reduction_ms(runner):
    """Device ms of one gradient reduction (`mean_across`) between the
    runner's replicas, queued on one stream so CUDA events time it: every
    parameter's gradient and the step's metrics."""
    from bundlesdf_tpu_torch.parallel import dp
    cur = torch.cuda.current_stream()
    reps = [replace(r, stream=cur) for r in runner.dp_replicas]
    tensors = [[torch.ones_like(p) for p in r.field.parameters()]
               + [torch.ones((), device=r.device) for _ in range(12)]
               for r in reps]
    nbytes = sum(t.numel() * t.element_size() for t in tensors[0])
    return _queued_ms(lambda: dp.mean_across(reps, tensors)), nbytes


def _record_dp_step(runner):
    """The (vals, rows, n_rows, group) of each scatter call of one DP step
    of @runner, one a replica, recorded on their way in."""
    from bundlesdf_tpu_torch.ops import hashgrid
    orig, seen = hashgrid.scatter_rows, []

    def recorder(vals, rows, n_rows, group=1):
        seen.append((vals.clone(), rows.clone(), n_rows, group))
        return orig(vals, rows, n_rows, group=group)

    hashgrid.scatter_rows = recorder
    try:
        runner.train(n_steps=1)
        torch.cuda.synchronize()
    finally:
        hashgrid.scatter_rows = orig
    return seen


def phase_placement(seq, feats, fx, nerf_device):
    """A BundleSdf with `nerf_device` set, strict sync, over PLACE_FRAMES
    frames: the runner on that card, the tracker on the default one, the
    kernel's launches (= NOF steps) on the runner's stream, poses synced
    back and finite."""
    from bundlesdf_tpu_torch.config import default_track_config
    cfg_n = online_nerf_config(default_track_config(), sync_max_delay=0,
                               n_step=PLACE_STEPS, nerf_device=nerf_device)
    t0 = time.perf_counter()
    t, frames, dt, launches, streams = run_video(seq, feats, cfg_n,
                                                 PLACE_FRAMES)
    want = torch.device("cuda", nerf_device)
    steps = t.pipeline_stats.get("nof_steps_total", 0)
    nerfed = sum(kf.nerfed for kf in t.bundler.keyframes)
    finite = all(np.isfinite(f.pose_in_model).all() for f in frames)
    nerf_stream = t.nerf.stream
    print(f"placement nerf_device={nerf_device}: runner on {t.nerf.device} "
          f"(stream on {nerf_stream.device}), tracker on {t.device}, "
          f"{len(frames)} frames in {dt:.3f} s ({len(frames) / dt:.4f} "
          f"frames/s), {t.pipeline_stats['n_batches']} NOF batches, {steps} "
          f"steps, scatter_rows launches {launches} on the runner's stream "
          f"{set(streams) == {nerf_stream.cuda_stream}}, {nerfed} of "
          f"{len(t.bundler.keyframes)} keyframes nerfed, poses finite "
          f"{finite}, {time.perf_counter() - t0:.1f} s in all", flush=True)
    if t.nerf.device != want or nerf_stream.device != want \
            or t.device.type != "cuda":
        raise AssertionError(f"placement: runner on {t.nerf.device}, stream "
                             f"on {nerf_stream.device}, expected {want}")
    if not (steps > 0 and launches == steps) \
            or set(streams) != {nerf_stream.cuda_stream}:
        raise AssertionError(f"placement: {launches} scatter_rows launches "
                             f"for {steps} NOF steps, streams "
                             f"{dict(streams)}")
    if not nerfed or not finite:
        raise AssertionError(f"placement: {nerfed} keyframes nerfed, poses "
                             f"finite {finite}")
    return {"frames_per_s": len(frames) / dt, "nof_steps": steps,
            "launches": launches}


def phase_dp(seq, feats, fx):
    """Phase 17: ray data parallelism on the card, two replicas sharing
    it, held against the single device; then NOF placement."""
    t_start = time.perf_counter()
    card = torch.device("cuda", 0)
    shared = [card, card]
    n_cards = torch.cuda.device_count()
    inputs = runner_inputs(7)
    res = {}
    dp = make_runner(inputs=inputs, dp_devices=shared)
    sd = make_runner(inputs=inputs)
    if dp.dp_devices != shared or sd.dp_devices is not None:
        raise AssertionError(f"dp runner replicas {dp.dp_devices}, single "
                             f"{sd.dp_devices}")
    for amp in (False, True):
        worst, same = phase_dp_grads(dp, shared, amp)
        res[f"grad_err_over_tol_{'amp' if amp else 'f32'}"] = worst
        if not worst <= 1.0 or not same:
            raise AssertionError(f"dp grads (amp={amp}): worst error "
                                 f"{worst:.4f} of its tolerance, replicas' "
                                 f"gradients bit-equal {same}")

    # 10 + 100 steps each: DP with its launches counted, then single
    streams, undo = count_streams()
    try:
        torch.cuda.synchronize()
        launches0 = scatter_launches()
        m0, _ = _train_timed(dp, DP_WARMUP)
        m1, dt_dp = _train_timed(dp, DP_STEPS)
        launches = scatter_launches() - launches0
    finally:
        undo()
    s0, _ = _train_timed(sd, DP_WARMUP)
    s1, dt_sd = _train_timed(sd, DP_STEPS)
    n_dp = DP_WARMUP + DP_STEPS
    loss_dp = np.concatenate([m0["loss"], m1["loss"]])
    loss_sd = np.concatenate([s0["loss"], s1["loss"]])
    f_dp, f_sd = float(loss_dp[-10:].mean()), float(loss_sd[-10:].mean())
    equal = _replicas_equal(dp)
    rep_streams = [r.stream.cuda_stream for r in dp.dp_replicas]
    dev_dp = _device_ms_a_step(dp, DP_PROFILE_STEPS)
    dev_sd = _device_ms_a_step(sd, DP_PROFILE_STEPS)
    red_ms, red_bytes = _reduction_ms(dp)
    res.update({
        "replicas": [str(d) for d in shared], "dp_steps": n_dp,
        "dp_launches": launches,
        "dp_steps_per_s": DP_STEPS / dt_dp, "sd_steps_per_s": DP_STEPS / dt_sd,
        "dp_host_ms_a_step": 1e3 * dt_dp / DP_STEPS,
        "sd_host_ms_a_step": 1e3 * dt_sd / DP_STEPS,
        "dp_device_ms_a_step": dev_dp, "sd_device_ms_a_step": dev_sd,
        "reduction_ms": red_ms, "reduction_bytes_a_replica": red_bytes,
        "loss_last10_dp": f_dp, "loss_last10_sd": f_sd})
    print(f"dp: {len(shared)} replicas on {res['replicas']}, "
          f"{dp.n_rays_valid} rays in store, {dp.tcfg.n_rand // 2} rays a "
          f"replica a step; DP {res['dp_steps_per_s']:.3f} steps/s against "
          f"single-device {res['sd_steps_per_s']:.3f} "
          f"({res['dp_steps_per_s'] / res['sd_steps_per_s']:.3f}x), host "
          f"(wall) ms a step {res['dp_host_ms_a_step']:.3f} / "
          f"{res['sd_host_ms_a_step']:.3f}, device ms a step (union over "
          f"streams, {DP_PROFILE_STEPS} steps) {dev_dp:.3f} / {dev_sd:.3f}; "
          f"gradient reduction {red_ms:.4f} device ms "
          f"({red_bytes / 1e6:.1f} MB a replica); loss {loss_dp[0]:.5f} -> "
          f"{f_dp:.5f} (last 10) against {loss_sd[0]:.5f} -> {f_sd:.5f}; "
          f"replicas bit-equal {equal}; scatter_rows launches {launches} for "
          f"{n_dp} steps, by stream "
          f"{ {('replica %d' % rep_streams.index(k) if k in rep_streams else k): v for k, v in streams.items()} }",
          flush=True)
    if not (np.isfinite(loss_dp).all() and np.isfinite(loss_sd).all()):
        raise AssertionError("dp: non-finite loss")
    if not (f_dp < DP_LOSS_RATIO * f_sd + 1e-3
            and f_sd < DP_LOSS_RATIO * f_dp + 1e-3):
        raise AssertionError(f"dp: last-10 loss {f_dp} against single-device "
                             f"{f_sd}, beyond {DP_LOSS_RATIO}x")
    if not equal:
        raise AssertionError("dp: the replicas' parameters differ")
    default = torch.cuda.default_stream().cuda_stream
    if launches != n_dp * len(shared) or len(set(rep_streams)) != 2 \
            or default in rep_streams \
            or dict(streams) != {k: n_dp for k in rep_streams}:
        raise AssertionError(f"dp: {launches} scatter_rows launches for "
                             f"{n_dp} steps x {len(shared)} replicas, by "
                             f"stream {dict(streams)}, replicas' streams "
                             f"{rep_streams}")

    # the kernel on one DP step's rows, each replica's call
    errs = []
    for i, (vals, rows, n_rows, group) in enumerate(_record_dp_step(dp)):
        err, _ = _check_scatter(f"dp step replica {i}", vals, rows, n_rows,
                                group)
        errs.append(err)
        print(f"scatter dp step replica {i}: M={rows.shape[0]} "
              f"C={vals.shape[1]} {vals.dtype} n_rows={n_rows} group={group}"
              f" max_abs_err {err:.3e} (within the row bound)", flush=True)
    if len(errs) != len(shared):
        raise AssertionError(f"dp: one step made {len(errs)} scatter calls")
    res["dp_step_kernel_max_abs_err"] = max(errs)

    # continual: new keyframes, then more DP steps from the re-synced master
    cfg, rgbs, depths, masks, poses, K = inputs
    dp.add_new_frames(rgbs[5:], depths[5:], masks[5:], None, poses)
    m2, _ = _train_timed(dp, DP_MORE_STEPS)
    equal2 = _replicas_equal(dp)
    n_frames = [r.field.spec.n_frames for r in dp.dp_replicas]
    print(f"dp continual: add_new_frames to {len(dp.images)} frames "
          f"({dp.n_rays_valid} rays), {DP_MORE_STEPS} more steps, loss "
          f"{m2['loss'][0]:.5f} -> {m2['loss'][-1]:.5f}, replicas' frames "
          f"{n_frames}, bit-equal {equal2}", flush=True)
    if not np.isfinite(m2["loss"]).all() or not equal2 \
            or n_frames != [len(dp.images)] * len(shared):
        raise AssertionError("dp continual: non-finite loss or replicas "
                             "out of sync")
    del dp, sd
    torch.cuda.empty_cache()

    if n_cards >= 2:   # every card: printed, not gated
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        r = make_runner(inputs=inputs, dp_devices=cards)
        phase_dp_grads(r, cards, amp=False)
        _, dt = _train_timed(r, DP_WARMUP)
        _, dt = _train_timed(r, DP_STEPS)
        print(f"dp over {n_cards} cards: {DP_STEPS / dt:.3f} steps/s, "
              f"replicas bit-equal {_replicas_equal(r)}", flush=True)
        del r
        torch.cuda.empty_cache()
    else:
        print("dp over several cards: not run (one card visible)",
              flush=True)

    res["placement"] = {0: phase_placement(seq, feats, fx, 0)}
    if n_cards >= 2:
        res["placement"][1] = phase_placement(seq, feats, fx, 1)
    else:
        print("placement nerf_device=1: not run (one card visible)",
              flush=True)
    res["seconds"] = time.perf_counter() - t_start
    print(f"phase 17: {res['seconds']:.1f} s", flush=True)
    return res


PREDICT_PAIRS = ((5, 0), (12, 5), (20, 12), (29, 20), (2, 0), (9, 7),
                 (17, 15), (26, 24))       # (A, B) frame ids, phase 18
PREDICT_CALLS = 5
SAMPLER_RTOL = 1e-5


def _rows_by_match(rows):
    """{(uA, vA, uB, vB) rounded to 1e-3: conf} of predict's rows."""
    return {tuple(np.round(r[:4].astype(np.float64), 3)): float(r[4])
            for r in rows}


def phase_predict(seq, device="cuda"):
    """Phase 18(a): `OrbMatcher.predict` (the LoFTR-shaped contract, whole
    images) on the card against the CPU, then timed."""
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    from bundlesdf_tpu_torch.matcher.pairing import process_image_pairs
    from bundlesdf_tpu_torch.utils.profiling import (device_events,
                                                     device_trace,
                                                     interval_union_ms,
                                                     load_trace, trace_path)
    frames = _loftr_frames(seq, {i for p in PREDICT_PAIRS for i in p})
    pairs = [(frames[a], frames[b]) for a, b in PREDICT_PAIRS]
    cA, cB, _ = process_image_pairs(pairs, LOFTR_SIZE, device)
    card = OrbMatcher(device=device)
    got = card.predict(cA, cB)
    ref = OrbMatcher(device="cpu").predict(cA.cpu(), cB.cpu())
    rows, conf_err, same = [], 0.0, True
    for g, r in zip(got, ref):
        dg, dr = _rows_by_match(g), _rows_by_match(r)
        same &= dg.keys() == dr.keys() and len(g) == len(dg)
        conf_err = max([conf_err] + [abs(dg[k] - dr[k])
                                     for k in dg.keys() & dr.keys()])
        rows.append(len(g))
    walls = []
    for _ in range(PREDICT_CALLS):
        _sync(device)
        t0 = time.perf_counter()
        card.predict(cA, cB)                # ends in a host pull
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="bsdf_predict_") as tmp:
        with device_trace(tmp, device):
            card.predict(cA, cB)
        dev_ms = interval_union_ms(device_events(
            load_trace(trace_path(tmp)))) / len(pairs)
    wall = float(np.median(walls))
    res = {"pairs": len(pairs), "size": LOFTR_SIZE, "rows": rows,
           "card_eq_cpu": bool(same), "conf_err": conf_err,
           "pairs_per_s": len(pairs) / wall,
           "wall_ms_per_pair": 1e3 * wall / len(pairs),
           "device_ms_per_pair": dev_ms}
    print(f"predict: OrbMatcher.predict on {len(pairs)} pairs of the "
          f"480x640 orbit {PREDICT_PAIRS} canonicalized to "
          f"{LOFTR_SIZE}x{LOFTR_SIZE}: rows a pair {rows}; card = CPU as "
          f"sets {same}, conf max err {conf_err:.3g}; "
          f"{res['pairs_per_s']:.3f} pairs/s (median of {PREDICT_CALLS} "
          f"calls, {res['wall_ms_per_pair']:.3f} ms a pair), device "
          f"{dev_ms:.4f} ms a pair (profiler union) | {_smi()}", flush=True)
    if not same or conf_err > 1e-6 or sum(rows) < 100:
        raise AssertionError(f"predict: card = CPU {same}, conf err "
                             f"{conf_err}, rows {rows}")
    return res


def phase_sampler(inputs):
    """Phase 18(b): `sample_occupied_steps` on a real step's trace, on the
    card against the CPU, and against the two calls it wraps."""
    from bundlesdf_tpu_torch.ops.sampling import (draw_occupied_samples,
                                                  linspace01,
                                                  occupied_sampler_state,
                                                  sample_occupied_steps)
    t0, t1, occ, cap, n = inputs
    z_g = sample_occupied_steps(t0, t1, occ, n, perturb=False, t_cap=cap)
    host = [x.cpu() for x in (t0, t1, occ, cap)]
    z_c = sample_occupied_steps(*host[:3], n, perturb=False, t_cap=host[3])
    rel = (z_g.cpu() - z_c).abs() / z_c.abs().clamp_min(1e-6)
    bad = rel > SAMPLER_RTOL
    # a sample within rounding of a segment boundary may land on the other
    # side of it on the card, whose cumsum adds in another order
    st = occupied_sampler_state(*host[:3], t_cap=host[3])
    u = linspace01(n)[None, :] * st["total"]
    cum, tol = st["cum"].contiguous(), 1e-6 * st["total"]
    edge = (torch.searchsorted(cum, u - tol, right=True)
            != torch.searchsorted(cum, u + tol, right=True))
    gens = [torch.Generator(t0.device).manual_seed(7) for _ in range(2)]
    z1 = sample_occupied_steps(t0, t1, occ, n, generator=gens[0], t_cap=cap)
    z2 = draw_occupied_samples(occupied_sampler_state(t0, t1, occ, t_cap=cap),
                               n, generator=gens[1])
    composed = bool(torch.equal(z1, z2))
    ms = _cuda_ms(lambda: sample_occupied_steps(t0, t1, occ, n, t_cap=cap))
    res = {"rays": t0.shape[0], "steps": t0.shape[1], "n_samples": n,
           "no_hit_rays": int(st["no_hit"].sum()),
           "max_rel_err": float(rel[~bad].max()) if (~bad).any() else 0.0,
           "over_tol": int(bad.sum()), "over_tol_at_edge": int(
               (bad & edge).sum()), "perturbed_eq_composition": composed,
           "ms": ms}
    print(f"sampler: sample_occupied_steps on one online step's trace "
          f"({res['rays']} rays x {res['steps']} steps, {n} samples, "
          f"{res['no_hit_rays']} rays with no occupied step, t_cap set): "
          f"card = CPU at perturb=False, max rel err {res['max_rel_err']:.3g}"
          f" (tolerance {SAMPLER_RTOL}; {res['over_tol']} samples over it, "
          f"{res['over_tol_at_edge']} of them at a segment boundary); "
          f"perturbed, bit-equal to the two calls under one seeded "
          f"generator {composed}; {ms:.4f} ms a call on the card | {_smi()}",
          flush=True)
    if (bad & ~edge).any() or not composed or not torch.isfinite(z1).all():
        raise AssertionError(f"sampler: {res}")
    return res


# what the kernels line keeps of a real step's measurement
KERNEL_KEYS = ("max_abs_err", "real_step_ms", "group1_ms", "library_ms",
               "plain_ms", "zero_fill_ms", "bound_ms", "bound_by",
               "bound_share", "m_rows", "n_rows", "group", "atomics",
               "check_by_level")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this smoke run "
                         "needs an NVIDIA GPU and does not run on the CPU")
    sys.path.insert(0, ROOT)
    import bundlesdf_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_card()
    phase_build()
    runner = make_runner()
    scatter = phase_scatter(runner.spec.grid.total_rows)
    real = phase_scatter_real(runner)
    grad_err = phase_hashgrid_grad(runner.spec.grid)
    phase_step_vs_cpu(runner)
    launches = phase_main(runner)
    sampler_in = record_sampler_inputs(runner)
    if "--profile" in sys.argv[1:]:
        phase_profile(runner)
    del runner
    torch.cuda.empty_cache()
    seq, feats, fx = tracker_inputs()
    phase_reader(seq)
    phase_tracker_components(seq, feats)
    tracked = phase_tracker_main(seq, feats, fx)
    if "--profile" in sys.argv[1:]:
        phase_tracker_profile(seq, feats)
    from bundlesdf_tpu_torch.config import default_track_config
    cfg_t = default_track_config()
    t, strict = phase_video(seq, feats, fx, "strict sync",
                            online_nerf_config(cfg_t, sync_max_delay=0),
                            n_frames=N_STRICT)
    mesh_err = phase_mesh_vs_cpu(t.nerf)
    del t
    torch.cuda.empty_cache()
    art_dir = tempfile.mkdtemp(prefix="bsdf_refine_")
    try:
        t, threaded = phase_video(
            seq, feats, fx, "threaded",
            online_nerf_config(cfg_t, sync_max_delay=4, async_host=True),
            strict_ref=strict, out_dir=art_dir)
        del t
        torch.cuda.empty_cache()
        refine = phase_refine(seq, fx, art_dir, threaded,
                              profile="--profile" in sys.argv[1:])
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    if "--profile" in sys.argv[1:]:
        phase_video_profile(seq, feats)
    bench = phase_bench()
    protocol = phase_protocol()
    print(f"phases 11-12: {bench['seconds'] + protocol['seconds']:.1f} s",
          flush=True)
    t13 = time.perf_counter()
    orb = phase_orb(seq, fx, tracked["ms_per_frame"])
    live = phase_live(protocol)
    print(f"phases 13-14: {time.perf_counter() - t13:.1f} s", flush=True)
    t15 = time.perf_counter()
    loftr = {"vs_cpu": phase_loftr_vs_cpu(seq), "bench": phase_loftr_bench(),
             "tracker": phase_loftr_tracker(seq)}
    if "--profile" in sys.argv[1:]:
        phase_loftr_profile()
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    ho3d = phase_ho3d(seq, fx, threaded)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)
    torch.cuda.empty_cache()
    dp = phase_dp(seq, feats, fx)
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    last = {"predict": phase_predict(seq), "sampler": phase_sampler(sampler_in)}
    print(f"phase 18: {time.perf_counter() - t18:.1f} s", flush=True)
    print(json.dumps({"orb": orb, "live": {k: live[k] for k in (
        "ADD(cm)", "ADDS(cm)", "wall_s", "frames_per_s",
        "replay_frames_per_s")}, "loftr": loftr, "ho3d": {
            "decode": ho3d["decode"], "reader_ms": ho3d["reader_ms"],
            "run": {k: v for k, v in ho3d["run"].items()
                    if k != "pipeline_stats"},
            "refine": {k: v for k, v in ho3d["refine"].items()
                       if k != "kernel"},
            "parallel": ho3d["parallel"]}, "dp": dp, **last}), flush=True)
    imported = [m for m in ("jax", "cv2", "PIL", "imageio", "pandas")
                if m in sys.modules]
    if imported:
        raise AssertionError(f"the port imported {imported}")
    # ms, plain_ms, library_ms and the bound: the rows of a real step
    print(json.dumps({"kernels": [{
        "name": "scatter_rows", "route": "cuda",
        "source": "bundlesdf_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "bundlesdf_tpu/ops/scatter.py:221",
        "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in scatter.values()]
                           + [real["max_abs_err"], grad_err,
                              dp["dp_step_kernel_max_abs_err"],
                              refine["kernel"]["max_abs_err"],
                              ho3d["refine"]["kernel"]["max_abs_err"]]),
        "ms": real["real_step_ms"], "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"], "bound_by": real["bound_by"],
        "library_ms": real["library_ms"],
        "bound_share": real["bound_share"],
        "real_step_ms": real["real_step_ms"],
        "group1_ms": real["group1_ms"],
        "zero_fill_ms": real["zero_fill_ms"],
        "atomics_by_level": real["atomics"],
        "full_path_launches": strict["launches"],
        "full_path_nof_steps": strict["nof_steps_total"],
        "threaded_path_launches": threaded["launches"],
        # the bench's lines (phase 11): launches = that line's NOF steps
        "bench_nof_line_launches": bench["nof_launches"],
        "bench_nof_line_steps": bench["nof_steps"],
        "bench_pipeline_line_launches": bench["pipeline_launches"],
        "bench_pipeline_line_steps": bench["pipeline"]["nof_steps_trained"],
        "extract_mesh_sdf_err": mesh_err,
        # phase 17: DP steps x replicas, each on its replica's stream
        "dp_launches": dp["dp_launches"], "dp_steps": dp["dp_steps"],
        "dp_replicas": dp["replicas"],
        "uniform": {k: {m: v[m] for m in ("ms", "library_ms", "plain_ms",
                                          "bound_ms")}
                    for k, v in scatter.items()},
        # the rows of one step at the refine config (phase 10)
        "refine": {
            "launches": refine["launches"], "steps": refine["steps"],
            **{k: refine["kernel"][k] for k in KERNEL_KEYS}},
        # the rows of one step at HO3D's refine config (phase 16)
        "ho3d_refine": {
            "launches": ho3d["refine"]["launches"],
            "steps": ho3d["refine"]["steps"],
            "online_launches": ho3d["run"]["launches"],
            "online_nof_steps": ho3d["run"]["nof_steps_total"],
            "hashed_levels": ho3d["refine"]["hashed_levels"],
            **{k: ho3d["refine"]["kernel"][k] for k in KERNEL_KEYS}}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
