#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`bundlesdf_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one printed line each (or a few), any failure exits non-zero:
  1. the card: torch/CUDA versions, `nvidia-smi` name and power limit;
  2. build the `scatter_rows` CUDA kernel from `bundlesdf_tpu_torch/csrc`;
  3. kernel vs plain PyTorch scatter at the training step's shapes
     (12.58M rows into the 2,462,164-row table), with times;
  4. hash-grid table/point gradients through the kernel vs the same graph
     with PyTorch's own scatter; one small training step on the card vs
     the same step on the CPU (the CPU path is the one held against the
     JAX package by tests/test_torch_*.py);
  5. the main path: `NofRunner` at the online workload (bench.py's
     configuration) trains 10 + 50 steps; steps/s, memory, losses, and
     the kernel's launch count;
  6. a JSON line of per-kernel results, then the final status line.
--profile adds a torch.profiler table of 5 steps.
Needs a CUDA card and nvcc; refuses to run on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# main-path shapes of the online workload (config.py defaults)
N_RAND, N_SAMPLES, N_LEVELS = 2048, 128 + 64, 4
M_ROWS = N_RAND * N_SAMPLES * N_LEVELS * 8        # 12,582,912 gathered rows
WARMUP_STEPS, TIMED_STEPS = 10, 50


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


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


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


def phase_scatter(n_rows):
    """Kernel vs plain at the main-path shapes; f32 atomics in another
    order are the only difference: atol 1e-4, rtol 1e-5."""
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows, scatter_rows_torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, C, dtype in (("c2_f32", 2, torch.float32),
                           ("c2_bf16", 2, torch.bfloat16),
                           ("c16_bf16", 16, torch.bfloat16)):
        vals, rows = _scatter_case(n_rows, C, dtype, gen)
        out = scatter_rows(vals, rows, n_rows)
        ref = scatter_rows_torch(vals, rows, n_rows)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, atol=1e-4, rtol=1e-5):
            raise AssertionError(f"scatter {name}: kernel != plain, "
                                 f"max abs err {err}")
        ms = _cuda_ms(lambda: scatter_rows(vals, rows, n_rows))
        plain_ms = _cuda_ms(lambda: scatter_rows_torch(vals, rows, n_rows))
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"scatter {name}: M={M_ROWS} n_rows={n_rows} C={C} "
              f"max_abs_err={err:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
              flush=True)
        del vals, rows, out, ref
    return results


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


def make_runner():
    """NofRunner at the online workload, as bench.py builds it."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import cube_orbit_sequence
    from bundlesdf_tpu_torch.config import default_nerf_config
    from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
    from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM

    seq = cube_orbit_sequence(n_frames=5, H=480, W=640, radius=0.45,
                              obj_size=0.08)
    translation = np.zeros(3)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(sc_factor=sc, translation=translation.tolist()))
    poses_gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    rgbs, depths, masks, normals, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        poses_gl.copy(), sc, translation)
    return NofRunner(cfg, rgbs, depths, masks, normals, poses, seq["K"],
                     device="cuda")


def phase_main(runner):
    from bundlesdf_tpu_torch.ops.scatter import scatter_rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter_rows.launches = 0
    m0 = runner.train(n_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m1 = runner.train(n_steps=TIMED_STEPS)   # pulls metrics: a host sync
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = scatter_rows.launches
    peak = torch.cuda.max_memory_allocated()
    loss = np.concatenate([m0["loss"], m1["loss"]])
    sdf = np.concatenate([m0["sdf_loss"], m1["sdf_loss"]])
    print(f"main path: {runner.n_rays_valid} rays in store, "
          f"{TIMED_STEPS / dt:.3f} steps/s, {1e3 * dt / TIMED_STEPS:.3f} ms/step "
          f"({TIMED_STEPS} steps after {WARMUP_STEPS} warm-up), peak "
          f"{peak / 2 ** 30:.3f} GiB, loss {loss[0]:.5f} -> {loss[-1]:.5f}, "
          f"sdf_loss {sdf[0]:.5f} -> {sdf[-1]:.5f}, scatter_rows launches "
          f"{launches}", flush=True)
    if not np.isfinite(loss).all():
        raise AssertionError("main path: non-finite loss")
    if not sdf[-5:].mean() < sdf[:5].mean():
        raise AssertionError(f"main path: sdf_loss did not fall "
                             f"({sdf[:5].mean()} -> {sdf[-5:].mean()})")
    if launches < WARMUP_STEPS + TIMED_STEPS:
        raise AssertionError(f"main path: {launches} scatter_rows launches "
                             f"for {WARMUP_STEPS + TIMED_STEPS} steps")
    return launches


def phase_profile(runner, n_steps=5):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.train(n_steps=n_steps)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    print(f"profile of {n_steps} steps, {torch.cuda.get_device_name(0)}\n"
          f"{table}", flush=True)


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
    grad_err = phase_hashgrid_grad(runner.spec.grid)
    phase_step_vs_cpu(runner)
    launches = phase_main(runner)
    if "--profile" in sys.argv[1:]:
        phase_profile(runner)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    main_case = scatter["c2_bf16"]
    print(json.dumps({"kernels": [{
        "name": "scatter_rows", "route": "cuda",
        "source": "bundlesdf_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "bundlesdf_tpu/ops/scatter.py:221",
        "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in scatter.values()]
                           + [grad_err]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
