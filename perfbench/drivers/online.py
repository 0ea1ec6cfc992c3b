"""The online loop: `BundleSdf.run` over the orbit with the NOF on, in
strict sync (`sync_max_delay` 0, the published setting), live ORB and the
configuration's artifacts written under the run's scratch directory.

Set-up renders the orbit on the card and tracks frames until the first
NOF batch has finished. In strict sync a batch starts and finishes within
the `run` call whose keyframe completes it, so the window opens at the
end of such a call, runs until `--seconds` have passed, and closes at the
end of the first call after that in which a batch finished: the window
holds whole batch periods. With `--trace 1` one whole batch period runs
under the profiler before the window opens.

The comparison follows the program batch by batch from its own state,
because the NOF's atomics make two sound runs drift apart (its hash-grid
backward sums in another order on each side, and 501 Adam steps a batch
amplify that). It has three parts:
- Every NOF batch, the set-up's first and each of the window's: a
  `BatchProbe` on the port's runner reads the batch's first three steps
  as the batch's own path (`start_training` / `poll_training`) runs them,
  and counts the steps the batch ran. The frozen reference, tracking the
  same frames, builds or extends its own runner from its own keyframes,
  takes the port's generator state as the previous batch left it (the
  draws of the port's earlier 498-step tails, which the reference skips),
  and takes the same three steps. Losses, the first gradient as Adam holds
  it and each parameter's change are compared as in the refine cells, the
  worst over the batches.
- The steps: each batch ran the configuration's `n_step + 1` steps, and
  the orchestrator's `nof_steps_total` grew over the window by the steps
  its batches ran.
- The tracker: where a batch ends the reference syncs back the poses the
  port's batch synced (the port's state) in place of training the rest of
  the batch; every window frame's pose is compared.
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import time

import numpy as np
import torch

from perfbench import trace
from perfbench.drivers import common, refine, tracking
from perfbench.harness import Outcome

NOF_KEYS = ("nerf_prep_s", "nerf_dispatch_s", "nerf_poll_s", "nerf_sync_s",
            "nerf_post_s")


def nof_seconds(stats) -> float:
    """Seconds the tracker thread spent in NOF batches so far."""
    return sum(float(stats.get(k, 0.0)) for k in NOF_KEYS)


def batch_finished(tracker, n_before: int) -> bool:
    """A batch began since @n_before batches and none is in flight."""
    nerf = tracker.nerf
    return (tracker.pipeline_stats["n_batches"] > n_before
            and not (nerf is not None and nerf.training_in_flight))


def keyframe_poses(tracker) -> list:
    """The poses the last NOF batch synced back into the keyframes."""
    kfs = tracker.bundler.keyframes[:tracker.nerf_num_frames]
    return [np.array(kf.pose_in_model, np.float64) for kf in kfs]


class BatchProbe:
    """Reads the port's NOF batches as their own path runs them. While
    installed on the runner class, a chunk that starts a batch (the runner
    at step 0: new, or extended by `add_new_frames`) is dispatched as 1, 2
    and the rest of its steps, which `train_steps` computes alike, since it
    draws and steps one step at a time. The probe keeps, on the device and
    with no host wait: the losses of steps 1-3, each leaf's first gradient
    as Adam holds it after step 1, each leaf's change after step 3, and
    the steps every batch ran (the rows of its chunks' metrics)."""

    def __init__(self):
        self.batches: list[dict] = []

    def install(self, runner_cls):
        """Wrap @runner_cls's `_train_chunk`; returns the plain one."""
        plain = runner_cls._train_chunk
        probe = self

        def chunk(runner, n):
            if runner.global_step != 0 or n < 3:
                m = plain(runner, n)
                if probe.batches:
                    probe.batches[-1]["steps"] += int(m["loss"].shape[0])
                return m
            return probe._first_chunk(plain, runner, n)

        runner_cls._train_chunk = chunk
        return plain

    def _first_chunk(self, plain, runner, n):
        named = dict(runner.field.named_parameters())
        st = runner.optimizer.state
        p0 = {k: v.detach().clone() for k, v in named.items()}
        m0 = {k: st[v]["exp_avg"].clone() for k, v in named.items()
              if v in st and "exp_avg" in st[v]}
        parts = [plain(runner, 1)]
        grads = {}
        for k, v in named.items():
            if v in st:
                m1 = st[v]["exp_avg"]
                if k in m0:
                    m1 = m1 - refine.ADAM_BETA1 * m0[k]
                grads[k] = torch.linalg.vector_norm(
                    (m1 / (1.0 - refine.ADAM_BETA1)).detach().double())
        parts.append(plain(runner, 2))
        change = {k: torch.linalg.vector_norm((v.detach() - p0[k]).double())
                  for k, v in named.items()}
        del p0, m0
        if n > 3:
            parts.append(plain(runner, n - 3))
        m = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        self.batches.append({"losses": m["loss"][:3].clone(), "grads": grads,
                             "change": change,
                             "steps": int(m["loss"].shape[0])})
        return m

    def readings(self) -> list[dict]:
        """Each batch's first steps as host numbers (`refine.first_steps`'
        form) and its step count."""
        return [{"losses": [float(x) for x in b["losses"].cpu()],
                 "grads": {k: float(v) for k, v in b["grads"].items()},
                 "change": {k: float(v) for k, v in b["change"].items()},
                 "steps": b["steps"]} for b in self.batches]


class ReferenceBatches:
    """How the frozen reference trains each NOF batch in its replay (its
    orchestrator's `NofBatches` seam). Each batch takes its first three
    steps (`refine.first_steps`). Following a run (@gen_states: the
    generator's state at the end of each of its batches, @synced: the poses
    each batch synced back), a batch starts from that run's generator state
    and syncs back that run's poses; without, it trains the rest of the
    batch itself and syncs back its own."""

    def __init__(self, gen_states=None, synced=None):
        self.gen_states, self.synced = gen_states, synced
        self.first: dict[int, dict] = {}
        self.gen_after: dict[int, torch.Tensor] = {}
        self.own_synced: dict[int, np.ndarray] = {}
        self.n_iters = None

    def before(self, runner, k):
        if self.gen_states is not None and k - 1 in self.gen_states:
            runner.generator.set_state(self.gen_states[k - 1])

    def train(self, runner, k):
        self.n_iters = runner.N_iters
        self.first[k] = refine.first_steps(runner)
        if self.synced is not None and k in self.synced:
            return self.synced[k]
        runner.train(n_steps=runner.N_iters - 3)
        self.gen_after[k] = runner.generator.get_state()
        poses, _ = runner.get_optimized_poses_in_real_world()
        self.own_synced[k] = np.asarray(poses, np.float64)
        return poses


def reference_replay(cell, sc, n_frames: int, batches: ReferenceBatches):
    """The frozen reference over the first @n_frames frames, its NOF
    batches trained by @batches; its poses {id: pose}."""
    mod = tracking.reference()
    tracker = tracking.make_tracker(mod, cell,
                                    os.path.join(cell.scratch, "ref"),
                                    quiet=True, nof_batches=batches)
    feed = tracking.Feed(tracker, sc)
    while feed.i < n_frames:
        feed.step()
    poses = feed.poses
    del feed, tracker
    common.release(cell.device)
    return poses


def nof_comparison(prog_first: dict, ref_first: dict):
    """(loss gap, gradient gap, change gap), each the worst over the
    batches of @ref_first ({batch: first steps}); a batch the other side
    lacks reads infinite."""
    worst = [0.0, 0.0, 0.0]
    if not ref_first:
        return [math.inf] * 3
    for k, ref in ref_first.items():
        prog = prog_first.get(k)
        gaps = (refine.compare(prog, ref)[:3] if prog is not None
                else (math.inf,) * 3)
        worst = [max(w, g) for w, g in zip(worst, gaps)]
    return worst


def steps_gap(probe_steps: list, n_iters, counter_growth: int,
              window_batches) -> int:
    """Steps missing or extra: each batch's against @n_iters, and the
    orchestrator's counter growth over the window against the steps the
    window's batches ran."""
    if n_iters is None:
        return math.inf
    gap = sum(abs(s - n_iters) for s in probe_steps)
    ran = sum(probe_steps[k] for k in window_batches
              if k < len(probe_steps))
    return gap + abs(counter_growth - ran)


def compare(cell, prog_poses, prog_first, ref_poses, ref_first, ids,
            steps=math.inf):
    """The online cell's numbers: the NOF steps' (loss, gradient, change
    gaps, the worst over the batches), the step count's and the
    tracker's (pose gaps over the window's frames)."""
    lim = cell.limits
    nof = nof_comparison(prog_first, ref_first)
    return ([(n, v, lim.get(n, 0.0)) for n, v in
             zip(("loss_gap", "grad_gap", "change_gap"), nof)]
            + [("nof_steps_gap", steps, lim.get("nof_steps_gap", 0.0))]
            + tracking.pose_comparison(cell, prog_poses, ref_poses, ids))


def run(cell):
    dev = cell.device
    p = cell.traffic
    max_frames = int(p.get("max_frames", 100000))
    parts = common.Parts(cell.t_start)
    mod = tracking.program()
    from bundlesdf_tpu_torch.nof.runner import NofRunner
    parts.mark("imports")
    sc = tracking.frames(cell)
    parts.mark("render")
    tracker = tracking.make_tracker(mod, cell,
                                    os.path.join(cell.scratch, "out"))
    feed = tracking.Feed(tracker, sc)
    parts.mark("build")
    probe = BatchProbe()
    plain_chunk = probe.install(NofRunner)
    # the port's synced poses and generator state at each batch's end
    synced, gen_states = {}, {}
    # the host clock at each batch's end: the window's batch periods
    ends = []

    def keep_batch():
        synced[tracker.cnt_nerf] = keyframe_poses(tracker)
        gen_states[tracker.cnt_nerf] = tracker.nerf.generator.get_state()
        ends.append(time.perf_counter())

    try:
        with torch.profiler.record_function("bench:warmup"):
            while not batch_finished(tracker, 0):
                feed.step()
                if feed.i >= max_frames:
                    raise RuntimeError("no NOF batch finished in the warm-up")
        keep_batch()
        common.sync(dev)
        setup_s = parts.mark("warmup")
        cell.note(parts.line())

        def until_batch_end(past: float, t_from: float):
            """Track frames until a batch finishes @past seconds after
            @t_from."""
            while True:
                n_b = tracker.pipeline_stats["n_batches"]
                feed.step()
                if batch_finished(tracker, n_b):
                    keep_batch()
                    if time.perf_counter() - t_from >= past:
                        return
                if feed.i >= max_frames:
                    raise RuntimeError("the window outran the traffic's "
                                       "frames")

        events = None
        if cell.trace:
            # one whole batch period under the profiler, before the window,
            # so the profiler's host cost stays out of the window's counters
            path = os.path.join(cell.scratch, "trace", "trace.json")
            with trace.device_trace(path):
                until_batch_end(0.0, time.perf_counter())
            events = trace.slim(path)
            gc.collect()
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)

        stats0 = dict(tracker.pipeline_stats)
        first, n_stage0 = feed.i, len(tracker.stage_stats)
        k0 = tracker.cnt_nerf
        t0 = time.perf_counter()
        n_ends = len(ends)
        until_batch_end(cell.seconds, t0)
        common.sync(dev)
        wall = time.perf_counter() - t0
    finally:
        NofRunner._train_chunk = plain_chunk
    stats1 = dict(tracker.pipeline_stats)
    ids = list(range(first, feed.i - 1))
    nof_s = nof_seconds(stats1) - nof_seconds(stats0)
    steps = int(stats1.get("nof_steps_total", 0)
                - stats0.get("nof_steps_total", 0))
    window = {"stages": tracker.stage_stats[n_stage0:],
              "frames": feed.i - first, "events": events, "window_s": wall,
              "nof_s": nof_s, "nof_steps": steps,
              "batches": stats1["n_batches"] - stats0["n_batches"],
              "device_kind": common.device_kind(dev)}
    window["units"] = window["batches"]
    if events is not None:
        window["trace_units"] = 1
    window_batches = range(k0 + 1, tracker.cnt_nerf + 1)
    prog_poses = dict(feed.poses)
    failed = sum(feed.failed.get(i, True) for i in ids)
    peak = common.memory_peak(dev)
    n_fed = feed.i
    prog = probe.readings()
    del feed, tracker, probe
    common.release(dev)

    ref = ReferenceBatches(gen_states=gen_states, synced=synced)
    ref_poses = reference_replay(cell, sc, n_fed, ref)
    gap = steps_gap([b["steps"] for b in prog], ref.n_iters, steps,
                    window_batches)
    compared = compare(cell, prog_poses, dict(enumerate(prog)), ref_poses,
                       ref.first, ids, gap)
    if dev.startswith("cuda"):
        cell.note(f"card {common.device_label()}")
    cell.note(f"setup_s {setup_s!r} window_s {wall!r} frames "
              f"{n_fed - first} batches {window['batches']} nof_steps {steps}"
              f" failed {failed} batches compared {len(ref.first)}")
    periods = np.diff([t0] + ends[n_ends:])
    cell.note("batch periods (s): " + " ".join(f"{x:.3f}" for x in periods))
    out = Outcome(
        end_to_end={"frames_per_s": (n_fed - first) / wall,
                    "setup_s": setup_s},
        window=window, compared=compared, attempted=n_fed - first,
        failed=failed, memory_peak_bytes=peak)
    if events is not None:
        out.busy_s, out.window_s = trace.busy_and_window_s(events)
        out.breakdown = {"device_ops": trace.top_ops(events),
                         "idle_gaps": trace.idle_gaps(events)}
    return out
