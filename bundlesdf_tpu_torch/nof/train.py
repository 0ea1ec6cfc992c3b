"""NOF training: render -> loss -> Adam.

Port of `bundlesdf_tpu/nof/train.py`, the re-design of the reference train
loop (`nerf_runner.py:679-863`). The JAX package scans the step on device;
here `train_steps` is a Python loop over `train_step` on the CPU, and on
CUDA a loop that replays the step's draw, gather, render, loss and
backward as one captured CUDA graph and then takes Adam's step
(`StepGraph`): eager PyTorch dispatches about a thousand small kernels a
step, which took the host 2-3 times the card's time. Optimizer: Adam
(betas 0.9/0.999, eps 1e-15) with the reference's staircase lr decay
(`schedule_lr` nerf_runner.py:579-583, applied every 10 steps) and a
separate pose lr. No gradient clipping: the JAX package applies none,
although the config carries `gradient_max_norm`.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from bundlesdf_tpu_torch.nof.losses import LossConfig, nof_loss
from bundlesdf_tpu_torch.nof.render import RenderConfig, render_rays
from bundlesdf_tpu_torch.ops.adam import Adam
from bundlesdf_tpu_torch.utils.profiling import count, snapshot, span


@dataclass(frozen=True)
class TrainConfig:
    n_step: int = 500
    n_rand: int = 2048
    lrate: float = 0.01
    lrate_pose: float = 0.01
    decay_rate: float = 0.1
    trunc: float = 0.01          # * sc_factor at build time
    trunc_start: float = 0.01    # * sc_factor at build time
    trunc_decay_type: str = ""   # "", "linear", "exp"


def make_optimizer(field, tcfg: TrainConfig):
    """Adam matching the reference (`create_optimizer` nerf_runner.py:494-503)
    with two parameter groups: `pose_array` at lrate_pose, everything else
    at lrate. `adam_step` rescales each group's lr every step. Adam's
    update -lr * m_hat / (sqrt(v_hat) + eps) is the JAX package's
    `optax.scale_by_adam` followed by its per-leaf `-lr * f * u`. On CUDA
    each group's update is one kernel launch (`ops/adam.py::Adam`, bit-equal
    to torch's foreach Adam); on the CPU it is `torch.optim.Adam`'s."""
    pose = [field.pose_array]
    rest = [p for n, p in field.named_parameters() if n != "pose_array"]
    return Adam(
        [{"params": rest, "lr": tcfg.lrate, "base_lr": tcfg.lrate},
         {"params": pose, "lr": tcfg.lrate_pose, "base_lr": tcfg.lrate_pose}],
        betas=(0.9, 0.999), eps=1e-15)


def truncation_at(step: int, tcfg: TrainConfig, n_iters: int) -> float:
    """Truncation annealing (ref get_truncation nerf_runner.py:663-676);
    sc_factor is already folded into trunc/trunc_start."""
    if tcfg.trunc_decay_type == "linear":
        return tcfg.trunc_start - (tcfg.trunc_start - tcfg.trunc) * (
            step / n_iters)
    if tcfg.trunc_decay_type == "exp":
        lamb = math.log(tcfg.trunc / tcfg.trunc_start) / (n_iters / 4)
        return max(tcfg.trunc_start * math.exp(step * lamb), tcfg.trunc)
    return tcfg.trunc


def lr_factor_at(step: int, tcfg: TrainConfig, n_iters: int) -> float:
    """Staircase decay: the reference recomputes lr every 10 steps as
    init * decay_rate**(global_step/N) (nerf_runner.py:579-583,764)."""
    return tcfg.decay_rate ** ((step // 10 * 10) / n_iters)


def step_gradients(field, optimizer, batch: dict, c2w, occ_grid,
                   rcfg: RenderConfig, lcfg: LossConfig, trunc,
                   generator=None, perturb: bool = True, trunc_inv=None):
    """Render, loss and backward of one training step on an injected ray
    @batch: the gradients are left in `.grad`; returns the detached
    metrics dict (scalar tensors on the device). @trunc: the truncation, a
    float or (in a captured step) a 0-dim device tensor with its
    reciprocal @trunc_inv (`render.raw2outputs`). Spans:
    `nof.render`, `nof.loss`, `nof.backward` (the gradients' reset and the
    backward pass)."""
    with span("nof.render"):
        out = render_rays(field, rcfg, batch, c2w, occ_grid,
                          generator=generator, perturb=perturb, trunc=trunc,
                          trunc_inv=trunc_inv)
    with span("nof.loss"):
        loss, metrics = nof_loss(out, batch, field, trunc, lcfg)
    with span("nof.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    return {k: v.detach() for k, v in metrics.items()}


def adam_step(optimizer, step: int, tcfg: TrainConfig, n_iters: int):
    """Adam's step at global @step, each group's lr at its base times the
    staircase factor (span `nof.adam`; on CUDA two `adam.launches`, one a
    group)."""
    with span("nof.adam"):
        f = lr_factor_at(step, tcfg, n_iters)
        for group in optimizer.param_groups:
            group["lr"] = group["base_lr"] * f
        optimizer.step()


def train_step(field, optimizer, batch: dict, step: int, c2w, occ_grid,
               rcfg: RenderConfig, lcfg: LossConfig, tcfg: TrainConfig,
               n_iters: int, generator=None, perturb: bool = True):
    """One training step on an injected ray @batch at global @step
    (`step_gradients` at the step's truncation, then `adam_step`).
    Returns the detached metrics dict (scalar tensors on the device)."""
    metrics = step_gradients(field, optimizer, batch, c2w, occ_grid, rcfg,
                             lcfg, truncation_at(step, tcfg, n_iters),
                             generator=generator, perturb=perturb)
    adam_step(optimizer, step, tcfg, n_iters)
    return metrics


def train_steps(field, optimizer, rays_store: dict, n_valid: int, c2w,
                occ_grid, start_step: int, n_steps: int, rcfg: RenderConfig,
                lcfg: LossConfig, tcfg: TrainConfig, n_iters: int,
                generator=None, graph: StepGraph | None = None):
    """Run @n_steps training steps; each draws `tcfg.n_rand` ray indices
    uniformly in [0, n_valid) from @generator and gathers its batch from
    @rays_store (dict of device tensors). Returns metrics stacked (n_steps,)
    on the device: no host sync inside the loop. Each step, draw and
    gather included, is the span `nof.step`. With @graph on CUDA the steps
    replay one captured step (`StepGraph.run`); on the CPU they run
    eagerly."""
    dev = rays_store["depth"].device
    if graph is not None and dev.type == "cuda":
        return graph.run(field, optimizer, rays_store, n_valid, c2w,
                         occ_grid, start_step, n_steps, rcfg, lcfg, tcfg,
                         n_iters, generator)
    history = []
    for i in range(n_steps):
        with span("nof.step"):
            idx = torch.randint(0, n_valid, (tcfg.n_rand,),
                                generator=generator, device=dev)
            batch = {k: v[idx] for k, v in rays_store.items()}
            history.append(train_step(field, optimizer, batch,
                                      start_step + i, c2w, occ_grid, rcfg,
                                      lcfg, tcfg, n_iters,
                                      generator=generator, perturb=True))
    return {k: torch.stack([m[k] for m in history]) for k in history[0]}


def capture_key(field, rays_store: dict, n_valid: int, c2w, occ_grid,
                rcfg: RenderConfig, lcfg: LossConfig, tcfg: TrainConfig,
                generator) -> tuple:
    """What a captured step reads and writes, as the host sees it: the
    address and shape of every parameter and of its gradient (which the
    captured backward writes and Adam then reads), of every ray-store
    column, of `c2w` and of the occupancy grid's tensors; `n_valid` (the
    draw's bound); the grid's resolutions, the field's spec and the three
    configs; the generator. A graph replays correctly on the same key
    only."""
    tensors = []
    for name, p in field.named_parameters():
        tensors += [(name, p), (name + ".grad", p.grad)]
    tensors += [(f"rays.{k}", v) for k, v in rays_store.items()]
    tensors += [("c2w", c2w), ("occ.grid", occ_grid.grid),
                ("occ.trace", occ_grid.trace)]
    return (tuple((n, None) if t is None else (n, t.data_ptr(),
                                                tuple(t.shape))
                  for n, t in tensors),
            n_valid, occ_grid.res, occ_grid.trace_res, field.spec, rcfg,
            lcfg, tcfg, generator)


class StepGraph:
    """`train_steps` on CUDA: the gradient half of a training step (the ray
    draw, the gather, render, loss and backward: `step_gradients`)
    captured as a CUDA graph and replayed once per step, each replay
    followed by Adam's step, run eagerly. Every kernel stays what it is;
    the `scatter_rows` kernel is captured with the rest.

    - A graph is valid only for the tensors it was captured on, so it is
      kept with their `capture_key`, and a step whose key differs runs
      eagerly; the next step, on the key that eager step left, captures.
      So each capture follows exactly one eager step. A runner keeps one
      `StepGraph` for its life: a keyframe batch (`add_new_frames`)
      rebinds the field, ray store, grid and poses and so recaptures once;
      a refine captures once.
    - Adam stays eager, outside the graph (`ops/adam.py::Adam`, one
      kernel launch a group, bit-equal to torch's foreach Adam): it reads
      the gradients the replay wrote into the tensors the capture left in
      `.grad`, and computes its bias corrections on the host in double
      precision. A
      capturable Adam computes them in float32 from float32 betas (1 -
      0.999f is 1.3e-5 off 1 - 0.999), and its steps drift from the plain
      Adam's further than the benchmark's comparison allows.
    - The truncation is a 0-dim device tensor (`self.trunc`, with its
      reciprocal `self.trunc_inv`), written before a step, eager or
      replayed, whose truncation differs from the last one written.
    - The generator is registered with the graph: replayed steps draw the
      rays and jitter that eager steps would, and leave the generator's
      state where eager steps leave it.
    - The graph writes each step's metrics into column `pos` of a device
      buffer and advances `pos`; the host copies the columns out once per
      `CAPACITY` steps.
    - Spans: `nof.graph.capture` around each capture (not inside a
      `nof.step`); `nof.graph.replay` around each replay, inside its
      `nof.step`. `nof.render`, `nof.loss` and `nof.backward` mark eager
      steps and the host work of a capture; `nof.adam` every step.
      Counters the capture counted (the kernel's `scatter_rows.launches`)
      are taken back, since nothing ran on the card, and added again at
      each replay.
    @new_graph: what makes a graph (`torch.cuda.CUDAGraph`); a test on the
    CPU passes a stand-in."""

    CAPACITY = 64

    def __init__(self, new_graph=None):
        self._new_graph = new_graph
        self._graph = None
        self._key = None       # what the graph was captured on
        self._warm = None      # the key an eager step last left
        self._names = None
        self._launches = {}
        self._trunc = None     # the value `self.trunc` holds
        self.trunc = self.trunc_inv = self.buf = self.pos = None

    def run(self, field, optimizer, rays_store, n_valid, c2w, occ_grid,
            start_step, n_steps, rcfg, lcfg, tcfg, n_iters, generator):
        """`train_steps`' steps through the graph: {metric: (n_steps,)}."""
        dev = rays_store["depth"].device
        if self.trunc is None or self.trunc.device != dev:
            self.trunc, self.trunc_inv = (
                torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(2))
            self._trunc = None

        def truncation(step):
            t = truncation_at(step, tcfg, n_iters)
            if t != self._trunc:
                self.trunc.fill_(t)
                self.trunc_inv.fill_(1.0 / t)
                self._trunc = t

        def key():
            return capture_key(field, rays_store, n_valid, c2w, occ_grid,
                               rcfg, lcfg, tcfg, generator)

        def gradients():
            idx = torch.randint(0, n_valid, (tcfg.n_rand,),
                                generator=generator, device=dev)
            batch = {k: v[idx] for k, v in rays_store.items()}
            m = step_gradients(field, optimizer, batch, c2w, occ_grid, rcfg,
                               lcfg, self.trunc, generator=generator,
                               perturb=True, trunc_inv=self.trunc_inv)
            self._names = sorted(m)
            return torch.stack([m[k] for k in self._names])

        parts = []
        i, k = 0, key()
        while i < n_steps:
            step = start_step + i
            if k != self._key and k == self._warm:
                self._capture(gradients, generator, dev)
                k = self._key = key()
            if k != self._key:
                with span("nof.step"):
                    truncation(step)
                    parts.append(gradients()[:, None])
                    adam_step(optimizer, step, tcfg, n_iters)
                i += 1
                k = self._warm = key()
                continue
            n = min(n_steps - i, self.CAPACITY)
            self.pos.zero_()
            for j in range(n):
                with span("nof.step"):
                    truncation(step + j)
                    with span("nof.graph.replay"):
                        self._graph.replay()
                    for name, c in self._launches.items():
                        count(name, c)
                    adam_step(optimizer, step + j, tcfg, n_iters)
            parts.append(self.buf[:, :n].clone())
            i += n
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return dict(zip(self._names, out))

    def _capture(self, gradients, generator, dev):
        """Capture @gradients (one step's, on the current stream) with the
        metrics' write; the old graph and its memory pool go first."""
        if dev.type == "cuda" and (torch.cuda.current_stream(dev)
                                   == torch.cuda.default_stream(dev)):
            raise RuntimeError("StepGraph: capture needs a CUDA stream of "
                               "its own, not the default stream")
        self._graph = self._key = None
        self.buf = torch.zeros((len(self._names), self.CAPACITY),
                               dtype=torch.float32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        graph = (self._new_graph or torch.cuda.CUDAGraph)()
        if generator is not None:
            graph.register_generator_state(generator)
        before = snapshot()
        with span("nof.graph.capture"):
            # thread_local: a tracker thread may keep using the card
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.buf.index_copy_(1, self.pos, gradients()[:, None])
                self.pos.add_(1)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        after = snapshot()
        # counters (whose seconds never grow) the capture counted
        self._launches = {}
        for name, (n, sec) in after.items():
            n0, sec0 = before.get(name, (0, 0.0))
            if n > n0 and sec == sec0:
                self._launches[name] = n - n0
                count(name, n0 - n)
        self._graph = graph
