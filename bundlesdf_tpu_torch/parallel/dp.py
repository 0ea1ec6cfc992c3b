"""Data-parallel NOF training over replicas of the field.

Port of `bundlesdf_tpu/parallel/dp.py`. The JAX package runs one
controller over a device mesh: the ray store sharded across devices, each
device drawing its own sub-batch, gradients `pmean`'d, then a replicated
Adam update, all inside one `shard_map`'ed scan. Here one host thread
drives a list of `Replica`s -- a `NofField`, its Adam, its generator and
its CUDA stream, on one device each -- step by step, with the same
semantics:

- `shard_rays` pads the ray store to a multiple of the replica count and
  restripes it round-robin, exactly as the JAX package does;
- each replica draws `n_rand // n_dev` rays from its own shard with its
  own generator, renders, and takes the mean loss's gradient on its own
  stream;
- `mean_across` is the `pmean`: each replica receives every replica's
  tensors (a copy where the devices differ) and adds them in replica
  order before dividing by the count, so every replica computes the same
  float sum and the replicas' updates stay bit-equal. CUDA events order
  the streams; the host never waits;
- every replica then applies the same Adam step.

Replicas may share a device (`[cuda:0, cuda:0]`): the math is the same,
which holds data parallelism against a single device on one card.
Replica 0 is the master (a runner's own field and optimizer);
`sync_replicas` copies its parameters and Adam moments into the others.

Streams: `grads_on_batch_dp` and `train_steps_dp` run on the replicas'
streams, after the work already queued on the current streams of the
replicas' devices and before the work queued there once they return. A
caller therefore prepares inputs (shards, poses, `sync_replicas`) and
reads results with plain tensor ops on its current streams.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from bundlesdf_tpu_torch.nof.losses import LossConfig, nof_loss
from bundlesdf_tpu_torch.nof.models import NofField
from bundlesdf_tpu_torch.nof.render import RenderConfig, render_rays
from bundlesdf_tpu_torch.nof.train import (TrainConfig, lr_factor_at,
                                           make_optimizer, truncation_at)
from bundlesdf_tpu_torch.ops.occupancy import OccupancyGrid


def make_ray_devices(devices=None, n_dev=None, base="cuda"):
    """The replica devices, the counterpart of `make_ray_mesh`. @devices:
    an explicit list, whose entries may repeat (`["cuda:0", "cuda:0"]`);
    else the first @n_dev visible cards (all of them when None). With a
    CPU @base, any @n_dev replicas share the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.device(base).type == "cpu":
        return [torch.device("cpu")] * n_dev
    n_vis = torch.cuda.device_count()
    n_dev = n_vis if n_dev is None else n_dev
    if n_dev > n_vis:
        raise RuntimeError(f"{n_dev} replica devices asked for, {n_vis} "
                           f"cards visible")
    return [torch.device("cuda", i) for i in range(n_dev)]


def shard_rays(rays_store: dict, devices, n_valid: int | None = None):
    """Pad the ray store to a multiple of the replica count and split its
    rows across @devices. Returns (one dict of tensors per replica, on its
    device; n_valid_local).

    When the store has a valid PREFIX of @n_valid rows, rows are RESTRIPED
    round-robin (global row j*n_dev + s -> shard s, local row j), so every
    shard's valid rows are again a prefix; samplers bound indices by
    n_valid_local = max(1, min(n_valid, n) // n_dev), which leaves out up
    to n_dev - 1 valid tail rows, as the JAX package does. With
    n_valid=None the shards are contiguous blocks and every row counts."""
    n_dev = len(devices)
    n = rays_store["depth"].shape[0]
    n_pad = -(-n // n_dev) * n_dev
    shards = [{} for _ in devices]
    for k, a in rays_store.items():
        if n_pad != n:
            a = torch.cat([a, a.new_zeros((n_pad - n,) + a.shape[1:])])
        if n_valid is None:
            a = a.reshape(n_dev, n_pad // n_dev, *a.shape[1:])
        else:
            a = a.reshape(n_pad // n_dev, n_dev, *a.shape[1:]).transpose(0, 1)
        for s, d in enumerate(devices):
            shards[s][k] = a[s].to(d).contiguous()
    n_valid_local = (n_pad // n_dev if n_valid is None
                     else max(1, min(n_valid, n) // n_dev))
    return shards, n_valid_local


def shard_batch(batch: dict, devices):
    """One fixed ray batch split into contiguous blocks across @devices
    (rows must divide the replica count; row order is irrelevant to the
    averaged gradient)."""
    n_dev = len(devices)
    n = batch["depth"].shape[0]
    if n % n_dev:
        raise ValueError(f"shard_batch: {n} rows do not split into "
                         f"{n_dev} equal shards")
    m = n // n_dev
    return [{k: v[s * m:(s + 1) * m].to(d) for k, v in batch.items()}
            for s, d in enumerate(devices)]


@dataclass
class Replica:
    """One replica of the NOF: its field, optimizer (None for gradients
    only), generator (batch draws and jitter) and stream (None on the
    CPU), all on @device."""
    device: torch.device
    field: NofField | None
    optimizer: torch.optim.Optimizer | None
    generator: torch.Generator
    stream: torch.cuda.Stream | None = None

    def on_stream(self):
        """Make the replica's stream current on its device."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self):
        """An event behind the work queued so far on the replica's
        stream (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, events):
        """Order the replica's later work after @events."""
        if self.stream is not None:
            for ev in events:
                if ev is not None:
                    self.stream.wait_event(ev)


def make_replicas(field: NofField, devices, optimizer=None, stream=None,
                  tcfg: TrainConfig | None = None, seed: int = 0):
    """Replicas of @field on @devices (devices[0] must be the field's): the
    first is @field itself with @optimizer and @stream (a new stream when
    None); the others get fields, Adams (when @optimizer is given) and
    streams of their own, synced from the first (`set_master`). Replica
    i's generator is seeded from (@seed, i), the counterpart of
    `fold_in(key, axis_index)`."""
    reps = []
    for i, d in enumerate(devices):
        d = torch.device(d)
        s = stream if i == 0 else None
        if s is None and d.type == "cuda":
            s = torch.cuda.Stream(device=d)
        gen_seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        reps.append(Replica(device=d, field=None, optimizer=None, stream=s,
                            generator=torch.Generator(device=d).manual_seed(
                                gen_seed)))
    set_master(reps, field, optimizer, tcfg)
    return reps


def set_master(replicas, field: NofField, optimizer=None,
               tcfg: TrainConfig | None = None):
    """Make @field and @optimizer the master's and bring the other replicas
    to them: a new field where the spec changed (a keyframe batch adds
    frames), an Adam over @tcfg where the master has one, then
    `sync_replicas`."""
    replicas[0].field, replicas[0].optimizer = field, optimizer
    for r in replicas[1:]:
        if r.field is None or r.field.spec != field.spec:
            # random init, overwritten by the sync below
            r.field = NofField(field.spec, device=r.device,
                               generator=torch.Generator(
                                   device=r.device).manual_seed(0))
            r.optimizer = None
        if optimizer is not None and r.optimizer is None:
            r.optimizer = make_optimizer(r.field, tcfg)
    sync_replicas(replicas)


def sync_replicas(replicas):
    """Copy the master's (replicas[0]) parameters and Adam state into every
    other replica, on the current streams (see the module docstring)."""
    master = replicas[0]
    params = list(master.field.parameters())
    with torch.no_grad():
        for r in replicas[1:]:
            mine = list(r.field.parameters())
            for p, q in zip(params, mine, strict=True):
                q.copy_(p)
            if r.optimizer is None or master.optimizer is None:
                continue
            r.optimizer.state.clear()
            for p, q in zip(params, mine):
                st = master.optimizer.state.get(p)
                if st:
                    # moments move to the replica; Adam's step count stays
                    # where it is (a host scalar)
                    r.optimizer.state[q] = {
                        k: (v.clone() if k == "step"
                            else v.to(q.device, copy=True))
                        for k, v in st.items()}


def _fetch(t, dst: Replica, src: Replica):
    """@t, a tensor of @src, on @dst's device: itself on the same device,
    else a copy ordered after @src's stream and before @dst's later work."""
    if t.device == dst.device:
        return t
    with src.on_stream(), dst.on_stream():
        return t.to(dst.device, non_blocking=True)


def _current_events(replicas):
    """Events behind the work queued on the current stream of each of the
    replicas' CUDA devices."""
    evs = []
    for d in {r.device for r in replicas if r.stream is not None}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        evs.append(ev)
    return evs


def _fork(replicas):
    """Every replica's stream waits for its devices' current streams."""
    evs = _current_events(replicas)
    for r in replicas:
        r.wait(evs)


def _join(replicas):
    """The devices' current streams wait for every replica's stream."""
    evs = [r.record() for r in replicas if r.stream is not None]
    for d in {r.device for r in replicas if r.stream is not None}:
        cur = torch.cuda.current_stream(d)
        for ev in evs:
            cur.wait_event(ev)


def mean_across(replicas, tensors):
    """The `pmean`: @tensors[i] is replica i's list of tensors (the same
    shapes on every replica). Returns each replica's list of means, on its
    device and stream: every replica's tensors added in replica order,
    then divided by the count, so the replicas' results are bit-equal. No
    replica's inputs are overwritten before every replica has read them."""
    n = len(replicas)
    ready = [r.record() for r in replicas]
    out = []
    for r in replicas:
        with r.on_stream():
            r.wait(ready)
            parts = [[_fetch(t, r, src) for t in ts]
                     for src, ts in zip(replicas, tensors)]
            acc = (torch._foreach_add(parts[0], parts[1]) if n > 1
                   else [t.clone() for t in parts[0]])
            for p in parts[2:]:
                torch._foreach_add_(acc, p)
            torch._foreach_div_(acc, float(n))
        out.append(acc)
    done = [r.record() for r in replicas]
    for r in replicas:
        r.wait(done)
    return out


def _grads(field):
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in field.parameters()]


def _local_grads(r: Replica, batch, c2w, occ_grid, trunc, rcfg, lcfg,
                 perturb):
    """Replica @r's loss gradient on its @batch (left in `.grad`), on its
    stream; returns its metrics."""
    with r.on_stream():
        out = render_rays(r.field, rcfg, batch, c2w, occ_grid,
                          generator=r.generator, perturb=perturb, trunc=trunc)
        loss, metrics = nof_loss(out, batch, r.field, trunc, lcfg)
        r.field.zero_grad(set_to_none=True)
        loss.backward()
    return metrics


def _on_devices(replicas, c2w, occ_grid: OccupancyGrid):
    """@c2w and @occ_grid on each replica's device (the same tensors where
    the device is theirs)."""
    return ([c2w.to(r.device) for r in replicas],
            [OccupancyGrid(occ_grid.grid.to(r.device), occ_grid.res,
                           occ_grid.trace.to(r.device), occ_grid.trace_res)
             for r in replicas])


def grads_on_batch_dp(replicas, batch_shards, c2w, occ_grid: OccupancyGrid,
                      trunc: float, rcfg: RenderConfig, lcfg: LossConfig):
    """Gradient of the mean loss over ONE fixed ray batch, data-parallel:
    each replica takes the mean-loss gradient over its equal-size shard
    (`shard_batch`) with perturb off, and the shards' gradients are
    averaged. Every default loss term is a plain batch mean, so this must
    EQUAL the single-device gradient on the whole batch up to float32
    reassociation -- the correctness pin a wrong denominator or a dropped
    shard fails. Each replica's `.grad` holds the average afterwards;
    returns the master's as {parameter name: tensor}."""
    c2ws, occs = _on_devices(replicas, c2w, occ_grid)
    _fork(replicas)
    for r, b, c, o in zip(replicas, batch_shards, c2ws, occs):
        _local_grads(r, b, c, o, trunc, rcfg, lcfg, perturb=False)
    means = mean_across(replicas, [_grads(r.field) for r in replicas])
    for r, avg in zip(replicas, means):
        for p, g in zip(r.field.parameters(), avg):
            p.grad = g
    _join(replicas)
    return {n: p.grad for n, p in replicas[0].field.named_parameters()}


def train_step_dp(replicas, batches, step: int, c2ws, occ_grids,
                  rcfg: RenderConfig, lcfg: LossConfig, tcfg: TrainConfig,
                  n_iters: int, perturb: bool = True):
    """One DP training step on injected per-replica @batches (and @c2ws /
    @occ_grids on each replica's device), on the replicas' streams:
    gradients and metrics averaged across replicas, then every replica's
    Adam step with the two lr groups and the staircase factor at @step.
    Returns the averaged metrics on the master (scalar tensors)."""
    trunc = truncation_at(step, tcfg, n_iters)
    local = []
    names = None
    for r, b, c, o in zip(replicas, batches, c2ws, occ_grids):
        m = _local_grads(r, b, c, o, trunc, rcfg, lcfg, perturb)
        names = sorted(m)
        local.append(_grads(r.field) + [m[k].detach() for k in names])
    means = mean_across(replicas, local)
    f = lr_factor_at(step, tcfg, n_iters)
    for r, avg in zip(replicas, means):
        with r.on_stream():
            for p, g in zip(r.field.parameters(), avg):
                p.grad = g
            for group in r.optimizer.param_groups:
                group["lr"] = group["base_lr"] * f
            r.optimizer.step()
    n_p = len(local[0]) - len(names)
    return dict(zip(names, means[0][n_p:]))


def train_steps_dp(replicas, rays_shards, n_valid_local: int, c2w,
                   occ_grid: OccupancyGrid, start_step: int, n_steps: int,
                   rcfg: RenderConfig, lcfg: LossConfig, tcfg: TrainConfig,
                   n_iters: int):
    """DP counterpart of `train_steps`: each step, each replica draws
    max(1, n_rand // n_dev) indices in [0, n_valid_local) from its own
    generator, gathers them from its shard (`shard_rays`) and takes part
    in `train_step_dp`. The replicas must be in sync (`sync_replicas`).
    Returns the averaged metrics stacked (n_steps,) on the master's
    device: no host sync inside the loop."""
    per_dev = max(1, tcfg.n_rand // len(replicas))
    c2ws, occs = _on_devices(replicas, c2w, occ_grid)
    _fork(replicas)
    history = []
    for i in range(n_steps):
        batches = []
        for r, rays in zip(replicas, rays_shards):
            with r.on_stream():
                idx = torch.randint(0, n_valid_local, (per_dev,),
                                    generator=r.generator, device=r.device)
                batches.append({k: v[idx] for k, v in rays.items()})
        history.append(train_step_dp(replicas, batches, start_step + i,
                                     c2ws, occs, rcfg, lcfg, tcfg, n_iters))
    with replicas[0].on_stream():
        out = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    _join(replicas)
    return out
