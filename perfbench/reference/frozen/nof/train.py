"""NOF training: render -> loss -> Adam, one eager step at a time.

Port of `bundlesdf_tpu/nof/train.py`, the re-design of the reference train
loop (`nerf_runner.py:679-863`). The JAX package scans the step on device;
here `train_steps` is a Python loop over `train_step`. Optimizer: Adam
(betas 0.9/0.999, eps 1e-15) with the reference's staircase lr decay
(`schedule_lr` nerf_runner.py:579-583, applied every 10 steps) and a
separate pose lr. No gradient clipping: the JAX package applies none,
although the config carries `gradient_max_norm`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from perfbench.reference.frozen.nof.losses import LossConfig, nof_loss
from perfbench.reference.frozen.nof.render import RenderConfig, render_rays


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
    at lrate. `train_step` rescales each group's lr every step. Adam's
    update -lr * m_hat / (sqrt(v_hat) + eps) is the JAX package's
    `optax.scale_by_adam` followed by its per-leaf `-lr * f * u`."""
    pose = [field.pose_array]
    rest = [p for n, p in field.named_parameters() if n != "pose_array"]
    return torch.optim.Adam(
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


def train_step(field, optimizer, batch: dict, step: int, c2w, occ_grid,
               rcfg: RenderConfig, lcfg: LossConfig, tcfg: TrainConfig,
               n_iters: int, generator=None, perturb: bool = True):
    """One training step on an injected ray @batch at global @step.
    Returns the detached metrics dict (scalar tensors on the device)."""
    trunc = truncation_at(step, tcfg, n_iters)
    out = render_rays(field, rcfg, batch, c2w, occ_grid, generator=generator,
                      perturb=perturb, trunc=trunc)
    loss, metrics = nof_loss(out, batch, field, trunc, lcfg)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    f = lr_factor_at(step, tcfg, n_iters)
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * f
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def train_steps(field, optimizer, rays_store: dict, n_valid: int, c2w,
                occ_grid, start_step: int, n_steps: int, rcfg: RenderConfig,
                lcfg: LossConfig, tcfg: TrainConfig, n_iters: int,
                generator=None):
    """Run @n_steps training steps; each draws `tcfg.n_rand` ray indices
    uniformly in [0, n_valid) from @generator and gathers its batch from
    @rays_store (dict of device tensors). Returns metrics stacked (n_steps,)
    on the device: no host sync inside the loop."""
    dev = rays_store["depth"].device
    history = []
    for i in range(n_steps):
        idx = torch.randint(0, n_valid, (tcfg.n_rand,), generator=generator,
                            device=dev)
        batch = {k: v[idx] for k, v in rays_store.items()}
        history.append(train_step(field, optimizer, batch, start_step + i,
                                  c2w, occ_grid, rcfg, lcfg, tcfg, n_iters,
                                  generator=generator, perturb=True))
    return {k: torch.stack([m[k] for m in history]) for k in history[0]}
