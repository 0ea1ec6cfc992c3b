"""A run with the timed path broken underneath comes out not correct: the
harness at a tiny size on the CPU (past its look for a card), with each
fault the cell can have planted in the port where it is produced; in the
online cell also faults that begin only after the set-up's first NOF
batch, so that only the window's batches carry them. No
cell spans chips, so none can leave out an exchange between them."""
import numpy as np
import pytest

import bundlesdf_tpu_torch.nof.runner as port_runner
import bundlesdf_tpu_torch.nof.train as port_train
import bundlesdf_tpu_torch.tracker.bundler as port_bundler
from perfbench.tests import tiny


def state_unchanged_nof(monkeypatch):
    """Adam's step returns the parameters unchanged."""
    real = port_runner.make_optimizer

    def make(field, tcfg):
        opt = real(field, tcfg)
        opt.step = lambda *a, **k: None
        return opt
    monkeypatch.setattr(port_runner, "make_optimizer", make)


def half_batch_nof(monkeypatch):
    """Each NOF step trains on the first half of its rays, the mean taken
    over those."""
    real = port_train.train_step

    def step(field, optimizer, batch, *a, **k):
        n = next(iter(batch.values())).shape[0] // 2
        return real(field, optimizer, {k_: v[:n] for k_, v in batch.items()},
                    *a, **k)
    monkeypatch.setattr(port_train, "train_step", step)


def stale_rays_after_first_batch(monkeypatch):
    """From the second NOF batch on, `add_new_frames` leaves the ray store
    as it was: the new keyframes' rays are never trained on."""
    real = port_runner.NofRunner.add_new_frames

    def add(self, *a, **k):
        rays, host, n = self.rays, self._rays_host, self.n_rays_valid
        real(self, *a, **k)
        self.rays, self._rays_host, self.n_rays_valid = rays, host, n
    monkeypatch.setattr(port_runner.NofRunner, "add_new_frames", add)


def short_batch_after_first_batch(monkeypatch):
    """From the second NOF batch on, a batch runs half of its steps."""
    real = port_runner.NofRunner.start_training

    def start(self, n_steps=None):
        if getattr(self, "_batches_started", 0):
            n_steps = (self.N_iters if n_steps is None else n_steps) // 2
        self._batches_started = getattr(self, "_batches_started", 0) + 1
        real(self, n_steps=n_steps)
    monkeypatch.setattr(port_runner.NofRunner, "start_training", start)


def state_unchanged_tracker(monkeypatch):
    """Bundle adjustment pulls its result and leaves every pose as it
    was."""
    monkeypatch.setattr(port_bundler.Bundler, "optimize_finish",
                        lambda self, pending: pending["out"].get())


def answer_altered(monkeypatch):
    """The new frame's pose moved by 1 mm where BA writes it."""
    real = port_bundler.Bundler.optimize_finish

    def finish(self, pending):
        real(self, pending)
        nf = pending["new_frame"]
        nf.pose_in_model = nf.pose_in_model.copy()
        nf.pose_in_model[0, 3] += 1e-3
    monkeypatch.setattr(port_bundler.Bundler, "optimize_finish", finish)


CASES = [("custom.refine", state_unchanged_nof, 0.3),
         ("custom.refine", half_batch_nof, 0.3),
         ("ho3d.refine", half_batch_nof, 0.3),
         ("custom.track", state_unchanged_tracker, 1.0),
         ("custom.track", answer_altered, 1.0),
         ("custom.online", state_unchanged_nof, 1.0),
         ("custom.online", half_batch_nof, 1.0),
         ("custom.online", stale_rays_after_first_batch, 1.0),
         ("custom.online", short_batch_after_first_batch, 1.0),
         ("custom.online", answer_altered, 1.0)]


@pytest.mark.parametrize("workload,fault,seconds", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in CASES])
def test_fault_is_not_correct(tmp_path, monkeypatch, workload, fault,
                              seconds):
    fault(monkeypatch)
    res, err = tiny.run(str(tmp_path), workload, seconds=seconds)
    assert res["correct"] is False, err
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


@pytest.mark.parametrize("workload", ["custom.refine", "custom.track",
                                      "custom.online"])
def test_sound_run_is_correct(tmp_path, workload):
    res, err = tiny.run(str(tmp_path), workload, seconds=0.3)
    assert res["correct"] is True, err
    assert np.isfinite(res["metrics"]["setup_s"]["value"])
