"""Pluggable experiment scalar/artifact logging.

The reference optionally attaches a `sacred` run and logs per-step training
scalars and output artifacts to it (`nerf_runner.py:569-576` _run.log_scalar
in the train loop, `:820-822` artifact registration). This is the port's
equivalent seam: a tiny logger protocol, a JSONL file default, and
a null sink. `NofRunner` calls it at the i_print cadence and on artifact
saves; any experiment tracker (wandb/mlflow/sacred itself) plugs in by
implementing the two methods.
"""
from __future__ import annotations

import json
import os
import time


class ExperimentLogger:
    """Protocol with no-op defaults (also usable as a null sink)."""

    def log_scalar(self, name: str, value: float, step: int) -> None:
        pass

    def log_scalars(self, scalars: dict, step: int) -> None:
        for k, v in sorted(scalars.items()):
            self.log_scalar(k, float(v), step)

    def add_artifact(self, path: str, name: str | None = None) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlLogger(ExperimentLogger):
    """File-backed default: one JSON line per scalar/artifact event under
    @run_dir (scalars.jsonl / artifacts.jsonl), append-only so concurrent
    readers (dashboards, tail -f) see events as they land."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._scalars = open(os.path.join(run_dir, "scalars.jsonl"), "a")
        self._artifacts = open(os.path.join(run_dir, "artifacts.jsonl"), "a")
        self._t0 = time.time()

    def log_scalar(self, name, value, step):
        self._scalars.write(json.dumps(
            {"step": int(step), "name": name, "value": float(value),
             "t": round(time.time() - self._t0, 3)}) + "\n")
        self._scalars.flush()

    def add_artifact(self, path, name=None):
        self._artifacts.write(json.dumps(
            {"path": str(path), "name": name or os.path.basename(str(path)),
             "t": round(time.time() - self._t0, 3)}) + "\n")
        self._artifacts.flush()

    def close(self):
        self._scalars.close()
        self._artifacts.close()


def make_experiment_logger(cfg: dict) -> ExperimentLogger:
    """Logger from config: `experiment_log: <dir>` enables the JSONL sink
    (the reference's equivalent knob is constructing the runner with a
    sacred _run); anything falsy -> null sink."""
    run_dir = cfg.get("experiment_log", "")
    return JsonlLogger(run_dir) if run_dir else ExperimentLogger()
