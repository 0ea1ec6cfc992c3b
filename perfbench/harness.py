"""The benchmark's core: find a cell's configuration, traffic, limits and
metric readers by name, run its driver, and assemble the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json` gives
it: `configs/<config>.json`, `traffic/<traffic>.json` (whose `driver` key
names the module of `drivers/` that runs the mix), `limits/<cell>.json`
and `metrics/<metric>.py` (a `read(window)` that returns a number, or None
where it finds nothing to read).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@dataclass
class Cell:
    """What a driver gets: the cell's entry, its configuration and traffic
    files, the run's arguments and where it may write."""
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    scratch: str
    log: list = field(default_factory=list)

    def note(self, msg: str):
        """A line for standard error (kept to the end of the run)."""
        self.log.append(msg)


@dataclass
class Outcome:
    """What a driver returns. @end_to_end: {metric: value} on the host
    clock; @window: what the per-layer readers read (counters, stage
    tables, the trace's events, the configuration); @compared:
    [(name, value, limit)], each correct while value <= limit."""
    end_to_end: dict
    window: dict
    compared: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_metric(bench_dir: str, name: str):
    """The reader of a per-layer metric: `metrics/<name>.py`'s `read`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The metrics of @kind ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def prepare(workload: str, seed: int, seconds: float, trace: bool,
            device: str, benchmark_json: str | None = None,
            bench_dir: str | None = None, scratch: str | None = None,
            t_start: float | None = None):
    """(BENCHMARK.json, the Cell) of @workload."""
    bench_dir = bench_dir or HERE
    bench = load_json(benchmark_json or os.path.join(REPO, "BENCHMARK.json"))
    wl = find(bench["workloads"], workload, "workload")
    cfg = load_json(os.path.join(bench_dir, "configs", f"{wl['config']}.json"))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{wl['traffic']}.json"))
    lim_path = os.path.join(bench_dir, "limits", f"{workload}.json")
    limits = load_json(lim_path) if os.path.exists(lim_path) else {}
    if scratch is None:
        import tempfile
        scratch = tempfile.mkdtemp(prefix=f"perfbench_{workload}_")
    cell = Cell(workload=wl, config=cfg, traffic=traffic, limits=limits,
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=device, scratch=scratch,
                t_start=time.perf_counter() if t_start is None else t_start)
    return bench, cell


def run_cell(bench: dict, cell: Cell, bench_dir: str | None = None,
             driver=None) -> tuple[dict, list[str]]:
    """Run the cell's driver and assemble the result line (a dict in the
    contract's key order) and the lines for standard error."""
    bench_dir = bench_dir or HERE
    name = cell.workload["name"]
    if driver is None:
        driver = importlib.import_module(
            f"perfbench.drivers.{cell.traffic['driver']}")
    out: Outcome = driver.run(cell)
    metrics = {}
    if cell.trace:
        for m in metrics_of(bench, name, "per_layer"):
            v = load_metric(bench_dir, m["name"])(out.window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in metrics_of(bench, name, "end_to_end"):
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                      "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in out.compared) and bool(
        out.compared)
    device = {"platform": "gpu" if cell.device.startswith("cuda") else "cpu",
              "kind": out.window.get("device_kind", cell.device),
              "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cell.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    res = {"correct": bool(correct), "attempted": int(out.attempted),
           "failed": int(out.failed), "metrics": metrics, "device": device}
    if cell.trace and out.breakdown is not None:
        res["breakdown"] = out.breakdown
    res["compared"] = {n: {"value": float(v), "limit": float(lim)}
                       for n, v, lim in out.compared}
    err = list(cell.log) + [f"{n} {v!r} limit {lim!r}"
                            for n, v, lim in out.compared]
    return res, err
