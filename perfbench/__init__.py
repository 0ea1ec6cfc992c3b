"""The benchmark of `bundlesdf_tpu_torch` on one NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the repository's root names the cells; each names a
configuration (`configs/<name>.json`), a traffic mix (`traffic/<name>.json`,
whose `driver` names the module of `drivers/` that runs it) and the limits
of its comparison (`limits/<cell>.json`); each per-layer metric is a reader
of its own (`metrics/<name>.py`). `reference/` holds the plain reference
that decides `correct`.
"""
