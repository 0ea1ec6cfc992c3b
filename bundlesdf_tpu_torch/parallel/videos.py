"""Throughput sweep: several video pipelines interleaved in one process.

Port of `bundlesdf_tpu/parallel/videos.py`. The reference runs benchmark
videos one after another (`run_ho3d.py:116-119`). Here one host loop
takes the videos' frames round-robin, and each video's device work runs
on a device of its own: its tracker is built by
`make_tracker(out_dir, device)` on that device (what
`jax.default_device` does for the JAX package), and each of its calls
runs with that card as the current CUDA device. Kernels of different
videos can then overlap on the device(s) while the host logic stays
serial. Videos are independent, so no collective is needed.

`devices` may name one card more than once: two videos interleaved on
one H100 is `devices=[cuda:0, cuda:0]`. There is no silent fallback to
fewer devices than asked for.
"""
from __future__ import annotations

import contextlib
import logging

import torch


def _current(dev):
    """Make @dev the current CUDA device for the calls inside."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def run_videos_parallel(video_jobs, make_tracker, n_devices=None,
                        devices=None):
    """@video_jobs: list of (reader, out_dir). @make_tracker:
    callable(out_dir, device) -> BundleSdf on that device. Interleaves
    frames across videos; video k runs on devices[k % n_devices].
    @devices: list of torch.devices (default: every visible card);
    @n_devices: how many of them to use (default: all of them).
    Returns the trackers, in job order."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_devices = n_devices or len(devices)
    assert len(devices) >= (n_devices or 1), (
        f"need {n_devices} devices, {len(devices)} given or visible")
    jobs = []
    for k, (reader, out_dir) in enumerate(video_jobs):
        dev = devices[k % n_devices]
        with _current(dev):
            tracker = make_tracker(out_dir, dev)
        jobs.append({"reader": reader, "tracker": tracker, "device": dev,
                     "i": 0, "done": False})

    remaining = len(jobs)
    while remaining > 0:
        for job in jobs:
            if job["done"]:
                continue
            reader = job["reader"]
            i = job["i"]
            if i >= len(reader):
                with _current(job["device"]):
                    job["tracker"].on_finish()
                job["done"] = True
                remaining -= 1
                logging.info(f"video done ({reader.get_video_name()})")
                continue
            with _current(job["device"]):
                job["tracker"].run(
                    reader.get_color(i), reader.get_depth(i), reader.K,
                    reader.id_strs[i], mask=reader.get_mask(i),
                    occ_mask=(reader.get_occ_mask(i)
                              if hasattr(reader, "get_occ_mask") else None))
            job["i"] += 1
    return [j["tracker"] for j in jobs]
