"""LoFTR inference throughput of the port.

    python -m bundlesdf_tpu_torch.bench_loftr [--device cuda] [--repeat 3]

Port of the repo's `bench_loftr.py`: the metric `loftr_pairs_per_sec`
over 400x400 grey crops (the pipeline's `feature_corres.resize`), full
`LoftrConfig()` with seeded random weights (the compute does not depend
on their values), amp off and on, batch 8 and batch 64. One JSON line per
(amp, batch):

- `value`: pairs/s of `LoftrMatcher.predict` on the host's clock (upload,
  net and the one host pull), the median of `--repeat` timed calls after
  a warm-up call;
- `device_ms_per_pair`: the union of the device intervals of one traced
  call (`utils/profiling.py`), over the batch;
- `peak_mem_gib`: `torch.cuda.max_memory_allocated` over one call;
- `gflop_per_pair` (`pair_flops`, from the shapes) and `flop_bound_share`:
  the time the card's dense peak at the net's dtype needs for those FLOPs
  over the device time, with the peak named (`peak`);
- `device`: the card's name and power limit as `nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader` prints them.

On the CPU the device fields are left out.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.bench import _traced_device_ms, device_label
from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher

# dense peaks of one H100 (NVIDIA data sheet, SXM part, 700 W); float32
# runs outside the tensor cores, since the port turns TF32 off
PEAKS = {torch.float32: (67e12, "67 TFLOP/s float32 (H100 SXM data sheet)"),
         torch.bfloat16: (989e12,
                          "989 TFLOP/s bf16 dense (H100 SXM data sheet)")}
SIZE, BATCHES = 400, (8, 64)


def pair_flops(cfg: LoftrConfig, H: int, W: int) -> dict:
    """Multiply-adds x 2 of one pair's forward, by stage, from the shapes:
    the backbone over both images, the coarse transformer, the dual
    softmax's similarity, and the fine stage (all K slots run, full or
    not)."""
    d0, d1, d2 = cfg.block_dims
    di = cfg.initial_dim
    h2, h4, h8 = (H // 2) * (W // 2), (H // 4) * (W // 4), (H // 8) * (W // 8)

    def conv(cin, cout, k, px):
        return 2 * cin * cout * k * k * px

    bb = (conv(1, di, 7, h2) + conv(di, d0, 3, h2) + 3 * conv(d0, d0, 3, h2)
          + conv(d0, d1, 3, h4) + conv(d1, d1, 3, h4) + conv(d0, d1, 1, h4)
          + 2 * conv(d1, d1, 3, h4)
          + conv(d1, d2, 3, h8) + conv(d2, d2, 3, h8) + conv(d1, d2, 1, h8)
          + 2 * conv(d2, d2, 3, h8)
          + conv(d2, d2, 1, h8) + conv(d1, d2, 1, h4) + conv(d2, d2, 3, h4)
          + conv(d2, d1, 3, h4) + conv(d0, d1, 1, h2) + conv(d1, d1, 3, h2)
          + conv(d1, d0, 3, h2))

    def layer(L, S, d):
        """One encoder layer over L query rows and S source rows."""
        D = d // cfg.nhead
        proj = 2 * L * d * d + 2 * 2 * S * d * d + 2 * L * d * d  # q,k,v,merge
        attn = 2 * S * d * D + 2 * L * d + 2 * L * d * D  # KV, Z, output
        mlp = 2 * L * (2 * d) * (2 * d) + 2 * L * (2 * d) * d
        return proj + attn + mlp

    L = h8
    K = min(cfg.max_matches, L)
    ww = cfg.fine_window ** 2
    coarse = 2 * cfg.n_coarse_layers * 2 * layer(L, L, cfg.d_coarse)
    dual = 2 * L * L * cfg.d_coarse
    fine = (2 * cfg.n_fine_layers * 2 * K * layer(ww, ww, cfg.d_fine)
            + 2 * K * 2 * cfg.d_coarse * cfg.d_fine
            + 2 * K * ww * 2 * (2 * cfg.d_fine) * cfg.d_fine
            + 2 * K * ww * cfg.d_fine + 2 * K * ww * 2)
    out = {"backbone": 2 * bb, "coarse_transformer": coarse,
           "dual_softmax": dual, "fine": fine}
    out["total"] = sum(out.values())
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_line(matcher: LoftrMatcher, imgs, batch: int, repeat: int = 3):
    """One `loftr_pairs_per_sec` record of @matcher on pairs (imgs[i],
    imgs[i+1]) of the first @batch images."""
    dev = matcher.device
    a = [imgs[i] for i in range(batch)]
    b = [imgs[(i + 1) % batch] for i in range(batch)]
    out = matcher.predict(a, b)  # warm-up
    times = []
    for _ in range(repeat):
        _sync(dev)
        t0 = time.perf_counter()
        out = matcher.predict(a, b)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    H, W = np.asarray(imgs[0]).shape[:2]
    flops = pair_flops(matcher.cfg, H // 8 * 8, W // 8 * 8)
    dtype = matcher.net.dtype
    rec = {"metric": "loftr_pairs_per_sec", "amp": matcher.cfg.amp,
           "batch": batch, "value": round(batch / dt, 2),
           "unit": f"pairs/s ({H}x{W}, batched inference)",
           "device": device_label(dev),
           "pairs_per_sec_repeats": [round(batch / t, 2) for t in times],
           "n_matches_first_pair": int(len(out[0])),
           "gflop_per_pair": round(flops["total"] / 1e9, 2),
           "gflop_by_stage": {k: round(v / 1e9, 3) for k, v in flops.items()
                              if k != "total"}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        matcher.predict(a, b)
        rec["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
        busy, _ = _traced_device_ms(lambda: matcher.predict(a, b), dev)
        ms = busy / batch
        peak, name = PEAKS[dtype]
        rec.update(device_ms_per_pair=round(ms, 4),
                   flop_bound_ms_per_pair=round(
                       1e3 * flops["total"] / peak, 4),
                   flop_bound_share=round(1e3 * flops["total"] / peak / ms,
                                          4),
                   peak=name)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (max(BATCHES), SIZE, SIZE)).astype(np.uint8)
    records = []
    for amp in (False, True):
        m = LoftrMatcher(seed=0, cfg=LoftrConfig(amp=amp), device=device)
        for batch in BATCHES:
            rec = bench_line(m, imgs, batch, args.repeat)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
