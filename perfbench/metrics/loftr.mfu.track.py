"""The LoFTR net's share of the card's bf16 dense peak: one pair's FLOPs
(`loftr_flops.pair_flops`, from the matcher's shapes and crop size) times
the pairs the program's `loftr.pairs` counter added in the traced slice,
over the device-busy union of the work launched inside its `loftr.net`
spans, over 989 TFLOP/s (`roofline.PEAK_BF16_FLOPS`). None on the CPU and
where the slice holds no such span or counts no pair."""
from perfbench import loftr_flops, roofline


def read(window):
    ms = (window.get("range_device_ms") or {}).get("loftr.net")
    pairs = (window.get("loftr_slice") or {}).get("loftr.pairs")
    shape = window.get("loftr_shape")
    if not ms or not pairs or not shape \
            or window.get("device_kind", "cpu") == "cpu":
        return None
    s = int(shape["size"])
    flops = loftr_flops.pair_flops(shape["cfg"], s, s)["total"]
    return 100.0 * flops * pairs / (ms / 1e3) / roofline.PEAK_BF16_FLOPS
