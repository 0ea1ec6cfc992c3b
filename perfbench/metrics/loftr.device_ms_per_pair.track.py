"""Device ms a LoFTR pair: the device-busy union of the work launched
inside the program's `loftr.net` spans (each batch's forward) in the traced
slice, over the pairs the program's `loftr.pairs` counter added in the
slice. None where the slice holds no such span or counts no pair."""


def read(window):
    ms = (window.get("range_device_ms") or {}).get("loftr.net")
    pairs = (window.get("loftr_slice") or {}).get("loftr.pairs")
    if not ms or not pairs:
        return None
    return ms / pairs
