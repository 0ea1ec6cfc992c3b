"""Regenerate the HO3D-layout fixture, `tests/fixtures/ho3d_orbit30/`:

- `rgb/<id>.jpg`: the 30 frames of `tests/ho3d_layout.py::orbit_sequence`
  (the first 30 of the 120-frame easy orbit at 480x640, phase 7's
  sequence), encoded by Pillow as baseline JPEGs at quality 95 with 4:2:0
  chroma (libjpeg's default), as HO3D's frames are;
- `sha256.json`: for each id, the SHA-256 of the pixels
  `imageio.v2.imread(path)[..., :3]` decodes from that file
  (`ho3d_layout.pixel_sha256`), which the port's decoder must match.

    python tests/fixtures/gen_ho3d_layout.py      (~10 s)

The GPU machine has no JPEG encoder, so these files are committed; the
rest of the layout (depth, meta, masks, visible_mesh.ply) is written from
the same sequence at run time by `tests/ho3d_layout.py`.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    import imageio.v2 as imageio
    import ho3d_layout as lay
    seq = lay.orbit_sequence(30)
    os.makedirs(os.path.join(lay.FIXTURE_DIR, "rgb"), exist_ok=True)
    hashes = {}
    for i, id_str in enumerate(seq["id_strs"]):
        path = os.path.join(lay.FIXTURE_DIR, "rgb", f"{id_str}.jpg")
        lay.encode_jpeg(seq["colors"][i], path)
        hashes[id_str] = lay.pixel_sha256(imageio.imread(path)[..., :3])
    with open(lay.HASHES, "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(hashes)} JPEGs and {lay.HASHES}")


if __name__ == "__main__":
    main()
