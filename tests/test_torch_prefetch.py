"""The port's prefetching reader (`bundlesdf_tpu_torch/datasets/
prefetch.py`) with the semantics tests/test_prefetch.py holds the JAX
package's to: the same frames as the wrapped reader, loaded ahead so that
consuming them beats a serial load; per-field accessors and eviction; and
over the port's `YcbineoatReader` on a dataset folder, every frame equal
to the reader's own."""
import time

import numpy as np

from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch.datasets import YcbineoatReader
from bundlesdf_tpu_torch.datasets.prefetch import PrefetchReader


class _SlowReader:
    def __init__(self, seq, delay=0.02):
        self.seq = seq
        self.K = seq["K"]
        self.id_strs = seq["id_strs"]
        self.delay = delay
        self.loads = 0

    def __len__(self):
        return len(self.id_strs)

    def get_video_name(self):
        return "slow"

    def get_color(self, i):
        time.sleep(self.delay)
        self.loads += 1
        return self.seq["colors"][i]

    def get_depth(self, i):
        return self.seq["depths"][i]

    def get_mask(self, i):
        return self.seq["masks"][i]


def test_prefetch_matches_and_overlaps():
    seq = cube_orbit_sequence(n_frames=8, H=24, W=32)
    base = _SlowReader(seq)
    pr = PrefetchReader(base, ahead=4, workers=2)
    assert len(pr) == 8 and pr.get_video_name() == "slow"
    # give workers a head start, then consume: frames should be cached
    time.sleep(0.3)
    t0 = time.time()
    for i in range(8):
        f = pr.frame(i)
        np.testing.assert_array_equal(f["color"], seq["colors"][i])
        np.testing.assert_array_equal(f["depth"], seq["depths"][i])
        np.testing.assert_array_equal(f["mask"], seq["masks"][i])
    consume = time.time() - t0
    # naive serial load would be >= 8 * delay; prefetch should beat it
    assert consume < 8 * base.delay
    assert base.loads == 8
    pr.close()


def test_prefetch_field_accessors():
    seq = cube_orbit_sequence(n_frames=3, H=24, W=32)
    pr = PrefetchReader(_SlowReader(seq, delay=0.0), ahead=2)
    np.testing.assert_array_equal(pr.get_color(1), seq["colors"][1])
    np.testing.assert_array_equal(pr.get_mask(2), seq["masks"][2])
    assert pr.get_occ_mask(1) is None      # the reader has no occluders
    pr.evict(1)
    assert 1 not in pr._cache
    pr.close()


def test_prefetch_over_the_dataset_reader(tmp_path):
    from bundlesdf_tpu_torch.benchmark_synthetic import write_dataset

    seq = cube_orbit_sequence(n_frames=4, H=24, W=32)
    write_dataset(str(tmp_path), seq)
    reader = YcbineoatReader(str(tmp_path))
    pr = PrefetchReader(reader, ahead=2, workers=2)
    np.testing.assert_array_equal(pr.K, reader.K)
    for i in range(len(reader)):
        f = pr.frame(i)
        np.testing.assert_array_equal(f["color"], reader.get_color(i))
        np.testing.assert_array_equal(f["depth"], reader.get_depth(i))
        np.testing.assert_array_equal(f["mask"], reader.get_mask(i))
    pr.close()
