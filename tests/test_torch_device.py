"""The port's entry points run on the CUDA card unless the caller passes
`device="cpu"`: where no card is visible, building one without `device`
raises instead of running on the CPU. The card's absence is forced inside
each test, so the tests mean the same on a machine with a card."""
import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import default_nerf_config, default_track_config
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.matcher.gt import GtMatcher
from bundlesdf_tpu_torch.nof.runner import NofRunner
from bundlesdf_tpu_torch.tracker.bundler import Bundler
from bundlesdf_tpu_torch.tracker.frame import Frame
from bundlesdf_tpu_torch.tracker.pool import FramePool


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _track_cfg(tmp_path):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp_path / "debug")
    return cfg


def _frame(device=None):
    kw = {} if device is None else {"device": device}
    return Frame(np.zeros((8, 8, 3), np.uint8), np.ones((8, 8), np.float32),
                 np.eye(3), 0, "0000", default_track_config(), **kw)


CONSTRUCTORS = {
    "NofRunner": lambda tmp, **kw: NofRunner(default_nerf_config(), None,
                                             None, None, None, None, None,
                                             **kw),
    "BundleSdf": lambda tmp, **kw: BundleSdf(cfg_track=_track_cfg(tmp), **kw),
    "Bundler": lambda tmp, **kw: Bundler(default_track_config(), **kw),
    "FramePool": lambda tmp, **kw: FramePool(8, 8, cap=2, **kw),
    "Frame": lambda tmp, **kw: _frame(**kw),
    "OrbMatcher": lambda tmp, **kw: OrbMatcher(**kw),
    "GtMatcher": lambda tmp, **kw: GtMatcher({}, **kw),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_default_device_is_the_card(no_card, tmp_path, name):
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        CONSTRUCTORS[name](tmp_path)
    # BundleSdf raises before it creates its debug directory
    assert not (tmp_path / "debug").exists()


@pytest.mark.parametrize("name", ["BundleSdf", "Bundler", "FramePool",
                                  "Frame", "OrbMatcher", "GtMatcher"])
def test_cpu_on_request(no_card, tmp_path, name):
    assert CONSTRUCTORS[name](tmp_path, device="cpu").device == torch.device("cpu")


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
