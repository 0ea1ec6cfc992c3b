"""Device -> host pulls that do not serialise the host loop.

The JAX package starts `copy_to_host_async` on a result and pulls whole
result dicts with one `jax.device_get`; here a `HostPull` issues a
non-blocking copy of every tensor into pinned host memory, records one
CUDA event behind them, and `get()` waits on that event only. On the CPU
the tensors are copied, so a result never aliases a buffer (such as a pool
slot) that later work writes in place. Each pull names its site; the wait
in `get()` is the span `pull.<site>` (`utils/profiling.py`).
"""
from __future__ import annotations

import torch

from bundlesdf_tpu_torch.utils.profiling import span


class HostPull:
    """Start device->host copies of a {name: tensor} dict now; `get()`
    returns {name: numpy array} once they have landed. @site names the
    caller (`track.ba`, `nof.chunk`, ...)."""

    def __init__(self, tensors: dict, site: str):
        self._span = "pull." + site
        self._event = None
        cuda = [v for v in tensors.values() if v.device.type == "cuda"]
        if not cuda:
            self._host = {k: v.detach().clone() for k, v in tensors.items()}
            return
        self._host = {}
        for k, v in tensors.items():
            if v.device.type == "cuda":
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                self._host[k] = buf
            else:
                self._host[k] = v.detach().clone()
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(cuda[0].device))

    def ready(self) -> bool:
        """True once the copies have landed; never waits."""
        return self._event is None or self._event.query()

    def get(self) -> dict:
        if self._event is not None:
            with span(self._span):
                self._event.synchronize()
            self._event = None
        return {k: v.numpy() for k, v in self._host.items()}
