"""The tracker's bundle adjustment replayed as CUDA graphs.

Eager PyTorch dispatches ~1,300 kernels for one `bundle_adjust_pooled`
call, which cost the host several times the card's time. A graph holds
the kernels for fixed shapes, and the BA's counts change every frame, so
`Bundler.optimize_dispatch` pads them to a few buckets, as the JAX package
pads them to compile buckets:

- N frames and D dense points a frame: not padded;
- P pairs: to N(N-1)/2, padded rows with `pair_valid` 0;
- Pw pairs of the wide search: to N-1 (the new frame's pairs), else to
  P, padded rows with `pair_w_dst` = P (dropped);
- C correspondences: to a power of two >= `C_MIN`, padded rows with
  `corr_valid` 0, index 0 and points 0;
- KF keyframes: to a power of two >= `KF_MIN`, padded rows with
  `kf_window_idx` -1 and the identity pose; their covisibility is unread.

The buckets keep a tracking run's keys few. On the 480x640 orbit at ~1
degree a frame (`custom.track`'s traffic, 300-400 frames, H100) C runs
2,445-8,472, the keyframes reach 61 by frame 375, and Pw is N-1 but for
a few frames: once the window holds its 10 frames (frame ~50), floors of
256 and 8 make 5 keys, these 1, plus one where Pw passes N-1. Padded rows
cost the card little: the sparse term's rows, the wide search's pairs and
the keyframes' covisibility are a small share of the BA's device time,
which its ~1,300 small kernels set.

`BAGraphs` packs a call's host arrays into one buffer (`pack_layout`),
keys the call by that layout (the padded shapes), the BA's scale and
config and the pool maps' frame shape, and on CUDA captures the call once
per key and replays it after one non-blocking upload and a gather of the
call's frames from the pool maps. CPU tensors take the same padding,
packing and gather and run eagerly.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from bundlesdf_tpu_torch.tracker.ba import drive, pooled_steps
from bundlesdf_tpu_torch.utils.profiling import count, span

# the caching allocator's alignment, so a packed input is aligned as an
# uploaded one is, and each kernel picks the same vector width
_ALIGN = 512
C_MIN = 16384    # correspondences
KF_MIN = 64      # keyframes
_DTYPES = {np.dtype(np.int64): torch.int64,
           np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool}


def pow2_at_least(n: int, lo: int) -> int:
    """The smallest power of two that is at least @n and @lo (a power of
    two)."""
    b = lo
    while b < n:
        b *= 2
    return b


def pack_layout(arrays: dict) -> tuple:
    """(layout, bytes) of @arrays ({name: numpy array}) packed in order:
    layout is ((name, dtype, shape, offset), ...), each array at an offset
    aligned to `_ALIGN` bytes."""
    out, off = [], 0
    for name, a in arrays.items():
        if a.dtype not in _DTYPES:
            raise TypeError(f"{name}: no packing for {a.dtype}")
        out.append((name, a.dtype.str, a.shape, off))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return tuple(out), max(off, _ALIGN)


def pack_into(buf: np.ndarray, arrays: dict, layout: tuple):
    """Write @arrays into the uint8 buffer @buf at @layout's offsets."""
    for name, _, _, off in layout:
        a = np.ascontiguousarray(arrays[name])
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)


def unpack(buf: torch.Tensor, layout: tuple) -> dict:
    """{name: tensor}: views of the uint8 tensor @buf at @layout."""
    out = {}
    for name, dt, shape, off in layout:
        dt = np.dtype(dt)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out[name] = buf[off:off + n].view(_DTYPES[dt]).view(shape)
    return out


class _Graph:
    """One key's device input buffer and its views, the maps of the call's
    frames (gathered from the pool maps before each run), its graph pieces
    and outputs."""

    def __init__(self, buf, layout, maps):
        self.buf = buf
        self.inputs = unpack(buf, layout)
        self.slots = self.inputs["slots"]          # pool slots, uploaded
        n = self.slots.shape[0]
        self.maps = {k: None if t is None else t.new_empty((n,) + t.shape[1:])
                     for k, t in maps.items()}
        # the BA reads the gathered maps: frame k sits in row k
        self.inputs["slots"] = torch.arange(n, device=buf.device)
        self.pieces = None
        self.out = None

    def gather(self, maps):
        for k, t in maps.items():
            if t is not None:
                torch.index_select(t, 0, self.slots, out=self.maps[k])


class BAGraphs:
    """`bundle_adjust_pooled` replayed as CUDA graphs, one set per key,
    least recently used first out past `MAX_GRAPHS`.

    - The BA is captured in pieces, two a Gauss-Newton iteration and one
      more. Between them run, eagerly and at the call's real counts, the
      products over the correspondences (`ba.sparse_points`) and the sums
      over the correspondences and the pairs (`ba.normal_sums`), into
      tensors the pieces hold. A batched product or a sum over padded rows
      may take another order than one over the real rows, and the
      tracker's poses can move far on such a difference, so a padded call
      keeps the bits of the exact one.
    - A key's first call runs the BA once eagerly on a side stream (each
      kernel's workspace and constant made outside the capture), captures
      the pieces there, then replays them; every later call copies its
      inputs in and replays. Every graph allocates from one shared memory
      pool: they never run at once, and each call's outputs are read (the
      tracker's `HostPull`) before the next replay on the stream.
    - The graphs read their own buffers only: the packed inputs, and the
      pool maps of the call's N frames, gathered into (N, ...) buffers on
      the stream before each run (the pool grows as keyframes come, and a
      graph holds the addresses it was captured on).
    - The key is the packed layout (the padded shapes), the BA's static
      arguments and each map's frame shape and type: what the cache does
      depends on the input shapes and the device alone.
    - Spans: `ba.graph.capture` around the eager run and the capture;
      `ba.graph.replay` around each call's replays and eager steps.
      Counters `ba.graph.captures`, `ba.graph.replays` (one a call).
    @new_graph: what makes a graph (`torch.cuda.CUDAGraph`); a test on the
    CPU passes a stand-in, and CPU tensors otherwise run eagerly."""

    MAX_GRAPHS = 4

    def __init__(self, new_graph=None):
        self._new_graph = new_graph
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._side = None

    def __len__(self):
        return len(self._graphs)

    def __call__(self, arrays: dict, maps: dict, poses_in=None, n_corr=None,
                 n_pairs=None, **static):
        """`bundle_adjust_pooled(**maps, **arrays, n_corr=, n_pairs=,
        **static)` with @arrays ({argument: numpy array}, padded) uploaded
        in one copy; @maps: {argument: device tensor or None}, the pool
        maps; @poses_in: a device tensor that takes the place of
        `arrays["poses0"]` (a coarser scale's result); @n_corr / @n_pairs:
        the real counts."""
        layout, nbytes = pack_layout(arrays)
        dev = maps["pool_xyzs"].device
        graphed = dev.type == "cuda" or self._new_graph is not None
        key = (layout, str(dev), tuple(sorted(static.items())),
               tuple((k, None if t is None else (tuple(t.shape[1:]), t.dtype))
                     for k, t in maps.items()))
        g = self._graphs.get(key) if graphed else None
        if g is None:
            g = _Graph(torch.empty(nbytes, dtype=torch.uint8, device=dev),
                       layout, maps)
        else:
            self._graphs.move_to_end(key)
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        pack_into(host.numpy(), arrays, layout)
        g.buf.copy_(host, non_blocking=True)
        if poses_in is not None:
            g.inputs["poses0"].copy_(poses_in)
        g.gather(maps)
        counts = dict(n_corr=n_corr, n_pairs=n_pairs)

        def steps():
            return pooled_steps(**g.maps, **g.inputs, **static)

        if not graphed:
            return drive(steps(), **counts)
        if g.pieces is None:
            self._capture(g, steps, counts, dev)
            self._graphs[key] = g
            while len(self._graphs) > self.MAX_GRAPHS:
                self._graphs.popitem(last=False)
        with span("ba.graph.replay"):
            for graph, step in g.pieces:
                graph.replay()
                if step is not None:
                    fn, args = step
                    fn(*args, **counts)
        count("ba.graph.replays")
        return g.out

    def _capture(self, g, steps, counts, dev):
        """The eager run, then each piece captured up to the next eager
        step (not run: the pieces write what the steps read only when
        replayed)."""
        cuda = dev.type == "cuda"
        ctx = contextlib.nullcontext()
        if cuda:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            cur = torch.cuda.current_stream(dev)
            self._side.wait_stream(cur)
            ctx = torch.cuda.stream(self._side)
        with span("ba.graph.capture"), ctx:
            drive(steps(), **counts)
            pieces, gen = [], steps()
            while True:
                graph = (self._new_graph or torch.cuda.CUDAGraph)()
                # thread_local: a NOF thread may keep using the card
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    step = next(gen)
                except StopIteration as stop:
                    graph.capture_end()
                    pieces.append((graph, None))
                    out = stop.value
                    break
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
                pieces.append((graph, step))
        if cuda:
            cur.wait_stream(self._side)
        count("ba.graph.captures")
        g.pieces, g.out = pieces, out
