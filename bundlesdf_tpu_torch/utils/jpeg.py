"""Baseline JPEG decoding without cv2, Pillow or imageio: the colour frames
of an HO3D video (`rgb/*.jpg`) on a machine that has none of them.

`read_jpeg(path)` / `decode_jpeg(data)` return what
`imageio.v2.imread(path)` returns on a machine whose Pillow runs
libjpeg-turbo with its defaults: (H, W, 3) uint8 RGB, or (H, W) uint8 for
a grey file, the same pixels bit for bit. That means the ISLOW integer
IDCT, fancy (triangle-filter) upsampling and jdcolor.c's fixed-point
YCbCr -> RGB tables.

Scope: baseline sequential JPEG at 8-bit precision (SOF0 and SOF1), with
DQT, DHT, SOS and DRI segments and restart markers. Files may have one
component (grey) or three (YCbCr). Chroma sampling may be 4:4:4, 4:2:2,
4:2:0 or 4:4:0. Any width and height are allowed, partial MCUs at the
edges included, and so are optimized Huffman tables. APPn and COM
segments are skipped. Progressive, lossless, hierarchical,
arithmetic-coded and 12-bit files, RGB-coded colour (libjpeg's reading of
an Adobe transform flag 0 or of the component ids R, G, B) and other
sampling ratios raise ValueError naming what is missing.

The marker segments are parsed and checked here, before any pointer
reaches C. The stages run in C (`csrc/jpeg_decode.c`): Huffman decode,
dequantization + IDCT, upsampling and colour conversion. The library is
compiled with `cc -O2 -shared` at first use into
`csrc/build/libjpeg_decode_<hash>.so` by `utils/build.py`, which renames
the finished file into place. A failed build raises: there is no Python
fallback. The decoder runs on the host, as imageio's does.
"""
from __future__ import annotations

import ctypes
import os
import re
import threading
import time

import numpy as np

from bundlesdf_tpu_torch.utils.build import BUILD_DIR, build_so

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "jpeg_decode.c")
CFLAGS = ["-O2", "-shared", "-fPIC"]
STAGES = ("parse", "entropy", "idct", "upsample", "color")

_lib = None
_lock = threading.Lock()

# zigzag index -> natural (row-major) index of a DQT table entry
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic progressive (SOF10)",
    0xCB: "arithmetic lossless (SOF11)", 0xCD: "arithmetic hierarchical "
    "(SOF13)", 0xCE: "arithmetic hierarchical progressive (SOF14)",
    0xCF: "arithmetic hierarchical lossless (SOF15)"}
# the end of an entropy-coded segment: 0xFF then neither a stuffed zero
# nor a restart marker
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
# chroma upsampling of 4:4:4, 4:2:2, 4:2:0 and 4:4:0
_CHROMA = ((1, 1), (2, 1), (2, 2), (1, 2))


def build_library(build_dir: str = BUILD_DIR) -> str:
    """Compile `csrc/jpeg_decode.c` into @build_dir unless a build of the
    same source is there. Returns its path; raises if the build fails."""
    cc = os.environ.get("CC", "cc")

    def command(tmp):
        out = os.path.join(tmp, "libjpeg_decode.so")
        return [cc, *CFLAGS, "-o", out, SOURCE], out

    return build_so("jpeg_decode", [SOURCE], command, CFLAGS, build_dir)[0]


def bind(lib):
    """Declare the C entry points' signatures on the ctypes handle @lib."""
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.jpeg_decode_scan.argtypes = [
        p_u8, i64, p_u8, ctypes.c_int, p_i64, i64, i64, i64,
        ctypes.POINTER(ctypes.c_int16)]
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_idct_plane.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
        i64, i64, p_u8]
    lib.jpeg_idct_plane.restype = None
    lib.jpeg_upsample.argtypes = [p_u8, i64, i64, i64, ctypes.c_int,
                                  ctypes.c_int, p_u8, i64]
    lib.jpeg_upsample.restype = None
    lib.jpeg_ycc_rgb.argtypes = [p_u8, p_u8, p_u8, i64, i64, i64, i64, p_u8]
    lib.jpeg_ycc_rgb.restype = None
    return lib


def load_library():
    """The ctypes handle of the decoder library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(build_library()))
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class _Frame:
    """What the SOF segment says: size and each component's id, sampling
    factors and quantization table."""

    def __init__(self, body):
        precision, H, W, n = (body[0], int.from_bytes(body[1:3], "big"),
                              int.from_bytes(body[3:5], "big"), body[5])
        if precision != 8:
            raise ValueError(f"JPEG: {precision}-bit samples are not "
                             f"supported (baseline 8-bit only)")
        if H == 0 or W == 0:
            raise ValueError("JPEG: a zero height (DNL marker) or width is "
                             "not supported")
        if n not in (1, 3):
            raise ValueError(f"JPEG: {n} components are not supported (1 "
                             f"or 3)")
        self.H, self.W = H, W
        self.ids, self.h, self.v, self.tq = [], [], [], []
        if len(body) != 6 + 3 * n:
            raise ValueError("JPEG: bad SOF segment length")
        for k in range(n):
            c = body[6 + 3 * k:9 + 3 * k]
            self.ids.append(c[0])
            self.h.append(c[1] >> 4)
            self.v.append(c[1] & 15)
            self.tq.append(c[2])
        if max(self.tq) > 3:
            raise ValueError("JPEG: bad quantization table selector")
        if len(set(self.ids)) != n:
            raise ValueError("JPEG: repeated component id in SOF")
        if not all(1 <= f <= 4 for f in self.h + self.v):
            raise ValueError("JPEG: bad sampling factors")
        self.hmax, self.vmax = max(self.h), max(self.v)
        # (horizontal, vertical) upsampling of each component
        self.ratio = [(self.hmax / h, self.vmax / v)
                      for h, v in zip(self.h, self.v)]
        if n == 3 and not (self.ratio[0] == (1, 1)
                           and self.ratio[1] == self.ratio[2]
                           and self.ratio[1] in _CHROMA):
            raise ValueError(f"JPEG: sampling factors {list(zip(self.h, self.v))}"
                             f" are not supported (4:4:4, 4:2:2, 4:2:0 or "
                             f"4:4:0 only)")
        self.mcus_x = -(-W // (8 * self.hmax))
        self.mcus_y = -(-H // (8 * self.vmax))
        # each component's block grid covers the whole interleaved MCUs
        self.grid = [(self.mcus_y * v, self.mcus_x * h)
                     for h, v in zip(self.h, self.v)]
        self.offset = np.cumsum([0] + [gy * gx for gy, gx in self.grid])
        self.coef = np.zeros((int(self.offset[-1]), 64), np.int16)
        # the component's real sample size (jdinput.c's downsampled size)
        self.size = [(-(-H * v // self.vmax), -(-W * h // self.hmax))
                     for h, v in zip(self.h, self.v)]


def _parse_sos(body, frame, restart, tables, data, lib):
    """Decode the scan whose header is @body and whose entropy-coded
    segment starts @data. Returns the segment's length."""
    n = body[0] if body else 0
    if not 1 <= n <= len(frame.ids) or len(body) != 4 + 2 * n:
        raise ValueError(f"JPEG: bad SOS segment ({n} components in "
                         f"{len(body)} bytes)")
    sel = [(body[1 + 2 * k], body[2 + 2 * k]) for k in range(n)]
    if len({cid for cid, _ in sel}) != n:
        raise ValueError("JPEG: scan names a component twice")
    ss, se, ahl = body[1 + 2 * n:4 + 2 * n]
    if (ss, se, ahl) != (0, 63, 0):
        raise ValueError("JPEG: a scan with spectral selection or "
                         "successive approximation (progressive) is not "
                         "supported")
    scomp = np.zeros((n, 6), np.int64)
    for k, (cid, tsel) in enumerate(sel):
        if cid not in frame.ids:
            raise ValueError(f"JPEG: scan names unknown component {cid}")
        if tsel >> 4 > 3 or tsel & 15 > 3:
            raise ValueError("JPEG: bad Huffman table selector")
        c = frame.ids.index(cid)
        scomp[k] = (frame.h[c] if n > 1 else 1, frame.v[c] if n > 1 else 1,
                    tsel >> 4, tsel & 15, frame.grid[c][1],
                    frame.offset[c])
    if n > 1:
        mcus_x, mcus_y = frame.mcus_x, frame.mcus_y
    else:   # non-interleaved: one block an MCU over the component's blocks
        c = frame.ids.index(sel[0][0])
        mcus_y, mcus_x = (-(-s // 8) for s in frame.size[c])
    m = _SEGMENT_END.search(data)
    seg_len = m.start() if m else len(data)
    seg = np.frombuffer(data, np.uint8, seg_len)
    rc = lib.jpeg_decode_scan(
        _ptr(seg, ctypes.c_uint8), seg_len, _ptr(tables, ctypes.c_uint8), n,
        _ptr(scomp, ctypes.c_int64), mcus_x, mcus_y, restart,
        _ptr(frame.coef, ctypes.c_int16))
    if rc != 0:
        raise ValueError(f"JPEG: corrupt entropy-coded data (code {rc})")
    return seg_len


def _rgb_coded(frame, jfif, adobe):
    """Whether libjpeg would read three components as RGB, not YCbCr
    (jdapimin.c default_decompress_parms)."""
    if jfif or len(frame.ids) != 3:
        return False
    if adobe is not None:
        return adobe == 0
    return tuple(frame.ids) == (82, 71, 66)      # 'R', 'G', 'B'


def decode_jpeg(data: bytes, times: dict | None = None) -> np.ndarray:
    """The pixels of the JPEG file @data (see the module docstring). With
    @times, adds each stage's milliseconds to it (keys `STAGES`)."""
    lib = load_library()
    t = time.perf_counter()
    marks = {}

    def lap(stage):
        nonlocal t
        now = time.perf_counter()
        marks[stage] = marks.get(stage, 0.0) + 1e3 * (now - t)
        t = now

    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI marker")
    qt = np.zeros((4, 64), np.uint16)
    tables = np.zeros((8, 272), np.uint8)
    frame, restart, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and \
                pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1                                 # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:                           # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        if length < 2 or pos + length > len(data):
            raise ValueError(f"JPEG: truncated segment at byte {pos}")
        body = data[pos + 2:pos + length]
        pos += length
        if marker in (0xC0, 0xC1):
            frame = _Frame(body)
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"JPEG: {_UNSUPPORTED_SOF[marker]} files are "
                             f"not supported (baseline sequential only)")
        elif marker == 0xCC:
            raise ValueError("JPEG: arithmetic coding (DAC) is not "
                             "supported")
        elif marker == 0xDB:                         # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                if tq > 3 or k + 1 + 64 * (pq + 1) > len(body):
                    raise ValueError("JPEG: bad quantization table")
                if pq:
                    vals = np.frombuffer(body, ">u2", 64, k + 1)
                    k += 129
                else:
                    vals = np.frombuffer(body, np.uint8, 64, k + 1)
                    k += 65
                qt[tq, _ZIGZAG] = vals
        elif marker == 0xC4:                         # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                if k + 17 > len(body):
                    raise ValueError("JPEG: bad Huffman table")
                counts = np.frombuffer(body, np.uint8, 16, k + 1)
                nv = int(counts.sum())
                if nv > 256 or tc > 1 or th > 3 or k + 17 + nv > len(body):
                    raise ValueError("JPEG: bad Huffman table")
                row = tables[4 * tc + th]
                row[:] = 0
                row[:16] = counts
                row[16:16 + nv] = np.frombuffer(body, np.uint8, nv, k + 17)
                k += 17 + nv
        elif marker == 0xDD:                         # DRI
            if len(body) != 2:
                raise ValueError("JPEG: bad DRI segment length")
            restart = int.from_bytes(body, "big")
        elif marker == 0xDA:                         # SOS
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            lap("parse")
            pos += _parse_sos(body, frame, restart, tables, data[pos:], lib)
            lap("entropy")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        # other APPn, COM: skipped
    if frame is None:
        raise ValueError("JPEG: no frame (SOF) segment")
    if _rgb_coded(frame, jfif, adobe):
        raise ValueError("JPEG: RGB-coded colour (no YCbCr transform) is not "
                         "supported")

    planes = []
    for c in range(len(frame.ids)):
        gy, gx = frame.grid[c]
        plane = np.empty((gy * 8, gx * 8), np.uint8)
        coef = frame.coef[frame.offset[c]:frame.offset[c + 1]]
        qtab = np.ascontiguousarray(qt[frame.tq[c]])
        lib.jpeg_idct_plane(_ptr(coef, ctypes.c_int16),
                            _ptr(qtab, ctypes.c_uint16), gy, gx,
                            _ptr(plane, ctypes.c_uint8))
        planes.append(plane)
    lap("idct")
    H, W = frame.H, frame.W
    if len(planes) == 1:
        out = planes[0][:H, :W].copy()
        lap("upsample")
    else:
        full = []
        for c, plane in enumerate(planes):
            hf, vf = (int(r) for r in frame.ratio[c])
            if hf == vf == 1:
                full.append(plane)
                continue
            dh, dw = frame.size[c]
            up = np.empty((dh * vf, dw * hf), np.uint8)
            lib.jpeg_upsample(_ptr(plane, ctypes.c_uint8), plane.shape[1],
                              dw, dh, hf, vf, _ptr(up, ctypes.c_uint8),
                              up.shape[1])
            full.append(up)
        lap("upsample")
        y, cb, cr = full
        out = np.empty((H, W, 3), np.uint8)
        lib.jpeg_ycc_rgb(_ptr(y, ctypes.c_uint8), _ptr(cb, ctypes.c_uint8),
                         _ptr(cr, ctypes.c_uint8), H, W, y.shape[1],
                         cb.shape[1], _ptr(out, ctypes.c_uint8))
    lap("color")
    if times is not None:
        for k, v in marks.items():
            times[k] = times.get(k, 0.0) + v
    return out


def read_jpeg(path: str, times: dict | None = None) -> np.ndarray:
    """Read the JPEG at @path (see `decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), times)
