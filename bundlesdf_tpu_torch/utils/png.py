"""PNG files in numpy, zlib and struct: the artifact and dataset images the
port reads and writes where cv2 is not installed (the GPU machine has no
cv2).

`write_png` takes uint8 or uint16 arrays, (H, W) gray or (H, W, 3) RGB,
and writes every row with filter 2 (Up) by default, which is one
vectorised difference, at zlib level 1. `read_png` decodes 8- and 16-bit
gray, gray+alpha, RGB and RGBA, 8-bit palette images and 1-, 2- and 4-bit
gray and palette images (dataset PNGs come in all of them),
non-interlaced, with all five row filters (encoders choose a filter per
row). An image whose rows use only None, Sub and Up is
decoded row by row, each row vectorised; Average and Paeth also read the
decoded byte to their left, so an image with such rows is decoded one
anti-diagonal of pixels at a time (`_unfilter_wavefront`). Channels are in
file order (RGB), not cv2's BGR; 16-bit samples come back as native
uint16. `read_png_unchanged` gives what cv2.imread(path,
cv2.IMREAD_UNCHANGED) gives instead: None for a missing file, channels in
BGR(A) order, gray + alpha as BGRA, and a palette image with a tRNS chunk
as BGRA.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels by PNG color type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2}     # writer: channels -> PNG color type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img, filter: int = 2) -> bytes:
    """The PNG file of @img (see module docstring) as bytes, every row
    with @filter: 2 (Up) or 4 (Paeth, the filter libpng's adaptive choice
    favours, and the slowest to decode)."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
    else:
        raise TypeError(f"write_png: uint8 or uint16 image, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    ch = 1 if a.ndim == 2 else a.shape[2]
    if a.ndim not in (2, 3) or ch not in _COLOR_TYPE or a.size == 0:
        raise ValueError(f"write_png: need (H, W) or (H, W, 3), got "
                         f"{a.shape}")
    H, W = a.shape[:2]
    rows = np.ascontiguousarray(a.reshape(H, W * ch).astype(
        ">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(H, -1)
    if filter not in (2, 4):
        raise ValueError(f"write_png: filter 2 (Up) or 4 (Paeth), got "
                         f"{filter}")
    b = np.zeros_like(rows, np.int16)
    b[1:] = rows[:-1]                     # the byte above
    if filter == 4:
        bpp = ch * depth // 8
        a, c = np.zeros_like(b), np.zeros_like(b)
        a[:, bpp:], c[:, bpp:] = rows[:, :-bpp], b[:, :-bpp]
        b = _paeth(a, b, c)
    filt = (rows - b).astype(np.uint8)    # mod 256
    raw = np.concatenate([np.full((H, 1), filter, np.uint8), filt], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img, filter: int = 2) -> None:
    """Write @img to @path as a PNG (@filter: see `encode_png`)."""
    data = encode_png(img, filter)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a, b, c):
    """The Paeth predictor of each byte from its left (@a), upper (@b) and
    upper-left (@c) neighbours (int16 arrays)."""
    da, db = a - c, b - c          # p - b and p - a, for p = a + b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(kinds, lines, H, W, bpp):
    """Rows of any filter types, one anti-diagonal of pixels at a time: a
    pixel's predictor reads its left, upper and upper-left neighbours,
    which lie on the two diagonals before its own, so each of the H + W - 1
    diagonals is one vectorised step over the rows it crosses."""
    r = np.arange(H)[:, None]
    diag = r + np.arange(W)[None, :]
    xs = np.zeros((H + W - 1, H, bpp), np.int16)   # xs[r + c, r] = line byte
    xs[diag, r] = lines.reshape(H, W, bpp)
    # s[d + 2, r + 1]: pixel (r, d - r) decoded; row 0, diagonals 0-1 and
    # every cell left of a row's first pixel stay 0, the PNG's border
    s = np.zeros((H + W + 1, H + 1, bpp), np.int16)
    kind = kinds.astype(np.intp)[:, None]
    zero = np.zeros((1, bpp), np.int16)
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        a, b, c = s[d + 1, lo + 1:hi + 1], s[d + 1, lo:hi], s[d, lo:hi]
        pred = np.choose(kind[lo:hi], (zero, a, b, (a + b) >> 1,
                                       _paeth(a, b, c)))
        s[d + 2, lo + 1:hi + 1] = (xs[d, lo:hi] + pred) & 255
    return s[diag + 2, r + 1].astype(np.uint8).reshape(H, W * bpp)


def decode_png(data: bytes, palette_alpha: bool = False) -> np.ndarray:
    """The image of the PNG file @data (see module docstring). With
    @palette_alpha, a palette image with a tRNS chunk comes back RGBA."""
    if data[:8] != _SIGNATURE:
        raise ValueError("read_png: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"read_png: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("read_png: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    packed = depth in (1, 2, 4) and ctype in (0, 3)
    if interlace or ctype not in _CHANNELS \
            or (depth not in (8, 16) and not packed) \
            or (ctype == 3 and (depth == 16 or plte is None)):
        raise ValueError(f"read_png: unsupported PNG (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    # rows are unfiltered as bytes; pixels of under 8 bits are unpacked
    # from them afterwards
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    stride = -(-W * _CHANNELS[ctype] * depth // 8)
    W_img, W = W, stride // bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:H * (stride + 1)].reshape(H, stride + 1)
    kinds = raw[:, 0]
    if (kinds > 4).any():
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"read_png: bad filter type {kinds[y]} in row {y}")
    if (kinds >= 3).any():
        out = _unfilter_wavefront(kinds, raw[:, 1:], H, W, bpp)
    else:
        out = np.empty((H, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(H):
            kind, line = raw[y, 0], raw[y, 1:]
            if kind == 0:
                out[y] = line
            elif kind == 1:
                out[y] = np.cumsum(line.reshape(W, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)
            else:
                out[y] = line + prior
            prior = out[y]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    elif packed:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        img = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            H, -1)[:, :W_img]
        if ctype == 0:        # gray scaled to 8 bits, as libpng expands it
            img = img * np.uint8(255 // ((1 << depth) - 1))
    else:
        img = out
    img = img.reshape(H, W_img, _CHANNELS[ctype])
    if ctype == 3:
        if palette_alpha and trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:min(len(trns), len(plte))] = trns[:len(plte)]
            plte = np.concatenate([plte, alpha[:, None]], axis=1)
        return plte[img[..., 0]]
    return img[..., 0] if img.shape[2] == 1 else img


def read_png(path: str) -> np.ndarray:
    """Read the PNG at @path (see module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_png_unchanged(path: str):
    """`cv2.imread(path, cv2.IMREAD_UNCHANGED)` for a PNG: None when @path
    does not exist; gray as (H, W); color as BGR, alpha as BGRA (gray +
    alpha with the gray replicated); a palette image expanded to BGR, or
    BGRA when it has a tRNS chunk."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        img = decode_png(f.read(), palette_alpha=True)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        g, a = img[..., 0], img[..., 1]
        return np.stack([g, g, g, a], axis=-1)
    order = [2, 1, 0, 3][:img.shape[2]]
    return np.ascontiguousarray(img[..., order])
