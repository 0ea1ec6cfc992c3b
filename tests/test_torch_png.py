"""`bundlesdf_tpu_torch/utils/png.py` against cv2 (CPU only: the GPU
machine has no cv2): files the port writes read back in cv2 as the same
arrays, files cv2 writes read back in the port as the same arrays, and
the port's decoder equals cv2's on rows written with each of the five PNG
filters, alone and mixed, and on a palette image. Equality is exact."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bundlesdf_tpu_torch.utils.png import (decode_png, encode_png, read_png,
                                           write_png)


def _to_cv(img):
    """Port channel order (RGB, RGBA) -> cv2's (BGR, BGRA)."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


@st.composite
def images(draw, channels=(1, 3)):
    H = draw(st.integers(1, 24))
    W = draw(st.integers(1, 24))
    ch = draw(st.sampled_from(channels))
    dtype = draw(st.sampled_from([np.uint8, np.uint16]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if draw(st.booleans()):      # smooth content: small row differences
        base = rng.integers(0, hi + 1, (1, W, ch))
        img = np.clip(base + np.arange(H)[:, None, None], 0, hi)
    else:
        img = rng.integers(0, hi + 1, (H, W, ch))
    img = img.astype(dtype)
    return img[..., 0] if ch == 1 else img


@settings(max_examples=40, deadline=None)
@given(img=images())
def test_port_writes_cv2_reads(tmp_path_factory, img):
    p = str(tmp_path_factory.mktemp("png") / "a.png")
    write_png(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, _to_cv(img))
    np.testing.assert_array_equal(read_png(p), img)


@settings(max_examples=40, deadline=None)
@given(img=images())
def test_port_writes_paeth_cv2_reads(tmp_path_factory, img):
    """Paeth rows, the slow case of the decoder, both ways."""
    p = str(tmp_path_factory.mktemp("png") / "p.png")
    write_png(p, img, filter=4)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                  _to_cv(img))
    np.testing.assert_array_equal(read_png(p), img)


@settings(max_examples=40, deadline=None)
@given(img=images(channels=(1, 3, 4)))
def test_cv2_writes_port_reads(tmp_path_factory, img):
    p = str(tmp_path_factory.mktemp("png") / "b.png")
    assert cv2.imwrite(p, _to_cv(img))
    back = read_png(p)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)


def _filter_row(kind, row, prior, bpp):
    """Reference PNG row filters (PNG spec section 9), one byte at a time."""
    out = np.zeros_like(row)
    for x in range(len(row)):
        a = int(row[x - bpp]) if x >= bpp else 0
        b = int(prior[x])
        c = int(prior[x - bpp]) if x >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (int(row[x]) - pred) % 256
    return out


def _png_with_filters(img, kinds, ctype=None, plte=None):
    """A PNG of @img whose row y uses filter kinds[y % len(kinds)]."""
    depth = 16 if img.dtype == np.uint16 else 8
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = np.ascontiguousarray(img.reshape(H, W * ch).astype(
        ">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(H, -1)
    bpp = ch * depth // 8
    prior = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y in range(H):
        k = kinds[y % len(kinds)]
        raw += bytes([k]) + _filter_row(k, rows[y], prior, bpp).tobytes()
        prior = rows[y]
    ctype = {1: 0, 3: 2, 4: 6}[ch] if ctype is None else ctype

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape,dtype", [((9, 13, 3), np.uint8),
                                         ((9, 13), np.uint8),
                                         ((9, 13), np.uint16),
                                         ((7, 5, 4), np.uint8)])
def test_each_filter_decodes_as_cv2(tmp_path, kind, shape, dtype):
    rng = np.random.default_rng(kind)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = _png_with_filters(img, [kind, (kind + 1) % 5, kind])
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                  _to_cv(img))


@pytest.mark.parametrize("shape,dtype", [((31, 47, 3), np.uint8),
                                         ((47, 31), np.uint16)])
def test_mixed_filters_decode_as_cv2(tmp_path, shape, dtype):
    """Every filter type in one image, in runs and alone, taller and wider
    than square: the anti-diagonal decoder's row ranges at both ends."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = _png_with_filters(img, [4, 4, 3, 1, 0, 2, 4, 3, 3, 2])
    p = str(tmp_path / "m.png")
    with open(p, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                  _to_cv(img))


def test_palette_decodes_as_cv2(tmp_path):
    rng = np.random.default_rng(3)
    plte = rng.integers(0, 256, (6, 3))
    idx = rng.integers(0, 6, (11, 8)).astype(np.uint8)
    p = str(tmp_path / "pal.png")
    with open(p, "wb") as f:
        f.write(_png_with_filters(idx, [4, 1, 3], ctype=3, plte=plte))
    back = read_png(p)
    np.testing.assert_array_equal(back, plte[idx])
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                  _to_cv(back))


def test_writer_uses_up_filter_and_rejects_other_types():
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    raw = zlib.decompress(encode_png(img)[8 + 25 + 8:-12 - 4])
    assert raw[0::5] == b"\x02\x02\x02"
    raw = zlib.decompress(encode_png(img, 4)[8 + 25 + 8:-12 - 4])
    assert raw[0::5] == b"\x04\x04\x04"
    with pytest.raises(ValueError):
        encode_png(img, 1)
    with pytest.raises(TypeError):
        encode_png(img.astype(np.float32))
    for shape in ((2, 2, 2), (2, 2, 4)):
        with pytest.raises(ValueError):
            encode_png(np.zeros(shape, np.uint8))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("width", [1, 3, 8, 13])
def test_read_png_unchanged_equals_cv2(tmp_path, bits, width):
    """`read_png_unchanged` is cv2.imread(path, IMREAD_UNCHANGED): palette
    images of 1-8 bits (BGR, BGRA with a tRNS chunk), 1-bit gray, gray +
    alpha (BGRA), RGB as BGR, and None for a missing file."""
    from PIL import Image
    from bundlesdf_tpu_torch.utils.png import read_png_unchanged
    rng = np.random.default_rng(bits * 100 + width)
    idx = rng.integers(0, 2 ** bits, (5, width)).astype(np.uint8)
    pal = Image.fromarray(idx, "P")
    pal.putpalette(list(rng.integers(0, 256, 3 * 2 ** bits)))
    files = {"pal": dict(bits=bits), "trns": dict(bits=bits, transparency=1)}
    for name, kw in files.items():
        pal.save(str(tmp_path / f"{name}.png"), **kw)
    Image.fromarray(idx.astype(bool)).save(str(tmp_path / "g1.png"))
    Image.fromarray(rng.integers(0, 256, (5, width, 2)).astype(np.uint8),
                    "LA").save(str(tmp_path / "la.png"))
    write_png(str(tmp_path / "rgb.png"),
              rng.integers(0, 256, (5, width, 3)).astype(np.uint8))
    for name in ("pal", "trns", "g1", "la", "rgb"):
        path = str(tmp_path / f"{name}.png")
        ref, got = cv2.imread(path, cv2.IMREAD_UNCHANGED), \
            read_png_unchanged(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert read_png_unchanged(str(tmp_path / "none.png")) is None
