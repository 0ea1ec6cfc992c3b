"""The port's baseline JPEG decoder (`bundlesdf_tpu_torch/utils/jpeg.py` +
`csrc/jpeg_decode.c`) against what the JAX reader decodes with,
`imageio.v2.imread` (Pillow on libjpeg-turbo), and against Pillow
directly: bit-equal pixels for grey, 4:4:4, 4:2:2, 4:2:0 and 4:4:0 files,
qualities 10-100, optimized Huffman tables, restart intervals and sizes
from 1x1 to 480x641; a hypothesis property over sizes and seeds; the
files outside its scope raise ValueError; the committed HO3D-layout
fixture decodes to its stored hashes; and two processes building the
library at once both load a whole one."""
import io
import os
import subprocess
import sys
import textwrap

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import ho3d_layout
from bundlesdf_tpu_torch.utils import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
PIL_SUB = {"444": 0, "422": 1, "420": 2}


def _image(H, W, seed=0, grey=False):
    """Smooth colour waves plus noise: edges for the IDCT, gradients for
    the chroma upsampling."""
    rng = np.random.default_rng(seed)
    ch = 1 if grey else 3
    yy, xx = np.mgrid[0:H, 0:W]
    wave = 127 + 110 * np.sin(xx[..., None] / 6.0 + np.arange(ch)) \
        * np.cos(yy[..., None] / 4.0 + 0.5 * np.arange(ch))
    img = np.clip(0.6 * wave + 0.4 * rng.integers(0, 256, (H, W, ch)), 0,
                  255).astype(np.uint8)
    return img[..., 0] if grey else img


def _encode(img, sampling, quality, optimize=False, restart=0, path=None):
    """A baseline JPEG of @img: Pillow for grey / 4:4:4 / 4:2:2 / 4:2:0,
    cv2 (libjpeg-turbo too) for 4:4:0, which Pillow cannot write."""
    if sampling == "440":
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["440"],
                  cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        ok, buf = cv2.imencode(".jpg", img[..., ::-1], params)
        assert ok
        return buf.tobytes()
    kw = dict(quality=quality, optimize=optimize)
    if sampling != "grey":
        kw["subsampling"] = PIL_SUB[sampling]
    if restart:
        kw["restart_marker_blocks"] = restart
    if path is not None:         # Pillow's optimize needs a real file when
        Image.fromarray(img).save(path, "JPEG", **kw)   # the image is big
        with open(path, "rb") as f:
            return f.read()
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _check(data):
    """The port's pixels against imageio's and Pillow's, bit for bit."""
    ref = imageio.imread(io.BytesIO(data))
    got = jpeg.decode_jpeg(data)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    if got.ndim == 3:     # the reader's slice
        np.testing.assert_array_equal(got[..., :3], ref[..., :3])


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["grey", "444", "422", "420", "440"])
def test_sampling_and_quality_equal_imageio(sampling, quality):
    img = _image(17, 33, seed=quality, grey=sampling == "grey")
    _check(_encode(img, sampling, quality))


@pytest.mark.parametrize("size", [(1, 1), (8, 8), (17, 33), (479, 641),
                                  (480, 640)])
@pytest.mark.parametrize("sampling", ["grey", "444", "422", "420", "440"])
def test_sizes_equal_imageio(sampling, size):
    img = _image(*size, seed=1, grey=sampling == "grey")
    _check(_encode(img, sampling, 85))


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("sampling", ["grey", "444", "420", "440"])
def test_optimized_tables_and_restarts_equal_imageio(tmp_path, sampling,
                                                     restart):
    img = _image(61, 77, seed=2, grey=sampling == "grey")
    data = _encode(img, sampling, 90, optimize=True, restart=restart,
                   path=str(tmp_path / "a.jpg"))
    if restart:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data   # DRI, RST0
    _check(data)


@settings(max_examples=40, deadline=None)
@given(H=st.integers(1, 70), W=st.integers(1, 70),
       seed=st.integers(0, 2 ** 16), quality=st.integers(5, 100),
       sampling=st.sampled_from(["grey", "444", "422", "420", "440"]))
def test_property_any_size_equals_imageio(H, W, seed, quality, sampling):
    _check(_encode(_image(H, W, seed, grey=sampling == "grey"), sampling,
                   quality))


def _sof_at(data):
    """Offset of the SOF marker's segment body in @data."""
    k = data.index(b"\xff\xc0")
    return k + 4


def test_unsupported_files_raise_value_error():
    img = _image(20, 24)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(b.getvalue())
    base = bytearray(_encode(img, "420", 75))
    twelve = bytearray(base)
    twelve[_sof_at(base)] = 12           # the frame's sample precision
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(twelve))
    arith = bytearray(base)
    arith[_sof_at(base) - 3] = 0xC9      # SOF9: arithmetic coding
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(arith))
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG\r\n")


def _segment(data, marker):
    """(start of the length field, end) of the first @marker segment."""
    k = data.index(b"\xff" + bytes([marker])) + 2
    return k, k + int.from_bytes(data[k:k + 2], "big")


def _with_sos(data, comps):
    """@data with its (single) SOS header rewritten to name @comps: (id,
    table selector) pairs, the same entropy-coded data after it."""
    k, end = _segment(data, 0xDA)
    body = bytes([len(comps)]) + b"".join(bytes(c) for c in comps) + \
        bytes([0, 63, 0])
    return data[:k] + (len(body) + 2).to_bytes(2, "big") + body + data[end:]


def test_malformed_scan_headers_raise_value_error():
    """A scan header that would send C more than the frame's components,
    a component twice, or a length that disagrees with its count is
    refused before the decoder runs."""
    data = _encode(_image(16, 16), "444", 75)
    k, end = _segment(data, 0xDA)
    sel = [(data[k + 3 + 2 * c], data[k + 4 + 2 * c]) for c in range(3)]
    _check(_with_sos(data, sel))            # the rewrite itself is faithful
    for comps in (sel + sel[:2],            # 5 entries: past C's pred[4]
                  sel * 86,                 # a count byte of 258 mod 256
                  [sel[0], sel[0], sel[1]],  # a repeated component
                  []):
        with pytest.raises(ValueError, match="SOS|twice"):
            jpeg.decode_jpeg(_with_sos(data, comps[:255]))
    short = bytearray(data)                 # count 3, but 4 + 2*2 bytes
    short[k + 2] = 2
    with pytest.raises(ValueError, match="SOS"):
        jpeg.decode_jpeg(bytes(short))


@pytest.mark.parametrize("case", ["adobe_rgb", "rgb_ids", "h4v1", "h2v2_2"])
def test_colour_and_sampling_outside_scope_raise(case):
    """RGB-coded colour and chroma ratios other than 4:4:4, 4:2:2, 4:2:0
    and 4:4:0 raise ValueError rather than decode in another way."""
    data = bytearray(_encode(_image(24, 40), "444", 75))
    sof = _sof_at(data) + 6                # the first component's 3 bytes
    if case == "adobe_rgb":                # APP14 Adobe, transform 0, no JFIF
        j0, j1 = _segment(data, 0xE0)
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
        data = data[:j0 - 2] + adobe + data[j1:]
        match = "RGB"
    elif case == "rgb_ids":                # ids R, G, B, no JFIF
        j0, j1 = _segment(data, 0xE0)
        for c, cid in enumerate(b"RGB"):
            data[sof + 3 * c] = cid
        s0, s1 = _segment(bytes(data), 0xDA)
        for c, cid in enumerate(b"RGB"):
            data[s0 + 3 + 2 * c] = cid
        data = data[:j0 - 2] + data[j1:]
        match = "RGB"
    elif case == "h4v1":                   # 4:1:1
        data[sof + 1] = 0x41
        match = "sampling"
    else:                                  # Y 2x2, Cb 2x2, Cr 1x1
        data[sof + 1] = data[sof + 4] = 0x22
        match = "sampling"
    with pytest.raises(ValueError, match=match):
        jpeg.decode_jpeg(bytes(data))


def test_fixture_frames_decode_to_their_hashes():
    hashes = ho3d_layout.load_hashes()
    files = ho3d_layout.fixture_jpegs()
    assert len(hashes) == len(files) == 30
    times = {}
    for path in files:
        img = jpeg.read_jpeg(path, times)
        assert img.shape == (480, 640, 3)
        key = os.path.basename(path)[:-4]
        assert ho3d_layout.pixel_sha256(img[..., :3]) == hashes[key]
    assert set(times) == set(jpeg.STAGES)
    # the stored hashes are imageio's own
    ref = imageio.imread(files[7])[..., :3]
    assert ho3d_layout.pixel_sha256(ref) == hashes["0007"]


def test_build_renames_into_place_from_two_processes(tmp_path):
    """Two processes build into one empty directory at once (through
    `utils/build.py`, which the scatter kernel and the native library use
    too): both load a whole library and decode, and the directory ends
    with the one library and no temporary files."""
    build = str(tmp_path / "build")
    data = _encode(_image(9, 11), "420", 80)
    (tmp_path / "a.jpg").write_bytes(data)
    script = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {ROOT!r})
        from bundlesdf_tpu_torch.utils import jpeg
        path = jpeg.build_library({build!r})
        jpeg._lib = jpeg.bind(ctypes.CDLL(path))
        img = jpeg.read_jpeg({str(tmp_path / 'a.jpg')!r})
        print(path, img.shape, int(img.sum()))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    ref = np.asarray(Image.open(io.BytesIO(data)))
    (got,) = {o for o, _ in outs}
    path, rest = got.split(" ", 1)
    assert rest == f"{ref.shape} {int(ref.sum())}\n"
    assert os.listdir(build) == [os.path.basename(path)]
    assert os.path.basename(path).startswith("libjpeg_decode_")


def test_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails is an error."""
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed"):
        jpeg.build_library(str(tmp_path / "b"))
    assert os.listdir(tmp_path / "b") == []
