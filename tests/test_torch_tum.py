"""The port's TUM IO, PNG codec and native decoder against the JAX
package's.

- Trajectories: the same bytes written, the same poses read (exact).
- ``associate`` and ``groundtruth_pose``: the same pairs and poses (exact).
- ``write_tum_dataset``: the port's files hold the pixels OpenCV writes for
  the JAX package's (exact), and the JAX TumDataset reads them back as the
  port does (intensity exact; depth NaN pattern exact, values within 1 ulp:
  OpenCV's path divides where the decoders multiply by 1/scale).
- The port's two decoders, native (C++) and numpy, give identical arrays
  on gray, RGB, RGBA and 16-bit files for every filter type, accept and
  reject the same hostile files, and never crash on one (run in a
  subprocess under an address-space limit).
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from dvo_slam_tpu.utils import synthetic, tum
from dvo_slam_tpu_torch import native
from dvo_slam_tpu_torch.utils import png
from dvo_slam_tpu_torch.utils import synthetic as t_synthetic
from dvo_slam_tpu_torch.utils import tum as t_tum
from test_torch_benchmark import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

W, H = 64, 48
K = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)


def _frames(n=5):
    rng = np.random.default_rng(3)
    poses = synthetic.orbit_trajectory(n, radius=0.04)
    frames = [synthetic.add_sensor_noise(i, z, rng, dropout=0.1)
              for i, z in synthetic.render_sequence(
                  synthetic.two_plane_scene(), np.asarray(K), W, H, poses)]
    return frames, poses


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same noisy frames written by each package's write_tum_dataset."""
    frames, poses = _frames()
    port_dir = str(tmp_path_factory.mktemp("port_seq"))
    jax_dir = str(tmp_path_factory.mktemp("jax_seq"))
    t_synthetic.write_tum_dataset(port_dir, frames, poses)
    synthetic.write_tum_dataset(jax_dir, frames, poses)
    return port_dir, jax_dir, frames, poses


def _assert_frames_equal(a, b, depth_ulp=0):
    (ta, ia, za), (tb, ib, zb) = a, b
    assert ta == tb
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(np.isnan(za), np.isnan(zb))
    fin = np.isfinite(za)
    if depth_ulp:
        np.testing.assert_array_max_ulp(za[fin], zb[fin], maxulp=depth_ulp)
    else:
        np.testing.assert_array_equal(za[fin], zb[fin])


def test_trajectory_files_like_jax(tmp_path):
    poses = synthetic.orbit_trajectory(7, radius=0.3, yaw_amplitude=0.5)
    stamps = [1305031102.175304 + i / 30.0 for i in range(7)]
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    t_tum.write_trajectory(ours, stamps, poses)
    tum.write_trajectory(theirs, stamps, poses)
    assert open(ours).read() == open(theirs).read()
    for path in (ours, theirs):
        for (ta, Ta), (tb, Tb) in zip(t_tum.read_trajectory(path),
                                      tum.read_trajectory(path)):
            assert ta == tb
            np.testing.assert_array_equal(Ta, Tb)


def test_associate_like_jax():
    rng = np.random.default_rng(5)
    a = list(np.arange(200) / 30.0 + rng.normal(scale=0.01, size=200))
    b = list(np.arange(190) / 30.0 + 0.004 + rng.normal(scale=0.012,
                                                          size=190))
    b[10] = b[11]  # a tie, resolved the same way by both
    for max_difference in (0.005, 0.02, 0.05):
        got = t_tum.associate(a, b, max_difference)
        assert got == tum.associate(a, b, max_difference)
        assert got


def test_written_pixels_like_jax(dirs):
    port_dir, jax_dir, _, _ = dirs
    for name in ("rgb.txt", "depth.txt", "assoc.txt", "groundtruth.txt"):
        assert (open(os.path.join(port_dir, name)).read()
                == open(os.path.join(jax_dir, name)).read()), name
    for kind in ("rgb", "depth"):
        files = sorted(os.listdir(os.path.join(jax_dir, kind)))
        assert files == sorted(os.listdir(os.path.join(port_dir, kind)))
        for f in files:
            want = cv2.imread(os.path.join(jax_dir, kind, f),
                              cv2.IMREAD_UNCHANGED)
            got = cv2.imread(os.path.join(port_dir, kind, f),
                             cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decoder", t_tum.DECODERS)
def test_port_files_read_by_jax(dirs, decoder):
    port_dir, _, frames, _ = dirs
    theirs = tum.TumDataset(port_dir)
    ours = t_tum.TumDataset(port_dir, decoder=decoder)
    assert ours.pairs == theirs.pairs and len(ours) == len(frames)
    for i in range(len(ours)):
        _assert_frames_equal(ours[i], theirs[i], depth_ulp=1)
    # Within the quantization of the written files.
    ts, intensity, depth = ours[2]
    np.testing.assert_allclose(intensity, frames[2][0], atol=0.5 + 1e-4)
    fin = np.isfinite(depth)
    np.testing.assert_array_equal(fin, np.isfinite(frames[2][1]))
    np.testing.assert_allclose(depth[fin], frames[2][1][fin],
                               atol=0.5 / t_tum.DEPTH_SCALE + 1e-6)


@pytest.mark.parametrize("decoder", t_tum.DECODERS)
def test_prefetch_iter_matches_getitem(dirs, decoder):
    port_dir, _, _, _ = dirs
    ds = t_tum.TumDataset(port_dir, decoder=decoder)
    direct = [ds[i] for i in range(len(ds))]
    fetched = list(ds.prefetch_iter(prefetch=2))
    assert len(fetched) == len(direct)
    for a, b in zip(direct, fetched):
        _assert_frames_equal(a, b)
    assert len(list(ds.prefetch_iter(limit=3))) == 3


def test_groundtruth_pose_like_jax(dirs):
    port_dir, _, _, _ = dirs
    ours, theirs = t_tum.TumDataset(port_dir), tum.TumDataset(port_dir)
    for ts in [-1.0, 0.0, 0.01, 0.02, 1 / 30.0 + 0.049, 0.0666, 0.14, 0.19,
               0.25, 10.0]:
        a, b = ours.groundtruth_pose(ts), theirs.groundtruth_pose(ts)
        assert (a is None) == (b is None), ts
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_decoder_name_is_checked(dirs):
    with pytest.raises(ValueError, match="decoder"):
        t_tum.TumDataset(dirs[0], decoder="cv2")


# --------------------------------------------------------------- the codec

def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _png(width, height, bit_depth=8, color_type=0, interlace=0,
         rows=None, filters=(0,)):
    """Minimal PNG writer in pure Python (shares no code with either
    decoder): raw scanline bytes behind the given filter bytes."""
    channels = {0: 1, 2: 3, 6: 4}.get(color_type, 1)
    stride = width * max(1, channels * bit_depth // 8)
    raw = bytearray()
    for y in range(height):
        raw.append(filters[y % len(filters)])
        raw.extend(bytes((x * 7 + y * 13) % 256 for x in range(stride))
                   if rows is None else rows[y])
    ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, color_type,
                       0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


KINDS = {"gray": (8, 0), "rgb": (8, 2), "rgba": (8, 6), "gray16": (16, 0)}
FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,),
           "paeth": (4,), "mixed": (4, 0, 3, 1, 2, 4, 4)}


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decoders_agree(tmp_path, kind, filters):
    bit_depth, color_type = KINDS[kind]
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    stride = 37 * channels * bit_depth // 8
    rng = np.random.default_rng(len(kind) * 10 + len(filters))
    rows = [rng.integers(0, 256, stride, np.uint8).tobytes()
            for _ in range(23)]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(37, 23, bit_depth, color_type, rows=rows,
                     filters=FILTERS[filters]))
    assert native.png_size(path) == png.png_size(path) == (37, 23)
    if bit_depth == 8:
        got = png.decode_intensity(path, 37, 23)
        want = native.decode_intensity(path, 37, 23)
        with pytest.raises(OSError):
            png.decode_depth(path, 37, 23)
    else:
        got = png.decode_depth(path, 37, 23, 5000.0)
        want = native.decode_depth(path, 37, 23, 5000.0)
        with pytest.raises(OSError):
            png.decode_intensity(path, 37, 23)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN where both are NaN
    # The raw samples, against OpenCV's libpng decode.
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    img = img[..., None] if img.ndim == 2 else img[..., [2, 1, 0, 3][
        :channels]]
    np.testing.assert_array_equal(png.decode(open(path, "rb").read()), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_encoder_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(9)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (29, 41), dtype)
    img[3] = img[2]  # rows the Up filter zeroes
    path = str(tmp_path / "e.png")
    png.write(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(png.decode(open(path, "rb").read())[..., 0],
                                  img)
    with pytest.raises(ValueError):
        png.encode(img.astype(np.float32))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """The decoder is chosen by name: a native build that fails raises
    with the compiler's output instead of switching decoders."""
    from dvo_slam_tpu_torch import _build

    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()


_CHILD = r"""
import ctypes, os, resource, sys

sys.path.insert(0, sys.argv[3])
import png_codec as png  # utils/png.py alone: numpy, struct and zlib

lib = ctypes.CDLL(sys.argv[1])
lib.dvo_decode_intensity.restype = ctypes.c_int
lib.dvo_decode_intensity.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ctypes.c_int]
lib.dvo_decode_depth.restype = ctypes.c_int
lib.dvo_decode_depth.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ctypes.c_int, ctypes.c_float]
lib.dvo_png_size.restype = ctypes.c_int
lib.dvo_png_size.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int)]

# An address-space cap over what the interpreter holds already: a decoder
# that believes a hostile header and allocates dies here instead of
# exhausting the machine.
used = int(open("/proc/self/statm").read().split()[0]) * os.sysconf(
    "SC_PAGE_SIZE")
resource.setrlimit(resource.RLIMIT_AS, (used + (3 << 30), used + (3 << 30)))

buf = (ctypes.c_float * (64 * 48))()
w, h = ctypes.c_int(), ctypes.c_int()
ok = err = 0
for name in sorted(os.listdir(sys.argv[2])):
    p = os.path.join(sys.argv[2], name)
    native = [
        lib.dvo_decode_intensity(p.encode(), buf, 64, 48) == 0,
        lib.dvo_decode_depth(p.encode(), buf, 64, 48, 5000.0) == 0,
        lib.dvo_png_size(p.encode(), ctypes.byref(w), ctypes.byref(h)) == 0,
    ]
    plain = []
    for fn in (lambda: png.decode_intensity(p, 64, 48),
               lambda: png.decode_depth(p, 64, 48, 5000.0),
               lambda: png.png_size(p)):
        try:
            fn()
            plain.append(True)
        except OSError:
            plain.append(False)
    if native != plain:
        print(f"MISMATCH {name} native {native} numpy {plain}")
    ok += sum(native)
    err += 3 - sum(native)
print(f"FUZZ_DONE ok={ok} err={err}")
"""


def _hostile(rng):
    """(name, bytes): a subset of tests/test_native_fuzz.py's corpus."""
    base8 = _png(64, 48)
    rows16 = [bytes((x * 3 + y) % 256 for x in range(128)) for y in range(48)]
    base16 = _png(64, 48, bit_depth=16, rows=rows16)
    yield "valid8", base8
    yield "valid16", base16
    for cut in [0, 4, 8, 12, 20, 33, len(base8) // 2, len(base8) - 1]:
        yield f"trunc{cut}", base8[:cut]
    for i in range(20):
        b = bytearray(base8 if i % 2 else base16)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        yield f"flip{i}", bytes(b)
    for name, w_, h_ in [("giant", 1 << 30, 1 << 30), ("gianthalf", 1 << 30, 48),
                         ("neg", 0xFFFFFFF0, 48), ("zero", 0, 0),
                         ("maxcap", 1 << 15, 1 << 15)]:
        ihdr = struct.pack(">IIBBBBB", w_, h_, 8, 0, 0, 0, 0)
        yield f"dims_{name}", (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                               + _chunk(b"IDAT", zlib.compress(b"\x00" * 64))
                               + _chunk(b"IEND", b""))
    yield "interlaced", _png(64, 48, interlace=1)
    yield "palette", _png(64, 48, color_type=3)
    yield "depth1", _png(64, 48, bit_depth=1)
    yield "badfilter", _png(64, 48, filters=(7,))
    b = bytearray(base8)
    b[33:37] = struct.pack(">I", 1 << 30)
    yield "lyinglen", bytes(b)
    gray_ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 64, 48, 8, 0, 0, 0, 0))
    yield "shortidat", (b"\x89PNG\r\n\x1a\n" + gray_ihdr
                        + _chunk(b"IDAT", zlib.compress(b"\x00" * 10))
                        + _chunk(b"IEND", b""))
    yield "longidat", (b"\x89PNG\r\n\x1a\n"
                       + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0,
                                                     0, 0, 0))
                       + _chunk(b"IDAT", zlib.compress(b"\x00" * (1 << 20)))
                       + _chunk(b"IEND", b""))
    yield "noihdr", (b"\x89PNG\r\n\x1a\n"
                     + _chunk(b"IDAT", zlib.compress(b"\x00" * 64)))
    yield "iendfirst", b"\x89PNG\r\n\x1a\n" + _chunk(b"IEND", b"")
    yield "garbage", bytes(rng.integers(0, 256, 512, np.uint8))
    yield "empty", b""


def test_hostile_files_fail_cleanly(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    n = 0
    for name, data in _hostile(np.random.default_rng(1234)):
        (corpus / f"{n:03d}_{name}.png").write_bytes(data)
        n += 1
    assert n > 40
    codec_dir = tmp_path / "codec"
    codec_dir.mkdir()
    (codec_dir / "png_codec.py").write_text(open(png.__file__).read())
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    native.load()  # the library the child opens
    proc = subprocess.run(
        [sys.executable, str(child), str(native.library_path()),
         str(corpus), str(codec_dir)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OPENBLAS_NUM_THREADS": "1"},
    )
    # The sentinel comes only after every file went through every entry
    # point of both decoders; a crash or an allocation failure loses it.
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert "FUZZ_DONE" in proc.stdout, proc.stderr[-2000:]
    assert "MISMATCH" not in proc.stdout, proc.stdout
    assert int(proc.stdout.split("ok=")[1].split()[0]) >= 4
