"""ctypes bindings of the native host runtime: PNG decode and the
prefetching RGB-D loader (``loader.cpp``, the port's copy of the JAX
package's; see it for the C ABI).

The library builds at first use, never at import:

    g++ -O3 -fPIC -std=c++17 -shared -o libdvo_native.so loader.cpp -lz -lpthread

into ``build/dvo_slam_tpu_torch/<hash>/libdvo_native.so`` beside the
package (``build/`` is git-ignored), keyed by a hash of the source and the
flags, like the CUDA kernels (``_build.py``). A failed build raises with
the compiler's output; nothing switches decoders behind the caller's back
(utils/tum.py takes the decoder by name, and ``utils/png.py`` is the plain
version of this one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
from pathlib import Path

import numpy as np

from dvo_slam_tpu_torch import _build

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
LIB_NAME = "libdvo_native.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build.BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _compile(out: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: it builds the native PNG "
                           "decoder (or pass decoder='numpy')")
    out.parent.mkdir(parents=True, exist_ok=True)
    # A per-process name, published atomically: concurrent builds never
    # share a file.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    _build._run_all([[cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                      *LINK_FLAGS]])
    os.replace(tmp, out)


def load():
    """The loaded native library (built on first use), with its C entry
    points' argtypes declared."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        ci, cf, cs = ctypes.c_int, ctypes.c_float, ctypes.c_char_p
        lib.dvo_decode_intensity.argtypes = [cs, fp, ci, ci]
        lib.dvo_decode_intensity.restype = ci
        lib.dvo_decode_depth.argtypes = [cs, fp, ci, ci, cf]
        lib.dvo_decode_depth.restype = ci
        lib.dvo_png_size.argtypes = [cs, ip, ip]
        lib.dvo_png_size.restype = ci
        lib.dvo_loader_create.argtypes = [
            ctypes.POINTER(cs), ctypes.POINTER(cs), ci, ci, ci, cf, ci]
        lib.dvo_loader_create.restype = ctypes.c_void_p
        lib.dvo_loader_next.argtypes = [ctypes.c_void_p, fp, fp]
        lib.dvo_loader_next.restype = ci
        lib.dvo_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.dvo_loader_destroy.restype = None
        _LIB = lib
    return _LIB


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def png_size(path: str):
    """(width, height) from the PNG header; OSError on a bad header."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().dvo_png_size(path.encode(), ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        raise OSError(f"cannot probe {path}")
    return w.value, h.value


def decode_intensity(path: str, width: int, height: int) -> np.ndarray:
    """An 8-bit gray/RGB/RGBA file as float32 intensity 0..255 (H, W)."""
    out = np.empty((height, width), np.float32)
    if load().dvo_decode_intensity(path.encode(), _float_ptr(out), width,
                                   height) != 0:
        raise OSError(f"decode failed: {path}")
    return out


def decode_depth(path: str, width: int, height: int,
                 scale: float = 5000.0) -> np.ndarray:
    """A 16-bit gray file as float32 meters (H, W), 0 -> NaN."""
    out = np.empty((height, width), np.float32)
    if load().dvo_decode_depth(path.encode(), _float_ptr(out), width, height,
                               scale) != 0:
        raise OSError(f"decode failed: {path}")
    return out


class PrefetchLoader:
    """Background-thread RGB-D frame loader (decode overlaps device
    compute). Frames that fail to decode are skipped.

        with PrefetchLoader(rgb_paths, depth_paths, W, H) as loader:
            for idx, intensity, depth in loader:
                ...
    """

    def __init__(self, rgb_paths, depth_paths, width, height,
                 depth_scale: float = 5000.0, prefetch: int = 4):
        self.handle = None
        if len(rgb_paths) != len(depth_paths):
            raise ValueError(f"{len(rgb_paths)} rgb paths for "
                             f"{len(depth_paths)} depth paths")
        self.lib = load()
        self.width, self.height = width, height
        n = len(rgb_paths)
        # Kept alive for the loader thread, which reads the strings.
        self._rgb = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        self._depth = (ctypes.c_char_p * n)(*[p.encode()
                                              for p in depth_paths])
        self.handle = self.lib.dvo_loader_create(
            self._rgb, self._depth, n, width, height, depth_scale, prefetch)
        if not self.handle:
            raise RuntimeError("dvo_loader_create failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while True:
            if not self.handle:
                raise RuntimeError("PrefetchLoader is closed")
            intensity = np.empty((self.height, self.width), np.float32)
            depth = np.empty((self.height, self.width), np.float32)
            idx = self.lib.dvo_loader_next(self.handle, _float_ptr(intensity),
                                           _float_ptr(depth))
            if idx == -1:
                return
            if idx == -2:
                continue  # decode error: the frame is skipped
            yield idx, intensity, depth

    def close(self):
        if self.handle:
            self.lib.dvo_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        # Loaders used without the context manager: the C++ decode thread
        # must not outlive the object.
        self.close()
