"""Build and load the port's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of this package with ``nvcc`` into
one shared library with a plain C interface, at first use, and loads it
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libdvo_kernels.so csrc/*.cu

The library goes to ``build/dvo_slam_tpu_torch/<hash>/libdvo_kernels.so``
beside the package (``build/`` is git-ignored), keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing is built or imported at module import: this module is
imported on machines without a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "dvo_slam_tpu_torch"
LIB_NAME = "libdvo_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
# Seconds the last build took in this process (None: library reused or not
# built) and the compiler's output (ptxas register / spill report).
BUILD_SECONDS = None
BUILD_LOG = ""


def find_nvcc() -> str:
    """Path of nvcc: CUDA_HOME as PyTorch finds it, then PATH."""
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    if home:
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (neither under CUDA_HOME nor on PATH): the CUDA "
        "toolkit is needed to build dvo_slam_tpu_torch's kernels"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _compile(out: Path):
    global BUILD_SECONDS, BUILD_LOG
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # Atomic publish: concurrent processes each write their own temp file.
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr


def load():
    """The loaded kernel library (built on first use), with its C entry
    points' argtypes declared."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dvo_sample_slab.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp, vp]
        lib.dvo_sample_slab.restype = ci
        _LIB = lib
    return _LIB
