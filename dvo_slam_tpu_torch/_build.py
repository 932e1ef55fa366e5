"""Build and load the port's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of this package with ``nvcc`` into
one shared library with a plain C interface, at first use, and loads it
with ctypes. Each source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libdvo_kernels.so *.o

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _run_all(cmds):
    """Run the commands in parallel; raise on the first that fails.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed ({p.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _compile(out: Path):
    global BUILD_SECONDS, BUILD_LOG
    out.parent.mkdir(parents=True, exist_ok=True)
    # Per-process names: concurrent builds never share a file.
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    tmp = out.with_name(f"{out.name}.{tag}")
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(_sources(), objs)])
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *[str(o) for o in objs]]])
    for o in objs:
        o.unlink()
    # Atomic publish.
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log


def load():
    """The loaded kernel library (built on first use), with its C entry
    points' argtypes declared."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dvo_sample_slab.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp, vp]
        lib.dvo_sample_slab.restype = ci
        common = [
            ci,  # B
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,  # reference points, N
            vp, ctypes.c_int64, ci, ci,  # slab, slab_stride, H, W
            vp, vp,  # K, T
            ci, ci, cf, cf, cf,  # use_depth, ref_grad, nu, floors
            ci, ci,  # scale_iters, warm_iters
        ]
        lib.dvo_linearize.argtypes = [
            *common, vp, ci, ci,  # sigma_init, warm, cluster size
            vp, vp, vp, vp, vp,  # out, rI, rZ, valid, stream
        ]
        lib.dvo_linearize.restype = ci
        lib.dvo_track_level.argtypes = [
            *common, ci, cf,  # max_iterations, precision
            cf, cf, cf, cf, ci,  # LM lambda init, up, down, max; cluster
            vp, vp, vp,  # out, out_i, stream
        ]
        lib.dvo_track_level.restype = ci
        cd = ctypes.c_double
        lib.dvo_pose_graph.argtypes = [
            vp, vp, vp, vp, vp, vp,  # poses, Z, info, mask, edge_i, edge_j
            vp, vp, vp, vp,  # vertex and dense plans (offsets, indices)
            ci, ci, ci, ci, ci,  # M, E, num_vertices, iterations, robust
            cd, cd, cd, ci,  # cauchy_c, gnc_init, gnc_decay, gnc_adaptive
            vp, vp, vp, vp, vp, vp, vp,  # scratch, poses, chi2, weights,
        ]  # stats, steps, stream
        lib.dvo_pose_graph.restype = ci
        lib.dvo_pose_graph_plan.argtypes = [ci, vp]
        lib.dvo_pose_graph_plan.restype = ci
        lib.dvo_level_plan.argtypes = [ci, ci, vp]
        lib.dvo_level_plan.restype = ci
        lib.dvo_error_string.argtypes = [ci]
        lib.dvo_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
