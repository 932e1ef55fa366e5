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
sources, the headers they include (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged tree is reused.
Nothing is built or imported at module import: this module is imported
on machines without a GPU.
"""

from __future__ import annotations

import ctypes
import functools
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
    """The library's path, keyed by the flags and every source and header
    of csrc/ (an edited header rebuilds too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
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


def _entry_points():
    """Every C entry point of the library: {name: (argument types, result
    type)} in ctypes, as ``load`` declares them (a pointer, the stream
    included, is c_void_p, or ctypes would pass it as a 32-bit int)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, cd = ctypes.c_int64, ctypes.c_double
    refs = [
        ci,  # B
        vp, vp, vp, vp, vp, vp, vp, vp, vp,  # reference points (or null)
        vp, i64, ci, cf, cf,  # slab route: rows, stride, table, thresholds
        ci, vp,  # compaction's budget and global slot table (or null)
        ci, vp, i64, ci, ci, vp,  # N, slab, slab_stride, H, W, K
    ]
    # use_depth .. warm_iters, estimator, influence, huber_k, tukey_b,
    # the scale floors
    scale = [ci, ci, cf, cf, cf, ci, ci, ci, ci, cf, cf, cf, cf]
    return {
        "dvo_sample_slab": ([
            vp, ci, ci, ci,  # slab, C, H, W
            vp, vp, ci, vp, vp,  # u, v, N, out, inb
            ci, vp,  # threads a block, stream
        ], ci),
        "dvo_empty": ([vp], ci),  # stream
        "dvo_late_copy": ([
            vp, vp, i64, vp, vp, i64,  # src, dst, bytes; twice
            i64, i64, vp,  # trigger and spin ns, stream
        ], ci),
        "dvo_linearize": ([
            *refs, vp, *scale, vp, ci, ci,  # T, ..., sigma_init, warm, C
            vp, vp, vp, vp, vp,  # out, rI, rZ, valid, stream
        ], ci),
        "dvo_track_level": ([
            *refs, vp, i64, *scale, ci, cf,  # T_init, stride, ..., precision
            cf, cf, cf, cf, cf, ci,  # LM lambda init, up, down, max, mu; C
            vp, i64, vp, i64,  # out, its row stride, out_i, its row stride
            cd, vp,  # loglik constant, stream
        ], ci),
        "dvo_track_level_split": ([
            *refs, vp, i64, *scale, ci, cf,  # T_init, stride, ..., precision
            cf, cf, cf, cf, cf, ci,  # LM lambda init, up, down, max, mu; C
            vp, i64, vp, i64, cd,  # out, stride, out_i, stride, loglik
            ci, ci, vp, vp, vp,  # the band's rows and first row, state,
            # sums, points
            ci, vp,  # the t-distribution's CTAs a row; timing (or null)
            ci, ci, ci, vp,  # stage, Sigma steps, iteration, stream
        ], ci),
        "dvo_pose_graph": ([
            vp, vp, vp, vp, vp, vp,  # poses, Z, info, mask, edge_i, edge_j
            vp, vp, vp,  # vertex plan (offsets, indices), dense plan indices
            vp, vp,  # the dense plan's blocks (offsets, list)
            ci, ci, ci, ci, ci,  # M, E, num_vertices, iterations, robust
            cd, cd, cd, ci,  # cauchy_c, gnc_init, gnc_decay, gnc_adaptive
            vp, vp, vp, vp, vp, vp, vp, vp,  # scratch, poses, chi2, weights,
        ], ci),  # stats, steps, timing (or null), stream
        "dvo_pose_graph_plan": ([ci, ci, vp], ci),
        "dvo_pose_graph_grid": ([
            vp, vp, vp, vp, vp, vp,  # poses, Z, info, mask, edge_i, edge_j
            vp, vp, vp,  # vertex plan (offsets, indices), dense plan indices
            vp, vp,  # the dense plan's blocks (offsets, list); null for CG
            vp, vp, vp, ci,  # the fill's bits, units, per column, units
            ci, ci, ci, ci, ci,  # M, E, num_vertices, iterations, robust
            cd, cd, cd, ci,  # cauchy_c, gnc_init, gnc_decay, gnc_adaptive
            ci, ci,  # solver (0 dense, 1 CG), CTAs
            vp, vp, vp, vp, vp, vp, vp, vp, vp,  # scratch, barrier, poses,
            vp,  # chi2, weights, stats, steps, zeroed, timing (or null),
        ], ci),  # stream
        "dvo_pose_graph_grid_plan": ([ci, ci, ci, ci, vp], ci),
        "dvo_level_plan": ([ci, ci, ci, vp], ci),
        "dvo_error_string": ([ci], ctypes.c_char_p),
        "dvo_scan_step": ([
            vp, vp, ci, ci,  # level rows, iterations, levels, iterations
            vp, vp, vp, vp,  # carry slot, table, force, frame's slabs
            cf, cf, ci, ci, ci,  # ratios, fuse, initial estimate, stats
            vp, vp, vp,  # packed row, next carry slot, table
            vp, vp,  # timing (or null), stream
        ], ci),
        "dvo_pyramid": ([
            vp, ci, vp, ci,  # intensity, i_u8, depth, depth encoding
            ci, ci, ci, cf, cf,  # H, W, num_levels, the raw scales
            vp, ci, ci, vp, vp,  # out, tile rows, fill path, timing, stream
        ], ci),
    }


def load():
    """The loaded kernel library (built on first use), with its C entry
    points' argtypes declared."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _entry_points().items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA card `index` (the kernels' grids
    are sized by it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def empty_launch(device):
    """One launch of an empty kernel (csrc/sampler.cu ``dvo_empty``) on
    the current stream of `device`: the launch floor that a kernel's time
    on a stream of launches includes."""
    launch("dvo_empty", device, ())


def launch(name, device, args):
    """Call the entry point `name` of the kernel library with `args` and
    the current stream of `device` (made the current device around the
    call, so the ctypes launch runs in its context); raise with the CUDA
    error if it did not launch."""
    import torch

    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.dvo_error_string(rc).decode()} (CUDA "
                           f"error {rc})")
