"""The port's bilinear slab sampler against the JAX package.

``sample_slab_reference`` (the CUDA kernel's plain version, which
``sample_slab`` runs for CPU tensors) is held to:
  * ``linearize._sample_gather``, the JAX gather path whose semantics the
    kernel copies: ``inb`` and the NaN pattern exact, values within
    1e-5 * max|slab| (f32, same formula, possibly other FMA contraction);
  * the Pallas TPU kernel in interpret mode at Precision.HIGHEST: values
    atol 1e-5 where both are valid; the port's validity (inb and a finite
    sample in every channel) masks nothing Pallas keeps, and Pallas keeps
    a point the port masks only where its smallest bilinear corner weight
    is below the kernel's f32 mask noise (the documented slip-through).
The kernel itself runs only on a CUDA card: tests/test_torch_kernels_cuda.py.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import linearize as lin_ops
from dvo_slam_tpu.ops.pallas import sampler as pallas_sampler
from dvo_slam_tpu_torch import _build
from dvo_slam_tpu_torch.ops import sampler
from dvo_slam_tpu_torch.ops.pyramid import NUM_CHANNELS

H, W, C = 32, 128, 6


def _slab(seed, shape=(C, H, W), n_nan=12, scale=50.0):
    rng = np.random.default_rng(seed)
    slab = (rng.normal(size=shape) * scale).astype(np.float32)
    c, h, w = shape
    for _ in range(n_nan):
        slab[rng.integers(c), rng.integers(h), rng.integers(w)] = np.nan
    return slab


def _warped_grid(h, w, max_shift=3.0):
    vg, ug = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    k = np.arange(h * w)
    u = ug.reshape(-1) + max_shift * np.sin(k / 300.0)
    v = vg.reshape(-1) + max_shift * np.cos(k / 400.0)
    return u.astype(np.float32), v.astype(np.float32)


def _special_points(h=H, w=W):
    """NaN, +-1e9, infinities, exact last-corner edges, just-outside."""
    u = [np.nan, 5.5, 1e9, -1e9, 5.5, 5.5, np.inf, -np.inf,
         w - 2, w - 2 + 0.75, w - 1, 0.0, -0.25, -1.0, 3.25, np.nan]
    v = [3.5, np.nan, 3.5, 3.5, 1e9, -1e9, 3.5, 3.5,
         h - 2, h - 2 + 0.5, 2.0, h - 2, 4.0, 4.0, h - 1, np.nan]
    return np.asarray(u, np.float32), np.asarray(v, np.float32)


def _points():
    u, v = _warped_grid(H, W)
    su, sv = _special_points()
    return np.concatenate([u, su]), np.concatenate([v, sv])


def _gather(slab, u, v):
    chans, inb = lin_ops._sample_gather(jnp.asarray(slab), jnp.asarray(u),
                                        jnp.asarray(v))
    return np.stack([np.asarray(c) for c in chans]), np.asarray(inb)


@pytest.mark.parametrize("channels", [6, 2, 1])
def test_reference_matches_gather(channels):
    slab = _slab(0)[:channels].copy()
    u, v = _points()
    want, want_inb = _gather(slab, u, v)
    got, inb = sampler.sample_slab_reference(
        torch.from_numpy(slab), torch.from_numpy(u), torch.from_numpy(v))
    got = got.numpy()
    assert got.shape == (channels, u.size)
    np.testing.assert_array_equal(inb.numpy(), want_inb)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # The special points really exercise both sides of every bound.
    n = u.size - 16
    assert inb[n:].any() and not inb[n:].all()
    assert np.isnan(got[:, n]).all()  # u = NaN
    fin = np.isfinite(want)
    scale = np.nanmax(np.abs(slab))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5 * scale)


def test_reference_matches_pallas_interpret():
    # Unit-scale values: Precision.HIGHEST is a multi-pass bf16 product,
    # exact to ~1e-6 relative, so atol 1e-5 needs |slab| ~ 1.
    slab = _slab(1, scale=1.0)
    u, v = _warped_grid(H, W)
    smp, valid, _ = pallas_sampler.sample_slab(
        pallas_sampler.slab_to_cmajor(jnp.asarray(slab)), jnp.asarray(u),
        jnp.asarray(v), height=H, rows_per_tile=1, margin=8,
        precision=jax.lax.Precision.HIGHEST, interpret=True,
    )
    smp, valid = np.asarray(smp), np.asarray(valid)
    got, inb = sampler.sample_slab_reference(
        torch.from_numpy(slab), torch.from_numpy(u), torch.from_numpy(v))
    got = got.numpy()
    ok = inb.numpy() & np.isfinite(got).all(axis=0)
    assert ok.mean() > 0.8
    assert not (ok & ~valid).any(), "Pallas masks points the port keeps"
    x0 = np.clip(np.floor(u), 0, W - 2)
    y0 = np.clip(np.floor(v), 0, H - 2)
    fx, fy = u - x0, v - y0
    w_min = np.minimum(fx, 1 - fx) * np.minimum(fy, 1 - fy)
    slipped = valid & ~ok
    assert (w_min[slipped] < 2 * pallas_sampler._MASK_NOISE_HIGHEST).all()
    both = valid & ok
    np.testing.assert_allclose(got[:, both], smp[:, both], atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    slab = torch.from_numpy(_slab(2))
    u, v = (torch.from_numpy(a) for a in _points())
    before = sampler.LAUNCHES
    out, inb = sampler.sample_slab(slab[:4], u, v)
    want, want_inb = sampler.sample_slab_reference(slab[:4], u, v)
    assert sampler.LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, want, equal_nan=True, rtol=0, atol=0)
    assert torch.equal(inb, want_inb)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    slab = torch.from_numpy(_slab(3))
    u, v = (torch.from_numpy(a) for a in _points())
    with pytest.raises(TypeError):
        sampler.sample_slab(slab.double(), u, v)
    with pytest.raises(ValueError):
        sampler.sample_slab(torch.cat([slab, slab[:1]]), u, v)  # C = 7
    with pytest.raises(ValueError):
        sampler.sample_slab(slab, u[::2], v[::2])  # non-contiguous
    with pytest.raises(ValueError):
        sampler.sample_slab(slab, u, v[:-1])
    with pytest.raises(ValueError):  # neither cpu nor cuda: no fallback
        sampler.sample_slab(slab.to("meta"), u.to("meta"), v.to("meta"))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_output_is_keyed_by_sources(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.name == _build.LIB_NAME
    assert path.parent.parent == _build.BUILD_ROOT
    assert path == _build.library_path()
    assert [s.name for s in _build._sources()] == ["keyframe_scan.cu",
                                                   "linearize.cu",
                                                   "pose_graph.cu",
                                                   "pose_graph_grid.cu",
                                                   "pyramid.cu",
                                                   "sampler.cu"]
    # The header both graph kernels include is part of the key.
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path() == path
    header = csrc / "pose_graph_common.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path() != path



@pytest.mark.parametrize("N, sms, want", [
    (1, 132, 64), (4800, 132, 64), (19200, 132, 64), (38400, 132, 128),
    (67328, 132, 128), (67329, 132, 256), (76800, 132, 256),
    (4800, 16, 128), (76800, 16, 256)])
def test_block_threads(N, sms, want):
    """The sampler kernel's block size from N: 256, halved down to 64
    while the grid gives the SMs fewer than two blocks each (640x480's
    levels 3 / 2 / 1 at 4 800 / 19 200 / 76 800 points, a pixel shard of
    level 1 at 38 400)."""
    got = sampler.block_threads(N, sms)
    assert got == want
    assert sampler._MIN_THREADS <= got <= sampler._MAX_THREADS
    assert got & (got - 1) == 0


def _source_constants(path, names):
    text = path.read_text()
    got = {}
    for name in names:
        m = re.search(rf"\b{name} = (\d+)", text)
        assert m, name
        got[name] = int(m.group(1))
    return got


def test_kernel_source_sampler_constants_match_python():
    """The channel limit and block sizes csrc/sampler.cu checks are the
    ones the wrapper checks and picks from."""
    got = _source_constants(_build.CSRC / "sampler.cu", [
        "kMaxChannels", "kMinThreads", "kMaxThreads"])
    assert list(got.values()) == [NUM_CHANNELS, sampler._MIN_THREADS,
                                  sampler._MAX_THREADS]


def _ctypes_of(param):
    """The ctypes type a C parameter or result type is passed as."""
    if "*" in param:
        return ctypes.c_char_p if "char" in param else ctypes.c_void_p
    for word, t in (("double", ctypes.c_double), ("float", ctypes.c_float),
                    ("int64_t", ctypes.c_int64), ("int", ctypes.c_int)):
        if word in param:
            return t
    raise AssertionError(f"no ctypes type for {param!r}")


_SIGNATURES = dict(
    (name, (res, params)) for res, name, params in re.findall(
        r'extern "C" ((?:const )?\w+\*?) (dvo_\w+)\(([^)]*)\)',
        "".join(p.read_text() for p in _build._sources())))


@pytest.mark.parametrize("name", sorted(_build._entry_points()))
def test_entry_point_argtypes_match_the_sources(name):
    """Every argtypes list load() declares has the C signature's arity and
    types (a pointer or the stream as c_void_p), and every extern "C"
    function of csrc/ has one."""
    assert sorted(_SIGNATURES) == sorted(_build._entry_points())
    res, params = _SIGNATURES[name]
    args, restype = _build._entry_points()[name]
    assert args == [_ctypes_of(p) for p in params.split(",")]
    assert restype == _ctypes_of(res)
