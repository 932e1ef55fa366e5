"""The port's parallel/ (torch.distributed) against the JAX package's
parallel/ (jax.sharding on the 8-device CPU mesh) and against the port's
own single-process runs.

One gloo world of 4 ranks is spawned once for the module
(tests/torch_sharded_cases.py runs in each rank, on meshes (2, 2), (4, 1)
and (1, 4)), in a thread while this process computes the JAX references;
the world has a timeout of its own. Tolerances are tests/test_sharded.py's:

- sharded tracking, the validation fleet, and tracking with a point
  budget (compacted per pixel shard, after the shard's row offset, as the
  JAX package compacts): T within 5e-5 and valid_pixels within rtol 1e-6
  of the JAX package's run (its sharded tracker on the 8-device mesh; its
  batched tracker for the fleet) and of the port's single-process
  track_batched;
- the edge-sharded H and g: atol 2e-3 and 1e-3 against both, the gauge
  block's diagonal excluded (the single-process builds add the prior);
- both sequence fleets: rel_pose / rel_poses within 1e-5 of the JAX
  package's batched forms and of the port's; keyframe switch flags
  exactly.

Every rank of the world returns the whole batch; all ranks must agree
exactly. The pixel route (``linearize.pixel_route``) must be taken on
exactly the meshes with more than one pixel rank.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models import dense_tracker, pose_graph
from dvo_slam_tpu.ops import camera, pyramid
from dvo_slam_tpu.parallel import batch_slam, sharded
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch import parallel as t_parallel
from dvo_slam_tpu_torch.ops import linearize as t_lin
from dvo_slam_tpu_torch.parallel import sharded as t_sharded

import torch_sharded_cases as cases

W, H = 64, 32
K_TUPLE = (W * 0.8, W * 0.8, (W - 1) / 2, (H - 1) / 2)
CFG = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                    max_iterations=10)
B = 4
FLEET_B = 2
SEQ_K = (32.0, 32.0, 31.5, 23.5)
SEQ_W, SEQ_H, SEQ_S, SEQ_T = 64, 48, 4, 5
SEQ_CFG = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=8)
SLAM_CFG = SlamConfig(local_map_optimize=False)
WORLD_TIMEOUT_S = 240.0
MESHES = cases.MESHES


def _port_fields(cfg):
    return dataclasses.asdict(
        convert.tracker_config_from_fields(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def inputs():
    scene = synthetic.two_plane_scene()
    K = np.asarray(K_TUPLE)
    xi = np.array([0.01, -0.005, 0.008, 0.004, -0.003, 0.005])
    i0, z0 = scene.render(K, W, H, np.eye(4))
    cur = [scene.render(K, W, H, se3_np.inverse(se3_np.exp(xi * s)))
           for s in (1.0, 0.5, -0.7, 1.3)]
    rng = np.random.default_rng(0)
    M, E = 8, 16
    graph = {
        "poses": np.stack([se3_np.exp(rng.normal(scale=0.2, size=6))
                           for _ in range(M)]).astype(np.float32),
        "ei": rng.integers(0, M - 1, E).astype(np.int32),
    }
    graph["ej"] = ((graph["ei"] + 1) % M).astype(np.int32)
    graph["Z"] = np.stack([se3_np.exp(rng.normal(scale=0.05, size=6))
                           for _ in range(E)]).astype(np.float32)
    graph["info"] = np.broadcast_to(np.eye(6, dtype=np.float32),
                                    (E, 6, 6)).copy()
    graph["mask"] = np.ones(E, bool)
    graph["mask"][5] = False
    seq_i, seq_z = [], []
    for s in range(SEQ_S):
        poses = synthetic.orbit_trajectory(SEQ_T, radius=0.02 + 0.01 * s)
        frames = synthetic.render_sequence(scene, np.asarray(SEQ_K), SEQ_W,
                                           SEQ_H, poses)
        seq_i.append(np.stack([f[0] for f in frames]))
        seq_z.append(np.stack([f[1] for f in frames]))
    force = np.zeros((SEQ_S, SEQ_T), bool)
    force[:, 2] = True
    force[1, 3] = True
    return {
        "K": K_TUPLE, "cfg": _port_fields(CFG),
        "ref_i": np.stack([i0] * B), "ref_z": np.stack([z0] * B),
        "cur_i": np.stack([c[0] for c in cur]),
        "cur_z": np.stack([c[1] for c in cur]),
        "fleet_B": FLEET_B,
        "fleet_T": np.stack([np.eye(4), se3_np.exp(xi * 0.3)]).astype(
            np.float32),
        "graph": graph,
        "seqs": {"i": np.stack(seq_i).astype(np.float32),
                 "z": np.stack(seq_z).astype(np.float32), "force": force},
        "seq_K": SEQ_K, "seq_cfg": _port_fields(SEQ_CFG),
        "slam_cfg": dataclasses.asdict(SLAM_CFG),
    }


@pytest.fixture(scope="module")
def world(inputs):
    """The 4-rank gloo world, started once; the fixture's value joins it
    (the ranks run while the JAX references compute here)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(t_parallel.spawn, cases.run, 4, "cpu", (inputs,),
                         WORLD_TIMEOUT_S)
    done = {}

    def result():
        if "out" not in done:
            done["out"] = future.result(timeout=WORLD_TIMEOUT_S + 30)
        return done["out"]

    yield result
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def single(inputs):
    return cases.single(inputs)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return sharded.make_mesh(8)  # (4, 2): batch x pixel


def _jax_pyramids(intensities, depths, levels):
    pyrs = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z), levels)
            for i, z in zip(intensities, depths)]
    return tuple(jnp.stack(lvl) for lvl in zip(*pyrs))


@pytest.fixture(scope="module")
def jax_pairs(inputs, jax_mesh):
    refs = _jax_pyramids(inputs["ref_i"], inputs["ref_z"], CFG.num_levels)
    curs = _jax_pyramids(inputs["cur_i"], inputs["cur_z"], CFG.num_levels)
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE),
                                   CFG.num_levels)
    T0 = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    out = {}
    for name, cfg in (("pairs", CFG), ("pairs_budget", dataclasses.replace(
            CFG, point_budget_fraction=0.5))):
        out[name] = sharded.sharded_track_pairs(jax_mesh, cfg)(
            refs, curs, Ks, T0)
    cand = tuple(lvl[:FLEET_B] for lvl in refs)
    news = tuple(jnp.broadcast_to(lvl[0], (FLEET_B,) + lvl.shape[1:])
                 for lvl in curs)
    Tf = jnp.asarray(inputs["fleet_T"])
    out["fleet"] = (
        dense_tracker.track_pairs_batched(cand, news, Ks, Tf, CFG),
        dense_tracker.track_pairs_batched(
            news, cand, Ks, jnp.asarray(np.stack(
                [se3_np.inverse(T) for T in inputs["fleet_T"]]),
                jnp.float32), CFG))
    return out


def _world(world, key):
    out = world()
    return out[0][key]


def _close_results(got, want):
    np.testing.assert_allclose(got.transformation,
                               np.asarray(want.transformation), atol=5e-5)
    np.testing.assert_allclose(got.valid_pixels,
                               np.asarray(want.valid_pixels), rtol=1e-6)


def test_mesh_shape_like_jax():
    for n, dp, sp in ((8, None, None), (8, 8, None), (8, None, 4),
                      (8, 2, 4), (4, None, None), (1, None, None),
                      (3, None, None)):
        assert t_sharded.mesh_shape(n, dp, sp) == sharded.make_mesh(
            n, dp, sp).devices.shape
    with pytest.raises(ValueError):
        t_sharded.mesh_shape(8, dp=3)
    assert not t_lin.pixel_route(None)


def test_world_ranks_agree(world):
    """Every rank returns the same whole-batch results, bit for bit, and
    sits at its own mesh coordinate."""
    out = world()
    assert len(out) == 4
    for rank, r in enumerate(out):
        for shape in MESHES:
            assert r[("coordinate", shape)] == (rank // shape[1],
                                                rank % shape[1])
        for key, v in r.items():
            if key[0] == "coordinate":
                continue
            for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(out[0][key])):
                np.testing.assert_array_equal(a, b, err_msg=str(key))


@pytest.mark.parametrize("shape", MESHES)
def test_pixel_route_taken_with_pixel_ranks(world, shape):
    sp = shape[1]
    assert _world(world, ("pixel_route", shape)) == (sp > 1)
    calls = _world(world, ("pairs_grouped_calls", shape))
    assert (calls > 0) == (sp > 1)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_track_pairs_like_jax(world, single, jax_pairs, shape):
    got = _world(world, ("pairs", shape))
    _close_results(got, single["pairs"])
    _close_results(got, jax_pairs["pairs"])
    np.testing.assert_allclose(got.valid_ratio, single["pairs"].valid_ratio,
                               rtol=1e-6)


def test_sharded_track_pairs_budget_like_jax(world, single, jax_pairs):
    """The pixel route under point compaction on the (2, 2) mesh, each
    pixel shard compacted to its own budget after its row offset, against
    the JAX package's (4, 2) mesh (the same two pixel shards); beside the
    single-process run, which compacts the whole grid (here, with every
    point selected and half kept, the same points)."""
    got = _world(world, ("pairs_budget", (2, 2)))
    want = jax_pairs["pairs_budget"]
    _close_results(got, want)
    np.testing.assert_allclose(got.valid_ratio, np.asarray(want.valid_ratio),
                               rtol=1e-6)
    assert (got.valid_pixels <= W * H // 2).all()  # the budget held
    _close_results(got, single["pairs_budget"])


@pytest.mark.parametrize("shape", MESHES)
def test_validation_fleet_like_jax(world, single, jax_pairs, shape):
    fwd, bwd = _world(world, ("fleet", shape))
    for got, s, j in zip((fwd, bwd), single["fleet"], jax_pairs["fleet"]):
        assert got.transformation.shape == (FLEET_B, 4, 4)
        _close_results(got, s)
        _close_results(got, j)
    T_fb = fwd.transformation[0].astype(np.float64) @ \
        bwd.transformation[0].astype(np.float64)
    assert np.linalg.norm(se3_np.log(T_fb)) < 5e-3


@pytest.fixture(scope="module")
def jax_graph(inputs):
    g = inputs["graph"]
    M, E = g["poses"].shape[0], g["ei"].shape[0]
    g2 = pose_graph.empty_graph(M, E)._replace(
        poses=jnp.asarray(g["poses"]), num_vertices=jnp.asarray(M, jnp.int32),
        edge_i=jnp.asarray(g["ei"]), edge_j=jnp.asarray(g["ej"]),
        measurements=jnp.asarray(g["Z"]), information=jnp.asarray(g["info"]),
        edge_mask=jnp.asarray(g["mask"]),
        num_edges=jnp.asarray(E, jnp.int32))
    H_ref, g_ref, _, _ = jax.jit(
        lambda gg: pose_graph._build_system(gg, False, 1.0))(g2)
    return np.asarray(H_ref, np.float64), np.asarray(g_ref)


@pytest.mark.parametrize("shape", MESHES)
def test_pose_graph_build_like_jax(world, single, jax_graph, shape):
    H_sh, g_sh = _world(world, ("graph", shape))
    H_sh = np.array(H_sh, np.float64)
    H_sh[:6, :6] = 0.0
    for H_ref, g_ref in (jax_graph, single["graph"]):
        H_ref = np.array(H_ref, np.float64)
        H_ref[:6, :6] = 0.0
        np.testing.assert_allclose(H_sh, H_ref, atol=2e-3)
        np.testing.assert_allclose(g_sh, np.asarray(g_ref), atol=1e-3)
    assert np.abs(H_sh).max() > 1.0  # the edges really contributed


@pytest.fixture(scope="module")
def jax_sequences(inputs):
    s = inputs["seqs"]
    K = camera.intrinsics(*SEQ_K)
    odo = batch_slam.track_sequences_batched(jnp.asarray(s["i"]),
                                             jnp.asarray(s["z"]), K, SEQ_CFG)
    kf = batch_slam.keyframe_sequences_batched(
        jnp.asarray(s["i"]), jnp.asarray(s["z"]), K, SEQ_CFG, SLAM_CFG,
        force_keyframe=jnp.asarray(s["force"]))
    return ({k: np.asarray(v) for k, v in odo.items()},
            {k: np.asarray(v) for k, v in kf.items()})


@pytest.mark.parametrize("shape", MESHES)
def test_track_sequences_sharded_like_jax(world, single, jax_sequences,
                                          shape):
    got = _world(world, ("sequences", shape))
    want = jax_sequences[0]
    assert got["rel_poses"].shape == (SEQ_S, SEQ_T - 1, 4, 4)
    np.testing.assert_allclose(got["rel_poses"],
                               single["sequences"]["rel_poses"], atol=1e-5)
    np.testing.assert_allclose(got["rel_poses"], want["rel_poses"],
                               atol=1e-5)
    np.testing.assert_array_equal(got["is_nan"], want["is_nan"])


@pytest.mark.parametrize("shape", MESHES)
def test_keyframe_sequences_sharded_like_jax(world, single, jax_sequences,
                                             shape):
    got = _world(world, ("keyframes", shape))
    want = jax_sequences[1]
    assert got["rel_pose"].shape == (SEQ_S, SEQ_T - 1, 4, 4)
    assert got["switch"][:, 1].all()  # the forced keyframe at frame 2
    np.testing.assert_array_equal(got["switch"], want["switch"])
    np.testing.assert_array_equal(got["switch"],
                                  single["keyframes"]["switch"])
    np.testing.assert_allclose(got["rel_pose"],
                               single["keyframes"]["rel_pose"], atol=1e-5)
    np.testing.assert_allclose(got["rel_pose"], want["rel_pose"], atol=1e-5)
