"""The port's .g2o IO and `optimize-graph` against the JAX package's.

Files written by either package are byte-identical for the same graph and
load into the same arrays in both (exact: the same text parsed by the
same code). Optimizing a loaded graph matches the JAX solve within
tests/test_torch_pose_graph.py's tolerances (poses 1e-4, robust weights
1e-3, chi2 rtol 1e-3).
"""

import numpy as np
import pytest

from dvo_slam_tpu import cli
from dvo_slam_tpu.models import pose_graph
from dvo_slam_tpu.utils import g2o_io
from dvo_slam_tpu_torch import cli as t_cli
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import pose_graph as t_pose_graph
from dvo_slam_tpu_torch.utils import g2o_io as t_g2o_io
from test_torch_pose_graph import _assert_close, _chain_graph, _jax_graph
from test_torch_benchmark import one_torch_thread  # noqa: F401

FIELDS = ("poses", "num_vertices", "edge_i", "edge_j", "measurements",
          "information", "edge_mask", "num_edges")


def _assert_same_graph(got, want):
    """A port host graph against a JAX one, field by field, exactly."""
    for name, a, b in zip(FIELDS, got, convert.pose_graph_to_numpy(
            [np.asarray(x) for x in want])):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        assert np.asarray(a).dtype == b.dtype, name


@pytest.mark.parametrize("n", [6, 12])
def test_files_identical_and_cross_load(tmp_path, n):
    g, _ = _chain_graph(n=n, drift=0.02, max_v=16, max_e=32)
    ours, theirs = str(tmp_path / "ours.g2o"), str(tmp_path / "theirs.g2o")
    t_g2o_io.save_g2o(ours, g)
    g2o_io.save_g2o(theirs, _jax_graph(g))
    assert open(ours).read() == open(theirs).read()
    text = open(ours).read()
    assert text.count("VERTEX_SE3:QUAT") == n and "FIX 0" in text
    assert text.count("EDGE_SE3:QUAT") == n  # odometry + one loop edge
    # Port-written -> JAX load, JAX-written -> port load.
    _assert_same_graph(t_g2o_io.load_g2o(theirs, 16, 32),
                       g2o_io.load_g2o(ours, 16, 32))
    back = t_g2o_io.load_g2o(ours, 16, 32)
    np.testing.assert_allclose(back.poses[:n], g.poses[:n], atol=1e-5)
    np.testing.assert_allclose(back.measurements[:n], g.measurements[:n],
                               atol=1e-5)
    np.testing.assert_allclose(back.information[:n], g.information[:n],
                               rtol=1e-5)


def test_save_solved_tensors(tmp_path):
    """The tensors optimize() returns save like their host copy."""
    g, _ = _chain_graph(n=6)
    solved, _, _ = t_pose_graph.optimize(g, iterations=5, device="cpu")
    a, b = str(tmp_path / "a.g2o"), str(tmp_path / "b.g2o")
    t_g2o_io.save_g2o(a, solved)
    t_g2o_io.save_g2o(b, convert.pose_graph_to_numpy(solved))
    assert open(a).read() == open(b).read()


def test_capacity_grows_like_jax(tmp_path):
    g, _ = _chain_graph(n=12, drift=0.02, max_v=16, max_e=32)
    path = str(tmp_path / "big.g2o")
    t_g2o_io.save_g2o(path, g)
    got = t_g2o_io.load_g2o(path, max_vertices=4, max_edges=4)
    assert int(got.num_vertices) == 12 and got.poses.shape[0] == 12
    assert got.edge_i.shape[0] == int(got.num_edges) == 12
    _assert_same_graph(got, g2o_io.load_g2o(path, max_vertices=4,
                                            max_edges=4))


def test_sparse_ids_compact_like_jax(tmp_path):
    info = " ".join(["10 0 0 0 0 0", "10 0 0 0 0", "10 0 0 0", "10 0 0",
                     "10 0", "10"])
    lines = [f"VERTEX_SE3:QUAT {vid} {0.1 * k:.3f} 0 0 0 0 0 1"
             for k, vid in enumerate([9, 0, 5])]
    lines += [f"EDGE_SE3:QUAT 0 5 0.1 0 0 0 0 0 1 {info}",
              f"EDGE_SE3:QUAT 5 9 0.1 0 0 0 0 0 1 {info}"]
    path = tmp_path / "sparse.g2o"
    path.write_text("\n".join(lines) + "\n")
    got = t_g2o_io.load_g2o(str(path))
    assert int(got.num_vertices) == 3 and int(got.num_edges) == 2
    np.testing.assert_array_equal(got.edge_i[:2], [0, 1])
    np.testing.assert_array_equal(got.edge_j[:2], [1, 2])
    _assert_same_graph(got, g2o_io.load_g2o(str(path)))
    out = tmp_path / "back.g2o"
    t_g2o_io.save_g2o(str(out), got)
    assert out.read_text().count("VERTEX_SE3:QUAT") == 3


@pytest.mark.parametrize("line, match", [
    ("EDGE_SE3:QUAT 0 7 0 0 0 0 0 0 1 " + " ".join(["1"] * 21), "undeclared"),
    ("VERTEX_SE3:QUAT -1 0 0 0 0 0 0 1", "negative"),
])
def test_bad_files_raise_like_jax(tmp_path, line, match):
    path = tmp_path / "bad.g2o"
    path.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n" + line + "\n")
    for load in (t_g2o_io.load_g2o, g2o_io.load_g2o):
        with pytest.raises(ValueError, match=match):
            load(str(path))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_after_load_like_jax(tmp_path, solver):
    g, _ = _chain_graph(n=8, drift=0.05, max_v=16, max_e=32)
    path = str(tmp_path / "graph.g2o")
    t_g2o_io.save_g2o(path, g)
    kw = dict(iterations=10, gnc_init=16.0, solver=solver)
    got = t_pose_graph.optimize(t_g2o_io.load_g2o(path, 16, 32),
                                device="cpu", **kw)
    want = pose_graph.optimize(g2o_io.load_g2o(path, 16, 32), **kw)
    _assert_close(got, want)


def _final_chi2(capsys):
    words = capsys.readouterr().out.split()
    assert words[:4] == ["vertices", "8", "edges", "8"], words
    return float(words[5])


def test_cli_optimize_graph_like_jax(tmp_path, capsys):
    g, _ = _chain_graph(n=8, drift=0.05, max_v=16, max_e=32)
    src = str(tmp_path / "in.g2o")
    t_g2o_io.save_g2o(src, g)
    ours, theirs = str(tmp_path / "ours.g2o"), str(tmp_path / "theirs.g2o")
    args = ["optimize-graph", src, "--iterations", "30"]
    assert cli.main(args + ["--out", theirs]) == 0
    want = _final_chi2(capsys)
    assert t_cli.main(args + ["--out", ours, "--device", "cpu"]) == 0
    got = _final_chi2(capsys)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    a, b = t_g2o_io.load_g2o(ours), t_g2o_io.load_g2o(theirs)
    np.testing.assert_allclose(a.poses[:8], b.poses[:8], atol=1e-4)
    _, chi2_before, _ = t_pose_graph.optimize(g, iterations=0, device="cpu")
    assert got < float(chi2_before)
