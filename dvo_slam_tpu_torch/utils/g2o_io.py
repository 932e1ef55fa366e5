"""g2o-format pose-graph serialization (counterpart of
``dvo_slam_tpu/utils/g2o_io.py``).

The reference's backend state is a g2o SparseOptimizer whose graphs can be
dumped/loaded as `.g2o` text (VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines) —
standard interchange with g2o_viewer and other SLAM tooling. This module
writes and reads the same format from the port's PoseGraph, so graphs
written by either package load in the other.

Format per g2o convention:
  VERTEX_SE3:QUAT id tx ty tz qx qy qz qw
  EDGE_SE3:QUAT id1 id2 tx ty tz qx qy qz qw <21 upper-triangular info>
"""

from __future__ import annotations

import numpy as np

from dvo_slam_tpu_torch.utils import se3_np


def save_g2o(path: str, graph) -> None:
    """Write a PoseGraph (host arrays, or the tensors ``optimize``
    returns) to .g2o text. Masked edges are left out."""
    from dvo_slam_tpu_torch.convert import to_numpy

    poses = to_numpy(graph.poses).astype(np.float64)
    n_v = int(graph.num_vertices)
    n_e = int(graph.num_edges)
    ei = to_numpy(graph.edge_i)
    ej = to_numpy(graph.edge_j)
    Z = to_numpy(graph.measurements).astype(np.float64)
    info = to_numpy(graph.information).astype(np.float64)
    mask = to_numpy(graph.edge_mask)

    iu, ju = np.triu_indices(6)
    with open(path, "w") as f:
        for k in range(n_v):
            t, q = se3_np.matrix_to_pose(poses[k])
            f.write(
                f"VERTEX_SE3:QUAT {k} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
        f.write("FIX 0\n")
        for e in range(n_e):
            if not mask[e]:
                continue
            t, q = se3_np.matrix_to_pose(Z[e])
            upper = " ".join(f"{info[e][i, j]:.9f}" for i, j in zip(iu, ju))
            f.write(
                f"EDGE_SE3:QUAT {int(ei[e])} {int(ej[e])} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {upper}\n"
            )


def load_g2o(path: str, max_vertices: int = 256, max_edges: int = 1024):
    """Read a .g2o file into a host PoseGraph (numpy arrays, as
    ``pose_graph.empty_graph_host`` makes them; ``optimize`` takes it).

    max_vertices/max_edges are MINIMUM padded capacities: a file larger
    than either grows the graph to fit.

    Sparse vertex ids (g2o permits any) are compacted to 0..n-1 in sorted
    order; edge endpoints follow the remapping, so a graph written back by
    save_g2o is renumbered but structurally identical. An edge naming an
    undeclared vertex raises ValueError.
    """
    from dvo_slam_tpu_torch.models import pose_graph

    vertices = {}
    edges = []
    iu, ju = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                vid = int(parts[1])
                if vid < 0:
                    raise ValueError(f"negative vertex id {vid} in {path}")
                t = [float(x) for x in parts[2:5]]
                q = [float(x) for x in parts[5:9]]
                vertices[vid] = se3_np.pose_to_matrix(t, q)
            elif parts[0] == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                t = [float(x) for x in parts[3:6]]
                q = [float(x) for x in parts[6:10]]
                upper = [float(x) for x in parts[10:31]]
                info = np.zeros((6, 6))
                info[iu, ju] = upper
                info[ju, iu] = upper
                edges.append((i, j, se3_np.pose_to_matrix(t, q), info))

    # Dense indices for the padded arrays: treating the largest id as the
    # vertex count would turn every id gap into a phantom identity vertex.
    id_map = {vid: k for k, vid in enumerate(sorted(vertices))}
    for i, j, _, _ in edges:
        if i not in id_map or j not in id_map:
            raise ValueError(
                f"edge ({i}, {j}) references an undeclared vertex in {path}"
            )
    g = pose_graph.empty_graph_host(max(max_vertices, len(id_map)),
                                    max(max_edges, len(edges)))
    for vid, T in vertices.items():
        g.poses[id_map[vid]] = T
    for e, (i, j, Zm, I) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = id_map[i], id_map[j]
        g.measurements[e], g.information[e] = Zm, I
        g.edge_mask[e] = True
    return g._replace(num_vertices=np.asarray(len(id_map), np.int32),
                      num_edges=np.asarray(len(edges), np.int32))
