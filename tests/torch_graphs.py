"""Seeded pose graphs that more than one test file of the port builds."""

import numpy as np

from dvo_slam_tpu_torch.models import pose_graph
from dvo_slam_tpu_torch.utils import se3_np


def two_lap_ring(M, seed=0):
    """chip_smoke._ring_graph's topology at M vertices, in memory: a chain
    over two laps of a 5 m ring and an edge from every 8th vertex of the
    second lap to the same place on the first, with 1 cm / 0.005 rad noise
    chained into the initial poses. Its factor's tiles fill in to about a
    third."""
    rng = np.random.default_rng(seed)
    lap = M // 2
    gt = [se3_np.exp(np.array([5 * np.sin(a), 5 * (1 - np.cos(a)),
                               0.2 * np.sin(2 * a), 0, 0, a]))
          for a in 2 * np.pi * np.arange(M) / lap]
    noise = np.array([0.01] * 3 + [0.005] * 3)
    info = np.diag(1.0 / noise**2)
    edges, T_est = [], [gt[0]]
    for k in range(M - 1):
        Z = (se3_np.inverse(gt[k]) @ gt[k + 1]
             @ se3_np.exp(rng.normal(size=6) * noise))
        edges.append((k, k + 1, Z))
        T_est.append(T_est[-1] @ Z)
    for k in range(lap, M, 8):
        Z = (se3_np.inverse(gt[k]) @ gt[k - lap]
             @ se3_np.exp(rng.normal(size=6) * noise))
        edges.append((k, k - lap, Z))
    g = pose_graph.empty_graph_host(M, pose_graph.bucket(len(edges), 64))
    g.poses[:] = np.stack(T_est)
    for e, (i, j, Z) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.measurements[e], g.information[e] = Z, info
        g.edge_mask[e] = True
    return g._replace(num_vertices=np.asarray(M, np.int32),
                      num_edges=np.asarray(len(edges), np.int32))
