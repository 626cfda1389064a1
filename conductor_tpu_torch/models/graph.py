"""Skeleton graph for the 13-keypoint ConductorMotion100 layout.

A copy of `conductor_tpu/models/graph.py`, carried by the port because
importing `conductor_tpu.models` pulls in flax.  Host-side numpy
construction of the ST-GCN adjacency stack, with the same layouts /
partition strategies as reference
`Contrastive_Stage/models/ST_GCN/st_gcn_utils/graph.py:3-173`: hop distances
via adjacency-matrix powers, in-degree digraph normalization, and the
uniform / distance / spatial partitioning schemes.  The result is a static
(K, V, V) float array baked into the model as a constant — no device work.
"""

from __future__ import annotations

import numpy as np

LAYOUTS: dict[str, dict] = {
    # MOCO keypoints: 0 Nose, 1-2 Eyes, 3-4 Ears, 5-6 Shoulders, 7-8 Elbows,
    # 9-10 Wrists, 11-12 Hips (`graph.py:42-57`).
    "ConductorMotionX": {
        "num_node": 13,
        "neighbor_link": [
            (0, 1), (0, 2), (1, 3), (2, 4),          # head
            (0, 5), (0, 6),                            # fake neck
            (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),   # upper body
            (11, 12), (5, 11), (6, 12),                # body outline
        ],
        "center": 1,
    },
    "openpose": {
        "num_node": 18,
        "neighbor_link": [
            (4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
            (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1),
            (0, 1), (15, 0), (14, 0), (17, 15), (16, 14),
        ],
        "center": 1,
    },
}


def get_hop_distance(num_node: int, edge, max_hop: int = 1) -> np.ndarray:
    """Shortest hop count between nodes up to max_hop (`graph.py:139-151`)."""
    A = np.zeros((num_node, num_node))
    for i, j in edge:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.zeros((num_node, num_node)) + np.inf
    transfer_mat = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive_mat = np.stack(transfer_mat) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive_mat[d]] = d
    return hop_dis


def normalize_digraph(A: np.ndarray) -> np.ndarray:
    """Column (in-degree) normalization A @ D^-1 (`graph.py:154-162`)."""
    Dl = np.sum(A, 0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return A @ Dn


def normalize_undigraph(A: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 (`graph.py:165-173`)."""
    Dl = np.sum(A, 0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-0.5)
    return Dn @ A @ Dn


def build_adjacency(
    layout: str = "ConductorMotionX",
    strategy: str = "uniform",
    max_hop: int = 1,
    dilation: int = 1,
) -> np.ndarray:
    """Build the (K, V, V) adjacency stack (`graph.py:25-136`)."""
    spec = LAYOUTS[layout]
    num_node = spec["num_node"]
    self_link = [(i, i) for i in range(num_node)]
    edge = self_link + spec["neighbor_link"]
    center = spec["center"]

    hop_dis = get_hop_distance(num_node, edge, max_hop=max_hop)
    valid_hop = range(0, max_hop + 1, dilation)

    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hop:
        adjacency[hop_dis == hop] = 1
    normalized = normalize_digraph(adjacency)

    if strategy == "uniform":
        return normalized[None].astype(np.float32)

    if strategy == "distance":
        A = np.zeros((len(list(valid_hop)), num_node, num_node))
        for i, hop in enumerate(valid_hop):
            A[i][hop_dis == hop] = normalized[hop_dis == hop]
        return A.astype(np.float32)

    if strategy == "spatial":
        A = []
        for hop in valid_hop:
            a_root = np.zeros((num_node, num_node))
            a_close = np.zeros((num_node, num_node))
            a_further = np.zeros((num_node, num_node))
            for i in range(num_node):
                for j in range(num_node):
                    if hop_dis[j, i] == hop:
                        if hop_dis[j, center] == hop_dis[i, center]:
                            a_root[j, i] = normalized[j, i]
                        elif hop_dis[j, center] > hop_dis[i, center]:
                            a_close[j, i] = normalized[j, i]
                        else:
                            a_further[j, i] = normalized[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        return np.stack(A).astype(np.float32)

    raise ValueError(f"unknown partition strategy: {strategy!r}")
