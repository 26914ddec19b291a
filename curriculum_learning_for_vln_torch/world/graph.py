"""Navigation graphs: connectivity parsing and all-pairs shortest paths.

Replaces the reference's networkx pipeline
(`tasks/R2R-judy/src/utils/misc.py:35-60` graph loading;
`src/environ/common_env.py:164-181` per-scan all-pairs Dijkstra) with a
vectorized scipy/numpy implementation that also produces the *next-hop*
matrix — the device-resident teacher-action table (the reference instead
stores full path lists per pair, `common_env.py:216-223`).

A scan graph is (node_ids, positions[V,3], undirected weighted edges with
Euclidean weights).  ``shortest_paths`` returns (dist[V,V], next_hop[V,V])
where next_hop[i, j] is the first node after i on a shortest i->j path
(i itself when i == j or j unreachable).

A copy of ``curriculum_learning_for_vln_tpu/world/graph.py`` (scipy
Dijkstra) so the PyTorch port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra as _csgraph_dijkstra


@dataclass
class ScanGraph:
    scan_id: str
    node_ids: List[str]                 # local index -> viewpoint id
    pos: np.ndarray                     # [V, 3] float32
    edges: np.ndarray                   # [E, 2] int32 (undirected, each pair once)
    id_to_local: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.id_to_local:
            self.id_to_local = {vid: i for i, vid in enumerate(self.node_ids)}

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    def edge_weights(self) -> np.ndarray:
        a, b = self.edges[:, 0], self.edges[:, 1]
        return np.linalg.norm(self.pos[a] - self.pos[b], axis=-1).astype(np.float32)

    def neighbors(self) -> List[np.ndarray]:
        """Per-node sorted neighbor lists."""
        V = self.num_nodes
        adj: List[List[int]] = [[] for _ in range(V)]
        for a, b in self.edges:
            adj[a].append(int(b))
            adj[b].append(int(a))
        return [np.array(sorted(set(n)), dtype=np.int32) for n in adj]


def load_connectivity(scan: str, connectivity_dir: str) -> ScanGraph:
    """Parse ``<dir>/<scan>_connectivity.json`` (Matterport format).

    Only ``included`` nodes with at least one unobstructed edge to another
    included node are kept, and the graph is checked undirected — matching
    the reference loader's semantics (misc.py:44-58) while re-indexing to
    dense local ids.
    """
    path = os.path.join(connectivity_dir, f"{scan}_connectivity.json")
    with open(path) as f:
        data = json.load(f)

    raw_pos = []
    for item in data:
        p = item["pose"]
        raw_pos.append((p[3], p[7], p[11]))

    edge_set = set()
    connected = set()
    for i, item in enumerate(data):
        if not item["included"]:
            continue
        for j, conn in enumerate(item["unobstructed"]):
            if conn and data[j]["included"]:
                if not data[j]["unobstructed"][i]:
                    raise ValueError(f"Graph should be undirected: {scan} {i}->{j}")
                edge_set.add((min(i, j), max(i, j)))
                connected.add(i)
                connected.add(j)

    kept = sorted(connected)
    remap = {old: new for new, old in enumerate(kept)}
    node_ids = [data[i]["image_id"] for i in kept]
    pos = np.array([raw_pos[i] for i in kept], dtype=np.float32)
    edges = np.array(sorted((remap[a], remap[b]) for a, b in edge_set), dtype=np.int32).reshape(-1, 2)
    return ScanGraph(scan_id=scan, node_ids=node_ids, pos=pos, edges=edges)


def shortest_paths(graph: ScanGraph) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs geodesic distances and next-hop matrix.

    Vectorized next-hop extraction: starting from direct predecessors,
    iterate next_hop[i, j] <- next_hop[i, pred[i, j]] until fixpoint
    (at most graph-diameter numpy gathers, no Python per-pair loop).
    """
    V = graph.num_nodes
    if V == 0:
        z = np.zeros((0, 0))
        return z.astype(np.float32), z.astype(np.int32)
    w = graph.edge_weights()
    a, b = graph.edges[:, 0], graph.edges[:, 1]
    m = csr_matrix(
        (np.concatenate([w, w]), (np.concatenate([a, b]), np.concatenate([b, a]))), shape=(V, V)
    )
    dist, pred = _csgraph_dijkstra(m, directed=False, return_predecessors=True)

    rows = np.arange(V)[:, None]
    cols = np.arange(V)[None, :].repeat(V, axis=0)
    UNREACH = -9999  # scipy's sentinel
    nh = np.where(pred == rows, cols, -1)          # direct neighbors: hop is target itself
    nh[rows.ravel(), rows.ravel()] = rows.ravel()  # i -> i: stay
    safe_pred = np.where(pred == UNREACH, rows, pred)
    for _ in range(V):
        missing = nh < 0
        if not missing.any():
            break
        cand = nh[rows, safe_pred]                 # next_hop[i, pred[i, j]]
        nh = np.where(missing, cand, nh)
    nh = np.where(nh < 0, rows, nh)                # unreachable: stay put
    dist = np.where(np.isinf(dist), 1e9, dist)
    return dist.astype(np.float32), nh.astype(np.int32)


def write_connectivity(graph: ScanGraph, connectivity_dir: str) -> str:
    """Serialize a ScanGraph back to Matterport connectivity JSON format
    (used by synthetic worlds and the C++ sim parity tests)."""
    os.makedirs(connectivity_dir, exist_ok=True)
    V = graph.num_nodes
    unob = np.zeros((V, V), dtype=bool)
    for a, b in graph.edges:
        unob[a, b] = unob[b, a] = True
    items = []
    for i in range(V):
        pose = [0.0] * 16
        pose[0] = pose[5] = pose[10] = pose[15] = 1.0
        pose[3], pose[7], pose[11] = (float(x) for x in graph.pos[i])
        items.append(
            {
                "image_id": graph.node_ids[i],
                "pose": pose,
                "included": True,
                "unobstructed": [bool(x) for x in unob[i]],
                "visible": [bool(x) for x in unob[i]],
                "height": 1.5,
            }
        )
    path = os.path.join(connectivity_dir, f"{graph.scan_id}_connectivity.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


def load_nav_graphs(scans: Sequence[str], connectivity_dir: str) -> Dict[str, ScanGraph]:
    return {scan: load_connectivity(scan, connectivity_dir) for scan in scans}
