"""The navigation world's tables, worked out from the raw scans.

For every panorama: its navigable neighbours in the order of the
simulator's view sweep (by view index, then heading), each with its
absolute heading and elevation and the closest of the 36 discretised
views; the geodesic distance to every panorama of its scan and the first
hop of a shortest path (Dijkstra over Euclidean edge lengths); and the
relative view-location embedding of each current view (the reference
repository's ``misc.py``, Anderson et al.'s 36-view panorama).  numpy on
the host, tensors on the device.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

ANGLE_INC = math.pi / 6.0
VIEWS = 36


def angle_feat(heading: torch.Tensor, elevation: torch.Tensor, size: int = 128) -> torch.Tensor:
    """[sin h, cos h, sin e, cos e], each repeated size / 4 times."""
    parts = torch.stack([torch.sin(heading), torch.cos(heading), torch.sin(elevation),
                         torch.cos(elevation)], dim=-1)
    return torch.repeat_interleave(parts, size // 4, dim=-1)


def loc_embedding(size: int = 128) -> np.ndarray:
    """[36 current views, 36 views, size]: the angle feature of each view
    relative to the current view's heading (elevation absolute)."""
    out = np.zeros((VIEWS, VIEWS, size), np.float32)
    for cur in range(VIEWS):
        for v in range(VIEWS):
            rel = (v - cur) % 12 + (v // 12) * 12
            h, e = (rel % 12) * ANGLE_INC, (rel // 12 - 1) * ANGLE_INC
            out[cur, v] = np.repeat(np.array([math.sin(h), math.cos(h), math.sin(e),
                                              math.cos(e)], np.float32), size // 4)
    return out


def compile_tables(graphs: Dict[str, dict], max_candidates: int, device) -> dict:
    """The world's tables over the scans in sorted order, panoramas numbered
    scan by scan; ``id`` maps (scan, viewpoint) to the global number."""
    scans = sorted(graphs)
    sizes = [len(graphs[s]["node_ids"]) for s in scans]
    N, L, MC = sum(sizes), max(sizes), max_candidates
    offset = np.concatenate([[0], np.cumsum(sizes)])
    cand_next = np.tile(np.arange(N)[:, None], (1, MC))
    cand_valid = np.zeros((N, MC), bool)
    cand_heading = np.zeros((N, MC), np.float32)
    cand_elev = np.zeros((N, MC), np.float32)
    cand_view = np.zeros((N, MC), np.int64)
    n_cands = np.zeros(N, np.int64)
    dist = np.full((N, L), 1e9, np.float32)
    next_hop = np.zeros((N, L), np.int64)
    node_local = np.zeros(N, np.int64)
    ids = {}
    for s, scan in enumerate(scans):
        g, off, V = graphs[scan], int(offset[s]), sizes[s]
        pos, edges = g["pos"].astype(np.float32), g["edges"]
        for i, vp in enumerate(g["node_ids"]):
            ids[(scan, vp)] = off + i
        node_local[off:off + V] = np.arange(V)
        w = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]], axis=-1).astype(np.float32)
        m = csr_matrix((np.concatenate([w, w]), (np.concatenate([edges[:, 0], edges[:, 1]]),
                                                 np.concatenate([edges[:, 1], edges[:, 0]]))),
                       shape=(V, V))
        d, pred = dijkstra(m, directed=False, return_predecessors=True)
        dist[off:off + V, :V] = np.where(np.isinf(d), 1e9, d)
        # first hop i -> j: walk j's predecessors back until the one after i
        hop = np.tile(np.arange(V)[None, :], (V, 1))
        rows = np.arange(V)[:, None]
        for _ in range(V):
            p = pred[rows, hop]
            step = (p >= 0) & (p != rows)
            if not step.any():
                break
            hop = np.where(step, p, hop)
        next_hop[off:off + V, :V] = np.where(np.isfinite(d), hop, rows) + off
        nbrs = [[] for _ in range(V)]
        for a, b in edges:
            nbrs[a].append(int(b))
            nbrs[b].append(int(a))
        for i in range(V):
            nb = np.array(sorted(set(nbrs[i])), np.int64)
            if nb.size == 0:
                continue
            if nb.size > MC:
                raise ValueError(f"{scan} node {i}: {nb.size} neighbours > {MC}")
            dlt = pos[nb] - pos[i][None, :]
            heading = np.mod(np.arctan2(dlt[:, 0], dlt[:, 1]), 2 * np.pi)
            elev = np.arctan2(dlt[:, 2], np.maximum(np.linalg.norm(dlt[:, :2], axis=-1), 1e-8))
            view = ((np.clip(np.round(elev / ANGLE_INC).astype(np.int64), -1, 1) + 1) * 12
                    + np.mod(np.round(heading / ANGLE_INC).astype(np.int64), 12))
            order = np.lexsort((heading, view))
            k, gi = nb.size, off + i
            cand_next[gi, :k] = nb[order] + off
            cand_valid[gi, :k] = True
            cand_heading[gi, :k] = heading[order]
            cand_elev[gi, :k] = elev[order]
            cand_view[gi, :k] = view[order]
            n_cands[gi] = k

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"cand_next": t(cand_next), "cand_valid": t(cand_valid),
            "cand_heading": t(cand_heading), "cand_elev": t(cand_elev),
            "cand_view": t(cand_view), "n_cands": t(n_cands), "dist": t(dist),
            "next_hop": t(next_hop), "node_local": t(node_local),
            "loc_embed": t(loc_embedding()), "id": ids}
