"""World compiler: navigation graphs -> packed device-resident tables.

The port of ``curriculum_learning_for_vln_tpu/world/compiler.py``.  The
host side is the same numpy code (scipy all-pairs Dijkstra; the native
C++ solver is not used by the port), so the packed tables are equal
element for element.  ``device_tables`` returns torch tensors on the
requested device:

* candidate table   — per node: neighbor ids, absolute headings/elevations,
                      closest view indices
* distance table    — per node: geodesic distance to every node of its scan
* next-hop table    — per node: first step of the shortest path to every goal
* feature table     — [N, 36, D] panoramic features, f32 or bf16

Unlike the JAX package, the feature table's view axis is NOT padded
36 -> 40: that padding exists only for the TPU kernel's DMA tiling.
Index tables are int64, the index type torch's gathers take.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..utils.angles import ANGLE_INC, all_loc_embeddings
from .graph import ScanGraph, shortest_paths
from .synthetic import synthetic_features

MAX_CANDIDATES_DEFAULT = 16

PRECISIONS = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent,
    so an entry point never carries on on the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class WorldTables(NamedTuple):
    """Device-side packed world (torch tensors).

    Shapes: N = total nodes, L = max nodes per scan, MC = candidate slots,
    D = visual feature dim.
    """

    pos: torch.Tensor          # [N, 3] f32
    node_scan: torch.Tensor    # [N] i64
    node_local: torch.Tensor   # [N] i64
    cand_next: torch.Tensor    # [N, MC] i64   global node ids (self where invalid)
    cand_valid: torch.Tensor   # [N, MC] bool
    cand_heading: torch.Tensor # [N, MC] f32   absolute heading to candidate
    cand_elev: torch.Tensor    # [N, MC] f32   absolute elevation to candidate
    cand_view: torch.Tensor    # [N, MC] i64   closest view index (0..35)
    n_cands: torch.Tensor      # [N] i64
    dist: torch.Tensor         # [N, L] f32    geodesic distance to scan-local nodes
    next_hop: torch.Tensor     # [N, L] i64    global id of next node toward local goal
    features: torch.Tensor     # [N, 36, D]    panoramic visual features (f32 | bf16)
    loc_embed: torch.Tensor    # [36, 36, 128] f32 relative view embedding per viewIndex

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[0]

    @property
    def max_candidates(self) -> int:
        return self.cand_next.shape[1]

    @property
    def feat_dim(self) -> int:
        return self.features.shape[-1]


@dataclass
class CompiledWorld:
    """Host-side compiled world: numpy tables plus string-id bookkeeping."""

    scan_ids: List[str]
    node_ids: List[str]                     # global id -> "viewpointId"
    scan_offset: np.ndarray                 # [S+1]
    node_scan: np.ndarray                   # [N]
    node_local: np.ndarray                  # [N]
    pos: np.ndarray
    cand_next: np.ndarray
    cand_valid: np.ndarray
    cand_heading: np.ndarray
    cand_elev: np.ndarray
    cand_view: np.ndarray
    n_cands: np.ndarray
    dist: np.ndarray
    next_hop: np.ndarray
    features: Optional[np.ndarray] = None
    _id_map: Optional[Dict[str, Dict[str, int]]] = None

    # -- lookups ----------------------------------------------------------
    def global_id(self, scan: str, viewpoint: str) -> int:
        if self._id_map is None:
            self._id_map = {}
            for g, (s, vid) in enumerate(zip(self.node_scan, self.node_ids)):
                self._id_map.setdefault(self.scan_ids[s], {})[vid] = g
        return self._id_map[scan][viewpoint]

    def viewpoint_of(self, global_id: int) -> str:
        return self.node_ids[global_id]

    def scan_of(self, global_id: int) -> str:
        return self.scan_ids[int(self.node_scan[global_id])]

    def scan_dist(self, scan: str) -> np.ndarray:
        """[V, V] distance matrix of one scan (for the evaluator)."""
        s = self.scan_ids.index(scan)
        o, e = int(self.scan_offset[s]), int(self.scan_offset[s + 1])
        return self.dist[o:e, : e - o]

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[0]

    # -- on-disk cache (the JAX package's world.npz layout) -----------------
    _FIELDS = ("scan_offset", "node_scan", "node_local", "pos", "cand_next", "cand_valid",
               "cand_heading", "cand_elev", "cand_view", "n_cands", "dist", "next_hop")

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, scan_ids=np.array(self.scan_ids),
                            node_ids=np.array(self.node_ids),
                            **{k: getattr(self, k) for k in self._FIELDS})

    @staticmethod
    def load(path: str) -> "CompiledWorld":
        z = np.load(path, allow_pickle=False)
        return CompiledWorld(scan_ids=[str(s) for s in z["scan_ids"]],
                             node_ids=[str(s) for s in z["node_ids"]],
                             **{k: z[k] for k in CompiledWorld._FIELDS})

    # -- device export ----------------------------------------------------
    def device_tables(self, precision: str = "f32", device=None) -> WorldTables:
        """The packed tables on ``device`` (default CUDA; raises if absent),
        with the feature table in ``precision`` ("f32" | "bf16")."""
        if self.features is None:
            raise ValueError("CompiledWorld has no features attached")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
        device = resolve_device(device)

        def idx(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        return WorldTables(
            pos=f32(self.pos),
            node_scan=idx(self.node_scan),
            node_local=idx(self.node_local),
            cand_next=idx(self.cand_next),
            cand_valid=torch.from_numpy(self.cand_valid).to(device),
            cand_heading=f32(self.cand_heading),
            cand_elev=f32(self.cand_elev),
            cand_view=idx(self.cand_view),
            n_cands=idx(self.n_cands),
            dist=f32(self.dist),
            next_hop=idx(self.next_hop),
            # cast on the device: round-to-nearest-even, as numpy's bf16 cast
            features=f32(self.features).to(PRECISIONS[precision]),
            loc_embed=f32(all_loc_embeddings()),
        )


def candidate_geometry(src_pos: np.ndarray, dst_pos: np.ndarray):
    """Absolute heading/elevation/closest-view from one node to neighbors.

    Matterport convention: heading measured clockwise from the +y axis
    (atan2(dx, dy)), elevation from the horizontal plane.  The closest view
    is the discretized camera pose minimizing angular distance — the same
    view the reference's 36-view sweep dedup converges to
    (common_env.py:252-273).
    """
    d = dst_pos - src_pos[None, :]
    heading = np.arctan2(d[:, 0], d[:, 1])
    heading = np.mod(heading, 2 * np.pi)
    horiz = np.linalg.norm(d[:, :2], axis=-1)
    elevation = np.arctan2(d[:, 2], np.maximum(horiz, 1e-8))
    h_idx = np.mod(np.round(heading / ANGLE_INC).astype(np.int64), 12)
    e_row = np.clip(np.round(elevation / ANGLE_INC).astype(np.int64), -1, 1) + 1
    view = (e_row * 12 + h_idx).astype(np.int32)
    return heading.astype(np.float32), elevation.astype(np.float32), view


def compile_world(
    graphs: Dict[str, ScanGraph],
    max_candidates: int = MAX_CANDIDATES_DEFAULT,
    feature_fn: Optional[Callable[[str, str], np.ndarray]] = None,
    feature_dim: int = 2048,
    num_views: int = 36,
) -> CompiledWorld:
    """Compile scan graphs into packed tables.

    ``feature_fn(scan, viewpoint_id) -> [num_views, feature_dim]`` supplies
    panoramic features (precomputed ResNet TSV rows or synthetic).  When
    None, features are left unattached (attach later via
    ``attach_features``).  Shortest paths come from scipy's Dijkstra.
    """
    scan_ids = sorted(graphs)
    counts = [graphs[s].num_nodes for s in scan_ids]
    N = int(np.sum(counts))
    L = int(np.max(counts)) if counts else 0
    MC = max_candidates

    scan_offset = np.zeros(len(scan_ids) + 1, dtype=np.int32)
    np.cumsum(counts, out=scan_offset[1:])

    node_ids: List[str] = []
    node_scan = np.zeros(N, dtype=np.int32)
    node_local = np.zeros(N, dtype=np.int32)
    pos = np.zeros((N, 3), dtype=np.float32)
    cand_next = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, MC))
    cand_valid = np.zeros((N, MC), dtype=bool)
    cand_heading = np.zeros((N, MC), dtype=np.float32)
    cand_elev = np.zeros((N, MC), dtype=np.float32)
    cand_view = np.zeros((N, MC), dtype=np.int32)
    n_cands = np.zeros(N, dtype=np.int32)
    dist = np.full((N, L), 1e9, dtype=np.float32)
    next_hop = np.zeros((N, L), dtype=np.int32)

    for s, scan in enumerate(scan_ids):
        g = graphs[scan]
        off = int(scan_offset[s])
        V = g.num_nodes
        node_ids.extend(g.node_ids)
        node_scan[off : off + V] = s
        node_local[off : off + V] = np.arange(V)
        pos[off : off + V] = g.pos

        sd, snh = shortest_paths(g)
        dist[off : off + V, :V] = sd
        next_hop[off : off + V, :V] = snh + off

        for li, nbrs in enumerate(g.neighbors()):
            gi = off + li
            if len(nbrs) > MC:
                raise ValueError(
                    f"Node {scan}/{g.node_ids[li]} has {len(nbrs)} neighbors > MAX_CANDIDATES={MC}"
                )
            if len(nbrs) == 0:
                continue
            h, e, v = candidate_geometry(g.pos[li], g.pos[nbrs])
            order = np.lexsort((h, v))  # sweep-like ordering: by view, then heading
            nbrs, h, e, v = nbrs[order], h[order], e[order], v[order]
            k = len(nbrs)
            cand_next[gi, :k] = nbrs + off
            cand_valid[gi, :k] = True
            cand_heading[gi, :k] = h
            cand_elev[gi, :k] = e
            cand_view[gi, :k] = v
            n_cands[gi] = k

    world = CompiledWorld(
        scan_ids=scan_ids,
        node_ids=node_ids,
        scan_offset=scan_offset,
        node_scan=node_scan,
        node_local=node_local,
        pos=pos,
        cand_next=cand_next,
        cand_valid=cand_valid,
        cand_heading=cand_heading,
        cand_elev=cand_elev,
        cand_view=cand_view,
        n_cands=n_cands,
        dist=dist,
        next_hop=next_hop,
    )
    if feature_fn is not None:
        attach_features(world, feature_fn, feature_dim=feature_dim, num_views=num_views)
    return world


def attach_features(
    world: CompiledWorld,
    feature_fn: Callable[[str, str], np.ndarray],
    feature_dim: int = 2048,
    num_views: int = 36,
) -> None:
    feats = np.zeros((world.num_nodes, num_views, feature_dim), dtype=np.float32)
    for g in range(world.num_nodes):
        feats[g] = feature_fn(world.scan_of(g), world.node_ids[g])
    world.features = feats


def attach_synthetic_features(world: CompiledWorld, feature_dim: int = 2048, num_views: int = 36) -> None:
    attach_features(
        world,
        lambda scan, vid: synthetic_features(f"{scan}_{vid}", num_views, feature_dim),
        feature_dim=feature_dim,
        num_views=num_views,
    )
