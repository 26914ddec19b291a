"""Synthetic navigation worlds for tests and benchmarking.

The Matterport connectivity data and ResNet feature TSV are external
multi-GB assets the reference assumes pre-downloaded (README.md:45-67).
This module generates structurally equivalent stand-ins — random geometric
indoor-style graphs, R2R-format episode datasets over them, and
deterministic pseudo-features — so every code path (world compiler, pure
env, agents, trainers, eval) runs end-to-end and can be benchmarked with
zero external data.  Generation is fully seeded and reproducible.

A copy of ``curriculum_learning_for_vln_tpu/world/synthetic.py`` so the
PyTorch port imports nothing of the JAX package.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import ScanGraph, shortest_paths


def make_scan_graph(
    scan_id: str,
    num_nodes: int = 64,
    seed: int = 0,
    extent: float = 20.0,
    floors: int = 2,
    k_nearest: int = 3,
) -> ScanGraph:
    """Random geometric graph resembling a Matterport scan.

    Nodes are scattered in an extent x extent footprint across ``floors``
    z-levels (3 m apart); each node connects to its k nearest neighbors
    (symmetrized), and the graph is stitched connected by linking each
    disconnected component to its nearest outside neighbor.
    """
    rng = np.random.default_rng(seed)
    pos = np.empty((num_nodes, 3), dtype=np.float32)
    pos[:, 0] = rng.uniform(0, extent, num_nodes)
    pos[:, 1] = rng.uniform(0, extent, num_nodes)
    pos[:, 2] = rng.integers(0, floors, num_nodes) * 3.0 + rng.uniform(-0.2, 0.2, num_nodes)

    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    edge_set = set()
    order = np.argsort(d2, axis=1)
    for i in range(num_nodes):
        for j in order[i, :k_nearest]:
            edge_set.add((min(i, int(j)), max(i, int(j))))

    # stitch components together
    parent = list(range(num_nodes))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for a, b in edge_set:
        union(a, b)
    while True:
        roots = {find(i) for i in range(num_nodes)}
        if len(roots) == 1:
            break
        comp = find(0)
        in_comp = np.array([find(i) == comp for i in range(num_nodes)])
        sub = d2[np.ix_(in_comp, ~in_comp)]
        ai, bj = np.unravel_index(np.argmin(sub), sub.shape)
        a = np.where(in_comp)[0][ai]
        b = np.where(~in_comp)[0][bj]
        edge_set.add((min(int(a), int(b)), max(int(a), int(b))))
        union(int(a), int(b))

    node_ids = [f"{scan_id}_vp{i:04d}" for i in range(num_nodes)]
    edges = np.array(sorted(edge_set), dtype=np.int32).reshape(-1, 2)
    return ScanGraph(scan_id=scan_id, node_ids=node_ids, pos=pos, edges=edges)


def make_world_graphs(
    num_scans: int = 8, nodes_per_scan: int = 64, seed: int = 0
) -> Dict[str, ScanGraph]:
    return {
        f"synth{scan:03d}": make_scan_graph(f"synth{scan:03d}", nodes_per_scan, seed * 1000 + scan)
        for scan in range(num_scans)
    }


_WORD_POOL = [
    "walk", "to", "the", "turn", "left", "right", "go", "down", "up", "stairs",
    "door", "room", "past", "stop", "at", "table", "into", "through", "hallway",
    "kitchen", "and", "then", "straight", "wait", "near", "exit", "front", "of",
]


def make_r2r_dataset(
    graphs: Dict[str, ScanGraph],
    num_paths: int = 64,
    seed: int = 0,
    min_hops: int = 4,
    max_hops: int = 6,
    instructions_per_path: int = 3,
    path_id_base: int = 0,
    scans: Optional[Sequence[str]] = None,
) -> List[dict]:
    """R2R-format items (scan / path / heading / distance / instructions)
    whose paths are exact shortest paths, like real R2R."""
    rng = np.random.default_rng(seed)
    scan_list = list(scans) if scans is not None else sorted(graphs)
    sp_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    items = []
    for p in range(num_paths):
        scan = scan_list[int(rng.integers(len(scan_list)))]
        g = graphs[scan]
        if scan not in sp_cache:
            sp_cache[scan] = shortest_paths(g)
        dist, nh = sp_cache[scan]
        hops = int(rng.integers(min_hops, max_hops + 1))
        for _ in range(50):
            start = int(rng.integers(g.num_nodes))
            # candidates at exactly `hops` graph hops: approximate by distance ranking
            goal = int(rng.integers(g.num_nodes))
            path = _walk(nh, start, goal)
            if len(path) - 1 >= min_hops and len(path) - 1 <= max_hops and dist[start, goal] < 1e8:
                break
        else:
            continue
        n_words = int(rng.integers(8, 18))
        instrs = [
            " ".join(rng.choice(_WORD_POOL, n_words).tolist()) + " ."
            for _ in range(instructions_per_path)
        ]
        items.append(
            {
                "distance": float(round(dist[start, goal], 2)),
                "scan": scan,
                "path_id": path_id_base + p,
                "path": [g.node_ids[i] for i in path],
                "heading": float(rng.uniform(0, 2 * np.pi)),
                "instructions": instrs,
            }
        )
    return items


def _walk(next_hop: np.ndarray, start: int, goal: int) -> List[int]:
    path = [start]
    cur = start
    for _ in range(next_hop.shape[0]):
        if cur == goal:
            break
        cur = int(next_hop[cur, goal])
        path.append(cur)
    return path


def synthetic_features(
    scan_node_key: str, num_views: int = 36, dim: int = 2048, dtype=np.float32
) -> np.ndarray:
    """Deterministic pseudo ResNet features for one viewpoint, seeded from
    its string key so regeneration is stable across processes."""
    h = int.from_bytes(hashlib.sha1(scan_node_key.encode()).digest()[:8], "little")
    rng = np.random.default_rng(h)
    return rng.standard_normal((num_views, dim)).astype(dtype) * 0.5 + 0.5


# ---------------------------------------------------------------------------
# Grounded synthetic worlds: a *learnable* VLN task with zero external data
# ---------------------------------------------------------------------------
#
# Plain synthetic features are per-node random hashes and instructions are
# word salad, so navigation on held-out scans is unlearnable by
# construction — fine for perf/micro tests, useless for training-quality
# comparisons.  The grounded mode assigns every node a room type from a
# GLOBAL vocabulary, makes each view's feature encode the room type of the
# neighbor reachable in that direction (shared room embeddings -> transfers
# to unseen scans), and generates instructions as the path's room-type
# sequence.  An agent that grounds instruction tokens in candidate features
# can then genuinely learn the task — the statistical parity harness
# (scripts/parity_matrix.py) trains on these worlds.

ROOM_TYPES = [
    "kitchen", "hallway", "bedroom", "bathroom", "office", "lounge",
    "garage", "stairway", "porch", "closet", "library", "dining",
]

_STARTERS = ["walk to the", "go to the", "head to the", "move to the"]
_JOINERS = ["then", "and then", "next", "after that"]


def assign_rooms(world, seed: int = 0) -> np.ndarray:
    """Global [num_nodes] room-type index per viewpoint, seeded from each
    node's string id so it is stable across processes and node orderings."""
    rooms = np.empty(world.num_nodes, dtype=np.int32)
    for g in range(world.num_nodes):
        key = f"{world.scan_of(g)}_{world.node_ids[g]}_room_{seed}"
        h = int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "little")
        rooms[g] = h % len(ROOM_TYPES)
    return rooms


def attach_grounded_features(world, rooms: np.ndarray, feature_dim: int = 2048,
                             noise: float = 0.3, seed: int = 0) -> None:
    """Features where view v at node u encodes the room type of the
    neighbor reached through v (plus noise).  Room embeddings are global —
    the visual grounding transfers to held-out scans, like real ResNet
    features of real room types."""
    rng = np.random.default_rng(seed)
    room_emb = rng.standard_normal((len(ROOM_TYPES), feature_dim)).astype(np.float32)
    feats = (rng.standard_normal((world.num_nodes, 36, feature_dim)) * noise).astype(np.float32)
    for g in range(world.num_nodes):
        for j in range(int(world.n_cands[g])):
            v = int(world.cand_view[g, j])
            nxt = int(world.cand_next[g, j])
            feats[g, v] += room_emb[rooms[nxt]]
    world.features = feats


_VAGUE = ["room", "area"]  # generic stand-ins for an under-specified clause


def grounded_instruction(room_seq: List[int], rng, corrupt: float = 0.0) -> str:
    """Instruction text for a path whose nodes (after the start) have the
    given room types, e.g. 'walk to the kitchen then go to the hallway .'

    ``corrupt`` in [0, 1] injects the degradations real low-quality R2R
    instructions exhibit (the difficulty signal the CLR2R scorer is built
    to detect, ref: tasks/R2R-judy/src/agent/vln_bert.py:24-75 over real
    annotator variance):

    * landmark sparsity — intermediate clauses dropped with p=0.7*corrupt
      (the final clause always survives, so the item stays solvable);
    * ambiguity — a clause's room type replaced by a generic word
      ("room"/"area") with p=0.5*corrupt;
    * distractors — a clause naming a room type that is NOT the next stop
      inserted with p=0.5*corrupt.

    At corrupt=0 this reproduces the original fully-specified generator
    (template-uniform, zero difficulty variance — the round-3 e2e study's
    honest-negative harness limitation)."""
    names = []
    for i, r in enumerate(room_seq):
        last = i == len(room_seq) - 1
        if not last and corrupt > 0 and rng.random() < 0.7 * corrupt:
            continue  # landmark sparsity: this waypoint goes unmentioned
        name = ROOM_TYPES[r]
        if corrupt > 0 and rng.random() < 0.5 * corrupt:
            name = _VAGUE[int(rng.integers(len(_VAGUE)))]  # ambiguity
        if not last and corrupt > 0 and rng.random() < 0.5 * corrupt:
            # distractor: an off-path room type, inserted as a real clause
            # (never after the stop clause — the goal stays unambiguous)
            names.append((ROOM_TYPES[int(rng.integers(len(ROOM_TYPES)))], False))
        names.append((name, last))
    parts = []
    for i, (name, last) in enumerate(names):
        starter = _STARTERS[int(rng.integers(len(_STARTERS)))]
        if last:
            joiner = f"{_JOINERS[int(rng.integers(len(_JOINERS)))]} " if i else ""
            parts.append(f"{joiner}stop at the {name}")
        elif i == 0:
            parts.append(f"{starter} {name}")
        else:
            parts.append(f"{_JOINERS[int(rng.integers(len(_JOINERS)))]} {starter} {name}")
    return " ".join(parts) + " ."


def make_grounded_dataset(
    graphs: Dict[str, ScanGraph],
    world,
    rooms: np.ndarray,
    num_paths: int = 64,
    seed: int = 0,
    min_hops: int = 3,
    max_hops: int = 6,
    instructions_per_path: int = 3,
    path_id_base: int = 0,
    scans: Optional[Sequence[str]] = None,
    heterogeneity: float = 0.0,
) -> List[dict]:
    """R2R-format items whose instructions describe the path's room-type
    sequence (see attach_grounded_features).

    ``heterogeneity`` > 0 gives each path a latent difficulty d ~ U(0,1)
    and corrupts its instructions at level d*heterogeneity (see
    grounded_instruction) — the ground truth is recorded as
    ``item["difficulty"]`` so curriculum-construction studies can check
    scorer-recovered difficulty against it (scripts/clr2r_e2e.py)."""
    rng = np.random.default_rng(seed)
    scan_list = list(scans) if scans is not None else sorted(graphs)
    sp_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    items = []
    for p in range(num_paths):
        scan = scan_list[int(rng.integers(len(scan_list)))]
        g = graphs[scan]
        if scan not in sp_cache:
            sp_cache[scan] = shortest_paths(g)
        dist, nh = sp_cache[scan]
        for _ in range(50):
            start = int(rng.integers(g.num_nodes))
            goal = int(rng.integers(g.num_nodes))
            path = _walk(nh, start, goal)
            if min_hops <= len(path) - 1 <= max_hops and dist[start, goal] < 1e8:
                break
        else:
            continue
        room_seq = [int(rooms[world.global_id(scan, g.node_ids[i])]) for i in path[1:]]
        d = float(rng.uniform(0.0, 1.0)) if heterogeneity > 0 else 0.0
        instrs = [grounded_instruction(room_seq, rng, corrupt=d * heterogeneity)
                  for _ in range(instructions_per_path)]
        item = {
            "distance": float(round(dist[start, goal], 2)),
            "scan": scan,
            "path_id": path_id_base + p,
            "path": [g.node_ids[i] for i in path],
            "heading": float(rng.uniform(0, 2 * np.pi)),
            "instructions": instrs,
        }
        if heterogeneity > 0:
            item["difficulty"] = d  # latent ground truth, diagnostics only
        items.append(item)
    return items
