"""The synthetic world and its traffic, made from a seed.

A frozen copy of the port's synthetic world (``world/synthetic.py``:
random geometric scans, k-nearest connectivity stitched connected,
R2R-format shortest paths of 4-6 edges), grown to Matterport3D / R2R
scale (Anderson et al., CVPR 2018) and returned as plain data that both
the program under test and the plain reference read:

* ``graphs``: scan id -> {"node_ids", "pos" [V, 3] f32, "edges" [E, 2]};
* training items: R2R-format paths (``scan``, ``path`` of viewpoint ids,
  ``heading``, three ``instructions``, ``path_id``) with a CLR2R round;
* serving requests: instruction, scan, start viewpoint, heading.

Every seed gets the same sizes: the node count of each scan and the
multiset of instruction lengths are fixed, and the seed draws the graphs,
the paths, the words and the order.  Instructions are words of the
vocabulary (alphanumeric, so the tokenizer maps each to one id).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

SPECIALS = ("<PAD>", "<UNK>", "<EOS>", "<BOS>")
LENGTH_SEED = 7  # the fixed draw of the instruction-length multiset


def scan_graph(scan_id: str, num_nodes: int, rng: np.random.Generator, extent: float = 20.0,
               floors: int = 2, k_nearest: int = 3) -> dict:
    """One scan: nodes over ``floors`` levels 3 m apart, each joined to its
    k nearest neighbours (symmetrised), components stitched by their
    nearest pair."""
    pos = np.empty((num_nodes, 3), dtype=np.float32)
    pos[:, 0] = rng.uniform(0, extent, num_nodes)
    pos[:, 1] = rng.uniform(0, extent, num_nodes)
    pos[:, 2] = rng.integers(0, floors, num_nodes) * 3.0 + rng.uniform(-0.2, 0.2, num_nodes)
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    edges = set()
    for i, row in enumerate(np.argsort(d2, axis=1)[:, :k_nearest]):
        for j in row:
            edges.add((min(i, int(j)), max(i, int(j))))
    parent = list(range(num_nodes))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        parent[find(a)] = find(b)
    while True:
        roots = np.array([find(i) for i in range(num_nodes)])
        if (roots == roots[0]).all():
            break
        inside = roots == roots[0]
        sub = d2[np.ix_(inside, ~inside)]
        ai, bj = np.unravel_index(np.argmin(sub), sub.shape)
        a, b = int(np.flatnonzero(inside)[ai]), int(np.flatnonzero(~inside)[bj])
        edges.add((min(a, b), max(a, b)))
        parent[find(a)] = find(b)
    return {"node_ids": [f"{scan_id}_vp{i:04d}" for i in range(num_nodes)], "pos": pos,
            "edges": np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)}


def scan_distances(g: dict):
    """(dist [V, V], predecessors) of a scan's Euclidean edge graph."""
    V = len(g["node_ids"])
    a, b = g["edges"][:, 0], g["edges"][:, 1]
    w = np.linalg.norm(g["pos"][a] - g["pos"][b], axis=-1)
    m = csr_matrix((np.concatenate([w, w]), (np.concatenate([a, b]), np.concatenate([b, a]))),
                   shape=(V, V))
    return dijkstra(m, directed=False, return_predecessors=True)


def make_graphs(world: dict, seed: int) -> Dict[str, dict]:
    """``world["scans"]`` scans holding ``world["panoramas"]`` nodes between
    them (sizes as even as the count allows, in an order drawn from the
    seed)."""
    S, N = world["scans"], world["panoramas"]
    sizes = np.full(S, N // S, dtype=np.int64)
    sizes[: N % S] += 1
    rng = np.random.default_rng([seed, 1])
    sizes = rng.permutation(sizes)
    return {f"scan{s:03d}": scan_graph(f"scan{s:03d}", int(sizes[s]), rng) for s in range(S)}


def split_scans(graphs: Dict[str, dict], world: dict) -> Dict[str, List[str]]:
    """The scans of each split, in order: train first, then val_unseen."""
    ids = sorted(graphs)
    n_train, n_unseen = world["train_scans"], world["val_unseen_scans"]
    return {"train": ids[:n_train], "val_unseen": ids[n_train: n_train + n_unseen]}


def length_table(lengths: dict, count: int) -> np.ndarray:
    """``count`` instruction lengths in words, the same multiset for every
    seed: a log-normal of the given mean and spread, clipped to [lo, hi]."""
    rng = np.random.default_rng(LENGTH_SEED)
    mu = np.log(lengths["mean_words"]) - 0.5 * lengths["log_sd"] ** 2
    n = np.exp(rng.normal(mu, lengths["log_sd"], count))
    return np.clip(np.round(n), lengths["min_words"], lengths["max_words"]).astype(np.int64)


def words_of(vocab: List[str]) -> List[str]:
    return [w for w in vocab if w not in SPECIALS and w.isalnum()]


def walk(pred: np.ndarray, start: int, goal: int) -> List[int]:
    """The shortest path start -> goal from the predecessors of ``start``'s
    Dijkstra (row ``start``)."""
    path = [goal]
    while path[-1] != start:
        path.append(int(pred[start, path[-1]]))
    return path[::-1]


def make_paths(graphs: Dict[str, dict], scans: List[str], spec: dict, vocab: List[str],
               seed: int) -> List[dict]:
    """``spec["paths"]`` R2R-format paths of ``min_hops``-``max_hops`` edges
    on ``scans``, each with ``instructions_per_path`` instructions of the
    fixed length multiset, in an order drawn from the seed, and a CLR2R
    round of 1..``rounds``."""
    rng = np.random.default_rng([seed, 2])
    per = spec["instructions_per_path"]
    lengths = rng.permutation(length_table(spec["lengths"], spec["paths"] * per))
    words = np.array(words_of(vocab))
    cache = {}
    items = []
    for p in range(spec["paths"]):
        scan = scans[int(rng.integers(len(scans)))]
        g = graphs[scan]
        if scan not in cache:
            cache[scan] = scan_distances(g)
        dist, pred = cache[scan]
        V = len(g["node_ids"])
        while True:
            start, goal = int(rng.integers(V)), int(rng.integers(V))
            if start != goal and np.isfinite(dist[start, goal]):
                path = walk(pred, start, goal)
                if spec["min_hops"] <= len(path) - 1 <= spec["max_hops"]:
                    break
        instrs = [" ".join(rng.choice(words, int(n)).tolist())
                  for n in lengths[p * per:(p + 1) * per]]
        items.append({"scan": scan, "path_id": p, "path": [g["node_ids"][i] for i in path],
                      "heading": float(rng.uniform(0, 2 * np.pi)), "instructions": instrs,
                      "distance": float(dist[start, goal]),
                      "round": int(rng.integers(1, spec["rounds"] + 1))})
    return items


def make_requests(graphs: Dict[str, dict], scans: List[str], spec: dict, vocab: List[str],
                  seed: int) -> List[dict]:
    """``spec["requests"]`` serving requests on ``scans``: a start viewpoint,
    a heading and an instruction of ``joins`` R2R lengths joined (R4R's
    construction, Jain et al., ACL 2019), held to ``min_words``-``max_words``
    words."""
    rng = np.random.default_rng([seed, 3])
    n, joins = spec["requests"], spec["joins"]
    lengths = length_table(spec["lengths"], n * joins).reshape(n, joins).sum(axis=1)
    lengths = rng.permutation(np.clip(lengths, spec["min_words"], spec["max_words"]))
    words = np.array(words_of(vocab))
    out = []
    for i in range(n):
        scan = scans[int(rng.integers(len(scans)))]
        g = graphs[scan]
        start = g["node_ids"][int(rng.integers(len(g["node_ids"])))]
        out.append({"instruction": " ".join(rng.choice(words, int(lengths[i])).tolist()),
                    "scan": scan, "start_viewpoint": start,
                    "heading": float(rng.uniform(0, 2 * np.pi))})
    return out


def read_vocab(path) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]
