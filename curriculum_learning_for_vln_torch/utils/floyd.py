"""Incremental all-pairs shortest paths for beam-search path stitching.

The port of ``curriculum_learning_for_vln_tpu/utils/floyd.py``, pure
Python and the same behaviour (ref: tasks/R2R-judy/src/utils/misc.py:
493-542): distances and via-points live in flat ``(x, y)``-keyed dicts
(missing = unreachable), ``update(k)`` is one Floyd-Warshall pivot
relaxation through a newly visited node, and ``path(x, y)`` rebuilds the
stitched route iteratively with an explicit stack.  Host-side only: it
shortens the physical walk the beam search leaves behind (agents/beam.py).
"""
from __future__ import annotations

import math
from typing import Dict, Hashable, List, Optional, Tuple


class FloydGraph:
    def __init__(self):
        # (x, y) -> best known distance; symmetric, absent = infinity
        self._dist: Dict[Tuple[Hashable, Hashable], float] = {}
        # (x, y) -> intermediate pivot on the best path, or None for a
        # direct edge
        self._via: Dict[Tuple[Hashable, Hashable], Optional[Hashable]] = {}
        self._nodes: set = set()
        self._visited: set = set()

    def distance(self, x: Hashable, y: Hashable) -> float:
        if x == y:
            return 0
        return self._dist.get((x, y), math.inf)

    def add_edge(self, x: Hashable, y: Hashable, dis: float) -> None:
        if dis < self.distance(x, y):
            self._dist[(x, y)] = self._dist[(y, x)] = dis
            self._via[(x, y)] = self._via[(y, x)] = None
        self._nodes.add(x)
        self._nodes.add(y)

    def update(self, k: Hashable) -> None:
        """Relax every pair through pivot ``k`` (one Floyd-Warshall
        sweep); call when the beam search physically visits ``k``."""
        for x in self._nodes:
            if x == k:
                continue
            d_xk = self.distance(x, k)
            if math.isinf(d_xk):
                continue
            for y in self._nodes:
                if y == k or y == x:
                    continue
                d = d_xk + self.distance(k, y)
                if d < self.distance(x, y):
                    self._dist[(x, y)] = self._dist[(y, x)] = d
                    self._via[(x, y)] = self._via[(y, x)] = k
        self._visited.add(k)

    def visited(self, k: Hashable) -> bool:
        return k in self._visited

    def path(self, x: Hashable, y: Hashable) -> List[Hashable]:
        """Route from x to y as [v1, ..., y] (x excluded), expanding
        pivots with an explicit work stack (left-to-right order)."""
        if x == y:
            return []
        out: List[Hashable] = []
        stack: List[Tuple[Hashable, Hashable]] = [(x, y)]
        while stack:
            a, b = stack.pop()
            k = self._via.get((a, b))
            if k is None:
                out.append(b)  # direct edge (or unknown pair): hop to b
            else:
                # expand (a, k) before (k, b): push in reverse order
                stack.append((k, b))
                stack.append((a, k))
        return out
