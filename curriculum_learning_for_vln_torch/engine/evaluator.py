"""Trajectory evaluation (ref: tasks/R2R-judy/src/engine/evaluator.py).

A copy of ``curriculum_learning_for_vln_tpu/engine/evaluator.py`` (numpy only), kept
in the port so that it imports nothing of the JAX package.

Same contract as the reference ``Evaluation``: init from ground-truth
splits, ``score(results)`` over a list of
``{"instr_id", "trajectory": [(viewpoint, heading, elevation), ...]}``
dicts with exact-coverage assertions (evaluator.py:124-126), producing
the summary dict of PL / NE / OSR / steps / SPL / nDTW / SDTW / CLS plus
SR/OSR at the 3 m margin (evaluator.py:128-146).

Distances come from the compiled world's packed tables rather than
networkx; metric math is shared with utils.metrics (reference-doctest
golden-tested).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.metrics import CLS, batched_ndtw_sdtw
from ..world.compiler import CompiledWorld

ERROR_MARGIN = 3.0  # meters (ref: evaluator.py:22)


class Evaluation:
    def __init__(self, world: CompiledWorld, items: Sequence[dict], data_name: str = "R2R",
                 splits: Sequence[str] = ()):
        self.world = world
        self.error_margin = ERROR_MARGIN
        self.dataset = data_name
        self.splits = list(splits)
        # gt is keyed by str(path_id): R2R path ids are ints, but R4R
        # joined ids ("<a>j<b>", data/datasets.py::make_r4r_items) are not
        self.gt: Dict[str, dict] = {}
        self.instr_ids = set()
        self.instr2path: Dict[str, str] = {}
        for item in items:
            self.gt[str(item["path_id"])] = item
            if data_name in ("R2R", "CLR2R", "R4R"):
                # exactly 3 instructions per path (ref: evaluator.py:35)
                self.instr_ids.update(f"{item['path_id']}_{i}" for i in range(3))
            elif data_name == "RxR":
                self.instr_ids.add(item["instruction_id"])
                self.instr2path[item["instruction_id"]] = str(item["path_id"])
            else:
                raise NotImplementedError(data_name)
        self._dist_cache: Dict[str, np.ndarray] = {}

    def _dist(self, scan: str) -> np.ndarray:
        if scan not in self._dist_cache:
            self._dist_cache[scan] = self.world.scan_dist(scan)
        return self._dist_cache[scan]

    def _local(self, scan: str, viewpoint: str) -> int:
        return int(self.world.node_local[self.world.global_id(scan, viewpoint)])

    def _score_item(self, scores, instr_id: str, path: List[Tuple[str, float, float]]):
        if self.dataset == "RxR":
            gt = self.gt[self.instr2path[instr_id]]
        else:
            # instr_id = "<path_id>_<j>" (ref: evaluator.py:60 int-parses;
            # rsplit keeps non-numeric R4R joined path ids working)
            gt = self.gt[str(instr_id).rsplit("_", 1)[0]]
        scan = gt["scan"]
        dist = self._dist(scan)
        loc = lambda vp: self._local(scan, vp)

        start = gt["path"][0]
        assert start == path[0][0], "Result trajectories should include the start position"
        goal = loc(gt["path"][-1])
        pred_nodes = [loc(p[0]) for p in path]
        gt_nodes = [loc(v) for v in gt["path"]]

        final = pred_nodes[-1]
        nearest = pred_nodes[int(np.argmin([dist[p, goal] for p in pred_nodes]))]

        scores["nav_errors"].append(float(dist[final, goal]))
        scores["oracle_errors"].append(float(dist[nearest, goal]))
        scores["trajectory_steps"].append(len(path) - 1)

        d_access = lambda u, v: dist[u, v]
        # nDTW/SDTW are deferred: collected per scan and computed by the
        # vectorized batched_ndtw_sdtw sweep at the end of score() (the
        # reference runs an O(|P|*|R|) Python DP per item, dtw.py:55-82)
        self._dtw_pending.append((scan, pred_nodes, gt_nodes))
        scores["clss"].append(float(CLS(d_access, threshold=self.error_margin)(pred_nodes, gt_nodes)))

        length = float(sum(dist[a, b] for a, b in zip(pred_nodes[:-1], pred_nodes[1:])))
        scores["trajectory_lengths"].append(length)
        is_success = dist[final, goal] < self.error_margin

        if self.splits == ["test"]:
            scores["success_path_length"].append(0.0)
        else:
            sg = dist[loc(start), goal]
            scores["success_path_length"].append(float(is_success * sg / max(sg, length)))

    def score(self, output) -> Tuple[dict, dict]:
        """Score a result list or a JSON results file path."""
        import json

        scores = defaultdict(list)
        remaining = set(self.instr_ids)
        self._dtw_pending: List[Tuple[str, List[int], List[int]]] = []
        if isinstance(output, str):
            with open(output) as f:
                output = json.load(f)
        if not isinstance(output, list):
            raise NotImplementedError(type(output))
        for item in output:
            if item["instr_id"] in remaining:
                remaining.remove(item["instr_id"])
                self._score_item(scores, item["instr_id"], item["trajectory"])
        assert len(remaining) == 0, (
            f"Missing {len(remaining)} of {len(self.instr_ids)} instruction ids"
        )
        assert len(scores["nav_errors"]) == len(self.instr_ids)

        # vectorized nDTW/SDTW, one DP sweep per scan group
        n = len(self._dtw_pending)
        ndtws = np.zeros(n)
        sdtws = np.zeros(n)
        by_scan: Dict[str, List[int]] = defaultdict(list)
        for i, (scan, _, _) in enumerate(self._dtw_pending):
            by_scan[scan].append(i)
        for scan, idxs in by_scan.items():
            dist = self._dist(scan)
            preds = [self._dtw_pending[i][1] for i in idxs]
            refs = [self._dtw_pending[i][2] for i in idxs]
            tp = max(len(p) for p in preds)
            tr = max(len(r) for r in refs)
            pred = np.zeros((len(idxs), tp), dtype=np.int64)
            ref = np.zeros((len(idxs), tr), dtype=np.int64)
            plen = np.array([len(p) for p in preds])
            rlen = np.array([len(r) for r in refs])
            for k, (p, r) in enumerate(zip(preds, refs)):
                pred[k, : len(p)] = p
                ref[k, : len(r)] = r
            nd, sd = batched_ndtw_sdtw(dist, pred, plen, ref, rlen, self.error_margin)
            ndtws[idxs] = nd
            sdtws[idxs] = sd
        scores["ndtws"] = [float(x) for x in ndtws]
        scores["sdtws"] = [float(x) for x in sdtws]

        summary = {
            "nav_error": float(np.average(scores["nav_errors"])),
            "oracle_error": float(np.average(scores["oracle_errors"])),
            "steps": float(np.average(scores["trajectory_steps"])),
            "lengths": float(np.average(scores["trajectory_lengths"])),
            "spl": float(np.average(scores["success_path_length"])),
            "ndtw": float(np.average(scores["ndtws"])),
            "sdtw": float(np.average(scores["sdtws"])),
            "cls": float(np.average(scores["clss"])),
        }
        num_success = sum(1 for e in scores["nav_errors"] if e < self.error_margin)
        summary["success_rate"] = num_success / len(scores["nav_errors"])
        num_oracle = sum(1 for e in scores["oracle_errors"] if e < self.error_margin)
        summary["oracle_rate"] = num_oracle / len(scores["oracle_errors"])
        return summary, dict(scores)
