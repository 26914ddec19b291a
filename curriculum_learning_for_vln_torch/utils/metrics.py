"""Trajectory evaluation metrics: DTW family and CLS.

A copy of ``curriculum_learning_for_vln_tpu/utils/metrics.py`` (numpy only), kept
in the port so that it imports nothing of the JAX package.

Formula-parity with the reference implementations
(`tasks/R2R-judy/src/utils/dtw.py:55-82`, `src/utils/cls.py:64-90`),
including their doctest golden values (reproduced in tests/test_metrics.py
on a 3x4 grid graph).  The API is graph-library-free: a ``distance``
accessor maps a pair of nodes to geodesic distance; nodes may be strings,
ints, or tuples.

Besides the per-item classes there is a vectorized ``batched_ndtw_sdtw``
that computes the DTW DP over a whole batch of padded integer-node paths
with one numpy sweep — the evaluator's fast path (the reference runs an
O(|P|·|R|) Python loop per item).
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

import numpy as np

DistanceLike = Union[Callable, dict]


def _accessor(distance: DistanceLike) -> Callable:
    if callable(distance):
        return distance
    return lambda u, v: distance[u][v]


class DTW:
    """Dynamic-time-warping metrics (dtw / ndtw / sdtw).

    ndtw = exp(-dtw / (threshold * len(reference)));
    sdtw = success * ndtw with success = d(pred[-1], ref[-1]) <= threshold.
    (ref: dtw.py:66-82)
    """

    def __init__(self, distance: DistanceLike, threshold: float = 3.0):
        self.distance = _accessor(distance)
        self.threshold = threshold

    def __call__(self, prediction: Sequence, reference: Sequence, metric=("sdtw",)) -> List[float]:
        if isinstance(metric, str):
            metric = [metric]
        assert set(metric) <= {"ndtw", "sdtw", "dtw"}

        d = self.distance
        np_, nr = len(prediction), len(reference)
        dp = np.full((np_ + 1, nr + 1), np.inf)
        dp[0][0] = 0.0
        for i in range(1, np_ + 1):
            for j in range(1, nr + 1):
                best_prev = min(dp[i - 1][j], dp[i][j - 1], dp[i - 1][j - 1])
                dp[i][j] = d(prediction[i - 1], reference[j - 1]) + best_prev
        dtw = dp[np_][nr]

        ndtw = math.exp(-dtw / (self.threshold * nr))
        success = d(prediction[-1], reference[-1]) <= self.threshold
        sdtw = ndtw if success else 0.0
        values = {"dtw": dtw, "ndtw": ndtw, "sdtw": sdtw}
        return [values[k] for k in metric]


class CLS:
    """Coverage weighted by Length Score (arXiv:1905.12255; ref: cls.py:64-90)."""

    def __init__(self, distance: DistanceLike, threshold: float = 3.0):
        self.distance = _accessor(distance)
        self.threshold = threshold

    def __call__(self, prediction: Sequence, reference: Sequence) -> float:
        d = self.distance

        def length(nodes):
            return float(sum(d(a, b) for a, b in zip(nodes[:-1], nodes[1:])))

        coverage = float(
            np.mean([math.exp(-min(d(u, v) for v in prediction) / self.threshold) for u in reference])
        )
        expected = coverage * length(reference)
        pred_len = length(prediction)
        score = expected / (expected + abs(expected - pred_len))
        return coverage * score


def path_length(distance: DistanceLike, nodes: Sequence) -> float:
    d = _accessor(distance)
    return float(sum(d(a, b) for a, b in zip(nodes[:-1], nodes[1:])))


# ---------------------------------------------------------------------------
# Vectorized batch metrics over padded integer node paths
# ---------------------------------------------------------------------------

def batched_ndtw_sdtw(
    dist: np.ndarray,
    pred: np.ndarray,
    pred_len: np.ndarray,
    ref: np.ndarray,
    ref_len: np.ndarray,
    threshold: float = 3.0,
):
    """Vectorized nDTW/SDTW for a batch of padded local-node-index paths.

    Args:
      dist: [N, N] geodesic distance matrix (one scan) or a [B, Tp, Tr]
            precomputed cost tensor is NOT accepted — nodes index ``dist``.
      pred: [B, Tp] int node indices, padded arbitrarily past ``pred_len``.
      pred_len / ref_len: [B] true lengths (>= 1).
      ref: [B, Tr] int node indices.

    Returns (ndtw[B], sdtw[B]) float64 arrays, identical to per-item DTW.
    """
    B, Tp = pred.shape
    Tr = ref.shape[1]
    cost = dist[pred[:, :, None], ref[:, None, :]]  # [B, Tp, Tr]

    INF = np.inf
    dp = np.full((B, Tp + 1, Tr + 1), INF)
    dp[:, 0, 0] = 0.0
    for i in range(1, Tp + 1):
        # vectorized over j via running-min scan: dp[i,j] depends on dp[i,j-1]
        prev = dp[:, i - 1, :]  # [B, Tr+1]
        row = np.full((B, Tr + 1), INF)
        for j in range(1, Tr + 1):
            best_prev = np.minimum(np.minimum(prev[:, j], row[:, j - 1]), prev[:, j - 1])
            row[:, j] = cost[:, i - 1, j - 1] + best_prev
        dp[:, i, :] = row

    idx = np.arange(B)
    dtw = dp[idx, pred_len, ref_len]
    ndtw = np.exp(-dtw / (threshold * ref_len))
    last_p = pred[idx, pred_len - 1]
    last_r = ref[idx, ref_len - 1]
    success = dist[last_p, last_r] <= threshold
    sdtw = np.where(success, ndtw, 0.0)
    return ndtw, sdtw
