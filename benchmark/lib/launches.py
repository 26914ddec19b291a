"""The observation step's kernel launches (K4-K7) of the traced steps, read
where the port calls them, so that each launch's bound counts the rows
it is asked to read.

While recording, the port's entries ``ops/cuda/pano_fused.pano_attend``
(K4), ``pano_attend_bwd`` (K5), ``ops/cuda/cand_score.cand_score`` (K6)
and ``cand_score_bwd`` (K7) are wrapped: each launch keeps a copy, on the
card, of the panorama, view and candidate-view indices it was given and
its shapes, and calls the port's entry unchanged.  The distinct
panoramas and views are counted once the traced steps have ended.  The
copies run inside the span ``bench.record``: they are the benchmark's
host operations, not the program's (a few device copies of a few KiB
each remain in the device time).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from . import costs
from .harness import span

RECORD = "record"  # the span of the recorder's own copies, which metrics/host_ops leaves out


class Launch(NamedTuple):
    kernel: str                  # "pano_fwd", "pano_bwd", "cand_fwd", "cand_bwd"
    B: int
    V: int
    D: int
    A: int
    MC: int
    dtype: str
    seeded: bool
    nodes: Optional[torch.Tensor] = None
    views: Optional[torch.Tensor] = None
    cand_view: Optional[torch.Tensor] = None


def _dtype(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _seeded(drop) -> bool:
    return getattr(drop, "seeds", None) is not None


class Recorder:
    """``start()`` wraps the port's entries, ``stop()`` puts them back."""

    def __init__(self):
        self.launches: List[Launch] = []
        self._saved = []

    def start(self) -> None:
        from curriculum_learning_for_vln_torch.ops.cuda import cand_score as cs
        from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as pf

        keep = self.launches.append

        def pano_fwd(nodes, views, cand_view, features, loc_embed, tv, *a, _f=pf.pano_attend,
                     **k):
            drop = a[0] if a else k.get("drop")
            _n, V, D = features.shape
            with span(RECORD):
                keep(Launch("pano_fwd", nodes.shape[0], V, D, loc_embed.shape[-1],
                            cand_view.shape[1], _dtype(features), _seeded(drop), nodes.clone(),
                            views.clone(), cand_view.clone()))
            return _f(nodes, views, cand_view, features, loc_embed, tv, *a, **k)

        def pano_bwd(nodes, views, features, loc_embed, *a, _f=pf.pano_attend_bwd, **k):
            drop = a[2] if len(a) > 2 else k.get("drop")
            _n, V, D = features.shape
            with span(RECORD):
                keep(Launch("pano_bwd", nodes.shape[0], V, D, loc_embed.shape[-1], 0,
                            _dtype(features), _seeded(drop), nodes.clone(), views.clone()))
            return _f(nodes, views, features, loc_embed, *a, **k)

        def cand(kernel, f):
            def wrapped(cand_img, cand_angle, *a, **k):
                drop = a[2] if len(a) > 2 else k.get("drop")
                B, MC, D = cand_img.shape
                keep(Launch(kernel, B, 0, D, cand_angle.shape[-1], MC, _dtype(cand_img),
                            _seeded(drop)))
                return f(cand_img, cand_angle, *a, **k)
            return wrapped

        for mod, name, new in ((pf, "pano_attend", pano_fwd), (pf, "pano_attend_bwd", pano_bwd),
                               (cs, "cand_score", cand("cand_fwd", cs.cand_score)),
                               (cs, "cand_score_bwd", cand("cand_bwd", cs.cand_score_bwd))):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)

    def stop(self) -> None:
        for mod, name, old in reversed(self._saved):
            setattr(mod, name, old)
        self._saved = []

    def count(self, kernel: str) -> int:
        return sum(1 for x in self.launches if x.kernel == kernel)


def distinct(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def observation_bounds(launches: List[Launch]) -> dict:
    """Bounds (s) of a training step's observation launches: K4 and K5 by
    the distinct panoramas and views each read, K6 and K7 by their rows."""
    out = {"pano": 0.0, "cand_fwd": 0.0, "cand_bwd": 0.0}
    for x in launches:
        if x.kernel in ("pano_fwd", "pano_bwd"):
            b = costs.pano_bounds(x.B, distinct(x.nodes), distinct(x.views), x.V, x.D, x.A, x.MC,
                                  x.dtype, x.seeded)
            out["pano"] += b["fwd" if x.kernel == "pano_fwd" else "bwd"]
        else:
            b = costs.cand_bounds(x.B, x.D, x.A, x.MC, x.dtype, x.seeded)
            out[x.kernel] += b["fwd" if x.kernel == "cand_fwd" else "bwd"]
    return out


def candidate_rows_bounds(launches: List[Launch]) -> dict:
    """Bounds (s) of K4 launches that serve the candidate rows alone (the
    Self-Monitor): the distinct (panorama, view) rows read, the rows
    written."""
    out = 0.0
    for x in launches:
        if x.kernel != "pano_fwd":
            raise ValueError(f"a candidate-rows call launched {x.kernel}")
        pairs = x.nodes[:, None].long() * x.V + x.cand_view.long()
        out += costs.pano_cands_bound(x.B, distinct(pairs), x.D, x.MC, x.dtype)
    return {"pano": out}
