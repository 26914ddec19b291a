#!/usr/bin/env python3
"""The word embedding's backward on one H100: advanced indexing's route
(``w[ids]``, whose backward is ``index_put_`` with accumulate) against
``models.core.embedding``'s (``F.embedding``), at the training cell's
shapes.

    python3 scripts/torch_embedding_bwd.py [--out DIR]

The training cell (``envdrop-spcl-train-b512``) embeds two batches of
80-token instructions an iteration, the pool's 1536 x 80 ids and the IL
batch's 512 x 80, padded past each instruction with id 0: lengths 8-50
tokens (mean 29, the cell's; 64% of the ids are padding), words drawn by
a Zipf law over the 992-word vocabulary, into D = 256 bf16 rows.  For
each shape, with an N(0, 1) bf16 gradient of the lookup's output, it
measures:

* each route's backward alone (``torch.autograd.grad`` of one retained
  lookup) in turns, old, new, new, old: CUDA-event ms a call and device
  ms a call by kernel name, with the launches a call
  (``scripts/torch_kernel_ab.py``'s ``kernel_times``);
* whether two backward runs give bitwise-equal gradients;
* whether the backward waits for the card on the host, under
  ``torch.cuda.set_sync_debug_mode("error")``;
* each route's largest error against an f64 ``index_add_``: on the
  padding row, on the other rows, and in bf16 ulps of its row's largest
  sum (one rounding of an exact sum is at most 0.5).

Prints one line per (shape, route, turn), the card's name and power
limit, and one JSON object, also written under DIR (default
``build/embedding_bwd``).  Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

from curriculum_learning_for_vln_torch.models import core  # noqa: E402
from torch_kernel_ab import card_line, kernel_times  # noqa: E402

V, D, L = 992, 256, 80
SHAPES = {"il 512x80": 512, "pool 1536x80": 1536}
ROUTES = {"index": lambda w, ids: w[ids], "embedding": lambda w, ids: core.embedding({"w": w}, ids)}
TURNS = ("index", "embedding", "embedding", "index")


def instruction_ids(rows: int, gen: torch.Generator, device) -> torch.Tensor:
    """[rows, L] word ids: Zipf-distributed words 1..V-1 up to each row's
    length (8-50 tokens), the padding id 0 after it."""
    zipf = 1.0 / torch.arange(1, V, dtype=torch.float64)
    words = torch.multinomial(zipf, rows * L, replacement=True, generator=gen).view(rows, L) + 1
    lengths = torch.randint(8, 51, (rows, 1), generator=gen)
    return torch.where(torch.arange(L) < lengths, words, 0).to(device)


def errors(grad: torch.Tensor, want: torch.Tensor) -> dict:
    err = (grad.double() - want).abs()
    scale = want.abs().amax(dim=1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
    return {"pad_row_max_err": err[0].max().item(), "other_rows_max_err": err[1:].max().item(),
            "max_ulps_of_row_scale": (err / ulp).max().item()}


def host_sync(fn) -> str:
    """The first line of the error that a blocking call raises inside
    ``fn(0)`` under the sync debug mode "error", or "" if none."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(0)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return ""


def measure(rows: int, device) -> dict:
    gen = torch.Generator().manual_seed(rows)
    ids = instruction_ids(rows, gen, device)
    g = torch.randn(rows, L, D, generator=gen).to(device, torch.bfloat16)
    table = torch.randn(V, D, generator=gen).to(device, torch.bfloat16)
    want = torch.zeros(V, D, dtype=torch.float64, device=device).index_add_(
        0, ids.reshape(-1), g.reshape(-1, D).double())
    res = {"ids": rows * L, "pad_share": (ids == 0).float().mean().item(), "routes": {}}
    calls = {}
    for name, route in ROUTES.items():
        w = table.clone().requires_grad_(True)
        y = route(w, ids)
        calls[name] = fn = (lambda y, w: lambda i: torch.autograd.grad(y, w, g, retain_graph=True)[0]
                            )(y, w)
        first, second = fn(0), fn(1)
        res["routes"][name] = {"bitwise_repeat": bool(torch.equal(first, second)),
                               "host_sync": host_sync(fn), **errors(first, want), "turns": []}
    for turn, name in enumerate(TURNS):
        t = kernel_times(calls[name], 20)
        res["routes"][name]["turns"].append(t)
        print(f"{rows}x{L} {name:9s} turn {turn}: ms {t['ms']:.4f} device_ms {t['device_ms']:.4f} "
              f"events {t['device_events']:.0f} "
              + ", ".join(f"{k} {ms:.4f} ({n:.0f})" for k, (ms, n) in t["device_split"].items()),
              flush=True)
    for r in res["routes"].values():
        r["device_ms_median"] = statistics.median(t["device_ms"] for t in r["turns"])
        r["ms_median"] = statistics.median(t["ms"] for t in r["turns"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "embedding_bwd"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    out = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "shapes": {label: measure(rows, device) for label, rows in SHAPES.items()}}
    out["new_device_ms_both_calls"] = sum(s["routes"]["embedding"]["device_ms_median"]
                                          for s in out["shapes"].values())
    out["old_device_ms_both_calls"] = sum(s["routes"]["index"]["device_ms_median"]
                                          for s in out["shapes"].values())
    print(out["card"])
    summary = {label: {name: {k: v for k, v in r.items() if k != "turns"}
                       for name, r in s["routes"].items()} for label, s in out["shapes"].items()}
    print(json.dumps({"summary": summary, "new_device_ms_both_calls": out["new_device_ms_both_calls"],
                      "old_device_ms_both_calls": out["old_device_ms_both_calls"]}))
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "embedding_bwd.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
