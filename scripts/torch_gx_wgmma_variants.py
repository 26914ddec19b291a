#!/usr/bin/env python3
"""K1/K3's bf16 gates_x (``csrc/lstm_scan.cu``: gx_wgmma_kernel) against
design variants patched from this source, on one GPU.

    python3 scripts/torch_gx_wgmma_variants.py [--out FILE.json]

Each variant is this tree's ``csrc/lstm_scan.cu`` with one choice changed
by a string patch (the patch must apply once), built with this
checkout's nvcc flags into ``build/gx_variants/`` and called through this
tree's wrapper (``ops/cuda/lstm_scan.py``), whose C signature they share:

* ``this``: the source as it is;
* ``S1`` .. ``S8``: K = D split a fixed 1, 2, 4 or 8 ways in place of
  ``gx_splits``;
* ``one_block``: one block an SM with a ring of four stages (128 KB) in
  place of two blocks of three;
* ``all_rows``: gx_wgmma multiplies every one of the B L rows of x, fed
  as TMA boxes, the padded steps' too, and stores the valid ones (the
  wasted rows against the gather by valid step);
* ``gather_always``: the consumers gather x's rows also where every step
  is valid (in place of TMA boxes);
* ``tile_a_block``: one step tile a block, the grid over all B L / WG_M
  of them, and ``rows_one_round``: rows of blocks for a round of one
  block an SM (in place of ``gx_rows``' round of two blocks an SM);
* diagnostics, which give wrong results and are timed only:
  ``no_products`` (gx_wgmma's loads, waits, reduction and stores without
  its wgmma) and ``no_reduction`` (without the split partials' cluster
  sum and its stores).

Every other variant is first held against the plain version (K3's outs,
hT and cT within 1e-4 x max(1, max |plain|), both directions).  Then all
are timed in turns (each variant, then all again in reverse order),
device ms of a K3 call by kernel name (``chip_smoke.device_time_ms``),
bf16, at the speaker's first layer (D = 2176, H = 256, B = 64, L = 35 at
full lengths, and at B = 61 over 0-35 tokens), the beam's rescoring
(D = 2176, B = 30, L = 16, 1-16 tokens), EnvDrop's encoder (D = H = 256,
L = 80) at 11-20, 17-80, 0 and 80 tokens, the Self-Monitor's (H = 512) and the
Follower's first layer (D = 300, H = 128) at 17-80.  Prints one line a
(case, variant, turn), the card's name and power limit, and one JSON
object of every time (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import build  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as k  # noqa: E402

OUT = ROOT / "build" / "gx_variants"
SRC = ROOT / "curriculum_learning_for_vln_torch" / "csrc"
DIAGNOSTIC = ("no_products", "no_reduction")
# (label, B, L, D, H, lengths): "full", "zero", "ragged" (0..L, a 0 and an
# L), "beam" (1..L, an L), "short" (11-20) or "long" (17-80)
CASES = [("speaker D=2176", 64, 35, 2176, 256, "full"),
         ("speaker B=61 0-35", 61, 35, 2176, 256, "ragged"),
         ("beam rescoring", 30, 16, 2176, 256, "beam"),
         ("EnvDrop 11-20", 64, 80, 256, 256, "short"), ("EnvDrop 17-80", 64, 80, 256, 256, "long"),
         ("EnvDrop 0 tokens", 64, 80, 256, 256, "zero"),
         ("EnvDrop 80 tokens", 64, 80, 256, 256, "full"),
         ("Self-Monitor 17-80", 64, 80, 256, 512, "long"),
         ("Follower D=300 17-80", 64, 80, 300, 128, "long")]


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"patch does not apply once: {old[:80]!r}")
    return text.replace(old, new)


SPLITS = "  const int S = gx_splits(nt * mt, (D + WG_DX_K - 1) / WG_DX_K);"
KERNEL = "__global__ void __launch_bounds__(WG_THREADS, 2)\ngx_wgmma_kernel("
ROWS = ("int gx_rows(int nt, int mt, int S) { return S > 1 ? mt : "
        "min(mt, max(1, 2 * WG_SMS / nt)); }")


def all_rows(s: str) -> str:
    """gx_wgmma over every sequence row of x, as TMA boxes (the dense
    feed), padded steps too; a row's result is stored where its step is
    valid."""
    s = sub(s, "  const int Mv = sm.starts[B], n0 = blockIdx.x * WG_N;",
            "  const int Mv = B * L, n0 = blockIdx.x * WG_N;")
    valid = "v % L < sm.starts[v / L + 1] - sm.starts[v / L]"
    s = sub(s, """      if (v >= Mv) continue;
      float* row = gx + (size_t)valid_row(sm.starts, B, L, v) * N + n0;""",
            f"""      if (v >= Mv || !({valid})) continue;
      float* row = gx + (size_t)v * N + n0;""")
    return sub(s, """    if (v >= Mv) return;
    const __nv_bfloat16* bc = bias + n0 + col;
    *reinterpret_cast<float4*>(gx + (size_t)valid_row(sm.starts, B, L, v) * N + n0 + col) =""",
               f"""    if (v >= Mv || !({valid})) return;
    const __nv_bfloat16* bc = bias + n0 + col;
    *reinterpret_cast<float4*>(gx + (size_t)v * N + n0 + col) =""")


def variants(src: str):
    one = sub(sub(src, KERNEL, KERNEL.replace(", 2)", ", 1)")),
              "constexpr int GX_ST = 3;", "constexpr int GX_ST = 4;")
    return {"this": src,
            **{f"S{n}": sub(src, SPLITS, f"  const int S = {n};") for n in (1, 2, 4, 8)},
            "one_block": one, "all_rows": all_rows(src),
            "gather_always": sub(src, "  if (Mv == B * L)\n    gx_tiles<true>",
                                 "  if (false)\n    gx_tiles<true>"),
            "tile_a_block": sub(src, ROWS, "int gx_rows(int nt, int mt, int S) { return mt; }"),
            "rows_one_round": sub(src, ROWS, ROWS.replace("2 * WG_SMS", "WG_SMS")),
            "no_products": sub(src, "        wgmma_128<0, 1>(acc0, acc1,",
                               "        if (n < 0) wgmma_128<0, 1>(acc0, acc1,"),
            "no_reduction": sub(src, """  if (S == 1) return;
  __syncthreads();  // every product has read the ring: it takes the partial tile
  const int m0 = blockIdx.y * WG_M;""", """  if (S >= 1) return;
  __syncthreads();  // every product has read the ring: it takes the partial tile
  const int m0 = blockIdx.y * WG_M;""")}

def build_variants():
    src = (SRC / "lstm_scan.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    shutil.copy(SRC / "common.cuh", OUT / "common.cuh")
    procs = {}
    for name, text in variants(src).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc builds variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def lengths_of(kind, B, L, gen, dev):
    if kind in ("full", "zero"):
        return torch.full((B,), L if kind == "full" else 0, device=dev)
    if kind == "short":
        return torch.randint(11, 21, (B,), generator=gen, device=dev)
    if kind == "long":
        return cs.long_lengths(B, gen, dev, hi=L)
    lengths = torch.randint(0 if kind == "ragged" else 1, L + 1, (B,), generator=gen, device=dev)
    lengths[0] = L
    if kind == "ragged":
        lengths[-1] = 0
    return lengths


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gx_wgmma_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for label, B, L, D, H, kind in CASES:
        lengths = lengths_of(kind, B, L, gen, dev)
        xs, w_ih, w_hh, b = cs.lstm_inputs(torch.bfloat16, dev, gen, B, L, D, H)
        want = [k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=r) for r in (False, True)]
        names = list(libs)
        for name in names:
            if name in DIAGNOSTIC:
                continue
            build._libs["lstm_scan"] = libs[name]
            for r, (out_p, (h_p, c_p)) in zip((False, True), want):
                out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=r)
                e = cs.compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4)
                cs.check(e[0] <= e[1], f"{name} at {label}, reverse={r}: {e[0]:.3g} > {e[1]:.3g}")
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                build._libs["lstm_scan"] = libs[name]
                ms, _, split = cs.device_time_ms(lambda i: k.lstm_scan(xs, lengths, w_ih, w_hh, b),
                                                 20)
                rows.append({"case": label, "variant": name, "turn": turn, "device_ms": ms,
                             "split": {n: v[0] for n, v in split.items()}})
                print(f"{label:20s} {name:13s} turn {turn}: device {ms:.4f} ms | "
                      + ", ".join(f"{n} {v[0]:.4f}" for n, v in split.items()), flush=True)
    build._libs.pop("lstm_scan", None)
    print(card, flush=True)
    result = {"gx_variants": rows, "card": card}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
