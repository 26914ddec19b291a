#!/usr/bin/env python3
"""K2's bf16 route (``csrc/lstm_scan.cu``: the pack launch, dx_wgmma,
dw_wgmma) against design variants patched from this source, on one GPU.

    python3 scripts/torch_k2_wgmma_variants.py [--out chiprun_out/k2_variants.json]

Each variant is this tree's ``csrc/lstm_scan.cu`` with one choice changed
by a string patch (the patch must apply once), built with this
checkout's nvcc flags into ``build/k2_variants/`` and called through this
tree's wrapper (``ops/cuda/lstm_scan.py``), whose C signature they share:

* ``this``: the source as it is;
* ``dw_k64``: dw_wgmma with K-tiles of 64 steps, one block an SM (the
  ring of dx_wgmma's size), in place of 32 and two;
* ``dw_S1`` .. ``dw_S8``: dw_wgmma's steps split a fixed 1, 2, 4 or 8
  ways in place of ``dw_splits``;
* ``dx_S1``: dx_wgmma without its split of K;
* ``walk_terms`` (H <= 256 only): the walk writes da's three bf16 terms
  at the packed rows itself (no f32 da), and the pack launch splits no da
  row: the other place the split could be made;
* diagnostics, which give wrong gradients and are timed only:
  ``dw_no_products`` (dw_wgmma's loads, waits and reduction without its
  wgmma), ``dw_no_reduction`` (without its partial tiles' cluster sum),
  ``pack_no_da`` (the pack launch without da's split).

Every other variant is first held against the plain version (chip_smoke's
tolerances: d_xs 8e-3, dW and db 1e-4, times max(1, max |plain|)).  Then
all are timed in turns (each variant, then all again in reverse order),
device ms a call by kernel name (``chip_smoke.device_time_ms``), bf16, B
= 64, at the speaker's first layer (D = 2176, H = 256, L = 35 at full
lengths) and second (D = 512), EnvDrop's encoder (D = H = 256, L = 80) at
11-20 and at 17-80 tokens, and the Self-Monitor's (H = 512) at 17-80.
Prints one line a (case, variant, turn), the card's name and power
limit, and one JSON object of every time (also written to ``--out``).
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

OUT = ROOT / "build" / "k2_variants"
SRC = ROOT / "curriculum_learning_for_vln_torch" / "csrc"
DIAGNOSTIC = ("dw_no_products", "dw_no_reduction", "pack_no_da")
# (label, B, L, D, H, lengths): "full", "short" (11-20) or "long" (17-80)
CASES = [("speaker D=2176", 64, 35, 2176, 256, "full"), ("speaker D=512", 64, 35, 512, 256, "full"),
         ("EnvDrop 11-20", 64, 80, 256, 256, "short"), ("EnvDrop 17-80", 64, 80, 256, 256, "long"),
         ("Self-Monitor 17-80", 64, 80, 256, 512, "long")]


def sub(text: str, old: str, new: str, first: bool = False) -> str:
    if first:
        if old not in text:
            raise SystemExit(f"patch does not apply: {old[:80]!r}")
        return text.replace(old, new, 1)
    if text.count(old) != 1:
        raise SystemExit(f"patch does not apply once: {old[:80]!r}")
    return text.replace(old, new)


DW_SPLITS = "  const int S = dw_splits(tiles);"
PACK_DA = "  split_row(da + (size_t)m * 4 * H, dap + (size_t)v * 4 * H, 4 * H);"
PACK_DA_PADDED = "  if (!valid) " + PACK_DA.lstrip()


def walk_terms(s: str) -> str:
    """The H <= 256 walk (bwd_recurrence_kernel) writes da's terms at the
    packed rows (rows numbered as the pack numbers them) in bf16; the pack
    zeroes only the rows past the valid steps."""
    s = sub(s, """                      const T* __restrict__ w_hh, float* __restrict__ da,
                      float* __restrict__ db_part, int B, int L, int H, int reverse) {""",
            """                      const T* __restrict__ w_hh, float* __restrict__ da,
                      float* __restrict__ db_part, int B, int L, int H, int reverse,
                      __nv_bfloat16* __restrict__ dap) {""")
    i = s.index("bwd_recurrence_kernel(const float* __restrict__ gates")
    s = s[:i] + sub(s[i:], """  int my_len = 0;
  float dh = 0.f, dc = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};""", """  int my_len = 0, vstart = 0;
  for (int b = 0; b < row && b < B; ++b) {
    const int64_t n = lengths[b];
    vstart += n < 0 ? 0 : n > L ? L : (int)n;
  }
  float dh = 0.f, dc = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};""", first=True)
    i = s.index("bwd_recurrence_kernel(const float* __restrict__ gates")
    s = s[:i] + sub(s[i:], """    if (owner && t < my_len) {
      float* dp = da + ((size_t)row * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g * H] = d4[g];
    }""", """    if (owner && t < my_len) {
      if constexpr (F32) {
        float* dp = da + ((size_t)row * L + t) * H4 + k;
#pragma unroll
        for (int g = 0; g < 4; ++g) dp[g * H] = d4[g];
      } else {
        __nv_bfloat16* dp = dap + (size_t)(vstart + t) * H4 + k;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float x = d4[g];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const __nv_bfloat16 tb = __float2bfloat16_rn(x);
            dp[(size_t)a * B * L * H4 + g * H] = tb;
            x -= __bfloat162float(tb);
          }
        }
      }
    }""", first=True)
    s = sub(s, """        static_cast<const T*>(w_hh), static_cast<float*>(da), static_cast<float*>(db_part), B, L,
        H, reverse);
  }""", """        static_cast<const T*>(w_hh), static_cast<float*>(da), static_cast<float*>(db_part), B, L,
        H, reverse,
        static_cast<__nv_bfloat16*>(pack) + (size_t)B * L * D + (size_t)3 * B * L * H);
  }""")
    return sub(s, PACK_DA, PACK_DA_PADDED)


def variants(src: str):
    dw_k64 = sub(sub(src, "constexpr int WG_DX_K = 64, WG_DW_K = 32;",
                     "constexpr int WG_DX_K = 64, WG_DW_K = 64;"),
                 "__global__ void __launch_bounds__(WG_THREADS, 2)\ndw_wgmma_kernel(",
                 "__global__ void __launch_bounds__(WG_THREADS, 1)\ndw_wgmma_kernel(")
    out = {"this": src, "dw_k64": dw_k64,
           **{f"dw_S{n}": sub(src, DW_SPLITS, f"  const int S = {n};") for n in (1, 2, 4, 8)},
           "dx_S1": sub(src, "  cfg.gridDim = dim3(xgrid.x, xgrid.y, dx_splits(xgrid.x * xgrid.y, "
                             "H4 / WG_DX_K));",
                        "  cfg.gridDim = dim3(xgrid.x, xgrid.y, 1);"),
           "walk_terms": walk_terms(src),
           "dw_no_products": sub(src, "        wgmma_mn(acc0, acc1, ad, wg_desc(b, WG_DW_BOX, 1024));",
                                 "        (void)ad, (void)b;"),
           "dw_no_reduction": sub(src, "  __syncthreads();  // every product has read the ring: it "
                                       "takes the partial tile\n\n  float* red",
                                  "  if (clusters >= 0) return;\n\n  float* red"),
           "pack_no_da": sub(src, PACK_DA, PACK_DA_PADDED)}
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_wgmma_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for label, B, L, D, H, kind in CASES:
        lengths = (torch.full((B,), L, device=dev) if kind == "full" else
                   torch.randint(11, 21, (B,), generator=gen, device=dev) if kind == "short" else
                   cs.long_lengths(B, gen, dev, hi=L))
        xs, w_ih, w_hh, b = cs.lstm_inputs(torch.bfloat16, dev, gen, B, L, D, H)
        d_out = torch.randn(B, L, H, generator=gen, device=dev)
        dhT, dcT = (torch.randn(B, H, generator=gen, device=dev) for _ in range(2))
        build._libs["lstm_scan"] = libs["this"]
        tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b)
        res = (xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT)
        want = k.lstm_scan_bwd_plain(*res)
        names = [n for n in libs if H <= 256 or n != "walk_terms"]
        for name in names:
            if name in DIAGNOSTIC:
                continue
            build._libs["lstm_scan"] = libs[name]
            got = k.lstm_scan_bwd(*res)
            e1, e2 = cs.compare(got[:1], want[:1], 8e-3), cs.compare(got[1:], want[1:], 1e-4)
            cs.check(e1[0] <= e1[1] and e2[0] <= e2[1],
                     f"{name} at {label}: d_xs {e1}, dW and db {e2}")
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                build._libs["lstm_scan"] = libs[name]
                ms, _, split = cs.device_time_ms(lambda i: k.lstm_scan_bwd(*res), 20)
                rows.append({"case": label, "variant": name, "turn": turn, "device_ms": ms,
                             "split": {n: v[0] for n, v in split.items()}})
                print(f"{label:18s} {name:16s} turn {turn}: device {ms:.4f} ms | "
                      + ", ".join(f"{n} {v[0]:.4f}" for n, v in split.items()), flush=True)
    print(card, flush=True)
    result = {"k2_variants": rows, "card": card}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
