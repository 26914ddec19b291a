#!/usr/bin/env python3
"""Where a step of K2's resident backward walk (``bwd_recurrence_res_kernel``,
bf16 at H = 512) goes, and how design variants of it compare, on one GPU.

    python3 scripts/torch_lstm_bwd_trace.py

Builds this checkout's ``csrc/lstm_scan.cu`` and variants of it, made by
patching its text (each patch must apply exactly once, so the script
follows the source it ships with), into ``build/variants/``:

* ``this``: the source as it is;
* ``after_wait``: the cells form da's sigmoids and tanhs after the wait
  for their partials, from the step's inputs, in place of the seven
  coefficients formed a step ahead (the walk's first design);
* ``one_chain``: one accumulator an m-tile in the step's product, in
  place of two (even and odd k-steps);
* ``trace_this`` and ``trace_after_wait``: those two with ``clock64``
  stamps at the phase boundaries of block 0's group steps (the cells'
  start, the end of their wait, of the partials' sum and of their work;
  the block barrier; the end of warp 0's product and of its sends; the
  end of warp 15's product).

Every variant is first held against the plain version at B = 64 and 40
(the tolerances of ``tests/test_torch_card_kernels.py``), then timed in
turns (each variant, then the same in reverse order) at D = 256, H = 512,
B = 64, L = 80 and 17-80 tokens: device ms of the walk's kernel and of
all K2's launches (``scripts/torch_kernel_ab.py``'s ``kernel_times``).
The traces print each phase's mean cycles a group step at B = 64 (two
row groups) and B = 40 (one), and the period of a group step.  Ends with the card's name, power limit and SM
clock (the trace is in SM cycles).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

import torch_card_world as cw  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import build  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as k  # noqa: E402
from torch_kernel_ab import card_line, kernel_times, require  # noqa: E402

OUT = ROOT / "build" / "variants"
KERNEL = "bwd_recurrence_res_kernel"
D, H, L = 256, 512, 80
SLOTS = 8  # stamps a group step

TRACE = [
    ("template <int H, int NT>\n__global__ void __launch_bounds__(RT, 1)\nbwd_recurrence_res_kernel(",
     "__device__ long long g_trace[160 * 8];\n"
     "template <int H, int NT>\n__global__ void __launch_bounds__(RT, 1)\nbwd_recurrence_res_kernel("),
    ("      if (cell && grp == g) {\n        if (l > 0) {\n",
     "      const bool tr = blockIdx.x == 0;\n      long long* trp = g_trace + (l * NT + g) * 8;\n"
     "      if (cell && grp == g) {\n        if (tr && tid == g * 8 * U) trp[0] = clock64();\n"
     "        if (l > 0) {\n"),
    ("          mbar_wait_cluster(bar, ((l - 1) >> 1) & 1);\n",
     "          mbar_wait_cluster(bar, ((l - 1) >> 1) & 1);\n"
     "          if (tr && tid == g * 8 * U) trp[1] = clock64();\n"),
    ("          for (int src = 1; src < RCL; ++src) s += rp[src * U * 8];\n",
     "          for (int src = 1; src < RCL; ++src) s += rp[src * U * 8];\n"
     "          if (tr && tid == g * 8 * U) trp[7] = s == 12345.f ? 0 : clock64();\n"),
    ("        for (int gt = 0; gt < 4; ++gt) db[gt] += d4[gt];\n      }\n"
     "      __syncthreads();  // the group's da terms are in dab\n",
     "        for (int gt = 0; gt < 4; ++gt) db[gt] += d4[gt];\n"
     "        if (tr && tid == g * 8 * U) trp[2] = clock64();\n      }\n"
     "      __syncthreads();  // the group's da terms are in dab\n"
     "      if (tr && tid == 0) trp[3] = clock64();\n"),
    ("        const int half = g * 2 + (l & 1);\n",
     "        if (tr && (tid == 0 || tid == 480)) trp[tid ? 6 : 4] = clock64();\n"
     "        const int half = g * 2 + (l & 1);\n"),
    ("          if (send) st_async4(cluster_addr(dst, warp), v, bar);\n        }\n",
     "          if (send) st_async4(cluster_addr(dst, warp), v, bar);\n        }\n"
     "        if (tr && tid == 0) trp[5] = clock64();\n"),
    ("// The forward walk's plan (K3, K1).",
     "extern \"C\" int trace_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n"
     "// The forward walk's plan (K3, K1)."),
]
AFTER_WAIT = [
    ("  float cf[7];  // this step's coefficients of da\n  {\n"
     "    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n    inputs_at(0, v);\n"
     "    coefs_of(v, cf);\n  }\n",
     "  float cf[7], nx[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n  inputs_at(0, nx);\n"),
    ("        float d4[4] = {0.f, 0.f, 0.f, 0.f};\n        const bool valid = t < clen;\n",
     "        coefs_of(nx, cf);\n"
     "        float d4[4] = {0.f, 0.f, 0.f, 0.f};\n        const bool valid = t < clen;\n"),
    ("      if (cell && grp == g) coefs_of(nn, cf);\n    }\n  }\n",
     "    }\n#pragma unroll\n    for (int q = 0; q < 6; ++q) nx[q] = nn[q];\n  }\n"),
]
ONE_CHAIN = [("              mma_bf16(acc[i][1], wa[i][ks + 1], b[2], b[3]);",
              "              mma_bf16(acc[i][0], wa[i][ks + 1], b[2], b[3]);")]
VARIANTS = {"this": [], "after_wait": AFTER_WAIT, "one_chain": ONE_CHAIN,
            "trace_this": TRACE, "trace_after_wait": AFTER_WAIT + TRACE}
PHASES = ["wait", "sum", "cells", "barrier", "product", "send", "to the next cells"]


def patched(src: str, pairs) -> str:
    for old, new in pairs:
        require(src.count(old) == 1, f"a variant's patch applies once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants():
    """Compile every variant at once; returns {name: ctypes.CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "curriculum_learning_for_vln_torch" / "csrc"
    (OUT / "common.cuh").write_text((csrc / "common.cuh").read_text())
    src = (csrc / "lstm_scan.cu").read_text()
    procs = {}
    for name, pairs in VARIANTS.items():
        (OUT / f"{name}.cu").write_text(patched(src, pairs))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        require(proc.returncode == 0, f"nvcc builds variant {name}:\n{log}")
        for entry, regs, st, ld in cw.kernel_resources(log, KERNEL):
            print(f"{name}: {entry}: {regs} registers, spills {st} / {ld} B", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def trace_of(lib, res):
    """Mean cycles a group step of each phase, and the period, from one
    call's stamps of block 0 (past the first step and before the last)."""
    build._libs["lstm_scan"] = lib
    k.lstm_scan_bwd(*res)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (160 * SLOTS))()
    build.check_launch(lib.trace_read(buf), "trace_read")
    stamps = list(buf)
    B = res[0].shape[0]
    rows = k.bwd_plan_query(B, H, torch.bfloat16)[1]
    nt = -(-rows // 8)
    maxlen = int(res[1][:rows].clamp(max=L).max())
    steps = range(nt, (maxlen - 1) * nt)
    total = dict.fromkeys(PHASES, 0)
    for s in steps:
        p, q = stamps[s * SLOTS:(s + 1) * SLOTS], stamps[(s + 1) * SLOTS:(s + 2) * SLOTS]
        for name, d in zip(PHASES, (p[1] - p[0], p[7] - p[1], p[2] - p[7], p[3] - p[2],
                                    p[4] - p[3], p[5] - p[4], q[0] - p[5])):
            total[name] += d
    n = len(steps)
    return {"row_groups": nt, "group_steps": n,
            "cycles": {name: v / n for name, v in total.items()},
            "period": (stamps[steps[-1] * SLOTS] - stamps[steps[0] * SLOTS]) / (n - 1),
            "warp15_after_warp0": sum(stamps[s * SLOTS + 6] - stamps[s * SLOTS + 4]
                                      for s in steps) / n}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_bwd_trace: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cw.SEED)
    sets = {}
    for B in (64, 40):
        lengths = cw.long_lengths(B, gen, dev)
        xs, w_ih, w_hh, b = cw.lstm_inputs(torch.bfloat16, dev, gen, B, L, D, H)
        d_out = torch.randn(B, L, H, generator=gen, device=dev)
        dhT, dcT = (torch.randn(B, H, generator=gen, device=dev) for _ in range(2))
        tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b)
        res = (xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT)
        sets[B] = (res, k.lstm_scan_bwd_plain(*res))
    timed = [n for n in VARIANTS if not n.startswith("trace")]
    times = {n: [] for n in timed}
    for turn, order in enumerate((timed, timed[::-1])):
        for name in order:
            build._libs["lstm_scan"] = libs[name]
            for B, (res, want) in sets.items():
                got = k.lstm_scan_bwd(*res)
                e1, e2 = cw.compare(got[:1], want[:1], 8e-3), cw.compare(got[1:], want[1:], 1e-4)
                require(e1[0] <= e1[1] and e2[0] <= e2[1],
                         f"{name} at B = {B}: d_xs {e1}, dW and db {e2}")
            res = sets[64][0]
            t = kernel_times(lambda i: k.lstm_scan_bwd(*res), 20)
            walk = t["device_split"][KERNEL][0]
            times[name].append({"walk": walk, "K2": t["device_ms"]})
            print(f"turn {turn} {name:10s}: walk {walk:.4f} device ms ({walk / 80 * 1e3:.2f} us "
                  f"a step), K2 {t['device_ms']:.4f}", flush=True)
    traces = {}
    for name in (n for n in VARIANTS if n.startswith("trace")):
        for B in (64, 40):
            tr = traces[f"{name} B={B}"] = trace_of(libs[name], sets[B][0])
            print(f"{name} B={B} ({tr['row_groups']} row group(s), {tr['group_steps']} group "
                  "steps): cycles a group step " + ", ".join(
                      f"{p} {c:.0f}" for p, c in tr["cycles"].items())
                  + f"; period {tr['period']:.0f}; warp 15's product ends "
                  f"{tr['warp15_after_warp0']:.0f} after warp 0's", flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"times": times, "traces": traces, "sm_clock": clock.strip()}))
    print(f"{card}, SM clock {clock.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
