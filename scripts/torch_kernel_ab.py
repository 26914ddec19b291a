#!/usr/bin/env python3
"""Time K3, K1 and K2 (the LSTM scan's inference forward, training
forward and backward) and K7 (the candidate scorer's backward) of this
checkout against those of another checkout, on one GPU, in turns within
one process: other, this, this, other.

    python3 scripts/torch_kernel_ab.py --other DIR

DIR is the root of another checkout of the repo, e.g. the parent commit
unpacked with ``git archive``.  Both trees' ``csrc/lstm_scan.cu`` and
``csrc/cand_score.cu`` (with their ``common.cuh``) are built with this
checkout's nvcc flags into ``build/ab/`` and called through their C entry
points, whose signatures both trees share, on the same inputs: K3, K1 and
K2 at B = 64, L = 80, D = H = 256 at 11-20 and 17-80 tokens (K2 from
K1's residuals), beside cuDNN's packed ``nn.LSTM`` (forward without and
with autograd recording, and ``autograd.grad`` through it) and each
kernel's bound (``chip_smoke.lstm_bounds``), and K3 and K1 also at 0 and
at 80 tokens in every row (the forward's fixed cost, and its full walk
of 80 valid steps); K7 at B = 64, 16 candidates
of 2048 + 128 features, in its four mask modes, rotating over 8
candidate sets.  Each kernel is timed by ``chip_smoke.device_time_ms``
(device ms a call, by kernel name) and held against this checkout's
plain version (the tolerances of chip_smoke.py).  Prints one line per
(kernel, dtype, case, tree, turn), then the card's name and power limit,
then one JSON object of every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from curriculum_learning_for_vln_torch.ops import philox  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import build  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import cand_score as kc  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as kl  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda.drop import NO_DROP, DropSpec, c_args  # noqa: E402

OUT = ROOT / "build" / "ab"
CSRC = "curriculum_learning_for_vln_torch/csrc"


def build_tree(tag: str, tree: Path):
    """{source: CDLL} of one tree's K2 and K7 sources, built side by side."""
    src = OUT / tag
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in ("lstm_scan.cu", "cand_score.cu", "common.cuh"):
        shutil.copy(tree / CSRC / f, src / f)
    procs = {name: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                                     str(src / f"{name}.so"), str(src / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in ("lstm_scan", "cand_score")}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {tag}/{name}:\n{log}")
        libs[name] = ctypes.CDLL(str(src / f"{name}.so"))
    return libs


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def lstm_cases(dtype, dev, gen):
    full = torch.full((64,), 80, device=dev)
    for label, lengths in (("11-20 tokens", torch.randint(11, 21, (64,), generator=gen,
                                                          device=dev)),
                           ("17-80 tokens", cs.long_lengths(64, gen, dev)),
                           # K3 and K1 only: the forward's fixed cost (no step
                           # valid) and its full walk (every step valid)
                           ("0 tokens", torch.zeros_like(full)), ("80 tokens", full)):
        xs, w_ih, w_hh, b = cs.lstm_inputs(dtype, dev, gen, 64)
        B, L, D = xs.shape
        H = w_hh.shape[0]
        valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
        f32 = dict(dtype=torch.float32, device=dev)
        uniform = label in ("0 tokens", "80 tokens")
        bounds = cs.lstm_bounds(xs, lengths, w_ih, w_hh, b)
        libs = (dict.fromkeys(("lstm_scan", "lstm_scan_train")) if uniform else
                {"lstm_scan": cs.lstm_library_infer(xs, lengths, w_ih, w_hh, b, 20),
                 **dict(zip(("lstm_scan_train", "lstm_scan_bwd"),
                            cs.lstm_library(xs, lengths, w_ih, w_hh, b, 20)))})

        # K3 and K1 through their C entry points, against the plain forward
        want_f = kl.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b)
        gx = torch.empty((B, L, 4 * H), **f32)
        fouts = (torch.empty((B, L, H), **f32), torch.empty((B, H), **f32),
                 torch.empty((B, H), **f32))
        carries = (torch.empty((L, B, H), **f32), torch.empty((L, B, H), **f32))
        for name, argtypes, train in (("lstm_scan", kl._ARGTYPES, False),
                                      ("lstm_scan_train", kl._TRAIN_ARGTYPES, True)):
            def call(lib, name=name, argtypes=argtypes, train=train):
                fn = entry(lib, name, argtypes)
                ptrs = [t.data_ptr() for t in (xs, lengths, w_ih, w_hh, b, gx, *fouts,
                                               *(carries if train else ()))]

                def run(i):
                    build.check_launch(fn(*ptrs, B, L, D, H, 0, build.DTYPE_CODES[dtype],
                                          build.stream_handle(xs)), name)
                return run

            def check(tag, name=name, train=train):
                got, want = [*fouts], [want_f[0], *want_f[1]]
                if train:
                    got += [*carries]
                    want += [want_f[2], want_f[3]]
                    if bool(valid.any()):
                        got.append(gx[valid])
                        want.append(want_f[4][valid])
                e = cs.compare(got, want, 1e-4)
                cs.check(e[0] <= e[1], f"{name} {tag} {dtype} {label}: {e[0]:.3g} > {e[1]:.3g}")
            yield name, label, call, check, bounds[name], libs[name]
        if uniform:
            continue

        # K2 from K1's residuals
        d_out = torch.randn(B, L, H, generator=gen, device=dev)
        dhT, dcT = (torch.randn(B, H, generator=gen, device=dev) for _ in range(2))
        _, _, hprev, cprev, gates = kl.lstm_scan_train(xs, lengths, w_ih, w_hh, b)
        res = (xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT)
        want = kl.lstm_scan_bwd_plain(*res)
        outs = (torch.empty_like(xs), torch.empty((D, 4 * H), **f32),
                torch.empty((H, 4 * H), **f32), torch.empty((4 * H,), **f32))
        scratch = (torch.empty((B, L, 4 * H), **f32), torch.empty((-(-B // 8), 4 * H), **f32))

        def call(lib):
            fn = entry(lib, "lstm_scan_bwd", kl._BWD_ARGTYPES)

            def run(i):
                err = fn(*(t.data_ptr() for t in (*res, *scratch, *outs)), B, L, D, H, 0,
                         build.DTYPE_CODES[dtype], build.stream_handle(xs))
                build.check_launch(err, "lstm_scan_bwd")
            return run

        def check(tag):
            e = cs.compare(outs[:1], want[:1], 1e-4 if dtype == torch.float32 else 8e-3)
            cs.check(e[0] <= e[1], f"K2 {tag} {dtype} {label}: d_xs {e[0]:.3g} > {e[1]:.3g}")
            e = cs.compare(outs[1:], want[1:], 1e-4)
            cs.check(e[0] <= e[1], f"K2 {tag} {dtype} {label}: dW {e[0]:.3g} > {e[1]:.3g}")
        yield "lstm_scan_bwd", label, call, check, bounds["lstm_scan_bwd"], libs["lstm_scan_bwd"]


def cand_cases(dtype, dev, gen):
    B, MC, D, A = 64, 16, 2048, 128
    sets = [torch.randn(B, MC, D, generator=gen, device=dev).to(dtype) for _ in range(8)]
    ang = torch.randn(B, MC, A, generator=gen, device=dev).to(dtype)
    valid = torch.rand(B, MC, generator=gen, device=dev) < 0.5
    d_logits = torch.randn(B, MC + 1, generator=gen, device=dev)
    for mode in cs.MODES:
        drop = cs.drop_spec(mode, B, MC, D, gen, dev)
        dargs = c_args(drop, B, MC, D, sets[0].device, "cand_score_bwd")
        want = kc.cand_score_bwd_plain(sets[0], ang, valid, d_logits, drop)
        out = torch.empty((B, D + A), device=dev)

        def call(lib, dargs=dargs, out=out, drop=drop):  # drop keeps the mask alive
            fn = entry(lib, "cand_score_bwd", kc._ARGTYPES)

            def run(i):
                err = fn(sets[i % 8].data_ptr(), ang.data_ptr(), valid.data_ptr(),
                         d_logits.data_ptr(), out.data_ptr(), B, MC, D, A,
                         build.DTYPE_CODES[dtype], *dargs, build.stream_handle(out))
                build.check_launch(err, "cand_score_bwd")
            return run

        def check(tag, want=want, out=out, mode=mode):
            e = cs.compare((out,), (want,), 1e-4)
            cs.check(e[0] <= e[1], f"K7 {tag} {dtype} {mode}: {e[0]:.3g} > {e[1]:.3g}")
        yield "cand_score_bwd", mode, call, check, None, None

    w = torch.where(valid, d_logits[:, :MC], 0.0).to(dtype)
    yield "einsum('bk,bkd->bd')", "library", None, lambda i: torch.einsum(
        "bk,bkd->bd", w, sets[i % 8]), None, None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"other": build_tree("other", Path(args.other).resolve()),
            "this": build_tree("this", ROOT)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, case, call, check, bound, lib in (item for cases in (lstm_cases, cand_cases)
                                                      for item in cases(dtype, dev, gen)):
            if call is None:  # the library call: no tree, no turns
                ms = cs.device_time_ms(check, 100)[0]
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "library", "device_ms": ms})
                cs.log(f"{kernel:22s} {str(dtype):14s} {case:13s} library: {ms:.4f} ms")
                continue
            if lib is not None:  # the LSTM kernels' cuDNN yardstick and bound
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "library", "device_ms": lib["library_device_ms"],
                             "bound_ms": bound[0], "bound_by": bound[1]})
                cs.log(f"{kernel:22s} {str(dtype):14s} {case:13s} cuDNN nn.LSTM: "
                       f"{cs.fmt(lib['library_device_ms'])} ms; bound {bound[0]:.4f} ms "
                       f"({bound[1]})")
            lstm = kernel.startswith("lstm_scan")
            iters = 20 if lstm else 100
            src = "lstm_scan" if lstm else "cand_score"
            for turn, tag in enumerate(("other", "this", "this", "other")):
                run = call(libs[tag][src])
                run(0)
                torch.cuda.synchronize()
                check(tag)
                ms, _, split = cs.device_time_ms(run, iters)
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case, "tree": tag,
                             "turn": turn, "device_ms": ms,
                             "split": {k: v[0] for k, v in split.items()}})
                cs.log(f"{kernel:22s} {str(dtype):14s} {case:13s} {tag:5s} (turn {turn}): "
                       f"{ms:.4f} ms | " + ", ".join(f"{k} {v[0]:.4f}" for k, v in split.items()))
    cs.log(cs.card_line())
    cs.log(json.dumps({"ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
