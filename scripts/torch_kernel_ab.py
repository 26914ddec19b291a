#!/usr/bin/env python3
"""Time the port's kernels of this checkout against those of another
checkout, on one GPU, in turns within one process: other, this, this,
other.

    python3 scripts/torch_kernel_ab.py --other DIR [--kernels pano cand lstm]

DIR is the root of another checkout of the repo, e.g. the parent commit
unpacked with ``git archive``.  Both trees' sources of the chosen groups
(with their ``common.cuh``) are built with this checkout's nvcc flags into
``build/ab/`` and called through their C entry points, whose signatures
both trees share (but for the LSTM scans' packed-W_hh scratch, which a
tree from before the wide walks does not take and H = 256 does not read),
on the same inputs; every call of a tree is first held against this
checkout's plain version (the tolerances of chip_smoke.py).

* ``pano``: K4 and K5 (``csrc/pano_fused.cu``) at B = 64, 36 views of
  2048 + 128 features (the synthetic world's distribution, N(0.5, 0.5^2)),
  MC = 16, in the four mask modes, again at B = 61 in prng_shared (a short
  last group) and at B = 64 in prng_shared on a table with every second
  value 0 ("zeros"), rotating over 8 node sets whose rows together exceed
  the 50 MB L2 (as chip_smoke.py does), beside each kernel's bound
  (``chip_smoke.pano_bounds``).
* ``cand``: K6 and K7 (``csrc/cand_score.cu``) at B = 64, 16 candidates of
  2048 + 128 features, in the four mask modes, rotating over 8 candidate
  sets, beside ``torch.einsum`` for K7.
* ``lstm``: K3, K1 and K2 (``csrc/lstm_scan.cu``) at B = 64, L = 80, D = H
  = 256 at 11-20 and 17-80 tokens (K2 from K1's residuals), beside cuDNN's
  packed ``nn.LSTM`` (forward without and with autograd recording, and
  ``autograd.grad`` through it) and each kernel's bound
  (``chip_smoke.lstm_bounds``), and K3 and K1 also at 0 and at 80 tokens in
  every row (the forward's fixed cost, and its full walk of 80 valid steps);
  then all three at the Self-Monitor's encoder shape, D = 256, H = 512, at
  17-80 tokens ("H=512": the wide walks, which take the packed-W_hh scratch,
  or in bf16 the resident walks, whose backward may write more rows of db's
  partial sums than clusters of 8 rows would: the scratch holds the larger).

Each turn is timed two ways: device ms a call (``chip_smoke.device_time_ms``,
summed by kernel name) and CUDA-event ms a call (``chip_smoke.cuda_time_ms``
around the same back-to-back calls through the C entry point, without the
wrapper's checks).  Prints one line per (kernel, dtype, case, tree, turn),
then the card's name and power limit, then one JSON object of every time.
All groups by default.
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
from curriculum_learning_for_vln_torch.ops.cuda import cand_score as kc  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as kl  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as kp  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda.drop import c_args  # noqa: E402
from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings  # noqa: E402

OUT = ROOT / "build" / "ab"
CSRC = "curriculum_learning_for_vln_torch/csrc"


SOURCES = {"lstm": "lstm_scan", "cand": "cand_score", "pano": "pano_fused"}


def build_tree(tag: str, tree: Path, names):
    """{source: CDLL} of one tree's sources ``names``, built side by side."""
    src = OUT / tag
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in (*(f"{n}.cu" for n in names), "common.cuh"):
        shutil.copy(tree / CSRC / f, src / f)
    procs = {name: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                                     str(src / f"{name}.so"), str(src / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in names}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {tag}/{name}:\n{log}")
        libs[name] = ctypes.CDLL(str(src / f"{name}.so"))
        libs[name].takes_wpack = "void* wpack" in (src / f"{name}.cu").read_text()
    return libs


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def lstm_entry(lib, symbol, argtypes, wpack):
    """An LSTM scan's entry point and the extra pointers it takes after the
    tensors: the packed-W_hh scratch ``wpack`` (its data pointer), or nothing
    for a tree whose signature predates it (H = 256 only)."""
    if lib.takes_wpack:
        return entry(lib, symbol, argtypes), [wpack.data_ptr()]
    return entry(lib, symbol, argtypes[:-8] + argtypes[-7:]), []


def lstm_cases(dtype, dev, gen):
    full = torch.full((64,), 80, device=dev)
    cases = [(label, 256, lengths) for label, lengths in (
        ("11-20 tokens", torch.randint(11, 21, (64,), generator=gen, device=dev)),
        ("17-80 tokens", cs.long_lengths(64, gen, dev)),
        # K3 and K1 only: the forward's fixed cost (no step valid) and its
        # full walk (every step valid)
        ("0 tokens", torch.zeros_like(full)), ("80 tokens", full))]
    cases.append(("H=512 17-80 tokens", 512, None))  # the Self-Monitor's encoder
    for label, H, lengths in cases:
        if lengths is None:
            lengths = cs.long_lengths(64, gen, dev)
        xs, w_ih, w_hh, b = cs.lstm_inputs(dtype, dev, gen, 64, H=H)
        wpack = torch.empty((4 * H * H,), dtype=dtype, device=dev)  # the wide walks' scratch
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
            def call(lib, name=name, argtypes=argtypes, train=train, wpack=wpack):
                fn, extra = lstm_entry(lib, name, argtypes, wpack)
                ptrs = [t.data_ptr() for t in (xs, lengths, w_ih, w_hh, b, gx, *fouts,
                                               *(carries if train else ()))] + extra

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
        # db's partial sums: a row each cluster of the walk, clusters of 8
        # rows or the resident walk's (this tree's plan); the larger serves both
        db_rows = max(-(-B // 8), kl.bwd_plan_query(B, H, dtype)[2])
        scratch = (torch.empty((B, L, 4 * H), **f32), torch.empty((db_rows, 4 * H), **f32))

        def call(lib, wpack=wpack):
            fn, extra = lstm_entry(lib, "lstm_scan_bwd", kl._BWD_ARGTYPES, wpack)

            def run(i):
                err = fn(*(t.data_ptr() for t in (*res, *scratch, *outs)), *extra, B, L, D, H, 0,
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
    q = torch.randn(B, D + A, generator=gen, device=dev) / 32
    groups = kc.cand_score_plan(B, MC).grid[1]
    for mode in cs.MODES:
        drop = cs.drop_spec(mode, B, MC, D, gen, dev)
        dargs = c_args(drop, B, MC, D, sets[0].device, "cand_score", dtype)
        want6 = kc.cand_score_plain(sets[0], ang, valid, q, drop)
        logits = torch.empty((B, MC + 1), device=dev)

        def call6(lib, dargs=dargs, logits=logits, drop=drop):  # drop keeps the mask alive
            fn = entry(lib, "cand_score", kc._FWD_ARGTYPES)

            def run(i):
                err = fn(sets[i % 8].data_ptr(), ang.data_ptr(), valid.data_ptr(), q.data_ptr(),
                         logits.data_ptr(), B, MC, D, A, build.DTYPE_CODES[dtype], *dargs,
                         groups, build.stream_handle(logits))
                build.check_launch(err, "cand_score")
            return run

        def check6(tag, want=want6, logits=logits, mode=mode):
            e = cs.compare((logits,), (want,), 1e-4)
            cs.check(e[0] <= e[1], f"K6 {tag} {dtype} {mode}: {e[0]:.3g} > {e[1]:.3g}")
        yield "cand_score", mode, call6, check6, None, None

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


def pano_cases(dtype, dev, gen):
    B0, V, D, A, MC = 64, 36, 2048, 128, 16
    # the synthetic world's feature distribution (world/synthetic.py), and
    # the same with every second value 0, as a ReLU leaves many
    features = (torch.randn(768, V, D, generator=gen, device=dev) * 0.5 + 0.5).to(dtype)
    zeros = features * (torch.arange(D, device=dev) % 2).to(dtype)
    loc = torch.from_numpy(all_loc_embeddings()).to(dev)
    node_sets = [torch.randint(0, 768, (B0,), generator=gen, device=dev) for _ in range(8)]
    views = torch.randint(0, V, (B0,), generator=gen, device=dev)
    cand_view = torch.randint(0, V, (B0, MC), generator=gen, device=dev)
    tv = torch.randn(B0, D + A, generator=gen, device=dev) / 32
    d_vis = torch.randn(B0, D + A, generator=gen, device=dev)
    for B, mode, table in ([(B0, m, features) for m in cs.MODES]
                           + [(B0 - 3, "prng_shared", features), (B0, "prng_shared", zeros)]):
        case = f"{mode} B={B}" + (" zeros" if table is zeros else "")
        sets = [n[:B].contiguous() for n in node_sets]
        vw, cv, q, dv = (t[:B].contiguous() for t in (views, cand_view, tv, d_vis))
        drop = cs.drop_spec(mode, B, V, D, gen, dev)
        dargs = c_args(drop, B, V, D, table.device, "pano_attend", dtype)
        want = kp.pano_attend_plain(sets[0], vw, cv, table, loc, q, drop)
        want5 = kp.pano_attend_bwd_plain(sets[0], vw, table, loc, want[1], dv, drop)
        bounds = cs.pano_bounds(sets[0], vw, cv, table, q, want, drop)
        vis = torch.empty((B, D + A), device=dev)
        alpha = torch.empty((B, V), device=dev)
        cand = torch.empty((B, MC, D), dtype=dtype, device=dev)
        d_tv = torch.empty((B, D + A), device=dev)

        def call4(lib, dargs=dargs, drop=drop, sets=sets, vw=vw, cv=cv, q=q, vis=vis, alpha=alpha,
                  cand=cand, B=B, table=table):
            fn = entry(lib, "pano_attend", kp._ARGTYPES)

            def run(i):
                err = fn(sets[i % 8].data_ptr(), vw.data_ptr(), cv.data_ptr(), table.data_ptr(),
                         loc.data_ptr(), q.data_ptr(), vis.data_ptr(), alpha.data_ptr(),
                         cand.data_ptr(), B, V, D, A, MC, build.DTYPE_CODES[dtype], *dargs,
                         build.stream_handle(vis))
                build.check_launch(err, "pano_attend")
            return run

        def check4(tag, want=want, vis=vis, alpha=alpha, cand=cand, case=case):
            cs.check(torch.equal(cand, want[2]), f"K4 {tag} {dtype} {case}: candidate rows")
            e = cs.compare((vis, alpha), want[:2], 1e-4)
            cs.check(e[0] <= e[1], f"K4 {tag} {dtype} {case}: {e[0]:.3g} > {e[1]:.3g}")
        yield "pano_attend", case, call4, check4, bounds[0], None

        def call5(lib, dargs=dargs, drop=drop, sets=sets, vw=vw, alpha=want[1], dv=dv, d_tv=d_tv,
                  B=B, table=table):
            fn = entry(lib, "pano_attend_bwd", kp._BWD_ARGTYPES)

            def run(i):
                err = fn(sets[i % 8].data_ptr(), vw.data_ptr(), table.data_ptr(),
                         loc.data_ptr(), alpha.data_ptr(), dv.data_ptr(), d_tv.data_ptr(), B, V,
                         D, A, build.DTYPE_CODES[dtype], *dargs, build.stream_handle(d_tv))
                build.check_launch(err, "pano_attend_bwd")
            return run

        def check5(tag, want=want5, d_tv=d_tv, case=case):
            e = cs.compare((d_tv,), (want,), 1e-4)
            cs.check(e[0] <= e[1], f"K5 {tag} {dtype} {case}: {e[0]:.3g} > {e[1]:.3g}")
        yield "pano_attend_bwd", case, call5, check5, bounds[1], None


CASES = {"pano": pano_cases, "cand": cand_cases, "lstm": lstm_cases}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", choices=tuple(CASES), default=list(CASES),
                    help="kernel groups to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [SOURCES[k] for k in args.kernels]
    libs = {"other": build_tree("other", Path(args.other).resolve(), names),
            "this": build_tree("this", ROOT, names)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, case, call, check, bound, lib in (item for k in args.kernels
                                                      for item in CASES[k](dtype, dev, gen)):
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
            elif bound is not None:
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "bound", "bound_ms": bound[0], "bound_by": bound[1]})
            lstm = kernel.startswith("lstm_scan")
            iters = 20 if lstm else 100
            src = ("lstm_scan" if lstm else "pano_fused" if kernel.startswith("pano")
                   else "cand_score")
            for turn, tag in enumerate(("other", "this", "this", "other")):
                run = call(libs[tag][src])
                run(0)
                torch.cuda.synchronize()
                check(tag)
                ms, _, split = cs.device_time_ms(run, iters)
                event_ms = cs.cuda_time_ms(run, iters)
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case, "tree": tag,
                             "turn": turn, "device_ms": ms, "event_ms": event_ms,
                             "split": {k: v[0] for k, v in split.items()}})
                cs.log(f"{kernel:22s} {str(dtype):14s} {case:16s} {tag:5s} (turn {turn}): "
                       f"device {ms:.4f} ms, event {event_ms:.4f} ms | "
                       + ", ".join(f"{k} {v[0]:.4f}" for k, v in split.items()))
    cs.log(cs.card_line())
    cs.log(json.dumps({"ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
