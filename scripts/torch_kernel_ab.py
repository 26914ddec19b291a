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
checkout's plain version (the tolerances of the card tests,
``tests/test_torch_card_kernels.py``).

* ``pano``: K4 and K5 (``csrc/pano_fused.cu``) at B = 64, 36 views of
  2048 + 128 features (the synthetic world's distribution, N(0.5, 0.5^2)),
  MC = 16, in the four mask modes, again at B = 61 in prng_shared (a short
  last group) and at B = 64 in prng_shared on a table with every second
  value 0 ("zeros"), rotating over 8 node sets whose rows together exceed
  the 50 MB L2, beside each kernel's bound (``benchmark/lib/costs.py``'s
  ``pano_bounds``).
* ``cand``: K6 and K7 (``csrc/cand_score.cu``) at B = 64, 16 candidates of
  2048 + 128 features, in the four mask modes, rotating over 8 candidate
  sets, beside ``torch.einsum`` for K7.
* ``lstm``: K3, K1 and K2 (``csrc/lstm_scan.cu``) at B = 64, L = 80, D = H
  = 256 at 11-20 and 17-80 tokens (K2 from K1's residuals), beside cuDNN's
  packed ``nn.LSTM`` (forward without and with autograd recording, and
  ``autograd.grad`` through it) and each kernel's bound
  (``benchmark/lib/costs.py``'s ``lstm_bounds``), and K3 and K1 also at 0
  and at 80 tokens in every row (the forward's fixed cost, and its full
  walk of 80 valid steps);
  then all three at the Self-Monitor's encoder shape, D = 256, H = 512, at
  17-80 tokens ("H=512": the wide walks, which take the packed-W_hh scratch,
  or in bf16 the resident walks, whose backward may write more rows of db's
  partial sums than clusters of 8 rows would: the scratch holds the larger),
  at the speaker's first layer, D = 2176, H = 256, L = 35 at full
  lengths ("speaker D=2176"; K2's bf16 GEMMs there run on wgmma, fed from
  a packed-operand scratch that a tree before them does not take), and K3
  and K1 at the beam's rescoring shapes ("beam rescoring": B = 30, L = 16,
  1-16 tokens with a 16; D = 2176 in bf16, 512 in f32, H = 256).  The
  device split names each launch (K1/K3's bf16 gates_x: ``gates_x_kernel``
  in a tree before its wgmma launch, ``gx_wgmma_kernel`` from it on).

Each turn is timed two ways: device ms a call (``device_time_ms``, summed
by kernel name, ``benchmark/lib/trace.py``'s ``kernel_label``) and
CUDA-event ms a call (``cuda_time_ms``) around the same back-to-back
calls through the C entry point, without the wrapper's checks.  The
inputs are the card tests' (``tests/torch_card_world.py``).  The two
timers and ``kernel_times`` are the repo's per-kernel timers:
``scripts/torch_embedding_bwd.py`` and ``scripts/torch_lstm_bwd_trace.py``
take them from here.  Prints one line per (kernel, dtype, case, tree, turn),
then the card's name and power limit, then one JSON object of every time.
All groups by default.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch_card_world as cw  # noqa: E402
from benchmark.lib import costs  # noqa: E402
from benchmark.lib.trace import kernel_label  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import build  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import cand_score as kc  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as kl  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as kp  # noqa: E402
from curriculum_learning_for_vln_torch.ops.cuda.drop import c_args  # noqa: E402
from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings  # noqa: E402

OUT = ROOT / "build" / "ab"
CSRC = "curriculum_learning_for_vln_torch/csrc"


SOURCES = {"lstm": "lstm_scan", "cand": "cand_score", "pano": "pano_fused"}
PREC = {torch.bfloat16: "bf16", torch.float32: "f32"}


def log(*args):
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` back-to-back calls between two
    CUDA events: the device's time, or the host's where the calls are
    issued more slowly than the device runs them."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int, warmup: int = 3, tries: int = 3):
    """(device ms, device events, per-name split) per call of ``fn(i)``:
    the summed durations of the device events (kernels, copies, sets) that
    ``iters`` calls launch, under torch.profiler, per call; the split maps
    each kernel name to (device ms, events) per call.  No host time enters
    it, however slowly the calls are issued; annotation spans are left
    out.  The times are taken name by name: each name's mean event times
    its whole number of events per call (at least one), summed over the
    names.  The profiler now and then loses events of a loop; such a loop
    is profiled again, and if a name still is not whole, its mean event
    still stands for it, so a lost event of a short kernel does not
    count as one of a long one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    best = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            by_name.setdefault(kernel_label(e.name), []).append(
                e.time_range.end - e.time_range.start)
        if sum(map(len, by_name.values())) > sum(map(len, best.values())):
            best = by_name
        if by_name and all(len(v) % iters == 0 for v in by_name.values()):
            break
    require(bool(best), "the profiler shows device events")
    split = {}
    for name, us in best.items():
        per_call = max(1, round(len(us) / iters))
        split[name] = (sum(us) / len(us) * per_call / 1e3, len(us) / iters)
    total = sum(ms for ms, _ in split.values())
    return total, sum(n for _, n in split.values()), split


def kernel_times(fn, iters: int, warmup: int = 3):
    """{ms, device_ms, device_events, device_split} of ``fn(i)``:
    CUDA-event ms and device-only ms, in all and by kernel name."""
    ms = cuda_time_ms(fn, iters, warmup)
    dev, n, split = device_time_ms(fn, iters, warmup)
    return {"ms": ms, "device_ms": dev, "device_events": n, "device_split": split}


def library_device_ms(fn, iters: int, what: str):
    """Device ms a call of one PyTorch library call; None where the call has
    no implementation for these inputs (no cuDNN RNN of this dtype)."""
    try:
        return device_time_ms(fn, iters)[0]
    except RuntimeError as e:
        log(f"  {what}: {e}".splitlines()[0])
        return None


def torch_lstm(xs, w_ih, w_hh, b):
    """torch.nn.LSTM (cuDNN) holding the kernels' weights in its layout."""
    D, H = w_ih.shape[0], w_hh.shape[0]
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(device=xs.device, dtype=xs.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()
    return lstm


def lstm_library(xs, lengths, w_ih, w_hh, b, iters):
    """cuDNN's torch.nn.LSTM on one packed direction: device ms of the
    forward without and with autograd recording, and of the backward of
    that forward's graph (None where cuDNN has no RNN of this dtype)."""
    lstm = torch_lstm(xs, w_ih, w_hh, b)
    x = xs.detach().clone().requires_grad_(True)
    what = f"torch.nn.LSTM in {xs.dtype}"

    def packed(t):
        return torch.nn.utils.rnn.pack_padded_sequence(t, lengths.cpu(), batch_first=True,
                                                       enforce_sorted=False)

    with torch.no_grad():
        infer_in = packed(xs)
        infer = library_device_ms(lambda i: lstm(infer_in), iters, what)
    fwd = library_device_ms(lambda i: lstm(packed(x)), iters, what)
    if fwd is None:
        return {"lstm_scan": infer, "lstm_scan_train": None, "lstm_scan_bwd": None}
    out, _ = lstm(packed(x))
    g = torch.randn_like(out.data)
    inputs = [x, *lstm.parameters()]
    bwd = library_device_ms(lambda i: torch.autograd.grad(out.data, inputs, g, retain_graph=True),
                            iters, what)
    return {"lstm_scan": infer, "lstm_scan_train": fwd, "lstm_scan_bwd": bwd}


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
        text = (src / f"{name}.cu").read_text()
        libs[name].takes_wpack = "void* wpack" in text
        libs[name].takes_pack = re.search(r"void\* pack\b", text) is not None
    return libs


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def lstm_entry(lib, symbol, argtypes, wpack, pack=None):
    """An LSTM scan's entry point and the extra pointers it takes after the
    tensors: the packed-W_hh scratch ``wpack`` and, for K2 (``pack`` given),
    the bf16 GEMMs' packed-operand scratch ``pack`` (their data pointers),
    each only where the tree's signature takes it (a tree before the wide
    walks: H = 256 only; one before the wgmma GEMMs takes no ``pack``)."""
    extra = [wpack.data_ptr()] if lib.takes_wpack else []
    if pack is not None and lib.takes_pack:
        extra.append(pack.data_ptr())
    ptrs = argtypes.index(ctypes.c_int)  # the pointers before the ints
    tensors = ptrs - (1 if pack is None else 2)
    return entry(lib, symbol, [ctypes.c_void_p] * (tensors + len(extra)) + argtypes[ptrs:]), extra


def lstm_cases(dtype, dev, gen):
    full = torch.full((64,), 80, device=dev)
    cases = [(label, 256, 256, 80, lengths) for label, lengths in (
        ("11-20 tokens", torch.randint(11, 21, (64,), generator=gen, device=dev)),
        ("17-80 tokens", cw.long_lengths(64, gen, dev)),
        # K3 and K1 only: the forward's fixed cost (no step valid) and its
        # full walk (every step valid)
        ("0 tokens", torch.zeros_like(full)), ("80 tokens", full))]
    cases.append(("H=512 17-80 tokens", 256, 512, 80, None))  # the Self-Monitor's encoder
    cases.append(("speaker D=2176", 2176, 256, 35, torch.full((64,), 35, device=dev)))
    # K3 and K1 only: the beam's rescoring (the speaker's first layer in
    # bf16, its post-LSTM in f32; B = 30, 1-16 tokens with a 16)
    beam = torch.randint(1, 17, (30,), generator=gen, device=dev)
    beam[0] = 16
    cases.append(("beam rescoring", 2176 if dtype == torch.bfloat16 else 512, 256, 16, beam))
    for label, D, H, L, lengths in cases:
        if lengths is None:
            lengths = cw.long_lengths(64, gen, dev)
        xs, w_ih, w_hh, b = cw.lstm_inputs(dtype, dev, gen, lengths.shape[0], L=L, D=D, H=H)
        wpack = torch.empty((4 * H * H,), dtype=dtype, device=dev)  # the wide walks' scratch
        B, L, D = xs.shape
        H = w_hh.shape[0]
        valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
        f32 = dict(dtype=torch.float32, device=dev)
        uniform = label in ("0 tokens", "80 tokens")
        fwd_only = uniform or label == "beam rescoring"
        steps = int(lengths.clamp(max=L).sum())
        bounds = {name: s * 1e3 for name, s in zip(
            ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"),
            costs.lstm_bounds(B, L, D, H, steps, PREC[dtype]).values())}
        libs = (dict.fromkeys(("lstm_scan", "lstm_scan_train")) if uniform else
                lstm_library(xs, lengths, w_ih, w_hh, b, 20))

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
                e = cw.compare(got, want, 1e-4)
                require(e[0] <= e[1], f"{name} {tag} {dtype} {label}: {e[0]:.3g} > {e[1]:.3g}")
            yield name, label, call, check, bounds[name], libs[name]
        if fwd_only:
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
        # this tree's bf16 GEMM operands, packed by valid step (f32: none)
        pack = torch.empty((B * L * (D + 15 * H) if dtype == torch.bfloat16 else 0,),
                           dtype=dtype, device=dev)

        def call(lib, wpack=wpack, pack=pack):
            fn, extra = lstm_entry(lib, "lstm_scan_bwd", kl._BWD_ARGTYPES, wpack, pack)

            def run(i):
                err = fn(*(t.data_ptr() for t in (*res, *scratch, *outs)), *extra, B, L, D, H, 0,
                         build.DTYPE_CODES[dtype], build.stream_handle(xs))
                build.check_launch(err, "lstm_scan_bwd")
            return run

        def check(tag):
            e = cw.compare(outs[:1], want[:1], 1e-4 if dtype == torch.float32 else 8e-3)
            require(e[0] <= e[1], f"K2 {tag} {dtype} {label}: d_xs {e[0]:.3g} > {e[1]:.3g}")
            e = cw.compare(outs[1:], want[1:], 1e-4)
            require(e[0] <= e[1], f"K2 {tag} {dtype} {label}: dW {e[0]:.3g} > {e[1]:.3g}")
        yield "lstm_scan_bwd", label, call, check, bounds["lstm_scan_bwd"], libs["lstm_scan_bwd"]


def cand_cases(dtype, dev, gen):
    B, MC, D, A = 64, 16, 2048, 128
    sets = [torch.randn(B, MC, D, generator=gen, device=dev).to(dtype) for _ in range(8)]
    ang = torch.randn(B, MC, A, generator=gen, device=dev).to(dtype)
    valid = torch.rand(B, MC, generator=gen, device=dev) < 0.5
    d_logits = torch.randn(B, MC + 1, generator=gen, device=dev)
    q = torch.randn(B, D + A, generator=gen, device=dev) / 32
    groups = kc.cand_score_plan(B, MC).grid[1]
    for mode in cw.MODES:
        drop = cw.drop_spec(mode, B, MC, D, gen, dev)
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
            e = cw.compare((logits,), (want,), 1e-4)
            require(e[0] <= e[1], f"K6 {tag} {dtype} {mode}: {e[0]:.3g} > {e[1]:.3g}")
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
            e = cw.compare((out,), (want,), 1e-4)
            require(e[0] <= e[1], f"K7 {tag} {dtype} {mode}: {e[0]:.3g} > {e[1]:.3g}")
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
    for B, mode, table in ([(B0, m, features) for m in cw.MODES]
                           + [(B0 - 3, "prng_shared", features), (B0, "prng_shared", zeros)]):
        case = f"{mode} B={B}" + (" zeros" if table is zeros else "")
        sets = [n[:B].contiguous() for n in node_sets]
        vw, cv, q, dv = (t[:B].contiguous() for t in (views, cand_view, tv, d_vis))
        drop = cw.drop_spec(mode, B, V, D, gen, dev)
        dargs = c_args(drop, B, V, D, table.device, "pano_attend", dtype)
        want = kp.pano_attend_plain(sets[0], vw, cv, table, loc, q, drop)
        want5 = kp.pano_attend_bwd_plain(sets[0], vw, table, loc, want[1], dv, drop)
        bounds = [s * 1e3 for s in costs.pano_bounds(
            B, int(torch.unique(sets[0]).numel()), int(torch.unique(vw).numel()), V, D, A, MC,
            PREC[dtype], mode.startswith("prng")).values()]
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
            require(torch.equal(cand, want[2]), f"K4 {tag} {dtype} {case}: candidate rows")
            e = cw.compare((vis, alpha), want[:2], 1e-4)
            require(e[0] <= e[1], f"K4 {tag} {dtype} {case}: {e[0]:.3g} > {e[1]:.3g}")
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
            e = cw.compare((d_tv,), (want,), 1e-4)
            require(e[0] <= e[1], f"K5 {tag} {dtype} {case}: {e[0]:.3g} > {e[1]:.3g}")
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
    gen = torch.Generator(device=dev).manual_seed(cw.SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, case, call, check, bound, lib in (item for k in args.kernels
                                                      for item in CASES[k](dtype, dev, gen)):
            if call is None:  # the library call: no tree, no turns
                ms = device_time_ms(check, 100)[0]
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "library", "device_ms": ms})
                log(f"{kernel:22s} {str(dtype):14s} {case:13s} library: {ms:.4f} ms")
                continue
            if lib is not None:  # the LSTM kernels' cuDNN yardstick and bound
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "library", "device_ms": lib, "bound_ms": bound})
                log(f"{kernel:22s} {str(dtype):14s} {case:13s} cuDNN nn.LSTM: {lib:.4f} ms; "
                    f"bound {bound:.4f} ms")
            elif bound is not None:
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case,
                             "tree": "bound", "bound_ms": bound})
            lstm = kernel.startswith("lstm_scan")
            iters = 20 if lstm else 100
            src = ("lstm_scan" if lstm else "pano_fused" if kernel.startswith("pano")
                   else "cand_score")
            for turn, tag in enumerate(("other", "this", "this", "other")):
                run = call(libs[tag][src])
                run(0)
                torch.cuda.synchronize()
                check(tag)
                ms, _, split = device_time_ms(run, iters)
                event_ms = cuda_time_ms(run, iters)
                rows.append({"kernel": kernel, "dtype": str(dtype), "case": case, "tree": tag,
                             "turn": turn, "device_ms": ms, "event_ms": event_ms,
                             "split": {k: v[0] for k, v in split.items()}})
                log(f"{kernel:22s} {str(dtype):14s} {case:16s} {tag:5s} (turn {turn}): "
                       f"device {ms:.4f} ms, event {event_ms:.4f} ms | "
                       + ", ".join(f"{k} {v[0]:.4f}" for k, v in split.items()))
    log(card_line())
    log(json.dumps({"ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
