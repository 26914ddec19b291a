#!/usr/bin/env python3
"""Drive the PyTorch port's EnvDrop serving and training paths, the
paper's curriculum recipe, the Follower and Self-Monitor agents, and the
speaker with back-translation, on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # build + kernel phases only: the
                                           # short first call for a new kernel

1. Prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions.
2. Builds the port's CUDA kernels from ``curriculum_learning_for_vln_
   torch/csrc`` (one ``nvcc`` per source, all at once, anew) and prints the
   compiler's register and spill report; the resident LSTM walks
   (``recurrence_res_kernel`` and ``bwd_recurrence_res_kernel``, which hold
   W_hh in registers), each instantiation printed by name, must show no
   spills and at most 128 registers a thread.
3. Kernel phases (in a full run, after phase 8, so that their profiler
   sessions do not come before the timed serve calls), in bf16 and f32:
   each kernel on the card at its path's shapes, held against its plain
   PyTorch version on the same inputs and timed beside its plain version,
   one PyTorch library call where there is one, and the least time the
   card could take.  Each kernel and library
   call gets two times per call: ``ms``, CUDA events around 100
   back-to-back calls (the host's time where the wrapper issues calls
   more slowly than the device runs them), and ``device_ms``, the summed
   durations of the device events of the same loop under torch.profiler
   (``device_events`` of them per call, taken kernel name by kernel
   name: K1-K3 print each launch's share), which no host time enters;
   comparisons with the library call and the bound use ``device_ms``.
   K6 and K7 are also checked at B = 61 in prng_shared (a short last
   group), K4 and K5 at B = 61 and B = 1 in every mode (their candidate
   rows exactly; each launch plan, S, G', blocks and shared memory, is
   printed, held equal to the one the C entry points compute, and
   beside it the clusters the card holds at once), K1-K3 at B = 61 over
   ragged lengths with a 0 and an 80 (a
   short last cluster) and K8 at (B, Din, H) = (37, 200, 48), before any
   timing; K2's bf16 d_xs must differ from its plain version in under 1%
   of its elements (both round one f32 product once):
   K3 (LSTM scan), K1 and K2 (training forward and backward of the scan;
   at the token lengths of the synthetic instructions, which the serve and
   train phases run, and at lengths up to MAX_ENC_LEN = 80), K4 and K5
   (observation step forward and backward) and K6 and K7 (candidate
   scoring forward and backward), the last four in the mask modes none,
   ext, prng and prng_shared (the plain prng modes draw the kernels'
   Philox bits, so they are held to the tolerance of the arithmetic), and
   K8 (the fused LSTM cell, which no path runs) at the EnvDrop decoder
   cell's shape beside ``torch.lstm_cell``.  K1-K3 also run the Follower's
   and the Self-Monitor's encoder layers (D = 300 then 256 at H = 128; D =
   256 at H = 512, the resident walk in bf16) at lengths up to 80 and at
   B = 61 over ragged lengths (the Self-Monitor's also at B = 40 and 1: one
   row group; K2's bf16 d_xs differing from plain in under 1% there too),
   each beside cuDNN's ``nn.LSTM`` and its bound, and the speaker
   encoder's layers ((D, H) = (2176, 256) and (512, 256)) at L = 35 full
   lengths and at B = 61 over ragged ones.  The forward and the
   backward walks' plans at the Self-Monitor's shape (B = 64, 61 and 1,
   bf16 and f32) are printed: blocks a cluster, rows a cluster, where W_hh
   sits, and the clusters against those the card holds at once
   (cudaOccupancyMaxActiveClusters), held equal to the C entry points' own
   plans (``lstm_scan.plan_query``, ``bwd_plan_query``); a plan of more
   than one wave fails.
4. Serve phase: EnvDrop at the full width of
   ``configs/envdrop/envdrop_config.yaml`` (random weights from a seed) on
   a synthetic world of 12 scans x 64 nodes with 2048-d features, answering
   micro-batches of 64 requests through ``Navigator.navigate_batch``.
   Checks the trajectories, the launches (K3 twice, K4 and K6 once per
   decoder step), and the plain versions' first-step logits.
5. Training phase: the same world and width, ``PACKED_RL 0``,
   ``OBS_MASKS prng``, bf16, B = 64, T = 35.  (a) One iteration's loss and
   clipped gradients through the kernels against the plain versions on the
   card, from the same parameters, batch and generator seed.  (b) Timed
   iterations of ``engine.loop.one_iter`` with the launches of each
   checked exactly (K1 = K2 = 4, K3 = 0, K4 = K6 = T_il + 36, K5 = K7 =
   T_il + 35) and a profile of one.  (c) Finite losses and changed
   parameters.  (d) A checkpoint written by the port, served by the port's
   ``Navigator``.
6. Curriculum phase: ``configs/envdrop/envdrop_cl_config.yaml`` as
   shipped (PACKED_RL 3), the same world and width, its request paths cut
   into 5 rounds by length.  (a) ``NaiveCurriculum(switch_epoch=1)``, 2
   epochs x 2 iterations and an evaluation: round_1, then the cumulative
   round_2.  (b) One SPCL packed weighted iteration in ``OBS_MASKS
   prng_shared`` through the kernels against the plain versions (loss and
   every gradient leaf).  (c) + (d) ``SelfPacedCurriculum.train``, one
   epoch of packed iterations, each with its launches checked exactly (K1
   = K2 = 4, K4 = K6 = T_il + 36, K5 = K7 = T_il + 35) and timed: ms,
   episodes done, completed episodes/s, and the device-busy share of one
   under the profiler.  (e) The SPCL update at the epoch's end (BURN_IN 0,
   INTERVAL 1) against a numpy recomputation.
7. Agents phase: the Follower (``configs/follower/follower_config.yaml``)
   and the Self-Monitor (``configs/monitor/selfmonitor_config.yaml``) at
   full width, bf16, B = 64, T = 10, seeded random weights, on the same
   world.  (a) ``Navigator.navigate_batch`` on 64-request micro-batches:
   trajectories, first-step logits against the plain versions, latency,
   and the launches of every call exactly (Follower K3 = 4, K4 = 10;
   Self-Monitor K3 = 1, K4 = 10).  (b) One sample-feedback training
   iteration through the kernels against the plain versions from the same
   parameters, batch and generator seed: the loss, every gradient leaf and
   the Self-Monitor's BN running statistics.  (c) Timed classic iterations
   (``engine.loop.agent_one_iter``, Adam, no clip) with exact launches
   (Follower K1 = K2 = 4, K4 = K5 = 10; Self-Monitor K1 = K2 = 1, K4 = 10,
   K5 = 0) and the device-busy share of one under the profiler.  (d) One
   SPCL-weighted iteration on the ``_cl_`` config as shipped (PACKED_RL
   ignored for these agents): its loss is dot(w, ml_vec) / sum(w)
   recomputed in numpy.  (e) ``check_the_code`` on the synthetic
   val_unseen split: SR 1.0.
8. Speaker phase: the speaker at the default ``AIDE.SPEAKER`` (RNN_DIM
   512, WEMB 256, MAX_DECODE 120) on the EnvDrop config's world, bf16, B =
   64, T = 35, seeded random weights.  (a) One teacher-forcing step through
   the kernels against the plain versions: the loss and every gradient
   leaf (K1 = K2 = 4: two layers, two directions).  (b) Timed teacher-
   forcing steps with exact launches and the device-busy share of one.
   (c) Greedy and sampled decodes and ``back_translate`` with its shared
   noise mask, each with K3 = 4 exactly, timed; the first step's logits
   against the plain versions.  (d) ``engine.self_train`` (2 speaker
   steps, 4 iterations), each call's launches exact: a real iteration as
   the training phase's at T_il = T, ``back_translate`` K3 = 4, a back-
   translated iteration K1 = K2 = 4 and K4-K7 = 0 (its decode is the
   unfused one); finite losses, moved parameters.  (e) A speaker
   checkpoint read back with its optimizer state, and ``main
   --self-train`` on a synthetic world for one short epoch.
9. Prints one ``{"kernels": [...]}`` line (with each kernel's launches on
   the Follower's, the Self-Monitor's and the speaker's paths), the card's
   name and power limit, and as the last line ``{"ok": true, "device":
   {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device, or without the port beside it, it fails.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

SEED = 0
BATCH = 64
NUM_SCANS, NODES_PER_SCAN, FEAT_DIM = 12, 64, 2048
CONFIG = "configs/envdrop/envdrop_config.yaml"
CL_CONFIG = "configs/envdrop/envdrop_cl_config.yaml"
VOCAB = "assets/train_vocab.txt"
SERVE_CALLS = 4          # distinct micro-batches of BATCH requests
SERVE_ROUNDS = 2         # timed passes over them
TRAIN_ITERS = 6          # timed training iterations (after one warm-up)
CURRICULUM_ITERS = 8     # SPCL packed iterations (a warm-up, 6 timed, one profiled)
MODES = ("none", "ext", "prng", "prng_shared")
RAGGED_CELL = (37, 200, 48)  # (B, Din, H) of K8's check at ragged edges
AGENT_CONFIGS = {"FOLLOWER": ("configs/follower/follower_config.yaml",
                              "configs/follower/follower_cl_config.yaml"),
                 "SELF-MONITOR": ("configs/monitor/selfmonitor_config.yaml",
                                  "configs/monitor/selfmonitor_cl_config.yaml")}
AGENT_T = 10  # their configs' MAX_EPISODE_LEN
# (D, H) of the Follower's and the Self-Monitor's encoder layers (K1-K3)
AGENT_LSTM_SHAPES = {"monitor": (256, 512), "follower_l1": (300, 128), "follower_l2": (256, 128)}
SPEAKER_ITERS = 4  # timed speaker teacher-forcing steps (after one warm-up)
SPEAKER_T = 35     # envdrop_config.yaml's MAX_EPISODE_LEN: the speaker's steps, all full
# (D, H) of the speaker encoder's layers (K1-K3): the BiLSTM over the chosen
# candidates' 2048 + 128 features, and the post-LSTM over its 2 x 256 outputs
SPEAKER_LSTM_SHAPES = {"speaker_l1": (FEAT_DIM + 128, 256), "speaker_post": (512, 256)}

# Published H100 SXM peaks (dense), used for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# name -> (source, TPU kernel it replaces, launch counter: module, attribute)
KERNELS = {
    "lstm_scan_train": ("csrc/lstm_scan.cu", "ops/pallas/lstm_scan.py:177",
                        "lstm_scan", "train_launches"),
    "lstm_scan_bwd": ("csrc/lstm_scan.cu", "ops/pallas/lstm_scan.py:299",
                      "lstm_scan", "bwd_launches"),
    "lstm_scan": ("csrc/lstm_scan.cu", "ops/pallas/lstm_scan.py:76", "lstm_scan", "launches"),
    "pano_attend": ("csrc/pano_fused.cu", "ops/pallas/pano_fused.py:224",
                    "pano_fused", "launches"),
    "pano_attend_bwd": ("csrc/pano_fused.cu", "ops/pallas/pano_fused.py:294",
                        "pano_fused", "bwd_launches"),
    "cand_score": ("csrc/cand_score.cu", "ops/pallas/cand_score.py:113",
                   "cand_score", "launches"),
    "cand_score_bwd": ("csrc/cand_score.cu", "ops/pallas/cand_score.py:151",
                       "cand_score", "bwd_launches"),
    "lstm_cell": ("csrc/lstm_cell.cu", "ops/pallas/lstm.py:47", "lstm_cell", "launches"),
}
# K8 is on no path of either package (ops/rnn.py keeps the decoder's cell
# plain): the kernel phase alone launches it.
OFF_PATH = ("lstm_cell",)


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
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


def kernel_label(name: str) -> str:
    """A device event's kernel name without its namespace, template
    arguments and parameter list: "dw_gemm_kernel<float>(...)" ->
    "dw_gemm_kernel"."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = base.split("(")[0].split("<")[0].rsplit("::", 1)[-1].strip()
    return base or name


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
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for i in range(warmup):
        fn(i)
    best = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    check(bool(best), "the profiler shows device events")
    split = {}
    for name, us in best.items():
        per_call = max(1, round(len(us) / iters))
        split[name] = (sum(us) / len(us) * per_call / 1e3, len(us) / iters)
    total = sum(ms for ms, _ in split.values())
    return total, sum(n for _, n in split.values()), split


def kernel_times(fn, iters: int, warmup: int = 3):
    """{ms, device_ms, device_events, device_split} of ``fn(i)``:
    CUDA-event ms (``cuda_time_ms``) and device-only ms, in all and by
    kernel name (``device_time_ms``)."""
    ms = cuda_time_ms(fn, iters, warmup)
    dev, n, split = device_time_ms(fn, iters, warmup)
    return {"ms": ms, "device_ms": dev, "device_events": n, "device_split": split}


def library_times(fn, iters: int, what: str):
    """``kernel_times`` of one PyTorch library call, prefixed "library_";
    all None where the call has no implementation for these inputs."""
    try:
        t = kernel_times(fn, iters)
    except RuntimeError as e:  # e.g. no cuDNN RNN or fused cell of this dtype: no yardstick
        log(f"  {what}: {e}".splitlines()[0])
        t = dict.fromkeys(("ms", "device_ms", "device_events"))
    return {f"library_{k}": v for k, v in t.items() if k != "device_split"}


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(got, want, rtol: float):
    """(max |got - want|, its tolerance rtol * max(1, max |want|)) over
    pairs of tensors."""
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    return err, rtol * max(1.0, scale)


def modules():
    from curriculum_learning_for_vln_torch.ops.cuda import (cand_score, lstm_cell, lstm_scan,
                                                            pano_fused)

    return {"lstm_scan": lstm_scan, "pano_fused": pano_fused, "cand_score": cand_score,
            "lstm_cell": lstm_cell}


def launch_counts():
    mods = modules()
    return {name: getattr(mods[m], attr) for name, (_, _, m, attr) in KERNELS.items()}


def reset_launch_counts():
    mods = modules()
    for _, _, m, attr in KERNELS.values():
        setattr(mods[m], attr, 0)


@contextmanager
def plain_kernels():
    """Route every kernel op to its plain version, on the card, for the
    reference runs; the wrappers' launch counts stay untouched."""
    mods = modules()
    names = {"lstm_scan": ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"),
             "pano_fused": ("pano_attend", "pano_attend_bwd"),
             "cand_score": ("cand_score", "cand_score_bwd"),
             "lstm_cell": ("lstm_cell",)}
    saved = {(m, f): getattr(mods[m], f) for m, fs in names.items() for f in fs}
    for (m, f) in saved:
        setattr(mods[m], f, getattr(mods[m], f + "_plain"))
    try:
        yield
    finally:
        for (m, f), fn in saved.items():
            setattr(mods[m], f, fn)


def drop_spec(mode, B, rows, D, gen, device, keep=0.7):
    from curriculum_learning_for_vln_torch.ops import philox
    from curriculum_learning_for_vln_torch.ops.cuda.drop import NO_DROP, DropSpec

    if mode == "none":
        return NO_DROP
    if mode == "ext":
        return DropSpec("ext", mask=torch.rand((B, rows, D), generator=gen, device=device) < keep,
                        keep=keep)
    return DropSpec(mode, seeds=philox.draw_seeds(B, gen, device), keep=keep)


def drop_bytes(drop) -> int:
    return nbytes(drop.mask) if drop.mode == "ext" else (
        nbytes(drop.seeds) if drop.mode in ("prng", "prng_shared") else 0)


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def lstm_inputs(dtype, device, gen, B, L=80, D=256, H=256):
    def u(*shape):
        return ((torch.rand(*shape, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)

    xs = torch.randn(B, L, D, generator=gen, device=device).to(dtype)
    return xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)


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
    """torch.nn.LSTM on one packed direction: (``library_times`` of the
    forward with autograd recording, of the backward of that forward's
    graph), all None where cuDNN has no RNN of this dtype."""
    lstm = torch_lstm(xs, w_ih, w_hh, b)
    x = xs.detach().clone().requires_grad_(True)
    what = f"torch.nn.LSTM in {xs.dtype}"

    def fwd(i):
        return lstm(torch.nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                                            enforce_sorted=False))

    lib_fwd = library_times(fwd, iters, what)
    if lib_fwd["library_ms"] is None:
        return lib_fwd, dict(lib_fwd)
    out, _ = fwd(0)
    g = torch.randn_like(out.data)
    inputs = [x, *lstm.parameters()]
    lib_bwd = library_times(lambda i: torch.autograd.grad(out.data, inputs, g, retain_graph=True),
                            iters, what)
    return lib_fwd, lib_bwd


def long_lengths(B, gen, device, lo=16, hi=80):
    """Token lengths uniform in lo..hi (hi = MAX_ENC_LEN, the cap that real
    R2R instructions reach), one of them hi: the LSTM kernels' serial loop
    runs to the longest row of each cluster, so its time grows with them."""
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
    lengths[0] = hi
    return lengths


def lstm_phases(dtype, device, gen, lengths, iters=20, D=256, H=256, L=80):
    """K3, K1 and K2 at an encoder layer's shapes (B = 64, L = 80; EnvDrop's
    D = H = 256 by default), both directions, over the token lengths
    ``lengths``."""
    k = modules()["lstm_scan"]
    B = lengths.shape[0]
    xs, w_ih, w_hh, b = lstm_inputs(dtype, device, gen, B, L, D, H)
    L, D, H = xs.shape[1], xs.shape[2], w_hh.shape[0]
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    d_out = torch.randn(B, L, H, generator=gen, device=device)
    dhT, dcT = (torch.randn(B, H, generator=gen, device=device) for _ in range(2))
    # each output group with its own tolerance; the worst of both directions
    err = {"lstm_scan": {}, "lstm_scan_train": {}, "lstm_scan_bwd": {}}

    def worst(name, part, e):  # the comparison nearest its tolerance
        err[name][part] = max(err[name].get(part, (0.0, float("inf"))), e,
                              key=lambda x: x[0] - x[1])

    differ = 0.0  # the largest share of d_xs elements at valid steps where K2 != plain

    for reverse in (False, True):
        out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        worst("lstm_scan", "outs,hT,cT", compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4))
        tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        tp = k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        # f32 state from the same rounded inputs: the order of the sums differs
        worst("lstm_scan_train", "outs,hT,cT,hprev,cprev,gates",
              compare((tk[0], *tk[1], tk[2], tk[3], tk[4][valid]),
                      (tp[0], *tp[1], tp[2], tp[3], tp[4][valid]), 1e-4))
        # K2 from the kernel's residuals; d_xs in the dtype of xs (bf16: one ulp is 2^-8)
        gk = k.lstm_scan_bwd(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT,
                             reverse=reverse)
        gp = k.lstm_scan_bwd_plain(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT,
                                   reverse=reverse)
        worst("lstm_scan_bwd", "d_xs",
              compare(gk[:1], gp[:1], 1e-4 if dtype == torch.float32 else 8e-3))
        worst("lstm_scan_bwd", "dW_ih,dW_hh,db", compare(gk[1:], gp[1:], 1e-4))
        check(bool((gk[0].float()[~valid] == 0).all()), "K2: d_xs is 0 at padded steps")
        # both round one f32 product to the dtype of xs once: they differ
        # only where the sums straddle a rounding boundary
        differ = max(differ, float((gk[0] != gp[0])[valid].float().mean()))

    tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b)
    times = {
        "lstm_scan": (kernel_times(lambda i: k.lstm_scan(xs, lengths, w_ih, w_hh, b,
                                                         reverse=bool(i & 1)), iters),
                      cuda_time_ms(lambda i: k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b), 3, 1)),
        "lstm_scan_train": (
            kernel_times(lambda i: k.lstm_scan_train(xs, lengths, w_ih, w_hh, b,
                                                     reverse=bool(i & 1)), iters),
            cuda_time_ms(lambda i: k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b), 3, 1)),
        "lstm_scan_bwd": (
            kernel_times(lambda i: k.lstm_scan_bwd(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3],
                                                   d_out, dhT, dcT), iters),
            cuda_time_ms(lambda i: k.lstm_scan_bwd_plain(xs, lengths, w_ih, w_hh, tk[4], tk[2],
                                                         tk[3], d_out, dhT, dcT), 3, 1)),
    }
    lib_fwd, lib_bwd = lstm_library(xs, lengths, w_ih, w_hh, b, iters)
    spec = {
        "lstm_scan": (lstm_library_infer(xs, lengths, w_ih, w_hh, b, iters),
                      "torch.nn.LSTM forward on a packed sequence (one direction)"),
        "lstm_scan_train": (lib_fwd,
                            "torch.nn.LSTM forward with autograd recording (one direction)"),
        "lstm_scan_bwd": (lib_bwd, "torch.autograd.grad through torch.nn.LSTM (one direction)"),
    }
    bounds = lstm_bounds(xs, lengths, w_ih, w_hh, b)
    out = []
    for name, (lib, call) in spec.items():
        t, plain_ms = times[name]
        out.append({"name": name, "max_abs_err": max(e for e, _ in err[name].values()),
                    "checks": {part: {"max_abs_err": e, "tol": tol}
                               for part, (e, tol) in err[name].items()},
                    "lengths": lengths_label(lengths), "valid_steps": bounds["valid_steps"],
                    **t, "plain_ms": plain_ms, **lib, "library_call": call,
                    "bound": bounds[name]})
    if dtype == torch.bfloat16:
        check(differ < 0.01, f"K2: bf16 d_xs differs from plain in {differ:.3%} of its elements")
        out[-1]["d_xs_differ"] = differ
    return out


def lstm_bounds(xs, lengths, w_ih, w_hh, b):
    """(bound ms, "bytes" or "operations") of K3, K1 and K2 per direction,
    from these inputs' valid steps, and their number: a per-step input
    that the function reads only at valid steps (xs, d_out, and K2's
    gates, hprev and cprev) counts those steps; an output counts its full
    size (outs, hT, cT; K1's hprev and cprev; d_xs, dW_ih, dW_hh, db).
    K1's gate residual is the port's own choice, not the function's, so
    K1's bound leaves it out (K2 reads it in place of recomputing x.W_ih
    and h.W_hh, so K2's counts it)."""
    B, L, D = xs.shape
    H = w_hh.shape[0]
    steps = int(lengths.clamp(max=L).sum())
    f32 = 4
    xs_valid = steps * D * xs.element_size()
    fwd_bytes = (xs_valid + nbytes(lengths, w_ih, w_hh, b) + B * L * H * f32
                 + 2 * B * H * f32)
    train_bytes = fwd_bytes + 2 * L * B * H * f32
    bwd_bytes = (xs_valid + nbytes(lengths, w_ih, w_hh) + 2 * B * H * f32  # + dhT, dcT
                 + steps * (4 * H + 2 * H + H) * f32      # gates, hprev, cprev, d_out
                 + nbytes(xs) + (D + H + 1) * 4 * H * f32)  # d_xs, dW_ih, dW_hh, db
    fwd_flops = 2 * steps * (D + H) * 4 * H
    bwd_flops = 2 * steps * 4 * H * (2 * H + 2 * D)
    return {"lstm_scan": bound_ms(fwd_bytes, fwd_flops, xs.dtype),
            "lstm_scan_train": bound_ms(train_bytes, fwd_flops, xs.dtype),
            "lstm_scan_bwd": bound_ms(bwd_bytes, bwd_flops, xs.dtype), "valid_steps": steps}


def kernel_resources(log_text: str, kernel: str):
    """[(entry, registers, spill store bytes, spill load bytes)] of each
    instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` report, matched
    by its mangled name (its length, then the name: ``recurrence_res_kernel``
    does not match ``bwd_recurrence_res_kernel``)."""
    mangled = f"{len(kernel)}{kernel}"
    out, entry, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])  # stack frame, spill stores, spill loads
        elif entry and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if mangled in entry:
                out.append((entry, regs, *spills))
            entry, spills = None, (0, 0)
    return out


def lstm_walk_plans(dtype, D=256, H=512, L=80):
    """The forward and the backward walks' plans at an encoder shape, B =
    64, 61 and 1: ``lstm_scan_fwd_plan`` / ``lstm_scan_bwd_plan`` from the
    clusters the card holds at once, held equal to the plans the C entry
    points compute (``plan_query`` / ``bwd_plan_query``), and one wave of
    clusters at most.  Returns {"fwd": [...], "bwd": [...]}."""
    k = modules()["lstm_scan"]
    elem = torch.empty((), dtype=dtype).element_size()
    plans = {"fwd": [], "bwd": []}
    for way, query, plan_of in (("fwd", k.plan_query, k.lstm_scan_fwd_plan),
                                ("bwd", k.bwd_plan_query, k.lstm_scan_bwd_plan)):
        for B in (BATCH, BATCH - 3, 1):
            q = query(B, H, dtype)
            p = plan_of(B, L, D, H, elem, clusters_at_once=q[5])
            check(q[:5] == (p.cluster, p.rows, p.clusters, p.rec_threads, p.rec_smem),
                  f"lstm_scan {way} {dtype} H={H} at B = {B}: plan {p} is the C plan {q}")
            waves = -(-p.clusters // q[6])
            w_regs = getattr(p, "w_regs", None)
            plans[way].append({"B": B, "D": D, "H": H, "cluster": p.cluster, "rows": p.rows,
                               "clusters": p.clusters, "blocks": p.rec_grid,
                               "threads": p.rec_threads, "smem": p.rec_smem,
                               "w_where": p.w_where, "w_regs": w_regs, "w_stream": p.w_stream,
                               "clusters_at_once": q[6], "clusters_at_once_planned": q[5],
                               "waves": waves})
            log(f"lstm_scan {way} walk {str(dtype):14s} D={D} H={H} B={B:2d}: W_hh: "
                f"{p.w_where}, cluster of {p.cluster} blocks, R = {p.rows} rows a cluster, "
                f"{p.clusters} clusters ({p.rec_grid} blocks) of {p.rec_threads} threads, "
                f"{p.rec_smem} B shared memory a block, "
                + (f"{w_regs} W_hh registers a thread, " if w_regs is not None else "")
                + f"{p.w_stream} B of W_hh streamed a step; the card holds {q[6]} of these "
                f"clusters at once (planned on {q[5]}): {waves} wave(s)")
            check(waves == 1, f"lstm_scan {way} {dtype} H={H} at B = {B}: {p.clusters} clusters "
                              f"of {p.cluster} need {waves} waves (the card holds {q[6]} at once)")
    return plans


def lstm_ragged(dtype, device, gen, B=61, L=80, D=256, H=256):
    """K3, K1 and K2 at B = 61 (a short last cluster of 5 rows) over
    ragged lengths 0..L, one row of length 0 and one of L, both
    directions, against their plain versions (the tolerances of
    ``lstm_phases``).  Returns {name: {part: {max_abs_err, tol}}}."""
    k = modules()["lstm_scan"]
    lengths = torch.randint(0, L + 1, (B,), generator=gen, device=device)
    lengths[0], lengths[-1] = 0, L
    xs, w_ih, w_hh, b = lstm_inputs(dtype, device, gen, B, L, D, H)
    H = w_hh.shape[0]
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    d_out = torch.randn(B, L, H, generator=gen, device=device)
    dhT, dcT = (torch.randn(B, H, generator=gen, device=device) for _ in range(2))
    res = {"lstm_scan": {}, "lstm_scan_train": {}, "lstm_scan_bwd": {}}

    def put(name, part, e):
        check(e[0] <= e[1], f"{name} {dtype} D={D} H={H} at B = {B}: {part} |kernel - plain| "
                            f"{e[0]:.3g} > {e[1]:.3g}")
        old = res[name].get(part, {"max_abs_err": 0.0, "tol": e[1]})
        res[name][part] = max(old, {"max_abs_err": e[0], "tol": e[1]},
                              key=lambda x: x["max_abs_err"] - x["tol"])

    for reverse in (False, True):
        out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        put("lstm_scan", "outs,hT,cT", compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4))
        tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        tp = k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        put("lstm_scan_train", "outs,hT,cT,hprev,cprev,gates",
            compare((tk[0], *tk[1], tk[2], tk[3], tk[4][valid]),
                    (tp[0], *tp[1], tp[2], tp[3], tp[4][valid]), 1e-4))
        gk = k.lstm_scan_bwd(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT,
                             reverse=reverse)
        gp = k.lstm_scan_bwd_plain(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT,
                                   dcT, reverse=reverse)
        put("lstm_scan_bwd", "d_xs",
            compare(gk[:1], gp[:1], 1e-4 if dtype == torch.float32 else 8e-3))
        put("lstm_scan_bwd", "dW_ih,dW_hh,db", compare(gk[1:], gp[1:], 1e-4))
        if dtype == torch.bfloat16:  # both round one f32 product to bf16 once
            differ = float((gk[0] != gp[0])[valid].float().mean()) if bool(valid.any()) else 0.0
            log(f"lstm_scan_bwd    bf16 D={D} H={H} at B = {B}, reverse={reverse}: d_xs differs "
                f"from plain in {differ:.4%} of its valid elements (limit 1%)")
            check(differ < 0.01, f"K2 bf16 D={D} H={H} at B = {B}: d_xs differs from plain in "
                                 f"{differ:.3%} of its elements")
    return res


def lengths_label(lengths) -> str:
    return (f"{int(lengths.min())}-{int(lengths.max())} tokens, mean "
            f"{float(lengths.float().mean()):.1f}")


def lstm_library_infer(xs, lengths, w_ih, w_hh, b, iters):
    lstm = torch_lstm(xs, w_ih, w_hh, b)
    with torch.no_grad():
        packed = torch.nn.utils.rnn.pack_padded_sequence(xs, lengths.cpu(), batch_first=True,
                                                         enforce_sorted=False)
        return library_times(lambda i: lstm(packed), iters, f"torch.nn.LSTM in {xs.dtype}")


def obs_phases(dtype, device, gen, features, B=BATCH, MC=16, iters=100):
    """K4 and K5 (one decoder step's observation op) and K6 and K7 (its
    candidate scorer) over the world's table, in the three mask modes."""
    mods = modules()
    kp, kc = mods["pano_fused"], mods["cand_score"]
    from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings

    N, V, D = features.shape
    A = 128
    loc = torch.from_numpy(all_loc_embeddings()).to(device)
    # eight index sets whose rows together exceed the 50 MB L2, so the
    # timed launches read their rows from device memory as a rollout does
    node_sets = [torch.randint(0, N, (B,), generator=gen, device=device) for _ in range(8)]
    views = torch.randint(0, V, (B,), generator=gen, device=device)
    cand_view = torch.randint(0, V, (B, MC), generator=gen, device=device)
    tv = torch.randn(B, D + A, generator=gen, device=device) / 32  # scores of O(1)
    d_vis = torch.randn(B, D + A, generator=gen, device=device)
    cand_sets = [features[n[:, None], cand_view].contiguous() for n in node_sets]
    # the angle rows in the table dtype, as env/env.py:103 makes them: no
    # conversion launch sits in K6/K7's timed calls
    cand_angle = torch.randn(B, MC, A, generator=gen, device=device).to(features.dtype)
    valid = torch.rand(B, MC, generator=gen, device=device) < 0.5
    q = torch.randn(B, D + A, generator=gen, device=device) / 32
    d_logits = torch.randn(B, MC + 1, generator=gen, device=device)
    # K6 at a batch that is not a multiple of 8: a short last prng_shared group
    Br = B - 3
    cd = drop_spec("prng_shared", Br, MC, D, gen, device)
    rargs = (cand_sets[0][:Br].contiguous(), cand_angle[:Br].contiguous(), valid[:Br].contiguous(),
             q[:Br].contiguous())
    e_r = compare((kc.cand_score(*rargs, cd),), (kc.cand_score_plain(*rargs, cd),), 1e-4)
    check(e_r[0] <= e_r[1], f"cand_score {dtype} prng_shared at B = {Br}: |kernel - plain| "
                            f"{e_r[0]:.3g} > {e_r[1]:.3g}")
    dr = d_logits[:Br].contiguous()
    e_rb = compare((kc.cand_score_bwd(*rargs[:3], dr, cd),),
                   (kc.cand_score_bwd_plain(*rargs[:3], dr, cd),), 1e-4)
    check(e_rb[0] <= e_rb[1], f"cand_score_bwd {dtype} prng_shared at B = {Br}: |kernel - plain| "
                              f"{e_rb[0]:.3g} > {e_rb[1]:.3g}")
    res = {"ragged": {"B": Br, "mode": "prng_shared", "max_abs_err": e_r[0], "tol": e_r[1]},
           "ragged_bwd": {"B": Br, "mode": "prng_shared", "max_abs_err": e_rb[0],
                          "tol": e_rb[1]},
           "pano_ragged": {}, "pano_ragged_bwd": {}, "pano_plans": pano_plans(dtype, V, D, A, MC)}
    # K4 and K5 at B = 61 (a short last prng_shared group, and blocks of 4
    # samples whose seed is another block's) and at B = 1, in every mode
    for Bs in (Br, 1):
        for mode in MODES:
            pd = drop_spec(mode, Bs, V, D, gen, device)
            sub = [t[:Bs].contiguous() for t in (node_sets[0], views, cand_view, tv, d_vis)]
            args = (*sub[:3], features, loc, sub[3])
            got, want = kp.pano_attend(*args, pd), kp.pano_attend_plain(*args, pd)
            check(torch.equal(got[2], want[2]),
                  f"pano_attend {dtype} {mode} at B = {Bs}: candidate rows are exact copies")
            e4 = compare(got[:2], want[:2], 1e-4)
            bargs = (sub[0], sub[1], features, loc, got[1], sub[4])
            e5 = compare((kp.pano_attend_bwd(*bargs, pd),),
                         (kp.pano_attend_bwd_plain(*bargs, pd),), 1e-4)
            for name, e in (("pano_attend", e4), ("pano_attend_bwd", e5)):
                check(e[0] <= e[1], f"{name} {dtype} {mode} at B = {Bs}: |kernel - plain| "
                                    f"{e[0]:.3g} > {e[1]:.3g}")
            res["pano_ragged"].setdefault(Bs, {})[mode] = {"max_abs_err": e4[0], "tol": e4[1]}
            res["pano_ragged_bwd"].setdefault(Bs, {})[mode] = {"max_abs_err": e5[0],
                                                               "tol": e5[1]}
    for mode in MODES:
        pd = drop_spec(mode, B, V, D, gen, device)
        cd = drop_spec(mode, B, MC, D, gen, device)
        args = (node_sets[0], views, cand_view, features, loc, tv)
        got, want = kp.pano_attend(*args, pd), kp.pano_attend_plain(*args, pd)
        check(torch.equal(got[2], want[2]),
              f"pano_attend {dtype} {mode} at B = {B}: candidate rows are exact copies")
        e4 = compare(got[:2], want[:2], 1e-4)
        alpha = got[1]
        bargs = (node_sets[0], views, features, loc, alpha, d_vis)
        e5 = compare((kp.pano_attend_bwd(*bargs, pd),), (kp.pano_attend_bwd_plain(*bargs, pd),),
                     1e-4)
        cargs = (cand_sets[0], cand_angle, valid)
        got6 = kc.cand_score(*cargs, q, cd)
        check(bool((got6[:, MC] == 0).all()), "cand_score: the STOP slot scores 0")
        e6 = compare((got6,), (kc.cand_score_plain(*cargs, q, cd),), 1e-4)
        e7 = compare((kc.cand_score_bwd(*cargs, d_logits, cd),),
                     (kc.cand_score_bwd_plain(*cargs, d_logits, cd),), 1e-4)
        # one drop spec per call of a timed loop: the seeds and the ext mask
        # are per sample, whatever the node set
        t4 = kernel_times(lambda i: kp.pano_attend(node_sets[i % 8], views, cand_view, features,
                                                   loc, tv, pd), iters)
        p4 = cuda_time_ms(lambda i: kp.pano_attend_plain(node_sets[i % 8], views, cand_view,
                                                         features, loc, tv, pd), 10)
        t5 = kernel_times(lambda i: kp.pano_attend_bwd(node_sets[i % 8], views, features, loc,
                                                       alpha, d_vis, pd), iters)
        p5 = cuda_time_ms(lambda i: kp.pano_attend_bwd_plain(node_sets[i % 8], views, features,
                                                             loc, alpha, d_vis, pd), 10)
        t6 = kernel_times(lambda i: kc.cand_score(cand_sets[i % 8], cand_angle, valid, q, cd),
                          iters)
        p6 = cuda_time_ms(lambda i: kc.cand_score_plain(cand_sets[i % 8], cand_angle, valid, q,
                                                        cd), 10)
        t7 = kernel_times(lambda i: kc.cand_score_bwd(cand_sets[i % 8], cand_angle, valid,
                                                      d_logits, cd), iters)
        p7 = cuda_time_ms(lambda i: kc.cand_score_bwd_plain(cand_sets[i % 8], cand_angle, valid,
                                                            d_logits, cd), 10)
        q_img = q[:, :D].to(dtype).contiguous()
        w = torch.where(valid, d_logits[:, :MC], 0.0).to(dtype)
        l6 = library_times(lambda i: torch.einsum("bkd,bd->bk", cand_sets[i % 8], q_img), iters,
                           "einsum bkd,bd->bk")
        l7 = library_times(lambda i: torch.einsum("bk,bkd->bd", w, cand_sets[i % 8]), iters,
                           "einsum bk,bkd->bd")
        no_lib = dict.fromkeys(("library_ms", "library_device_ms", "library_device_events"))
        ang_b = B * MC * A * features.element_size()
        b4, b5 = pano_bounds(node_sets[0], views, cand_view, features, tv, got, pd)
        res[mode] = [
            {"name": "pano_attend", "err": e4, **t4, "plain_ms": p4, **no_lib,
             "library_call": "none: no one PyTorch call gathers, drops, attends and copies rows",
             "bound": b4},
            {"name": "pano_attend_bwd", "err": e5, **t5, "plain_ms": p5, **no_lib,
             "library_call": "none: no one PyTorch call re-gathers, drops and back-propagates "
                             "the attention",
             "bound": b5},
            {"name": "cand_score", "err": e6, **t6, "plain_ms": p6, **l6,
             "library_call": "torch.einsum('bkd,bd->bk') over the image rows",
             "bound": bound_ms(nbytes(cand_sets[0], valid, q, got6) + ang_b + drop_bytes(cd),
                               2 * B * MC * (D + A), dtype)},
            {"name": "cand_score_bwd", "err": e7, **t7, "plain_ms": p7, **l7,
             "library_call": "torch.einsum('bk,bkd->bd') over the image rows",
             "bound": bound_ms(nbytes(cand_sets[0], valid, d_logits) + ang_b + drop_bytes(cd)
                               + B * (D + A) * 4, 2 * B * MC * (D + A), dtype)},
        ]
    return res


def pano_bounds(nodes, views, cand_view, features, tv, outs, drop):
    """(K4's, K5's) bound (ms, by): the distinct nodes' feature rows and the
    distinct views' angle rows read once, the indices, the query (or the
    cotangent and alpha) and the mask or seeds read once, the outputs
    (vis, alpha, cand; or d_tv) written once; 4 FLOP an element of [rows ;
    angle rows] a sample (a dot and a weighted sum)."""
    B, (_, V, D), A = nodes.shape[0], features.shape, tv.shape[1] - features.shape[-1]
    rows = int(torch.unique(nodes).numel()) * V * D * features.element_size()
    loc_rows = int(torch.unique(views).numel()) * V * A * 4
    flops = 4 * B * V * (D + A)
    return (bound_ms(rows + loc_rows + nbytes(nodes, views, cand_view, tv) + drop_bytes(drop)
                     + nbytes(*outs), flops, features.dtype),
            bound_ms(rows + loc_rows + nbytes(nodes, views, outs[1], tv) + drop_bytes(drop)
                     + nbytes(tv), flops, features.dtype))


def pano_plans(dtype, V, D, A, MC):
    """K4's and K5's launch plans at B = 64, 61 and 1: ``pano_plan`` against
    the plan the C entry points compute (``plan_query``), with the clusters
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    kp = modules()["pano_fused"]
    plans = []
    for name, mc in (("pano_attend", MC), ("pano_attend_bwd", 0)):
        for B in (BATCH, BATCH - 3, 1):
            p = kp.pano_plan(B, V, D, A, dtype, mc)
            q = kp.plan_query(B, V, D, A, dtype, mc)
            check(q[:6] == (p.cluster, p.samples, p.grid[1], p.cols, p.ang_quads, p.smem),
                  f"{name} {dtype} at B = {B}: pano_plan {p} is the C plan {q[:6]}")
            blocks = p.grid[0] * p.grid[1]
            est = kp.clusters_at_once(p.cluster, p.smem)
            plans.append({"name": name, "B": B, "S": p.cluster, "G": p.samples, "blocks": blocks,
                          "smem": p.smem, "waves_planned": p.waves, "clusters_at_once": q[6],
                          "clusters_at_once_planned": est})
            log(f"{name:16s} {str(dtype):14s} B={B:3d}: plan S={p.cluster} G'={p.samples} "
                f"grid {p.grid} = {blocks} blocks, {p.smem} B shared memory a block, "
                f"{p.waves} wave(s) planned; the card holds {q[6]} of its {p.grid[1]} clusters "
                f"at once (planned on {est})")
    return plans


def lstm_cell_phase(dtype, device, gen, B=BATCH, Din=64 + FEAT_DIM + 128, H=512, iters=100):
    """K8 at the EnvDrop decoder cell's shape: x = [action embedding ;
    attended panorama] (64 + 2048 + 128), h and c 512 wide, every operand
    in ``dtype``.  Six weight sets in turn exceed the 50 MB L2, so the timed
    launches read the weights from device memory."""
    k = modules()["lstm_cell"]

    def inputs(B, Din, H, sets):
        def u(*shape):
            return ((torch.rand(*shape, generator=gen, device=device) * 2 - 1)
                    / H ** 0.5).to(dtype)

        x, h, c = (torch.randn(B, n, generator=gen, device=device).to(dtype) for n in (Din, H, H))
        return x, h, c, [(u(Din, 4 * H), u(H, 4 * H), u(4 * H)) for _ in range(sets)]

    # f32 sums of Din + H products in another order; bf16 outputs are
    # rounded to bf16, one ulp of which is 2^-8 relative
    rtol = 1e-4 if dtype == torch.float32 else 8e-3
    # a ragged shape first: B < 64, K = 248 not a multiple of 16, the x/h
    # boundary inside a K slice, H = 48 not a multiple of 64
    xr, hr, cr, wr = inputs(*RAGGED_CELL, 1)
    e_r = compare(k.lstm_cell(xr, hr, cr, *wr[0]), k.lstm_cell_plain(xr, hr, cr, *wr[0]), rtol)
    check(e_r[0] <= e_r[1], f"lstm_cell {dtype} at (B, Din, H) = {RAGGED_CELL}: |kernel - plain| "
                            f"{e_r[0]:.3g} > {e_r[1]:.3g}")
    x, h, c, weights = inputs(B, Din, H, 6)
    got = k.lstm_cell(x, h, c, *weights[0])
    want = k.lstm_cell_plain(x, h, c, *weights[0])
    err = compare(got, want, rtol)
    t = kernel_times(lambda i: k.lstm_cell(x, h, c, *weights[i % 6]), iters)
    plain_ms = cuda_time_ms(lambda i: k.lstm_cell_plain(x, h, c, *weights[i % 6]), 10)
    lib_w = [(w_ih.t().contiguous(), w_hh.t().contiguous(), b) for w_ih, w_hh, b in weights]
    zero = torch.zeros_like(weights[0][2])  # b_hh: K8's b is b_ih + b_hh
    lib = library_times(lambda i: torch.lstm_cell(x, (h, c), *lib_w[i % 6], zero), iters,
                        f"torch.lstm_cell in {dtype}")
    moved = nbytes(x, h, c, *weights[0], *got)
    return {"name": "lstm_cell", "max_abs_err": err[0], "tol": err[1], **t,
            "plain_ms": plain_ms, **lib,
            "library_call": "torch.lstm_cell (weights transposed to torch's layout beforehand)",
            "shape": {"B": B, "Din": Din, "H": H},
            "ragged": dict(zip(("B", "Din", "H"), RAGGED_CELL), max_abs_err=e_r[0], tol=e_r[1]),
            "bound": bound_ms(moved, 2 * B * (Din + H) * 4 * H, dtype)}


def kernel_phases(world, lengths, device):
    """Every kernel in bf16 and f32; returns {(name, prec): result}, the
    observation kernels' results in the prng mode (the training path's)
    with the other modes under "modes"."""
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    gen = torch.Generator(device=device).manual_seed(SEED)
    long = long_lengths(lengths.shape[0], gen, device)
    results = {}
    for prec in ("bf16", "f32"):
        dtype = PRECISIONS[prec]
        features = torch.from_numpy(world.features).to(device).to(dtype)
        ragged = lstm_ragged(dtype, device, gen)
        for r, r_long in zip(lstm_phases(dtype, device, gen, lengths),
                             lstm_phases(dtype, device, gen, long)):
            r["long"] = r_long
            r["ragged"] = {"B": 61, "lengths": "0-80, a 0 and an 80", **ragged[r["name"]]}
            r["agent_shapes"], r["speaker_shapes"] = {}, {}
            results[(r["name"], prec)] = r
        plans = lstm_walk_plans(dtype, *AGENT_LSTM_SHAPES["monitor"])
        for label, (D, H) in AGENT_LSTM_SHAPES.items():
            ragged = lstm_ragged(dtype, device, gen, D=D, H=H)
            # the Self-Monitor's walk also at one row group and one cluster
            small = ({B: lstm_ragged(dtype, device, gen, B=B, D=D, H=H) for B in (40, 1)}
                     if label == "monitor" else {})
            for r in lstm_phases(dtype, device, gen, long, D=D, H=H):
                r["ragged"] = {"B": 61, "lengths": "0-80, a 0 and an 80", **ragged[r["name"]]}
                for B, res in small.items():
                    r["ragged"][f"B={B}"] = res[r["name"]]
                r["shape"] = {"D": D, "H": H}
                if label == "monitor":
                    r["plans"] = plans["bwd" if r["name"] == "lstm_scan_bwd" else "fwd"]
                results[(r["name"], prec)]["agent_shapes"][label] = r
        # the speaker encoder's layers at full lengths, and at B = 61 over ragged ones
        full = torch.full((BATCH,), SPEAKER_T, dtype=torch.long, device=device)
        for label, (D, H) in SPEAKER_LSTM_SHAPES.items():
            ragged = lstm_ragged(dtype, device, gen, L=SPEAKER_T, D=D, H=H)
            for r in lstm_phases(dtype, device, gen, full, D=D, H=H, L=SPEAKER_T):
                r["ragged"] = {"B": 61, "lengths": f"0-{SPEAKER_T}, a 0 and a {SPEAKER_T}",
                               **ragged[r["name"]]}
                r["shape"] = {"D": D, "H": H}
                results[(r["name"], prec)]["speaker_shapes"][label] = r
        by_mode = obs_phases(dtype, device, gen, features)
        for i, r in enumerate(by_mode["prng"]):
            r = dict(r)
            r["max_abs_err"], r["tol"] = r.pop("err")
            r["modes"] = {}
            for mode in MODES:
                m = by_mode[mode][i]
                b_ms, b_by = m["bound"]
                r["modes"][mode] = {"max_abs_err": m["err"][0], "tol": m["err"][1],
                                    **{k: m[k] for k in TIME_KEYS}, "bound_ms": b_ms}
                check(m["err"][0] <= m["err"][1],
                      f"{r['name']} {prec} {mode}: |kernel - plain| {m['err'][0]:.3g} "
                      f"> {m['err'][1]:.3g}")
                log(f"{r['name']:16s} {prec:4s} {mode:4s} max|kernel-plain| {m['err'][0]:.3g} "
                    f"(tol {m['err'][1]:.3g}) | {times_label(m)}, bound {b_ms:.4f} ms ({b_by})")
            if r["name"] in ("cand_score", "cand_score_bwd"):
                r["ragged"] = by_mode["ragged" if r["name"] == "cand_score" else "ragged_bwd"]
                log(f"{r['name']:16s} {prec:4s} prng_shared at B={r['ragged']['B']}: "
                    f"max|kernel-plain| {r['ragged']['max_abs_err']:.3g} "
                    f"(tol {r['ragged']['tol']:.3g})")
            if r["name"] in ("pano_attend", "pano_attend_bwd"):
                r["ragged"] = by_mode["pano_ragged" if r["name"] == "pano_attend"
                                      else "pano_ragged_bwd"]
                r["plans"] = [p for p in by_mode["pano_plans"] if p["name"] == r["name"]]
                for Bs, errs in r["ragged"].items():
                    log(f"{r['name']:16s} {prec:4s} at B={Bs}: max|kernel-plain| " + ", ".join(
                        f"{mode} {e['max_abs_err']:.3g} (tol {e['tol']:.3g})"
                        for mode, e in errs.items()))
            results[(r["name"], prec)] = r
        del features
        modules()["lstm_cell"].launches = 0
        r = results[("lstm_cell", prec)] = lstm_cell_phase(dtype, device, gen)
        r["kernel_phase_launches"] = modules()["lstm_cell"].launches
        check(r["max_abs_err"] <= r["tol"],
              f"lstm_cell {prec}: |kernel - plain| {r['max_abs_err']:.3g} > {r['tol']:.3g}")
        rg = r["ragged"]
        log(f"lstm_cell        {prec:4s} B={BATCH} Din={r['shape']['Din']} H={r['shape']['H']}: "
            f"max|kernel-plain| {r['max_abs_err']:.3g} (tol {r['tol']:.3g}); at B={rg['B']} "
            f"Din={rg['Din']} H={rg['H']} {rg['max_abs_err']:.3g} (tol {rg['tol']:.3g}) | "
            f"{times_label(r)}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
        for name in ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"):
            base = results[(name, prec)]
            for r in (base, base["long"], *base["agent_shapes"].values(),
                      *base["speaker_shapes"].values()):
                b_ms, b_by = r["bound"]
                errs = ", ".join(f"{part} {c['max_abs_err']:.3g} (tol {c['tol']:.3g})"
                                 for part, c in r["checks"].items())
                shape = r.get("shape", {"D": 256, "H": 256})
                log(f"{name:16s} {prec:4s} D={shape['D']} H={shape['H']} lengths {r['lengths']}: "
                    f"max|kernel-plain| {errs} | {times_label(r)}, bound {b_ms:.4f} ms ({b_by}, "
                    f"{r['valid_steps']} valid steps)")
                log(f"{'':16s} {prec:4s} device ms a call by kernel: " + ", ".join(
                    f"{k} {ms:.4f} ({n:g}x)" for k, (ms, n) in r["device_split"].items()))
                if "d_xs_differ" in r:
                    log(f"{'':16s} {prec:4s} d_xs differs from plain in {r['d_xs_differ']:.4%} "
                        f"of its valid elements (limit 1%)")
                for part, c in r["checks"].items():
                    check(c["max_abs_err"] <= c["tol"],
                          f"{name} {prec} {part} agrees with its plain version")
            for label, r in (("EnvDrop", base), *base["agent_shapes"].items(),
                             *base["speaker_shapes"].items()):
                rg = r["ragged"]
                log(f"{name:16s} {prec:4s} {label} at B={rg['B']}, lengths {rg['lengths']}: "
                    "max|kernel-plain| " + ", ".join(
                        f"{part} {c['max_abs_err']:.3g} (tol {c['tol']:.3g})"
                        for part, c in rg.items()
                        if isinstance(c, dict) and not part.startswith("B=")))
                for Bs, parts in rg.items():
                    if Bs.startswith("B="):
                        log(f"{name:16s} {prec:4s} {label} at {Bs}: max|kernel-plain| " + ", ".join(
                            f"{part} {c['max_abs_err']:.3g} (tol {c['tol']:.3g})"
                            for part, c in parts.items()))
        torch.cuda.synchronize()
    for r in results.values():
        for x in (r, r.get("long", {}), *r.get("agent_shapes", {}).values(),
                  *r.get("speaker_shapes", {}).values()):
            if "bound" in x:
                x["bound_ms"], x["bound_by"] = x.pop("bound")
    return results


def fmt(x):
    return "None" if x is None else f"{x:.4f}"


# the times each kernel entry carries: CUDA-event ms and device-only ms of
# the kernel and of its library call, and the plain version's event ms
TIME_KEYS = ("ms", "device_ms", "device_events", "plain_ms", "library_ms", "library_device_ms",
             "library_device_events")


def times_label(r) -> str:
    return (f"kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms; library {fmt(r['library_ms'])} ms, device "
            f"{fmt(r['library_device_ms'])} ms")


# ---------------------------------------------------------------------------
# Serve phase
# ---------------------------------------------------------------------------

def build_serving(num_scans=NUM_SCANS, nodes_per_scan=NODES_PER_SCAN, feat_dim=FEAT_DIM):
    """The synthetic world, its dataset items, the requests, tokenizer,
    EnvDrop config and seeded f32 parameters of the serve and train phases."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, read_vocab
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    cfg = get_cfg_defaults()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["TPU.PACKED_RL", 0, "TPU.OBS_MASKS", "prng"])
    m = cfg.MODEL.ENVDROP
    graphs = synthetic.make_world_graphs(num_scans, nodes_per_scan, seed=SEED)
    world = compiler.compile_world(graphs, 16)
    compiler.attach_synthetic_features(world, feature_dim=feat_dim)
    data = synthetic.make_r2r_dataset(graphs, num_paths=SERVE_CALLS * BATCH + 16, seed=SEED + 1)
    tok = Tokenizer(read_vocab(VOCAB), encoding_length=cfg.DATA.MAX_ENC_LEN)
    requests = [{"instruction": it["instructions"][0], "scan": it["scan"],
                 "start_viewpoint": it["path"][0], "heading": it["heading"]}
                for it in data[:SERVE_CALLS * BATCH]]
    check(len(requests) == SERVE_CALLS * BATCH, "enough synthetic requests")
    f32_agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), feat_dim,
                             cfg.AGENT.MAX_EPISODE_LEN)
    params = f32_agent.init(torch.Generator().manual_seed(SEED))
    return world, data, requests, tok, cfg, m, params


def check_trajectories(world, requests, outs, episode_len):
    for req, out in zip(requests, outs):
        traj = out["trajectory"]
        check(traj[0][0] == req["start_viewpoint"], "a trajectory starts at its start viewpoint")
        check(1 <= len(traj) <= episode_len + 1, "a trajectory has at most one move per step")
        for a, b in zip(traj[:-1], traj[1:]):
            ga = world.global_id(req["scan"], a[0])
            gb = world.global_id(req["scan"], b[0])
            check(gb in world.cand_next[ga][world.cand_valid[ga]],
                  "a trajectory moves only between graph neighbours")


def compare_actions(res_k, res_p, tol):
    """Actions of two rollouts agree, sample by sample, up to the first
    step where the plain run's two best logits lie within ``tol`` (a tie
    the kernels' other summation order may break the other way); after
    such a step the two trajectories may rightly differ.  Returns the
    number of samples cut short by a tie."""
    act_k, act_p = res_k.steps.action.cpu(), res_p.steps.action.cpu()
    alive = res_p.steps.alive_before.cpu()
    top2 = res_p.steps.logits.float().topk(2, dim=-1).values.cpu()
    ties = 0
    for b in range(act_k.shape[1]):
        for t in range(act_k.shape[0]):
            if not alive[t, b]:
                break
            if act_k[t, b] != act_p[t, b]:
                check(float(top2[t, b, 0] - top2[t, b, 1]) <= tol,
                      f"f32 actions of sample {b} differ at step {t} without a tie")
                ties += 1
                break
    return ties


def serve_phase(world, requests, tok, m, params, episode_len, precision, device):
    """Serve every micro-batch through the kernels (counted), check the
    trajectories and the launches, and compare with the plain run."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), world.features.shape[-1],
                         episode_len, compute_dtype=PRECISIONS[precision])
    nav = Navigator(world, agent, params, tok, max_batch=BATCH, precision=precision, device=device)
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    nav.navigate_batch(batches[0])  # first call: kernels loaded, allocator warm
    torch.cuda.synchronize()

    reset_launch_counts()
    latencies, outs = [], []
    for r in range(SERVE_ROUNDS):
        for reqs in batches:
            t0 = time.perf_counter()
            out = nav.navigate_batch(reqs)  # ends in a copy of the records to the host
            latencies.append(time.perf_counter() - t0)
            if r == 0:
                outs += out
    counts = launch_counts()
    calls = SERVE_ROUNDS * len(batches)
    T = agent.episode_len
    want = dict.fromkeys(KERNELS, 0)
    want.update(lstm_scan=2 * calls, pano_attend=T * calls, cand_score=T * calls)
    check(counts == want, f"serve launches {counts} over {calls} calls of {T} steps")
    check_trajectories(world, requests, outs, T)

    # the same requests with the plain versions on the card
    ep = nav.episodes(batches[0])
    res_k = nav.rollout(ep)
    with plain_kernels():
        res_p = nav.rollout(ep)
        outs_p = nav.navigate_batch(batches[0])
    l_k, l_p = res_k.steps.logits[0].float(), res_p.steps.logits[0].float()
    live = l_p > -1e29
    check(bool(torch.equal(live, l_k > -1e29)), "the same candidate slots are masked")
    scale = float(l_p[live].abs().max())
    err = float((l_k - l_p)[live].abs().max())
    rel = err / max(scale, 1.0)
    # f32 sums of up to 2176 products, in another order, whose magnitudes
    # add up to some 50 times the result: a relative error near 1e-5
    tol = 1e-4
    check(rel <= tol, f"{precision}: first-step logits |kernel - plain| / scale = {rel:.3g}")
    ties = compare_actions(res_k, res_p, tol * max(scale, 1.0)) if precision == "f32" else None
    if precision == "f32" and ties == 0:
        check(outs_p == outs[:BATCH], "f32 trajectories equal with the plain versions")
    return {"precision": precision, "calls": calls, "launches": counts,
            "latency_s": latencies, "first_step_logit_err": err, "logit_scale": scale,
            "rel_err": rel, "action_ties": ties, "nav": nav, "batches": batches}


def profile(fn):
    """(wall ms under the profiler, device-busy ms, rows by kernel) of fn().
    Busy is the union of the device events' intervals (kernels and
    copies); the rows sum each kernel name's device time and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        # an annotation's span (Optimizer.step#...) covers its kernels and the gaps between
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    return wall * 1e3, busy_us / 1e3, rows


def print_profile(what, wall, busy, rows):
    log(f"profile of {what}: wall {wall:.2f} ms under the profiler, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%)" if rows
        else f"profile of {what}: the profiler shows no device time")
    for dev_ms, count, key in rows[:12]:
        log(f"  {dev_ms:9.3f} ms {count:6d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# Training phase
# ---------------------------------------------------------------------------

def train_phase(world, data, tok, cfg, m, params0, requests, device):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.checkpoint import save_checkpoint
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    precision = cfg.TPU.PRECISION
    T = cfg.AGENT.MAX_EPISODE_LEN
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=PRECISIONS[precision], obs_masks=cfg.TPU.OBS_MASKS)
    tables = world.device_tables(precision, device)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=device)
    il_bucket = il_bucket_fn(cfg, agent)
    params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
    leaves = tree.tree_leaves(params)
    log(f"training: {env.size()} episodes, B={BATCH}, T={T}, {precision}, OBS_MASKS "
        f"{agent.obs_masks}, DROP_RATE {m.DROP_RATE}, FEAT_DROP_RATE {m.FEAT_DROP_RATE}, "
        f"{sum(p.numel() for p in leaves)} parameters")

    # (a) one iteration's loss and clipped gradients, kernels vs plain
    batch = env.next_batch()
    il_len = il_bucket(env)

    def grads():
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        total, logs = loop.iteration_loss(agent, "sample", tables, params, batch, gen,
                                          il_len=il_len)
        for p in leaves:
            p.grad = None
        total.backward()
        loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return total.item(), logs["rl_loss"].item(), [p.grad.clone() for p in leaves]

    loss_k, rl_k, g_k = grads()
    with plain_kernels():
        loss_p, rl_p, g_p = grads()
    loss_err = abs(loss_k - loss_p)
    # f32 sums in another order over the same bf16-rounded operands: a
    # relative 1e-4; gradients reach the embedding through d_xs rounded to
    # bf16, one ulp of which is 2^-8 relative
    check(loss_err <= 1e-4 * max(1.0, abs(loss_p)),
          f"training loss kernels {loss_k} vs plain {loss_p}")
    grad_err = 0.0
    for gk, gp in zip(g_k, g_p):
        e = float((gk - gp).abs().max())
        tol = 1e-2 * max(float(gp.abs().max()), 1e-6)
        grad_err = max(grad_err, e / max(float(gp.abs().max()), 1e-6))
        check(e <= tol, f"a gradient leaf of shape {tuple(gk.shape)}: |kernel - plain| {e:.3g} "
                        f"> {tol:.3g}")
    log(f"train (a): loss kernels {loss_k:.6f} plain {loss_p:.6f} (|diff| {loss_err:.3g}); "
        f"rl loss {rl_k:.6f} / {rl_p:.6f}; worst gradient leaf |kernel - plain| / max|plain| "
        f"{grad_err:.3g} (tol 1e-2; earlier runs 3.93e-3, and 6.8e-3 while da entered d_xs "
        f"unsplit) over {len(leaves)} leaves, il_len {il_len}")
    for p in leaves:
        p.grad = None

    # (b) timed iterations with exact launch counts
    optimizer = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
    before = [p.detach().clone() for p in leaves]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def iterate():
        b = env.next_batch()
        il = il_bucket(env)
        logs = loop.one_iter(agent, optimizer, "sample", tables, params, b, gen, il_len=il)
        return logs, il

    iterate()  # warm-up
    torch.cuda.synchronize()
    times, losses, totals = [], [], {k: 0 for k in KERNELS}
    for _ in range(TRAIN_ITERS):
        reset_launch_counts()
        t0 = time.perf_counter()
        logs, il = iterate()
        loss = float(logs["loss"])  # a sync: the iteration has finished
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        counts = launch_counts()
        t_il = il or T
        want = dict.fromkeys(KERNELS, 0)
        want.update(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=t_il + T + 1,
                    cand_score=t_il + T + 1, pano_attend_bwd=t_il + T, cand_score_bwd=t_il + T)
        check(counts == want, f"train launches {counts}, expected {want} (T_il {t_il})")
        for k, v in counts.items():
            totals[k] += v
    med = statistics.median(times)
    log(f"train (b): {TRAIN_ITERS} iterations, ms per iteration median {med * 1e3:.2f} "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); launches {totals}")
    wall, busy, rows = profile(iterate)
    print_profile("one training iteration", wall, busy, rows)

    # (c) finite losses, parameters moved
    check(all(x == x and abs(x) < float("inf") for x in losses), f"finite losses {losses}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, leaves))
    check(moved == len(leaves), f"{moved} of {len(leaves)} parameter leaves changed")
    log(f"train (c): losses {[round(x, 4) for x in losses]}; {moved}/{len(leaves)} leaves changed")

    # (d) a checkpoint written by the port, served by the port
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "latest.ckpt")
        save_checkpoint(path, params, optimizer, gen, epoch=1, cfg_yaml=cfg.dump())
        nav = Navigator.from_checkpoint(world, agent, path, tok, max_batch=BATCH,
                                        precision=precision, device=device)
        outs = nav.navigate_batch(requests[:BATCH])
    served = tree.tree_leaves(nav.params)
    check(all(torch.equal(a.detach().to(b.dtype), b) for a, b in zip(leaves, served)),
          "the served weights are the trained ones")
    check_trajectories(world, requests[:BATCH], outs, T)
    log(f"train (d): checkpoint written and served: {len(outs)} trajectories, "
        f"{sum(len(o['trajectory']) - 1 for o in outs)} moves")
    return {"ms": [t * 1e3 for t in times], "median_ms": med * 1e3, "launches": totals,
            "busy": (wall, busy), "loss_err": loss_err, "grad_rel_err": grad_err}


# ---------------------------------------------------------------------------
# Curriculum phase
# ---------------------------------------------------------------------------

def curriculum_setup(world, data, tok, device):
    """The CL config as shipped (PACKED_RL 3, SPCL parameters) on the bench
    world: its train paths cut into 5 rounds by path length (as
    pipeline.build_synthetic_universe cuts the synthetic universe), the
    cumulative NAIVE round envs, the SELF-PACE env, and a val_unseen env
    of the paths the requests leave out."""
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv, R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(CL_CONFIG)
    check(cfg.TPU.PACKED_RL == 3, "the CL config ships PACKED_RL 3")
    train = sorted(data[:SERVE_CALLS * BATCH], key=lambda it: it["distance"])
    per = len(train) // 5
    rounds = {f"round_{k}": expand_r2r_items(train[(k - 1) * per: k * per if k < 5 else None],
                                             tok) for k in range(1, 6)}
    naive, acc = {}, []
    for k in range(1, 6):
        acc = acc + rounds[f"round_{k}"]
        naive[f"round_{k}"] = R2RBatchEnv(world, acc, BATCH, tok, SEED + k, device=device)
    spcl_env = CLR2RBatchEnv(world, rounds, BATCH, cfg.TRAIN.SELF_PACE.CRATE, tok, SEED,
                             device=device)
    valid = {"val_unseen": R2RBatchEnv(world, expand_r2r_items(data[SERVE_CALLS * BATCH:], tok),
                                       BATCH, tok, SEED + 12, "val_unseen", device=device)}
    return cfg, naive, spcl_env, valid


def spcl_reference(w0, lamb0, loss, a, c, mu, pace):
    """One SPCL update (lambda, then weights) in numpy f32, for (e)."""
    f32 = np.float32
    lamb = f32(lamb0 + mu) if lamb0 < loss.max() else f32(lamb0 + f32(mu / 2))
    easy = {"linear": lambda: 1 - loss / lamb, "binary": lambda: np.ones_like(loss),
            "log": lambda: np.log(loss + (1 - lamb)) / np.log(1 - lamb)}[pace]()
    w = np.maximum(np.where(loss >= lamb, f32(0.01), easy), f32(0.01)).astype(f32)
    aw = np.dot(a, w)
    if aw > c:
        w = w + a * (c - aw) / np.dot(a, a)
        w = np.where(w <= 0, f32(0.001), w)
    return w.astype(f32), lamb


def curriculum_phase(world, data, tok, params0, device):
    """The paper's recipe as the CL config ships it, B = 64, T = 35, bf16:
    (a) NAIVE rounds, (b) one SPCL packed weighted iteration in
    OBS_MASKS prng_shared through the kernels against the plain versions,
    (c) + (d) timed SPCL packed iterations through the trainer with exact
    launch counts, (e) the SPCL update on the card against numpy."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.engine import curriculum, loop
    from curriculum_learning_for_vln_torch.engine import trainer as trainer_mod
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    cfg, naive_envs, spcl_env, valid = curriculum_setup(world, data, tok, device)
    m, T = cfg.MODEL.ENVDROP, cfg.AGENT.MAX_EPISODE_LEN
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def agent_for(masks):
        return EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                            compute_dtype=PRECISIONS[cfg.TPU.PRECISION], obs_masks=masks)

    def run_cfg(*extra):
        c = cfg.clone()
        c.merge_from_list(["OUTPUT.CKPT_DIR", tmp, "OUTPUT.TSBOARD_DIR", "",
                           "OUTPUT.LOG_DIR", "", *extra])
        return c

    # (a) NAIVE, switch every epoch: round_1, then the cumulative round_2
    class Naive(curriculum.NaiveCurriculum):
        def select_env(self, train_env, ep):
            env = super().select_env(train_env, ep)
            self.used.append((ep, env))
            return env

    naive = Naive(switch_epoch=1)
    naive.used = []
    reset_launch_counts()
    t0 = time.perf_counter()
    c = run_cfg("TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.EVAL_INTERVAL", 2)
    _, best = naive.train(c, agent_for("prng"), "", naive_envs, valid, seed=SEED, device=device)
    naive_counts = launch_counts()
    used = {ep: env for ep, env in naive.used if ep > 0}
    r1, r2 = naive_envs["round_1"], naive_envs["round_2"]
    check(used.get(1) is r1 and used.get(2) is r2, "NAIVE epoch 1 on round_1, epoch 2 on round_2")
    check(r2.data[:r1.size()] == r1.data and r2.size() > r1.size(), "round_2 holds round_1")
    check(naive_counts["lstm_scan_train"] == 4 * 4, f"NAIVE: 4 packed iterations {naive_counts}")
    out["naive"] = {"rounds": [r1.size(), r2.size()], "launches": naive_counts,
                    "val_unseen_sr": best["val_unseen"]["success_rate"],
                    "s": time.perf_counter() - t0}
    log(f"curriculum (a): NAIVE switch 1: epoch 1 on round_1 ({r1.size()} episodes), epoch 2 on "
        f"round_2 ({r2.size()}); 2 x 2 packed iterations + eval in {out['naive']['s']:.1f} s; "
        f"launches {naive_counts}")

    # (b) SPCL, prng_shared: one packed weighted iteration, kernels vs plain
    agent = agent_for("prng_shared")
    spcl = curriculum.SelfPacedCurriculum.from_config(cfg, spcl_env, device=device)
    tables = world.device_tables(cfg.TPU.PRECISION, device)
    il_bucket = il_bucket_fn(cfg, agent)
    params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
    leaves = tree.tree_leaves(params)
    raws, idx = [], []
    for _ in range(cfg.TPU.PACKED_RL):
        raws.append(spcl_env.next_batch())
        idx.append(spcl_env.cur_batch_index)
        if len(raws) == 1:
            il_len = il_bucket(spcl_env)
    pool = loop.concat_batches(raws)
    loop.check_pool_valid(pool)
    w_il, w_pool = spcl.batch_weights(idx[0]), spcl.batch_weights(np.concatenate(idx))
    check(bool((w_pool != w_pool[0]).any()), "the SPCL weights differ across the pool")

    def grads():
        gen = torch.Generator(device=device).manual_seed(SEED + 9)
        total, logs = loop.packed_iteration_loss(agent, tables, params, raws[0], pool, gen,
                                                 w_il, w_pool, il_len)
        for p in leaves:
            p.grad = None
        total.backward()
        loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return total.item(), int(logs["episodes_done"]), [p.grad.clone() for p in leaves]

    loss_k, done_k, g_k = grads()
    with plain_kernels():
        loss_p, done_p, g_p = grads()
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= 1e-4 * max(1.0, abs(loss_p)),
          f"SPCL packed loss kernels {loss_k} vs plain {loss_p}")
    grad_err = 0.0
    for gk, gp in zip(g_k, g_p):
        scale = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        grad_err = max(grad_err, e / scale)
        check(e <= 1e-2 * scale, f"an SPCL packed gradient leaf of shape {tuple(gk.shape)}: "
                                 f"|kernel - plain| {e:.3g} > {1e-2 * scale:.3g}")
    for p in leaves:
        p.grad = None
    out["packed_check"] = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_err": loss_err,
                           "grad_rel_err": grad_err, "episodes_done": [done_k, done_p],
                           "il_len": il_len}
    log(f"curriculum (b): SPCL packed weighted iteration, prng_shared: loss kernels "
        f"{loss_k:.6f} plain {loss_p:.6f} (|diff| {loss_err:.3g}); worst gradient leaf "
        f"|kernel - plain| / max|plain| {grad_err:.3g} (tol 1e-2; earlier runs 3.64e-3, and "
        f"5.74e-3 while da entered d_xs unsplit); episodes done {done_k} / "
        f"{done_p} of a pool of {pool.valid.shape[0]}, il_len {il_len}")

    # (c), (d), (e): SPCL through its trainer, one epoch, the update at its end
    times, done, started, per_iter, profiled, snap = [], [], [], [], {}, {}
    packed_one_iter = loop.packed_one_iter
    profiled_iter = CURRICULUM_ITERS - 1  # the last one, under the profiler, is not timed

    def timed(*args):
        before = launch_counts()
        il = args[-1]
        t0 = time.perf_counter()
        if len(times) == profiled_iter:
            box = []
            profiled["wall"], profiled["busy"], profiled["rows"] = profile(
                lambda: box.append(packed_one_iter(*args)))
            logs = box[0]
        else:
            logs = packed_one_iter(*args)
        n = int(logs["episodes_done"])  # a sync: the iteration has finished
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        done.append(n)
        started.append(int(logs["episodes_started"]))
        after = launch_counts()
        t_il = il or T
        got = {k: after[k] - before[k] for k in KERNELS}
        want = dict.fromkeys(KERNELS, 0)
        want.update(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=t_il + T + 1,
                    cand_score=t_il + T + 1, pano_attend_bwd=t_il + T, cand_score_bwd=t_il + T)
        check(got == want, f"packed iteration launches {got}, expected {want} (T_il {t_il})")
        per_iter.append((t_il, got))
        return logs

    class Spcl(curriculum.SelfPacedCurriculum):
        def end_epoch(self, ep, writer):
            snap.update(w=self.weight.cpu().numpy(), lamb=float(self.lamb),
                        loss=self.loss_for_item.cpu().numpy())
            super().end_epoch(ep, writer)

    c = run_cfg("TRAIN.CLMODE", "SELF-PACE", "TPU.OBS_MASKS", "prng_shared",
                "TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", CURRICULUM_ITERS,
                "TRAIN.EVAL_INTERVAL", 100, "TRAIN.SELF_PACE.BURN_IN", 0,
                "TRAIN.SELF_PACE.INTERVAL", 1)
    trainer = Spcl.from_config(c, spcl_env, device=device)
    trainer_mod.packed_one_iter = timed
    try:
        reset_launch_counts()
        trainer.train(c, agent, "", spcl_env, valid, seed=SEED, device=device)
        totals = launch_counts()
    finally:
        trainer_mod.packed_one_iter = packed_one_iter
    check(len(times) == CURRICULUM_ITERS, f"{len(times)} packed iterations")
    # the first iteration warms the allocator, the last ran under the profiler
    steady = times[1:profiled_iter]
    med = statistics.median(steady)
    eps_per_s = sum(done[1:profiled_iter]) / sum(steady)
    busy = profiled["busy"] / profiled["wall"]
    out["packed"] = {"ms": [t * 1e3 for t in times], "median_ms": med * 1e3,
                     "episodes_done": done, "episodes_started": started,
                     "episodes_per_s": eps_per_s, "launches": totals, "per_iteration": per_iter,
                     "busy": (profiled["wall"], profiled["busy"])}
    log(f"curriculum (c): launches per packed iteration exact: "
        f"{[(t_il, g['lstm_scan_train'], g['pano_attend'], g['pano_attend_bwd']) for t_il, g in per_iter]}"
        f" (T_il, K1, K4, K5); totals {totals}")
    log(f"curriculum (d): {len(steady)} timed SPCL packed iterations (after one warm-up; one "
        f"more under the profiler), ms per iteration median {med * 1e3:.2f} (min "
        f"{min(steady) * 1e3:.2f}, max {max(steady) * 1e3:.2f}; all "
        f"{[round(t * 1e3, 2) for t in times]}); episodes done {done} of started {started} "
        f"(pool {BATCH * cfg.TPU.PACKED_RL}); completed episodes/s {eps_per_s:.1f} over the timed "
        f"iterations; device busy {100 * busy:.1f}% of one iteration")
    print_profile("one SPCL packed iteration", profiled["wall"], profiled["busy"],
                  profiled["rows"])

    # (e) the update at the epoch's end against numpy
    w_ref, lamb_ref = spcl_reference(snap["w"], snap["lamb"], snap["loss"],
                                     spcl_env.a, np.float32(spcl_env.c),
                                     c.TRAIN.SELF_PACE.MIU, c.TRAIN.SELF_PACE.FUNC)
    w_err = float(np.abs(trainer.weight.cpu().numpy() - w_ref).max())
    lamb_err = abs(float(trainer.lamb) - float(lamb_ref))
    recorded = int((snap["loss"] > 0).sum())
    check(recorded >= BATCH and w_err <= 1e-6 and lamb_err <= 1e-6,
          f"SPCL update on the card: |w - numpy| {w_err:.3g}, |lambda - numpy| {lamb_err:.3g}, "
          f"{recorded} items recorded")
    check(not np.array_equal(trainer.weight.cpu().numpy(), snap["w"]), "the weights moved")
    out["spcl_update"] = {"w_err": w_err, "lamb_err": lamb_err, "lamb": float(trainer.lamb),
                          "recorded_items": recorded}
    log(f"curriculum (e): SPCL update on the card: lambda {snap['lamb']} -> "
        f"{float(trainer.lamb)}, {recorded} of {len(spcl_env)} items recorded, "
        f"max|w - numpy| {w_err:.3g}, |lambda - numpy| {lamb_err:.3g} (tol 1e-6)")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Agents phase: the Follower and the Self-Monitor
# ---------------------------------------------------------------------------

def agent_launches(name, serve):
    """The exact launches of one serve call or one training iteration of
    the Follower or the Self-Monitor at T = AGENT.MAX_EPISODE_LEN steps:
    the Follower's 2-layer BiLSTM encoder runs K3 (serve) or K1 and K2
    (train) once per layer and direction, its observation op K4 (and K5
    under autograd) once a step; the Self-Monitor's 1-layer LSTM runs one
    K3 or K1 + K2, and K4 once a step on a query that carries no gradient,
    so no K5.  No path of either runs K6, K7 or K8."""
    enc = 4 if name == "FOLLOWER" else 1
    want = dict.fromkeys(KERNELS, 0)
    if serve:
        want.update(lstm_scan=enc, pano_attend=AGENT_T)
    else:
        want.update(lstm_scan_train=enc, lstm_scan_bwd=enc, pano_attend=AGENT_T,
                    pano_attend_bwd=AGENT_T if name == "FOLLOWER" else 0)
    return want


# leaves whose gradient is 0 but for f32 rounding: the Follower's b_v (the
# reparameterised query leaves it out) and ActionScoring's b_act and output
# bias (each adds one constant to every candidate's score); the
# Self-Monitor's BN-MLP input bias and first-layer bias (a BatchNorm takes
# out the shift)
ZERO_GRAD = {
    "FOLLOWER": {("decoder", "visual_attn", "linear_in_v", "b"),
                 ("decoder", "decode_action", "linear_act", "b"),
                 ("decoder", "decode_action", "linear_out", "b")},
    "SELF-MONITOR": {("decoder", "proj_navigable_mlp", "bn_in", "bias"),
                     ("decoder", "proj_navigable_mlp", "layers", 0, "b")},
}


def leaf_paths(tree, prefix=()):
    """The key path of every leaf, in ``utils.tree.tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, prefix + (i,))]
    return [] if tree is None else [prefix]


def agent_cfg(config, *extra):
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(extra))
    check(cfg.AGENT.MAX_EPISODE_LEN == AGENT_T, f"{config} ships T = {AGENT_T}")
    return cfg


def agent_phase(name, config, cl_config, world, data, requests, tok, device, card):
    """(a) serve, (b) one training iteration through the kernels against
    the plain versions, (c) timed classic iterations, (d) one SPCL-weighted
    iteration on the _cl_ config, for one agent at the full width of its
    config, bf16, B = 64, T = 10, seeded random weights."""
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import curriculum, loop
    from curriculum_learning_for_vln_torch.engine.trainer import packed_factor
    from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv, R2RBatchEnv
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.utils import tree

    cfg = agent_cfg(config)
    precision = cfg.TPU.PRECISION
    agent = build_agent(cfg, tok.vocab_size(), FEAT_DIM)
    check(agent.name == name, f"{config} builds {name}")
    params0, state0 = init_agent(agent, torch.Generator().manual_seed(SEED))
    m = agent.cfg
    out = {"config": config, "precision": precision,
           "parameters": sum(p.numel() for p in tree.tree_leaves(params0))}
    log(f"{name}: {config}, {precision}, B={BATCH}, T={AGENT_T}, E={m.WORD_EMB_SIZE}, "
        f"H={m.HIDDEN_SIZE}, encoder {m.ENC_LAYERS} layer(s) bidirectional={m.ENC_BIDIRECTION}, "
        f"{out['parameters']} parameters")

    # (a) serve
    nav = Navigator(world, agent, params0, tok, max_batch=BATCH, precision=precision,
                    device=device, model_state=state0)
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    nav.navigate_batch(batches[0])
    torch.cuda.synchronize()
    lat, outs = [], []
    for r in range(SERVE_ROUNDS):
        for reqs in batches:
            reset_launch_counts()
            t0 = time.perf_counter()
            o = nav.navigate_batch(reqs)
            lat.append(time.perf_counter() - t0)
            counts = launch_counts()
            check(counts == agent_launches(name, True),
                  f"{name} serve launches {counts}, expected {agent_launches(name, True)}")
            if r == 0:
                outs += o
    check_trajectories(world, requests, outs, AGENT_T)
    ep = nav.episodes(batches[0])
    res_k = nav.rollout(ep)
    with plain_kernels():
        res_p = nav.rollout(ep)
    l_k, l_p = res_k.steps.logits[0].float(), res_p.steps.logits[0].float()
    live = l_p > -1e29
    check(bool(torch.equal(live, l_k > -1e29)), f"{name}: the same candidate slots are masked")
    scale = float(l_p[live].abs().max())
    err = float((l_k - l_p)[live].abs().max())
    # f32 encoder and observation outputs summed in another order, then bf16
    # weights downstream: well inside a bf16 ulp (2^-8) of the logits' scale
    check(err <= 1e-3 * max(scale, 1.0), f"{name}: first-step logits |kernel - plain| {err:.3g} "
                                         f"of scale {scale:.3g}")
    moves = sum(len(o["trajectory"]) - 1 for o in outs)
    med = statistics.median(lat)
    out["serve"] = {"calls": len(lat), "latency_ms": [t * 1e3 for t in lat],
                    "median_ms": med * 1e3, "min_ms": min(lat) * 1e3, "max_ms": max(lat) * 1e3,
                    "launches_per_call": agent_launches(name, True),
                    "first_step_logit_err": err, "logit_scale": scale, "moves": moves}
    log(f"{name} (a) serve: {len(lat)} calls of {BATCH} requests, latency median "
        f"{med * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
        f"{BATCH / med:.1f} requests/s; launches a call exact {agent_launches(name, True)}; "
        f"first-step logits |kernel - plain| {err:.3g} of scale {scale:.3g}; {moves} moves | "
        f"{card}")
    wall, busy, rows = profile(lambda: nav.navigate_batch(batches[0]))
    out["serve"]["busy"] = (wall, busy)
    print_profile(f"one {name} serve call", wall, busy, rows)
    del nav

    # (b) one training iteration, kernels vs plain, from the same parameters,
    # batch and generator seed (sample feedback, dropout on, as configured)
    tables = world.device_tables(precision, device)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=device)
    params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
    state = tree.tree_map(lambda t: t.to(device), state0)
    leaves = tree.tree_leaves(params)
    batch = env.next_batch()
    lamb = cfg.TRAIN.PROGMONITOR_WEIGHT

    def grads():
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        total, logs, new_state = loop.agent_iteration_loss(
            agent, cfg.AGENT.FEEDBACK, tables, params, state, batch, gen, lamb=lamb)
        for p in leaves:
            p.grad = None
        total.backward()
        # a leaf outside the graph (the Follower's b_v: the reparameterised
        # query leaves it out, its true gradient is 0) has no gradient
        return (total.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                               for p in leaves], tree.tree_leaves(new_state))

    reset_launch_counts()
    loss_k, g_k, s_k = grads()
    counts = launch_counts()
    check(counts == agent_launches(name, False),
          f"{name} train launches {counts}, expected {agent_launches(name, False)}")
    with plain_kernels():
        loss_p, g_p, s_p = grads()
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= 1e-4 * max(1.0, abs(loss_p)), f"{name} loss kernels {loss_k} plain {loss_p}")
    grad_err, top = 0.0, max(float(g.abs().max()) for g in g_p)
    for path, gk, gp in zip(leaf_paths(params), g_k, g_p):
        if path in ZERO_GRAD[name]:
            # a shift every score of a softmax (or every row of a BatchNorm)
            # takes out: its gradient is 0 up to f32 rounding in both runs
            e = max(float(gk.abs().max()), float(gp.abs().max()))
            check(e <= 1e-3 * top, f"{name}: the gradient of {'/'.join(map(str, path))} "
                                   f"{e:.3g} is not 0 against the largest, {top:.3g}")
            continue
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        grad_err = max(grad_err, e / sc)
        check(e <= 1e-2 * sc, f"{name}: the gradient leaf {'/'.join(map(str, path))}: "
                              f"|kernel - plain| {e:.3g} > {1e-2 * sc:.3g}")
    bn_err = 0.0
    for a, b in zip(s_k, s_p):  # the Self-Monitor's BN running statistics
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
        bn_err = max(bn_err, e)
        check(e <= 1e-3, f"{name}: BN running statistics |kernel - plain| {e:.3g}")
    out["check"] = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_err": loss_err,
                    "grad_rel_err": grad_err, "bn_rel_err": bn_err if s_k else None,
                    "leaves": len(leaves)}
    log(f"{name} (b): {cfg.AGENT.FEEDBACK} iteration, loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} (|diff| {loss_err:.3g}); worst gradient leaf |kernel - plain| / max|plain| "
        f"{grad_err:.3g} (tol 1e-2) over {len(leaves) - len(ZERO_GRAD[name])} leaves, "
        f"{len(ZERO_GRAD[name])} more 0 up to rounding"
        + (f"; BN statistics {bn_err:.3g} (tol 1e-3) over {len(s_k)} leaves" if s_k else ""))
    for p in leaves:
        p.grad = None

    # (c) timed classic iterations: sample feedback, the config's optimizer
    optimizer = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    before = [p.detach().clone() for p in leaves]
    box = {"state": state}

    def iterate():
        logs, box["state"] = loop.agent_one_iter(agent, optimizer, cfg.AGENT.FEEDBACK, tables,
                                                 params, box["state"], env.next_batch(), gen,
                                                 lamb=lamb)
        return logs

    iterate()
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(TRAIN_ITERS):
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(iterate()["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        counts = launch_counts()
        check(counts == agent_launches(name, False),
              f"{name} timed iteration launches {counts}, expected {agent_launches(name, False)}")
    check(all(x == x and abs(x) < float("inf") for x in losses), f"{name}: finite losses {losses}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, leaves))
    med = statistics.median(times)
    wall, busy, rows = profile(iterate)
    out["train"] = {"ms": [t * 1e3 for t in times], "median_ms": med * 1e3,
                    "launches_per_iteration": agent_launches(name, False), "busy": (wall, busy),
                    "losses": losses, "leaves_moved": moved}
    log(f"{name} (c): {TRAIN_ITERS} timed {cfg.AGENT.FEEDBACK} iterations ({cfg.TRAIN.OPTIM}), ms "
        f"per iteration median {med * 1e3:.2f} (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}); launches an iteration exact {agent_launches(name, False)}; "
        f"losses {[round(x, 4) for x in losses]}; {moved}/{len(leaves)} leaves moved; device busy "
        f"{100 * busy / wall:.1f}% under the profiler | {card}")
    print_profile(f"one {name} training iteration", wall, busy, rows)

    # (d) one SPCL-weighted iteration on the _cl_ config as shipped
    ccfg = agent_cfg(cl_config, "TPU.PACKED_RL", 3)
    check(ccfg.TRAIN.CLMODE == "SELF-PACE", f"{cl_config} ships SELF-PACE")
    train = sorted(data[:SERVE_CALLS * BATCH], key=lambda it: it["distance"])
    per = len(train) // 5
    rounds = {f"round_{k}": expand_r2r_items(train[(k - 1) * per: k * per if k < 5 else None],
                                             tok) for k in range(1, 6)}
    spcl_env = CLR2RBatchEnv(world, rounds, BATCH, ccfg.TRAIN.SELF_PACE.CRATE, tok, SEED,
                             device=device)
    spcl = curriculum.SelfPacedCurriculum.from_config(ccfg, spcl_env, device=device)
    check(packed_factor(ccfg, agent, spcl) == 0, f"PACKED_RL is ignored for {name}")
    b = spcl_env.next_batch()
    idx = spcl_env.cur_batch_index
    w = spcl.batch_weights(idx)
    check(bool((w != w[0]).any()), "the SPCL weights differ across the batch")
    logs, box["state"] = loop.agent_one_iter(agent, optimizer, ccfg.AGENT.FEEDBACK, tables, params,
                                             box["state"], b, gen, weights=w,
                                             lamb=ccfg.TRAIN.PROGMONITOR_WEIGHT)
    spcl.record_losses(idx, logs["loss_per_sample"])
    vec, w_np = logs["loss_per_sample"].cpu().numpy(), w.cpu().numpy()
    ref = float(np.dot(w_np.astype(np.float64), vec) / w_np.astype(np.float64).sum())
    spcl_err = abs(float(logs["loss"]) - ref)
    check(spcl_err <= 1e-5 * max(1.0, abs(ref)), f"{name} SPCL loss {float(logs['loss'])} vs "
                                                 f"numpy {ref}")
    recorded = spcl.loss_for_item[spcl._rows(idx)].cpu().numpy()
    check(np.array_equal(recorded, vec.astype(np.float32)),
          "the SPCL record is the unscaled per-sample vector")
    out["spcl"] = {"loss": float(logs["loss"]), "numpy": ref, "err": spcl_err,
                   "weights": [float(w_np.min()), float(w_np.max())]}
    log(f"{name} (d): SPCL-weighted iteration on {cl_config} (PACKED_RL 3 ignored): loss "
        f"{float(logs['loss']):.6f} = dot(w, ml_vec) / sum(w) in numpy {ref:.6f} (|diff| "
        f"{spcl_err:.3g}); weights {w_np.min():.3g}..{w_np.max():.3g}; record unscaled")
    return out


def agents_phase(world, data, requests, tok, device, card):
    """The Follower and the Self-Monitor, then (e) ``check_the_code``."""
    from curriculum_learning_for_vln_torch.engine.trainer import check_the_code

    out = {}
    for name, (config, cl_config) in AGENT_CONFIGS.items():
        out[name] = agent_phase(name, config, cl_config, world, data, requests, tok, device, card)
    _, _, _, valid = curriculum_setup(world, data, tok, device)
    summary = check_the_code(agent_cfg(AGENT_CONFIGS["FOLLOWER"][0]),
                             world.device_tables("bf16", device), valid)
    check(summary["success_rate"] == 1.0 and summary["nav_error"] == 0.0,
          f"check_the_code: SR {summary['success_rate']}, NE {summary['nav_error']}")
    out["check_the_code"] = {"val_unseen": summary}
    log(f"agents (e): check_the_code on the synthetic val_unseen split: SR "
        f"{summary['success_rate']}, nav error {summary['nav_error']}, "
        f"{valid['val_unseen'].size()} episodes")
    return out


# ---------------------------------------------------------------------------
# Speaker phase: the speaker and back-translation
# ---------------------------------------------------------------------------

def launches_of(**counts):
    """Every kernel's expected launches: the ones named, 0 for the rest."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def counted(kind, fn, record):
    """``fn`` with each call's launches (by kernel) and ms (to a
    synchronize) appended to ``record[kind]``."""
    def run(*args, **kwargs):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        after = launch_counts()
        record[kind].append(({k: after[k] - before[k] for k in KERNELS},
                             (time.perf_counter() - t0) * 1e3))
        return out

    return run


def speaker_phase(world, data, tok, cfg, device, card):
    """The speaker at the width of ``AIDE.SPEAKER`` (RNN_DIM 512, WEMB 256,
    MAX_DECODE 120) and back-translation, on the EnvDrop config's world,
    TPU.PRECISION (bf16) with f32 masters, B = 64, T = 35, seeded random
    weights: (a) one teacher-forcing step through the kernels against the
    plain versions, (b) timed teacher-forcing steps, (c) decoding, greedy,
    sampled and back-translation's, (d) ``engine.self_train`` for a few
    iterations, (e) a speaker checkpoint read back and ``main
    --self-train``."""
    import glob
    import importlib

    from curriculum_learning_for_vln_torch.agents.common import cast_compute_params
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.speaker import (Speaker,
                                                                  collect_shortest_path_features)
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.models.speaker_model import speaker_decoder_apply
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.utils.tokenizer import (BOS_IDX, EOS_IDX, PAD_IDX,
                                                                   UNK_IDX)
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    st = importlib.import_module("curriculum_learning_for_vln_torch.engine.self_train")
    precision, T, s = cfg.TPU.PRECISION, cfg.AGENT.MAX_EPISODE_LEN, cfg.AIDE.SPEAKER
    check(T == SPEAKER_T, f"{CONFIG} ships T = {SPEAKER_T}")
    dtype = PRECISIONS[precision]
    speaker = Speaker(s, tok.vocab_size(), feat_dim=FEAT_DIM, episode_len=T, compute_dtype=dtype)
    tables = world.device_tables(precision, device)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=device)
    params, opt = speaker.init(torch.Generator().manual_seed(SEED), device)
    leaves = tree.tree_leaves(params)
    out = {"parameters": sum(p.numel() for p in leaves), "precision": precision}
    log(f"speaker: RNN_DIM {s.RNN_DIM} (bidirectional {s.BI_DIRECTION}), WEMB {s.WEMB}, "
        f"MAX_DECODE {s.MAX_DECODE}, DROPOUT {s.DROPOUT}, FEAT_DROPOUT {s.FEAT_DROPOUT}, "
        f"{precision}, B={BATCH}, T={T}, F={speaker.feature_size}, vocab {tok.vocab_size()}, "
        f"{out['parameters']} parameters")
    want_train = launches_of(lstm_scan_train=4, lstm_scan_bwd=4)  # 2 layers x 2 directions
    want_decode = launches_of(lstm_scan=4)

    # (a) one teacher-forcing step, kernels vs plain, from the same parameters,
    # batch and generator seed (dropout on, as configured)
    batch = env.next_batch()
    feats = collect_shortest_path_features(tables, batch, T, dtype)

    def grads():
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        loss = speaker.teacher_forcing_loss(params, feats, batch.instr_tokens, True, gen)
        for p in leaves:
            p.grad = None
        loss.backward()
        # baseline_fc1 / fc2 are on no path of the speaker (speaker_model.py): no gradient
        return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                             for p in leaves]

    reset_launch_counts()
    loss_k, g_k = grads()
    counts = launch_counts()
    check(counts == want_train, f"speaker step launches {counts}, expected {want_train}")
    with plain_kernels():
        loss_p, g_p = grads()
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= 1e-4 * max(1.0, abs(loss_p)), f"speaker loss kernels {loss_k} plain {loss_p}")
    grad_err, worst = 0.0, ""
    for path, gk, gp in zip(leaf_paths(params), g_k, g_p):
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        if e / sc > grad_err:
            grad_err, worst = e / sc, "/".join(map(str, path))
        # the bf16 compute weights' gradients are bf16: one ulp of the leaf's
        # largest element is up to 2^-7 of it
        check(e <= 1e-2 * sc, f"speaker gradient leaf {'/'.join(map(str, path))}: |kernel - "
                              f"plain| {e:.3g} > {1e-2 * sc:.3g}")
    for p in leaves:
        p.grad = None
    out["check"] = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_err": loss_err,
                    "grad_rel_err": grad_err, "worst_leaf": worst, "leaves": len(leaves),
                    "launches": counts}
    log(f"speaker (a): teacher-forcing loss kernels {loss_k:.6f} plain {loss_p:.6f} (|diff| "
        f"{loss_err:.3g}); worst gradient leaf |kernel - plain| / max|plain| {grad_err:.3g} "
        f"({worst}; tol 1e-2, one bf16 ulp is up to 2^-7) over {len(leaves)} leaves; launches "
        f"exact {counts}")

    # (b) timed teacher-forcing steps with exact launches
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    speaker.train_steps(params, opt, tables, env, gen, 1)  # warm-up
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in leaves]
    times, losses = [], []
    for _ in range(SPEAKER_ITERS):
        reset_launch_counts()
        t0 = time.perf_counter()
        losses += speaker.train_steps(params, opt, tables, env, gen, 1)[2]  # ends in a sync
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = launch_counts()
        check(counts == want_train, f"timed speaker step launches {counts}, expected {want_train}")
    check(all(x == x and abs(x) < float("inf") for x in losses), f"finite losses {losses}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, leaves))
    check(moved >= len(leaves) - 4, f"{moved} of {len(leaves)} speaker leaves moved")
    med = statistics.median(times)
    wall, busy, rows = profile(lambda: speaker.train_steps(params, opt, tables, env, gen, 1))
    out["train"] = {"ms": [t * 1e3 for t in times], "median_ms": med * 1e3, "busy": (wall, busy),
                    "losses": losses, "leaves_moved": moved,
                    "launches_per_step": want_train}
    log(f"speaker (b): {SPEAKER_ITERS} timed teacher-forcing steps (ClippedAdam), ms per step "
        f"median {med * 1e3:.2f} (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
        f"launches a step exact {want_train}; losses {[round(x, 4) for x in losses]}; "
        f"{moved}/{len(leaves)} leaves moved (baseline_fc* have no gradient); device busy "
        f"{100 * busy / wall:.1f}% under the profiler | {card}")
    print_profile("one speaker teacher-forcing step", wall, busy, rows)

    # (c) decoding: greedy, sampled, and back-translation's through a shared mask
    ep = env.next_batch()
    speaker.infer_batch(params, tables, ep, gen)  # warm-up
    dec = {}
    for label, kw in (("greedy", {}), ("sampled", {"sampling": True})):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words = speaker.infer_batch(params, tables, ep, gen, **kw).cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        check(counts == want_decode, f"{label} decode launches {counts}, expected {want_decode}")
        check(words.shape == (BATCH, s.MAX_DECODE) and not (words == UNK_IDX).any(),
              f"{label} decode: {words.shape} words, no <UNK>")
        for row in words:
            eos = np.flatnonzero(row == EOS_IDX)
            check(not len(eos) or (row[eos[0] + 1:] == PAD_IDX).all(), "<PAD> after <EOS>")
        ended = int(sum((row == EOS_IDX).any() for row in words))
        dec[label] = {"ms": ms, "launches": counts, "ended": ended}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_ep, noise = speaker.back_translate(params, tables, env, ep, int(ep.instr_tokens.shape[1]),
                                           gen, FEAT_DIM)
    toks, lens = new_ep.instr_tokens.cpu().numpy(), new_ep.instr_len.cpu().numpy()
    bt_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    check(counts == want_decode, f"back_translate launches {counts}, expected {want_decode}")
    keep = 1.0 - s.FEAT_DROPOUT
    check(bool(((noise == 0) | ((noise - 1.0 / keep).abs() <= 1e-6)).all())
          and noise.shape == (FEAT_DIM,), "the shared mask holds 0 and 1 / keep only")
    check((toks[:, 0] == BOS_IDX).all() and (toks[np.arange(BATCH), lens - 1] == EOS_IDX).all(),
          "back-translated instructions run <BOS> .. <EOS>")
    check(torch.equal(new_ep.start_node, ep.start_node) and bool(new_ep.valid.all()),
          "back-translation keeps the episodes")
    dec["back_translate"] = {"ms": bt_ms, "launches": counts, "mean_len": float(lens.mean()),
                             "mask_kept": float((noise > 0).float().mean())}

    def first_logits():  # the greedy decode's first step
        with torch.no_grad():
            f = collect_shortest_path_features(tables, ep, T, dtype)
            ctx, cmask = speaker._encode(params, f, False)
            h0 = torch.zeros((BATCH, s.RNN_DIM), device=device)
            bos = torch.full((BATCH, 1), BOS_IDX, dtype=torch.long, device=device)
            lg, _, _ = speaker_decoder_apply(cast_compute_params(params["decoder"], dtype), bos,
                                             ctx, cmask, h0, h0, False)
        return lg[:, 0].float()

    l_k = first_logits()
    with plain_kernels():
        l_p = first_logits()
    scale, lerr = float(l_p.abs().max()), float((l_k - l_p).abs().max())
    # f32 encoder outputs summed in another order, then bf16 weights downstream
    check(lerr <= 1e-3 * max(scale, 1.0), f"speaker first-step logits |kernel - plain| {lerr:.3g} "
                                          f"of scale {scale:.3g}")
    dec["first_step_logit_err"], dec["logit_scale"] = lerr, scale
    out["decode"] = dec
    log(f"speaker (c): decode of {s.MAX_DECODE} steps at B={BATCH}: greedy "
        f"{dec['greedy']['ms']:.2f} ms ({dec['greedy']['ended']} of {BATCH} ended), sampled "
        f"{dec['sampled']['ms']:.2f} ms, back_translate {bt_ms:.2f} ms (feature walk, masked "
        f"encoder, greedy decode, injection; mean length {lens.mean():.1f}, mask keeps "
        f"{dec['back_translate']['mask_kept']:.3f}); launches a call exact {want_decode}; "
        f"first-step logits |kernel - plain| {lerr:.3g} of scale {scale:.3g} | {card}")

    # (d) engine.self_train: speaker_iters 2, iters_per_epoch 4, each call's launches exact
    agent = EnvDropAgent(cfg.MODEL.ENVDROP, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=dtype, obs_masks=cfg.TPU.OBS_MASKS)
    record = {"pretrain": [], "real": [], "bt": [], "back_translate": []}
    st_speaker = Speaker(s, tok.vocab_size(), feat_dim=FEAT_DIM, episode_len=T,
                         compute_dtype=dtype)
    st_speaker.train_steps = counted("pretrain", st_speaker.train_steps, record)
    st_speaker.back_translate = counted("back_translate", st_speaker.back_translate, record)
    saved = st.one_iter, st.backtranslation_step
    st.one_iter = counted("real", st.one_iter, record)
    st.backtranslation_step = counted("bt", st.backtranslation_step, record)
    t0 = time.perf_counter()
    try:
        reset_launch_counts()
        st_params, _, (st_spk, _), st_losses = st.self_train(
            cfg, agent, st_speaker, env, env, tables, seed=SEED, speaker_iters=2, epochs=1,
            iters_per_epoch=4)
    finally:
        st.one_iter, st.backtranslation_step = saved
    st_s = time.perf_counter() - t0
    want = {"pretrain": launches_of(lstm_scan_train=8, lstm_scan_bwd=8),  # 2 steps
            "real": launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=2 * T + 1,
                                cand_score=2 * T + 1, pano_attend_bwd=2 * T,
                                cand_score_bwd=2 * T),
            "back_translate": want_decode,
            "bt": launches_of(lstm_scan_train=4, lstm_scan_bwd=4)}
    for kind, calls in record.items():
        check(len(calls) == (1 if kind == "pretrain" else 2), f"self_train: {len(calls)} {kind}")
        for counts, _ in calls:
            check(counts == want[kind], f"self_train {kind} launches {counts}, expected "
                                        f"{want[kind]}")
    all_losses = st_losses["real"] + st_losses["bt"]
    check(all(x == x and abs(x) < float("inf") for x in all_losses), f"finite {st_losses}")
    p0 = tree.tree_leaves(agent.init(torch.Generator().manual_seed(SEED + 1)))
    s0 = tree.tree_leaves(speaker.init(torch.Generator().manual_seed(SEED), device)[0])
    moved = sum(int(not torch.equal(a.to(device), b.detach()))
                for a, b in zip(p0, tree.tree_leaves(st_params)))
    spk_moved = sum(int(not torch.equal(a.detach(), b.detach()))
                    for a, b in zip(s0, tree.tree_leaves(st_spk)))
    check(moved == len(p0) and spk_moved >= len(s0) - 4,
          f"self_train moved {moved}/{len(p0)} EnvDrop and {spk_moved}/{len(s0)} speaker leaves")
    out["self_train"] = {"s": st_s, "losses": st_losses, "envdrop_leaves_moved": moved,
                         "speaker_leaves_moved": spk_moved,
                         "ms": {k: [ms for _, ms in v] for k, v in record.items()},
                         "launches": {k: want[k] for k in record}}
    log(f"speaker (d): self_train (2 speaker steps, 4 iterations) in {st_s:.1f} s: real "
        f"{[round(x, 4) for x in st_losses['real']]} bt {[round(x, 4) for x in st_losses['bt']]}; "
        + "; ".join(f"{k} ms {[round(ms, 2) for _, ms in v]}" for k, v in record.items())
        + f"; launches exact: real {want['real']}, back_translate {want['back_translate']}, "
        f"bt {want['bt']}; {moved}/{len(p0)} EnvDrop and {spk_moved}/{len(s0)} speaker leaves "
        f"moved | {card}")

    # (e) a speaker checkpoint read back, optimizer state included; main --self-train
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "speaker.ckpt")
        speaker.save(path, params, opt, epoch=1)
        p2, opt2, epoch = speaker.load(path, load_optim=True, device=device)
        check(epoch == 1 and all(torch.equal(a.detach(), b.detach()) for a, b in
                                 zip(leaves, tree.tree_leaves(p2))), "speaker params read back")
        st1, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
        check(st1.keys() == st2.keys() and all(
            torch.equal(st1[k][n].cpu(), st2[k][n].cpu())
            for k in st1 for n in ("step", "exp_avg", "exp_avg_sq")),
              "the speaker's optimizer state read back")
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--self-train",
               "--seed", str(SEED), "--config-file", CONFIG, "TPU.SYNTHETIC_WORLD", "True",
               "TPU.SYNTHETIC_SCANS", "6", "TPU.SYNTHETIC_NODES", "48", "TRAIN.MAX_EPOCH", "1",
               "TRAIN.ITER_PER_EPOCH", "2", "OUTPUT.LOG_DIR", d, "OUTPUT.TSBOARD_DIR", "",
               "OUTPUT.CKPT_DIR", d]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        main_s = time.perf_counter() - t0
        text = "".join(open(f).read() for f in glob.glob(os.path.join(d, "*.log")))
    check(run.returncode == 0 and "Self-training finished" in text,
          f"main --self-train: rc {run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    lines = [ln.split(": ", 1)[-1] for ln in text.splitlines()
             if "speaker pretrain" in ln or "self-train epoch" in ln]
    out["main"] = {"s": main_s, "log": lines}
    log(f"speaker (e): checkpoint read back with its optimizer state ({len(st1)} leaves); "
        f"main --self-train (synthetic 6 x 48, 200 speaker steps, 1 epoch of 2) in "
        f"{main_s:.1f} s: {' | '.join(lines)}")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    kernels_only = "--kernels-only" in sys.argv[1:]
    from curriculum_learning_for_vln_torch.ops.cuda import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    for name in build.SOURCES:  # anew, so that the compiler reports every kernel
        build.library_path(name).unlink(missing_ok=True)
    logs = build.build(ptxas_verbose=True)
    log(f"build: {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for kernel in ("recurrence_res_kernel", "bwd_recurrence_res_kernel"):
        res = kernel_resources(logs["lstm_scan"], kernel)
        check(len(res) == 2, f"{kernel}'s two instantiations in the build report: {res}")
        for entry, regs, st, ld in res:
            log(f"resident walk {kernel} {entry}: {regs} registers a thread, {st} B spill "
                f"stores, {ld} B spill loads")
            check(st == ld == 0 and regs <= 128, f"{entry}: {regs} registers, spills {st} / {ld}")

    t0 = time.perf_counter()
    world, data, requests, tok, cfg, m, params = build_serving()
    precision = cfg.TPU.PRECISION
    log(f"world: {world.num_nodes} nodes x 36 views x {FEAT_DIM}, {len(requests)} requests, "
        f"EnvDrop H={m.HIDDEN_SIZE} E={m.WORD_EMB_SIZE} A={m.ACT_EMB_SIZE}, enc len "
        f"{tok.encoding_length}, episode len {cfg.AGENT.MAX_EPISODE_LEN}, precision {precision}, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    lengths = torch.tensor([tok.encode_sentence(r["instruction"])[1] for r in requests[:BATCH]],
                           device=device)
    log(f"instruction lengths of the first micro-batch: {int(lengths.min())} to "
        f"{int(lengths.max())} tokens of {tok.encoding_length}")
    if kernels_only:
        results = kernel_phases(world, lengths, device)
        log(json.dumps({"kernels_only": {f"{n}/{p}": {k: v for k, v in r.items()}
                                         for (n, p), r in results.items()}}))
        return 0

    serve = {}
    for prec in (precision, "f32" if precision != "f32" else "bf16"):
        s = serve_phase(world, requests, tok, m, params, cfg.AGENT.MAX_EPISODE_LEN, prec, device)
        lat = s["latency_s"]
        med = statistics.median(lat)
        log(f"serve {prec}: {s['calls']} calls of {BATCH} requests, latency median "
            f"{med * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
            f"{BATCH / med:.1f} requests/s | launches {s['launches']} | first-step logits "
            f"|kernel - plain| {s['first_step_logit_err']:.3g} of scale "
            f"{s['logit_scale']:.3g}; f32 action ties {s['action_ties']} | {card}")
        serve[prec] = s
    nav = serve[precision]["nav"]
    wall, busy, rows = profile(lambda: nav.navigate_batch(serve[precision]["batches"][0]))
    print_profile(f"one {precision} serve call", wall, busy, rows)
    serve_counts = serve[precision]["launches"]
    del serve, nav

    train = train_phase(world, data, tok, cfg, m, params, requests, device)
    tw, tb = train["busy"]
    log(f"train: {train['median_ms']:.2f} ms per iteration (median of {TRAIN_ITERS}), device "
        f"busy {100 * tb / tw:.1f}% under the profiler | {card}")

    cur = curriculum_phase(world, data, tok, params, device)
    pk = cur["packed"]
    pw, pb = pk["busy"]
    log(f"curriculum: {pk['median_ms']:.2f} ms per SPCL packed iteration (median of "
        f"{CURRICULUM_ITERS - 2}), {pk['episodes_per_s']:.1f} completed episodes/s, device busy "
        f"{100 * pb / pw:.1f}% under the profiler | {card}")

    agents = agents_phase(world, data, requests, tok, device, card)
    for name in AGENT_CONFIGS:
        a = agents[name]
        sw, sb = a["serve"]["busy"]
        tw, tb = a["train"]["busy"]
        log(f"agents {name}: serve {a['serve']['median_ms']:.2f} ms a call of {BATCH} (device busy "
            f"{100 * sb / sw:.1f}%), train {a['train']['median_ms']:.2f} ms an iteration (device "
            f"busy {100 * tb / tw:.1f}%) | {card}")

    spk = speaker_phase(world, data, tok, cfg, device, card)
    sw, sb = spk["train"]["busy"]
    log(f"speaker: {spk['train']['median_ms']:.2f} ms a teacher-forcing step (device busy "
        f"{100 * sb / sw:.1f}%), greedy decode of {cfg.AIDE.SPEAKER.MAX_DECODE} steps "
        f"{spk['decode']['greedy']['ms']:.2f} ms, back_translate "
        f"{spk['decode']['back_translate']['ms']:.2f} ms a batch of {BATCH} | {card}")

    # after the timed path, so that the kernel phases' profiler sessions
    # do not come before the timed serve calls (whether a session leaves
    # host-side launch overhead behind is not settled)
    results = kernel_phases(world, lengths, device)

    # each kernel's launches on its main path: the serve run for K3, this
    # slice's SPCL packed training run for the others; K8 is on no path
    kernels = []
    for name, (src, tpu, _, _) in KERNELS.items():
        r, r32 = results[(name, precision)], results[(name, "f32")]
        if name in OFF_PATH:
            launches, path = 0, "none: no path of either package runs it (kernel phase only)"
        elif name == "lstm_scan":
            launches, path = serve_counts[name], "serve"
        else:
            launches, path = pk["launches"][name], "SPCL packed training (curriculum phase)"
        check(launches > 0 or name in OFF_PATH, f"{name} launched on its main path")
        entry = {
            "name": name, "route": "cuda", "source": f"curriculum_learning_for_vln_torch/{src}",
            "replaces": f"curriculum_learning_for_vln_tpu/{tpu}",
            "launches": launches, "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in TIME_KEYS}, "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "dtype": precision, "library_call": r["library_call"], "check": "ok",
            "main_path": path, "serve_launches": serve_counts[name],
            "classic_train_launches": train["launches"][name],
            **{f"{a.lower().replace('-', '_')}_launches": {
                "serve_call": agents[a]["serve"]["launches_per_call"][name],
                "train_iteration": agents[a]["train"]["launches_per_iteration"][name]}
               for a in AGENT_CONFIGS},
            "f32": {k: r32[k] for k in ("max_abs_err", *TIME_KEYS, "bound_ms", "bound_by")},
            "speaker_launches": {
                "train_step": spk["train"]["launches_per_step"][name],
                "decode_call": spk["decode"]["greedy"]["launches"][name],
                "back_translate": spk["decode"]["back_translate"]["launches"][name],
                "self_train": {k: v[name] for k, v in spk["self_train"]["launches"].items()}},
        }
        if "checks" in r:  # the LSTM kernels: each output group, and the long lengths
            keys = ("lengths", "valid_steps", "checks", *TIME_KEYS, "device_split", "bound_ms",
                    "bound_by")
            entry.update(lengths=r["lengths"], valid_steps=r["valid_steps"], checks=r["checks"],
                         device_split=r["device_split"])
            entry["f32"].update(checks=r32["checks"], device_split=r32["device_split"])
            entry["long_lengths"] = {prec: {k: x["long"][k] for k in keys}
                                     for prec, x in ((precision, r), ("f32", r32))}
            # the Follower's, the Self-Monitor's and the speaker's encoder layers
            for group, labels in (("agent_shapes", AGENT_LSTM_SHAPES),
                                  ("speaker_shapes", SPEAKER_LSTM_SHAPES)):
                entry[group] = {
                    label: {prec: {k: x[group][label][k]
                                   for k in ("shape", *keys, "max_abs_err", "ragged", "plans")
                                   if k in x[group][label]}
                            for prec, x in ((precision, r), ("f32", r32))}
                    for label in labels}
        else:
            entry["tol"] = r["tol"]
        if "ragged" in r:  # K4-K7 at a short prng_shared group, K8 at ragged edges
            entry["ragged"] = {precision: r["ragged"], "f32": r32["ragged"]}
        if "plans" in r:  # K4, K5: the launch plans at B = 64, 61 and 1
            entry["plans"] = {precision: r["plans"], "f32": r32["plans"]}
        if name in OFF_PATH:
            entry.update(shape=r["shape"], kernel_phase_launches=r["kernel_phase_launches"])
        if "modes" in r:
            entry["mask_mode"] = "prng (prng_shared on the SPCL path: under modes)"
            entry["modes"] = r["modes"]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
