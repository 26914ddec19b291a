#!/usr/bin/env python3
"""Drive the PyTorch port's EnvDrop serving and training paths on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # build + kernel phases only

1. Prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions.
2. Builds the port's CUDA kernels from ``curriculum_learning_for_vln_
   torch/csrc`` (one ``nvcc`` per source, all at once) and prints the
   compiler's register and spill report.
3. Kernel phases, in bf16 and f32, each kernel on the card at its path's
   shapes, held against its plain PyTorch version on the same inputs and
   timed with CUDA events beside its plain version, one PyTorch library
   call where there is one, and the least time the card could take:
   K3 (LSTM scan), K1 and K2 (training forward and backward of the scan;
   at the token lengths of the synthetic instructions, which the serve and
   train phases run, and at lengths up to MAX_ENC_LEN = 80), K4 and K5 (observation step forward and backward) and K6 and K7
   (candidate scoring forward and backward), the last four in the mask
   modes none, ext and prng (the plain prng mode draws the kernels' Philox
   bits, so prng is held to the tolerance of the arithmetic).
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
6. Prints one ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device, or without the port beside it, it fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import torch

SEED = 0
BATCH = 64
NUM_SCANS, NODES_PER_SCAN, FEAT_DIM = 12, 64, 2048
CONFIG = "configs/envdrop/envdrop_config.yaml"
VOCAB = "assets/train_vocab.txt"
SERVE_CALLS = 4          # distinct micro-batches of BATCH requests
SERVE_ROUNDS = 2         # timed passes over them
TRAIN_ITERS = 6          # timed training iterations (after one warm-up)
MODES = ("none", "ext", "prng")

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
}


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
    """Mean device time of ``fn(i)`` over ``iters`` back-to-back calls."""
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
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    return {"lstm_scan": lstm_scan, "pano_fused": pano_fused, "cand_score": cand_score}


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
             "cand_score": ("cand_score", "cand_score_bwd")}
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
    return DropSpec("prng", seeds=philox.draw_seeds(B, gen, device), keep=keep)


def drop_bytes(drop) -> int:
    return nbytes(drop.mask) if drop.mode == "ext" else (
        nbytes(drop.seeds) if drop.mode == "prng" else 0)


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def lstm_inputs(dtype, device, gen, B, L=80, D=256, H=256):
    def u(*shape):
        return ((torch.rand(*shape, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)

    xs = torch.randn(B, L, D, generator=gen, device=device).to(dtype)
    return xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)


def lstm_library(xs, lengths, w_ih, w_hh, b, iters):
    """torch.nn.LSTM (cuDNN) on one packed direction: (forward ms with
    autograd recording, backward ms of that forward's graph), or Nones
    where cuDNN has no RNN of this dtype."""
    D, H = w_ih.shape[0], w_hh.shape[0]
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(device=xs.device, dtype=xs.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()
    x = xs.detach().clone().requires_grad_(True)
    try:
        fwd_ms = cuda_time_ms(lambda i: lstm(torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths.cpu(), batch_first=True, enforce_sorted=False)), iters)
        out, _ = lstm(torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths.cpu(), batch_first=True, enforce_sorted=False))
        g = torch.randn_like(out.data)
        inputs = [x, *lstm.parameters()]
        bwd_ms = cuda_time_ms(lambda i: torch.autograd.grad(out.data, inputs, g,
                                                            retain_graph=True), iters)
        return fwd_ms, bwd_ms
    except RuntimeError as e:  # a cuDNN RNN without this dtype: no yardstick
        log(f"  torch.nn.LSTM in {xs.dtype}: {e}".splitlines()[0])
        return None, None


def long_lengths(B, gen, device, lo=16, hi=80):
    """Token lengths uniform in lo..hi (hi = MAX_ENC_LEN, the cap that real
    R2R instructions reach), one of them hi: the LSTM kernels' serial loop
    runs to the longest row of each cluster, so its time grows with them."""
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
    lengths[0] = hi
    return lengths


def lstm_phases(dtype, device, gen, lengths, iters=20):
    """K3, K1 and K2 at the encoder's shapes (B = 64, L = 80, D = H = 256),
    both directions, over the token lengths ``lengths``."""
    k = modules()["lstm_scan"]
    B = lengths.shape[0]
    xs, w_ih, w_hh, b = lstm_inputs(dtype, device, gen, B)
    L, D, H = xs.shape[1], xs.shape[2], w_hh.shape[0]
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    d_out = torch.randn(B, L, H, generator=gen, device=device)
    dhT, dcT = (torch.randn(B, H, generator=gen, device=device) for _ in range(2))
    # each output group with its own tolerance; the worst of both directions
    err = {"lstm_scan": {}, "lstm_scan_train": {}, "lstm_scan_bwd": {}}

    def worst(name, part, e):  # the comparison nearest its tolerance
        err[name][part] = max(err[name].get(part, (0.0, float("inf"))), e,
                              key=lambda x: x[0] - x[1])

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

    tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b)
    times = {
        "lstm_scan": (cuda_time_ms(lambda i: k.lstm_scan(xs, lengths, w_ih, w_hh, b,
                                                         reverse=bool(i & 1)), iters),
                      cuda_time_ms(lambda i: k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b), 3, 1)),
        "lstm_scan_train": (
            cuda_time_ms(lambda i: k.lstm_scan_train(xs, lengths, w_ih, w_hh, b,
                                                     reverse=bool(i & 1)), iters),
            cuda_time_ms(lambda i: k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b), 3, 1)),
        "lstm_scan_bwd": (
            cuda_time_ms(lambda i: k.lstm_scan_bwd(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3],
                                                   d_out, dhT, dcT), iters),
            cuda_time_ms(lambda i: k.lstm_scan_bwd_plain(xs, lengths, w_ih, w_hh, tk[4], tk[2],
                                                         tk[3], d_out, dhT, dcT), 3, 1)),
    }
    lib_fwd, lib_bwd = lstm_library(xs, lengths, w_ih, w_hh, b, iters)

    # bounds per direction, from this run's valid steps: a per-step input
    # that the function reads only at valid steps (xs, d_out, and K2's
    # gates, hprev and cprev) counts those steps; an output counts its
    # full size (outs, hT, cT; K1's hprev and cprev; d_xs, dW_ih, dW_hh,
    # db).  K1's gate residual is the port's own choice, not the
    # function's, so K1's bound leaves it out (K2 reads it in place of
    # recomputing x.W_ih and h.W_hh, so K2's counts it).
    steps = int(lengths.clamp(max=L).sum())
    f32 = 4
    xs_valid = steps * D * xs.element_size()
    fwd_bytes = (xs_valid + nbytes(lengths, w_ih, w_hh, b) + B * L * H * f32
                 + 2 * B * H * f32)
    train_bytes = fwd_bytes + 2 * L * B * H * f32
    bwd_bytes = (xs_valid + nbytes(lengths, w_ih, w_hh, dhT, dcT)
                 + steps * (4 * H + 2 * H + H) * f32      # gates, hprev, cprev, d_out
                 + nbytes(xs) + (D + H + 1) * 4 * H * f32)  # d_xs, dW_ih, dW_hh, db
    fwd_flops = 2 * steps * (D + H) * 4 * H
    bwd_flops = 2 * steps * 4 * H * (2 * H + 2 * D)
    spec = {
        "lstm_scan": (fwd_bytes, fwd_flops,
                      lstm_library_infer(xs, lengths, w_ih, w_hh, b, iters),
                      "torch.nn.LSTM forward on a packed sequence (one direction)"),
        "lstm_scan_train": (train_bytes, fwd_flops, lib_fwd,
                            "torch.nn.LSTM forward with autograd recording (one direction)"),
        "lstm_scan_bwd": (bwd_bytes, bwd_flops, lib_bwd,
                          "torch.autograd.grad through torch.nn.LSTM (one direction)"),
    }
    out = []
    for name, (moved, flops, lib, call) in spec.items():
        ms, plain_ms = times[name]
        out.append({"name": name, "max_abs_err": max(e for e, _ in err[name].values()),
                    "checks": {part: {"max_abs_err": e, "tol": tol}
                               for part, (e, tol) in err[name].items()},
                    "lengths": lengths_label(lengths), "valid_steps": steps,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib, "library_call": call,
                    "bound": bound_ms(moved, flops, dtype)})
    return out


def lengths_label(lengths) -> str:
    return (f"{int(lengths.min())}-{int(lengths.max())} tokens, mean "
            f"{float(lengths.float().mean()):.1f}")


def lstm_library_infer(xs, lengths, w_ih, w_hh, b, iters):
    D, H = w_ih.shape[0], w_hh.shape[0]
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(device=xs.device, dtype=xs.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(xs, lengths.cpu(), batch_first=True,
                                                         enforce_sorted=False)
        try:
            return cuda_time_ms(lambda i: lstm(packed), iters)
        except RuntimeError as e:
            log(f"  torch.nn.LSTM in {xs.dtype}: {e}".splitlines()[0])
            return None


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
    cand_angle = torch.randn(B, MC, A, generator=gen, device=device)
    valid = torch.rand(B, MC, generator=gen, device=device) < 0.5
    q = torch.randn(B, D + A, generator=gen, device=device) / 32
    d_logits = torch.randn(B, MC + 1, generator=gen, device=device)
    rows = int(torch.unique(node_sets[0]).numel()) * V * D * features.element_size()
    loc_rows = int(torch.unique(views).numel()) * V * A * 4
    res = {}
    for mode in MODES:
        pd = drop_spec(mode, B, V, D, gen, device)
        cd = drop_spec(mode, B, MC, D, gen, device)
        args = (node_sets[0], views, cand_view, features, loc, tv)
        got, want = kp.pano_attend(*args, pd), kp.pano_attend_plain(*args, pd)
        check(torch.equal(got[2], want[2]), "pano_attend: candidate rows are exact copies")
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
        t4 = cuda_time_ms(lambda i: kp.pano_attend(node_sets[i % 8], views, cand_view, features,
                                                   loc, tv, pd), iters)
        p4 = cuda_time_ms(lambda i: kp.pano_attend_plain(node_sets[i % 8], views, cand_view,
                                                         features, loc, tv, pd), 10)
        t5 = cuda_time_ms(lambda i: kp.pano_attend_bwd(node_sets[i % 8], views, features, loc,
                                                       alpha, d_vis, pd), iters)
        p5 = cuda_time_ms(lambda i: kp.pano_attend_bwd_plain(node_sets[i % 8], views, features,
                                                             loc, alpha, d_vis, pd), 10)
        t6 = cuda_time_ms(lambda i: kc.cand_score(cand_sets[i % 8], cand_angle, valid, q, cd),
                          iters)
        p6 = cuda_time_ms(lambda i: kc.cand_score_plain(cand_sets[i % 8], cand_angle, valid, q,
                                                        cd), 10)
        t7 = cuda_time_ms(lambda i: kc.cand_score_bwd(cand_sets[i % 8], cand_angle, valid,
                                                      d_logits, cd), iters)
        p7 = cuda_time_ms(lambda i: kc.cand_score_bwd_plain(cand_sets[i % 8], cand_angle, valid,
                                                            d_logits, cd), 10)
        q_img = q[:, :D].to(dtype).contiguous()
        w = torch.where(valid, d_logits[:, :MC], 0.0).to(dtype)
        l6 = cuda_time_ms(lambda i: torch.einsum("bkd,bd->bk", cand_sets[i % 8], q_img), iters)
        l7 = cuda_time_ms(lambda i: torch.einsum("bk,bkd->bd", w, cand_sets[i % 8]), iters)
        ang_b = B * MC * A * features.element_size()
        res[mode] = [
            {"name": "pano_attend", "err": e4, "ms": t4, "plain_ms": p4, "library_ms": None,
             "library_call": "none: no one PyTorch call gathers, drops, attends and copies rows",
             "bound": bound_ms(rows + loc_rows + nbytes(node_sets[0], views, cand_view, tv)
                               + drop_bytes(pd) + nbytes(*got), 4 * B * V * (D + A), dtype)},
            {"name": "pano_attend_bwd", "err": e5, "ms": t5, "plain_ms": p5, "library_ms": None,
             "library_call": "none: no one PyTorch call re-gathers, drops and back-propagates "
                             "the attention",
             "bound": bound_ms(rows + loc_rows + nbytes(node_sets[0], views, alpha, d_vis)
                               + drop_bytes(pd) + B * (D + A) * 4, 4 * B * V * (D + A), dtype)},
            {"name": "cand_score", "err": e6, "ms": t6, "plain_ms": p6, "library_ms": l6,
             "library_call": "torch.einsum('bkd,bd->bk') over the image rows",
             "bound": bound_ms(nbytes(cand_sets[0], valid, q, got6) + ang_b + drop_bytes(cd),
                               2 * B * MC * (D + A), dtype)},
            {"name": "cand_score_bwd", "err": e7, "ms": t7, "plain_ms": p7, "library_ms": l7,
             "library_call": "torch.einsum('bk,bkd->bd') over the image rows",
             "bound": bound_ms(nbytes(cand_sets[0], valid, d_logits) + ang_b + drop_bytes(cd)
                               + B * (D + A) * 4, 2 * B * MC * (D + A), dtype)},
        ]
    return res


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
        for r, r_long in zip(lstm_phases(dtype, device, gen, lengths),
                             lstm_phases(dtype, device, gen, long)):
            r["long"] = r_long
            results[(r["name"], prec)] = r
        by_mode = obs_phases(dtype, device, gen, features)
        for i, r in enumerate(by_mode["prng"]):
            r = dict(r)
            r["max_abs_err"], r["tol"] = r.pop("err")
            r["modes"] = {}
            for mode in MODES:
                m = by_mode[mode][i]
                b_ms, b_by = m["bound"]
                r["modes"][mode] = {"max_abs_err": m["err"][0], "tol": m["err"][1],
                                    "ms": m["ms"], "plain_ms": m["plain_ms"],
                                    "library_ms": m["library_ms"], "bound_ms": b_ms}
                check(m["err"][0] <= m["err"][1],
                      f"{r['name']} {prec} {mode}: |kernel - plain| {m['err'][0]:.3g} "
                      f"> {m['err'][1]:.3g}")
                log(f"{r['name']:16s} {prec:4s} {mode:4s} max|kernel-plain| {m['err'][0]:.3g} "
                    f"(tol {m['err'][1]:.3g}) | kernel {m['ms']:.4f} ms, plain "
                    f"{m['plain_ms']:.4f} ms, library {fmt(m['library_ms'])} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
            results[(r["name"], prec)] = r
        del features
        for name in ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"):
            for r in (results[(name, prec)], results[(name, prec)]["long"]):
                b_ms, b_by = r["bound"]
                errs = ", ".join(f"{part} {c['max_abs_err']:.3g} (tol {c['tol']:.3g})"
                                 for part, c in r["checks"].items())
                log(f"{name:16s} {prec:4s} lengths {r['lengths']}: max|kernel-plain| {errs} | "
                    f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                    f"{fmt(r['library_ms'])} ms, bound {b_ms:.4f} ms ({b_by}, "
                    f"{r['valid_steps']} valid steps)")
                for part, c in r["checks"].items():
                    check(c["max_abs_err"] <= c["tol"],
                          f"{name} {prec} {part} agrees with its plain version")
        torch.cuda.synchronize()
    for r in results.values():
        for x in (r, r.get("long", {})):
            if "bound" in x:
                x["bound_ms"], x["bound_by"] = x.pop("bound")
    return results


def fmt(x):
    return "None" if x is None else f"{x:.4f}"


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
        if e.device_type != DeviceType.CUDA:
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
        f"{grad_err:.3g} (tol 1e-2) over {len(leaves)} leaves, il_len {il_len}")
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
        want = dict(lstm_scan_train=4, lstm_scan_bwd=4, lstm_scan=0, pano_attend=t_il + T + 1,
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
    logs = build.build(ptxas_verbose=True)
    log(f"build: {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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
    results = kernel_phases(world, lengths, device)
    if kernels_only:
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

    # each kernel's launches on its main path: the serve run for K3, the
    # training run for the others
    kernels = []
    for name, (src, tpu, _, _) in KERNELS.items():
        r, r32 = results[(name, precision)], results[(name, "f32")]
        launches = serve_counts[name] if name == "lstm_scan" else train["launches"][name]
        check(launches > 0, f"{name} launched on its main path")
        entry = {
            "name": name, "route": "cuda", "source": f"curriculum_learning_for_vln_torch/{src}",
            "replaces": f"curriculum_learning_for_vln_tpu/{tpu}",
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": precision,
            "library_call": r["library_call"], "check": "ok",
            "main_path": "serve" if name == "lstm_scan" else "train",
            "serve_launches": serve_counts[name],
            "f32": {k: r32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        }
        if "checks" in r:  # the LSTM kernels: each output group, and the long lengths
            keys = ("lengths", "valid_steps", "checks", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")
            entry.update(lengths=r["lengths"], valid_steps=r["valid_steps"], checks=r["checks"])
            entry["f32"].update(checks=r32["checks"])
            entry["long_lengths"] = {prec: {k: x["long"][k] for k in keys}
                                     for prec, x in ((precision, r), ("f32", r32))}
        else:
            entry["tol"] = r["tol"]
        if "modes" in r:
            entry["mask_mode"] = "prng"
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
