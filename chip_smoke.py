#!/usr/bin/env python3
"""Drive the PyTorch port's EnvDrop serving and training paths, the
paper's curriculum recipe, the Exp3.S curriculum with the per-round
train evaluation, R4R with the gt-route teacher, the rollout early exit,
the Follower and Self-Monitor agents (the Follower also with frozen
GloVe embeddings), the speaker with back-translation, beam search with
speaker rescoring, the ViLBERT scorer with the CLR2R construction,
data-parallel training over several processes, the rollout BPTT, and the
plain route without any kernel (TPU.USE_PALLAS False) beside the kernels,
on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # build + kernel phases only: the
                                           # short first call for a new kernel
    python3 chip_smoke.py --dp-only        # build + the data-parallel phase
    python3 chip_smoke.py --bptt-only      # build + the slice-11 phase (14)
    python3 chip_smoke.py --slice12-only   # build + the slice-12 phase (15)

1. Prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions.
2. Builds the port's CUDA kernels from ``curriculum_learning_for_vln_
   torch/csrc`` (one ``nvcc`` per source, all at once, anew) and prints the
   compiler's register and spill report; the resident LSTM walks
   (``recurrence_res_kernel`` and ``bwd_recurrence_res_kernel``, which hold
   W_hh in registers), each instantiation printed by name, must show no
   spills and at most 128 registers a thread.
3. Kernel phases (in a full run, last, so that their profiler sessions
   do not come before the timed serve calls, and in a process of their
   own, fresh as with ``--kernels-only``), in bf16 and f32:
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
   lengths and at B = 61 over ragged ones, the first layer also timed at B
   = 64 over ragged lengths 1-35 (the bf16 gates_x's tiles of valid steps
   then straddle batch rows); each K1/K3 row with its gates_x launch's
   useful TFLOP/s beside K2's GEMMs' (``gemm_rates``); K3 also at the beam's
   rescoring shapes (bf16 (2176, 256) and f32 (512, 256), B = 30, ragged
   lengths up to 16) beside cuDNN and its bound.  The forward and the
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
7. Curriculum-and-data phase, on the port's own synthetic world at
   EnvDrop's full width (``pipeline.build_environments`` with
   ``TPU.SYNTHETIC_WORLD``, 6 scans of 160 nodes: 2048-d features), bf16,
   B = 64, T = 35: (a) ``TRAIN.CLMODE AUTO`` on ``envdrop_cl_config.yaml``
   (its PACKED_RL 3 turned off by AUTO), the five rounds as the bandit's
   arms: one iteration through the kernels against the plain versions
   (loss and every gradient leaf), then one epoch of the trainer
   ``main.build_trainer`` returns (8 iterations, each with exact
   launches), its arms and ``log_w`` after the epoch's rewards against a
   numpy recomputation of Exp3.S; (b) ``TRAIN.EVAL_TRAIN`` in that epoch:
   each round's train split scored at B = 128 (K3 twice and K4 = K6 = T a
   batch, exactly) before the validation splits, and one batch of 128
   evaluated again with every K3, K4 and K6 call held against its plain
   version on the same inputs; (c) ``DATA.NAME R4R`` with ``AGENT.TEACHER
   path`` (the pipeline's R4R branch): one iteration kernels vs plain;
   (d) ``TPU.SCAN_EARLY_EXIT`` on and off (``loop.configure_runtime``)
   from the same seed, with the IL rollout bucketed and at the full T: the
   same loss and gradients, the generator left in the same state, K4 / K6
   launches, and the wall and device-busy ms of each, timed in turns
   (off, on, on, off); (e) the Follower of ``follower_config.yaml`` with
   a GloVe table it writes as ``.npy``: kernels vs plain, one Adam step
   with exact launches, the table unchanged bit for bit; (f) ``main`` as a
   user runs it, three processes of their own run together, each printing
   its launches:
   AUTO with the early exit, EnvDrop on R4R with the path teacher, and
   the Follower with the GloVe table on R4R (the table read back from its
   checkpoint unchanged).  Every kernel K1-K7 must launch on these paths.
8. Agents phase: the Follower (``configs/follower/follower_config.yaml``)
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
9. Speaker phase: the speaker at the default ``AIDE.SPEAKER`` (RNN_DIM
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
10. Beam phase (``main --beam``): EnvDrop at full width (random weights
   from a seed; the beam decodes in f32 on the bf16 tables, as the JAX
   package does), the default ``AIDE.SPEAKER`` in bf16, one batch of 64
   instructions, beam 30, max_iters 500.  (a) The listener's encoder and
   one rescoring call through K3 against the plain versions.  (b)
   ``beam_rollout`` timed: iterations, ms a decode step, host ms an
   iteration, ms a rescoring call, with exact launches (K3 = 2 for the
   listener + 4 for each episode with a path, nothing else).  (c) Every
   episode has a path, every score is a log-probability, every dijk path
   a connected walk.  (d) ``main --beam 5`` on a synthetic 6 x 48 world.
11. ViLBERT phase: ``VilBertConfig``'s default widths (hidden 768, 12 + 3
   layers, bi 1024 x 16 heads) with the shipped vocabulary and 2048-d
   features, about 1.4e8 parameters with Adam in f32.  (a) ``score_paths``
   on the card against the same parameters on the CPU.  (b) Timed
   pretraining steps (B = 32) and the scoring of 1,000 items, each with
   its device-busy share; no kernel of the port launches.  (c) The loss
   falls over 20 steps.  (d) ``build_clr2r`` writes five rounds.
12. Data-parallel phase (after ViLBERT, before the kernel phases):
   DP_RANKS = 2 rank processes share the card (gloo over CUDA tensors;
   NCCL refuses two ranks on one GPU), each on its rows of the same
   batches.  (a) The classic EnvDrop iteration at full width, B = 64 (32
   a rank), T = 35, prng, in bf16 and f32: the loss and every gradient
   leaf after the sum over the ranks against one process on the same
   parameters, batch and generator seed (f32: 1e-4 of each leaf, in L2
   and element by element; bf16: 1e-2 in L2, each leaf's gradient being
   summed in bf16 over the steps), each rank's launches exact (K1 = K2 =
   4, K4 = K6 = T_il + 36, K5 = K7 = T_il + 35), and timed iterations at
   N = 1 (rank 0 alone) and N = 2 (each rank).  (b) One SPCL packed
   iteration of ``envdrop_cl_config.yaml`` (prng_shared, a pool of 3 x 64
   in every rank): the episodes started and done equal, the loss and
   gradients as (a).  (c) One Self-Monitor iteration in f32: the loss,
   every gradient leaf within 1e-3 in L2 (beside the same one-process
   iteration with its BatchNorm sums split as the ranks split them: the
   BatchNorm's own rounding), the BN running statistics within 1e-5.  (e)
   ViLBERT at ``VilBertConfig``'s defaults: ``score_paths`` over model =
   2 against replicated scoring within 1e-5 (f32, TF32 off).  (d) ``main``
   (the Follower, f32, teacher feedback, SGD, 3 iterations) as four
   processes run together: one process, 2 ranks joined by the VLN_*
   variables, and world size 1 on NCCL: every scalar within 1e-4 of the
   one process's, rank 0 alone writing the checkpoint, each printing its
   launches.
13. Prints one ``{"kernels": [...]}`` line (with each kernel's launches on
   the curriculum-and-data phase's, the Follower's, the Self-Monitor's,
   the speaker's, the beam's, the ViLBERT, the data-parallel, the BPTT and
   the slice-12 paths, the plain route's zeros among them), the card's name
   and power limit, and as the last line ``{"ok": true, "device": {...}}``.
14. Slice-11 phase (after phase 12, before the kernel phases), on the
   serve world at EnvDrop's full width, B = 64, T = 35, prng: (a) one
   classic iteration with ``TPU.FUSED_BPTT`` on (the hand-written rollout
   backward, ops/bptt.py) against off, in bf16 and f32, from the same
   parameters, batch and generator seed: the losses within 1e-5
   relative, every gradient leaf within 1e-4 in L2 (f32) or 1e-2 (bf16),
   the generator's state equal, the launches exact (on: K1 = K2 = 4, K4 =
   K6 = 1 for the A2C tail's bootstrap step, nothing else; off: as phase
   5), then bf16 iterations timed in turns (off, on, on, off) and one of
   each profiled (its device-busy share); (b) ``main`` with
   ``TPU.FUSED_BPTT True`` (PACKED_RL 0) for one short epoch on the 6 x
   160 synthetic world (K5 = K7 = 0); (c) the native C++ solver builds
   and the serve world compiled with it has scipy's tables but its
   distances (within 1e-4) and its next hops at equal-cost ties (each
   still on a shortest path); (d) ``utils.roofline.roofline_summary`` of
   the timed iterations and of a serve call (the H100's published peaks);
   (e) the peak device memory of one bf16 iteration with the flag off and
   on, in prng and ext, at B = 64 and 512 (the BPTT draws its masks again
   and gathers the observations again where autograd stores them).
15. Slice-12 phase (after phase 14, before the kernel phases): the plain
   route (TPU.USE_PALLAS False: the encoders' autograd step loop, the
   agents' unfused decode) against the kernels, on the serve world.  (a)
   EnvDrop's ``Navigator(use_pallas=False)`` against the default one at
   full width, f32 and bf16, 64 requests a call: first-step logits within
   1e-4 of their scale in f32 (1e-2 in bf16, where the plain route
   contracts the attention in bf16 as JAX's XLA route does), trajectories
   equal but after a tie (``compare_actions``), launches a call exact
   (kernels: K3 = 2, K4 = K6 = T; plain: every K 0); bf16 calls timed in
   turns (kernels, plain, plain, kernels) with each route's device-busy
   share.  (b) One classic EnvDrop iteration (B = 64, T = 35) and one
   Follower and one Self-Monitor iteration (their configs' full widths, T =
   10), each through ``loop.configure_runtime`` with USE_PALLAS True and
   False, from the same parameters, batch and generator seed, at DROP_RATE
   (and FEAT_DROP_RATE) 0 with teacher feedback, f32 and bf16: the loss
   within 1e-5 relative (bf16 1e-3), every gradient leaf within 1e-4 in L2
   (bf16 1e-2), the leaves whose gradient is 0 within 1e-3 (bf16 1e-2) of
   the largest, the Self-Monitor's BN statistics within 1e-3; launches
   exact (EnvDrop's IL: K1 = K2 = 2, K4-K7 = T_il; the agents as phase 8;
   plain 0); then iterations with the configs' dropout timed in turns with
   busy shares (EnvDrop sample feedback, prng: kernels as phase 5, plain
   0).  (c) ``main`` with TPU.CKPT_ASYNC True and False (PACKED_RL 0, 2
   epochs of 2 iterations, run together on the 6 x 160 world): the same
   checkpoint files after the rotation, every bundle equal array by array.
   (d) ``run_eval`` over 32 paths written by ``write_results`` and scored
   from the file: the same scores as in memory.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device, or without the port beside it, it fails.
"""
from __future__ import annotations

import gc
import glob
import json
import math
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
# the first layer again at B = 64 over ragged lengths (1-35 tokens, a 35): the
# bf16 gates_x's tiles of valid steps then straddle batch rows
SPEAKER_RAGGED = "speaker_l1_ragged"
BEAM_SIZE = 30        # the default of BeamSearch.beam_rollout / beam_search (JAX beam.py:315-316)
BEAM_MAX_ITERS = 500  # BeamSearch's default expansion budget
# K3 at the beam's rescoring shapes: the speaker encoder's first layer (bf16,
# the compute dtype) and its post-LSTM (f32, after the f32 attention) over
# up to BEAM_SIZE paths of up to 16 steps
RESCORE_B, RESCORE_L = BEAM_SIZE, 16
RESCORE_SHAPES = {"rescore_l1": (FEAT_DIM + 128, 256, torch.bfloat16),
                  "rescore_post": (512, 256, torch.float32)}
AUTO_ITERS = 8        # AUTO iterations in one epoch: 8 draws of 5 arms repeat some, so
                      # the epoch's end rewards the bandit
R4R_JOINS = 1         # DATA.R4R_JOINS as the config ships it
EXIT_ROUNDS = 5       # rounds of (off, on, on, off) timed iterations of the early exit
MAIN_ITERS = 3        # iterations an epoch of each ``main`` run of the curriculum-and-data phase
# the pipeline's synthetic world at full width (over 128 nodes a scan: 2048-d features)
SYN_SCANS, SYN_NODES = 6, 160
VIL_BATCH = 32        # ViLBERT pretraining batch
VIL_STEPS = 20        # timed pretraining steps (after one warm-up)
VIL_ITEMS = 1000      # items scored by score_difficulty
VIL_PATH = 8          # max_path_len of the scorer's inputs (R2R paths have at most 7 nodes)
DP_RANKS = 2          # rank processes of the data-parallel phase, sharing the one card
DP_ITERS = 3          # timed iterations at N = 1 and at N = DP_RANKS (after one warm-up)
DP_MAIN_ITERS = 3     # iterations of each ``main`` run of the data-parallel phase
DP_CLR2R_STEPS = 20   # pretraining steps of the data-parallel phase's build_clr2r runs

BPTT_ROUNDS = 2       # rounds of (off, on, on, off) timed iterations of phase 14 (prng)
BPTT_MAIN_ITERS = 2   # iterations of phase 14's ``main`` run
BPTT_MEM_BATCHES = (64, 512)  # batches of phase 14's memory reading
S12_ROUNDS = 2        # rounds of (kernels, plain, plain, kernels) timed calls of phase 15
S12_MAIN_ITERS = 2    # iterations an epoch of phase 15's two ``main`` runs (2 epochs each)
S12_EVAL_PATHS = 32   # paths (3 instructions each) of phase 15's results file

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
    arguments and parameter list: "bwd_recurrence_kernel<float>(...)" ->
    "bwd_recurrence_kernel"."""
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
    """The least time of the work: its bytes over the H100's memory rate or
    its operations over the dtype's dense peak, whichever is longer (the
    published peaks of ``utils/roofline.py``)."""
    from curriculum_learning_for_vln_torch.utils import roofline as R

    peak = {torch.bfloat16: R.H100_PEAK_BF16_FLOPS, torch.float32: R.H100_PEAK_F32_FLOPS}
    t_bytes = nbytes / R.H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak[dtype] * 1e3
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
    out[-1]["gemm_rates"] = k2_gemm_rates(out[-1]["device_split"], bounds["valid_steps"], D, H,
                                          dtype)
    for r in out[:2]:
        r["gemm_rates"] = gx_rates(r["device_split"], bounds["valid_steps"], D, H, dtype)
    return out


def gx_rates(split, steps, D, H, dtype):
    """{launch: {device ms, useful TFLOP/s, issued TFLOP/s}} of K3's or K1's
    input-side GEMM (gates_x: x . W_ih + b at the valid steps) from a
    call's device split: 2 steps D 4H products, each issued once (bf16
    ``gx_wgmma_kernel``; f32 ``gates_x_kernel`` counts a split-TF32 product
    once)."""
    name = "gx_wgmma_kernel" if dtype == torch.bfloat16 else "gates_x_kernel"
    ms = split.get(name, (None,))[0]
    rate = 2 * steps * D * 4 * H / ms / 1e9 if ms else None
    return {name: {"device_ms": ms, "useful_tflops": rate, "issued_tflops": rate}}


def k2_gemm_rates(split, steps, D, H, dtype):
    """{launch: {device ms, useful TFLOP/s, issued TFLOP/s}} of K2's two
    input-side GEMM launches, from a call's device split: useful, the
    products the function needs at the valid steps (d_xs 2 steps 4H D; dW
    2 steps 4H (D + H)); issued, those the launch runs on the tensor cores
    (bf16: three terms of da for d_xs and dW_ih, six term products for
    dW_hh; f32: each split-TF32 product counted once)."""
    useful = {"dx": 2 * steps * 4 * H * D, "dw": 2 * steps * 4 * H * (D + H)}
    if dtype == torch.bfloat16:
        names = {"dx": "dx_wgmma_kernel", "dw": "dw_wgmma_kernel"}
        issued = {"dx": 3 * useful["dx"], "dw": 2 * steps * 4 * H * (3 * D + 6 * H)}
    else:
        names = {"dx": "dx_gemm_kernel", "dw": "dw_gemm_kernel"}
        issued = useful
    rates = {}
    for k, name in names.items():
        ms = split.get(name, (None,))[0]
        rates[name] = {"device_ms": ms,
                       "useful_tflops": useful[k] / ms / 1e9 if ms else None,
                       "issued_tflops": issued[k] / ms / 1e9 if ms else None}
    return rates


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


def lstm_rescore_phase(device, gen, iters=20):
    """K3 at the beam's rescoring shapes (RESCORE_SHAPES, B = 30, L = 16,
    ragged lengths 1..16 with a 16), both directions against its plain
    version (outs, hT, cT within 1e-4 x max(1, |plain|)), and timed beside
    cuDNN's forward and the bound.  Returns {label: result}."""
    k = modules()["lstm_scan"]
    out = {}
    for label, (D, H, dtype) in RESCORE_SHAPES.items():
        lengths = torch.randint(1, RESCORE_L + 1, (RESCORE_B,), generator=gen, device=device)
        lengths[0] = RESCORE_L
        xs, w_ih, w_hh, b = lstm_inputs(dtype, device, gen, RESCORE_B, RESCORE_L, D, H)
        errs = []
        for reverse in (False, True):
            out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
            out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
            e = compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4)
            check(e[0] <= e[1], f"lstm_scan {dtype} D={D} H={H} at B = {RESCORE_B}, reverse="
                                f"{reverse}: |kernel - plain| {e[0]:.3g} > {e[1]:.3g}")
            errs.append(e)
        err = max(errs, key=lambda x: x[0] - x[1])  # the one nearest its tolerance
        t = kernel_times(lambda i: k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=bool(i & 1)),
                         iters)
        plain_ms = cuda_time_ms(lambda i: k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b), 3, 1)
        lib = lstm_library_infer(xs, lengths, w_ih, w_hh, b, iters)
        bounds = lstm_bounds(xs, lengths, w_ih, w_hh, b)
        b_ms, b_by = bounds["lstm_scan"]
        r = {"shape": {"B": RESCORE_B, "L": RESCORE_L, "D": D, "H": H}, "dtype": str(dtype),
             "lengths": lengths_label(lengths), "valid_steps": bounds["valid_steps"],
             "max_abs_err": err[0], "tol": err[1], **t, "plain_ms": plain_ms, **lib,
             "bound_ms": b_ms, "bound_by": b_by,
             "gemm_rates": gx_rates(t["device_split"], bounds["valid_steps"], D, H, dtype)}
        out[label] = r
        (gx_name, g), = r["gemm_rates"].items()
        log(f"lstm_scan        {str(dtype):14s} beam rescoring D={D} H={H} B={RESCORE_B} lengths "
            f"{r['lengths']}: max|kernel-plain| {err[0]:.3g} (tol {err[1]:.3g}) | "
            f"{times_label(r)}, bound {b_ms:.4f} ms ({b_by}) | device ms a call by kernel: "
            + ", ".join(f"{k} {ms:.4f} ({n:g}x)" for k, (ms, n) in t["device_split"].items())
            + f" | {gx_name} {fmt(g['useful_tflops'])} TFLOP/s useful")
    return out


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
        D, H = SPEAKER_LSTM_SHAPES["speaker_l1"]
        ragged = torch.randint(1, SPEAKER_T + 1, (BATCH,), generator=gen, device=device)
        ragged[0] = SPEAKER_T
        for r in lstm_phases(dtype, device, gen, ragged, D=D, H=H, L=SPEAKER_T):
            r["shape"] = {"D": D, "H": H}
            results[(r["name"], prec)]["speaker_shapes"][SPEAKER_RAGGED] = r
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
                for k, g in r.get("gemm_rates", {}).items():
                    if g["device_ms"]:
                        log(f"{'':16s} {prec:4s} {k}: {g['device_ms']:.4f} ms, "
                            f"{g['useful_tflops']:.1f} TFLOP/s useful, "
                            f"{g['issued_tflops']:.1f} issued on the tensor cores")
                for part, c in r["checks"].items():
                    check(c["max_abs_err"] <= c["tol"],
                          f"{name} {prec} {part} agrees with its plain version")
            for label, r in (("EnvDrop", base), *base["agent_shapes"].items(),
                             *base["speaker_shapes"].items()):
                if "ragged" not in r:  # SPEAKER_RAGGED: its lengths are ragged already
                    continue
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


KERNEL_WRAPPER = """\
import json, sys
import chip_smoke
results, rescore = chip_smoke.kernel_phases_here()
with open(sys.argv[1], "w") as f:
    json.dump({"results": {f"{n}/{p}": r for (n, p), r in results.items()}, "rescore": rescore}, f)
"""


def first_lengths(requests, tok, device):
    """The token lengths of the first micro-batch of requests."""
    return torch.tensor([tok.encode_sentence(r["instruction"])[1] for r in requests[:BATCH]],
                        device=device)


def kernel_phases_here():
    """``kernel_phases`` and ``lstm_rescore_phase`` in this process, at the
    serve world's first micro-batch's lengths, the libraries built."""
    from curriculum_learning_for_vln_torch.ops.cuda import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    world, _, requests, tok, *_ = build_serving()
    return (kernel_phases(world, first_lengths(requests, tok, device), device),
            lstm_rescore_phase(device, torch.Generator(device=device).manual_seed(SEED + 7)))


def kernel_phases_apart():
    """``kernel_phases_here`` in a process of its own, as ``--kernels-only``
    runs them, so that what the earlier phases leave in this process (the
    allocator's blocks, the profiler's sessions) does not enter their
    times.  Their log lines go to this process's output; returns
    (results, rescore shapes)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kernels.json")
        sys.stdout.flush()
        run = subprocess.run([sys.executable, "-c", KERNEL_WRAPPER, path], timeout=900)
        check(run.returncode == 0, f"the kernel phases' process: rc {run.returncode}")
        with open(path) as f:
            data = json.load(f)
    return {tuple(k.split("/")): r for k, r in data["results"].items()}, data["rescore"]


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
        il = args[9]  # il_len: the trainer passes it, then the mesh, by position
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
# Curriculum-and-data phase: Exp3.S, EVAL_TRAIN, R4R, the early exit, GloVe
# ---------------------------------------------------------------------------

def exp3s_reference(n, kw, losses):
    """Exp3.S (fixed-share exponential weights, the loss decrease of an
    arm as its reward, rescaled against the quantiles of the recent
    rewards) recomputed in numpy over one epoch's losses: (the arms drawn,
    log_w after the epoch's rewards)."""
    rng = np.random.default_rng(kw["seed"])
    log_w, window, last, arms = np.zeros(n), [], {}, []

    def pi():
        w = np.exp(log_w - log_w.max())
        return (1.0 - kw["eps"]) * w / w.sum() + kw["eps"] / n

    for _ in losses:
        arms.append(int(rng.choice(n, p=pi())))
    for arm, loss in zip(arms, losses):
        if arm in last:
            r = last[arm] - loss
            window = (window + [r])[-max(2, kw["rrsize"]):]
            lo, hi = np.quantile(window, kw["beta"]), np.quantile(window, 1.0 - kw["beta"])
            r = 0.0 if hi <= lo else float(np.clip(2.0 * (r - lo) / (hi - lo) - 1.0, -1.0, 1.0))
            p = pi()
            v = log_w.copy()
            v[arm] += kw["eta"] * (r / max(p[arm], 1e-8))
            ew = np.exp(v - v.max())
            mixed = (1.0 - kw["alpha"]) * ew + kw["alpha"] / max(n - 1, 1) * (ew.sum() - ew)
            log_w = v.max() + np.log(np.maximum(mixed, 1e-300))
        last[arm] = loss
    return arms, log_w


def kernel_vs_plain(what, grads_fn, tol=1e-2, names=None):
    """``grads_fn()`` -> (loss, gradient leaves) through the kernels and
    through their plain versions: the loss within 1e-4 of its scale, each
    leaf within ``tol`` of its largest plain element (``names``: the
    leaves' key paths, to name the worst).  Returns (loss err, worst
    relative leaf err, the kernel run's launches)."""
    reset_launch_counts()
    loss_k, g_k = grads_fn()
    counts = launch_counts()
    with plain_kernels():
        loss_p, g_p = grads_fn()
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= 1e-4 * max(1.0, abs(loss_p)), f"{what}: loss kernels {loss_k} plain {loss_p}")
    worst, worst_at = 0.0, ""
    for i, (gk, gp) in enumerate(zip(g_k, g_p, strict=True)):
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        if i == 0 or e / sc > worst:
            worst = e / sc
            worst_at = (f" ({'.'.join(map(str, names[i]))}: {e:.3g} of max {sc:.3g})"
                        if names else "")
        check(e <= tol * sc, f"{what}: a gradient leaf of shape {tuple(gk.shape)}: "
                             f"|kernel - plain| {e:.3g} > {tol * sc:.3g}")
    log(f"{what}: loss kernels {loss_k:.6f} plain {loss_p:.6f} (|diff| {loss_err:.3g}); worst "
        f"gradient leaf |kernel - plain| / max|plain| {worst:.3g}{worst_at} (tol {tol}) over "
        f"{len(g_k)} leaves; launches {counts}")
    return loss_err, worst, counts


def iteration_launches(t_il, T):
    """One EnvDrop iteration's launches: the encoder's 2 directions (K1, K2)
    in the IL and the A2C rollouts, K4 and K6 a step of each and one more
    for the bootstrap step, K5 and K7 a step of each."""
    return launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=t_il + T + 1,
                       cand_score=t_il + T + 1, pano_attend_bwd=t_il + T, cand_score_bwd=t_il + T)


@contextmanager
def checked_calls():
    """Hold every call of K3, K4 and K6 against its plain version on the
    same inputs, as the calls are made (the tolerances of the kernel
    phases: 1e-4 of each output's scale, K4's candidate rows exact).
    Yields {name: [(max |kernel - plain|, tol), ...]}."""
    mods = modules()
    where = {"lstm_scan": "lstm_scan", "pano_attend": "pano_fused", "cand_score": "cand_score"}
    saved = {n: getattr(mods[m], n) for n, m in where.items()}
    calls = {n: [] for n in where}

    def flat(out):  # the output tensors, nested tuples opened
        if not isinstance(out, tuple):
            return [out]
        return [t for x in out for t in flat(x)]

    def wrap(name, fn):
        def call(*args, **kwargs):
            got = fn(*args, **kwargs)
            want = getattr(mods[where[name]], name + "_plain")(*args, **kwargs)
            g, w = flat(got), flat(want)
            if name == "pano_attend":  # (visual, alpha, candidate rows)
                check(torch.equal(g[2], w[2]), "K4's candidate rows are exact copies")
                g, w = g[:2], w[:2]
            calls[name].append(compare(g, w, 1e-4))
            return got

        return call

    for name, fn in saved.items():
        setattr(mods[where[name]], name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(mods[where[name]], name, fn)


MAIN_WRAPPER = """\
import json, sys
import chip_smoke
from curriculum_learning_for_vln_torch import main
main.main(*main.parse_args(sys.argv[1:]))
print("launches " + json.dumps(chip_smoke.launch_counts()))
"""


def start_main(args, d):
    """``main`` with ``args`` in a process of its own, as a user runs it,
    logging under ``d``, started; ``finish_main`` collects it."""
    cmd = [sys.executable, "-c", MAIN_WRAPPER, "--seed", str(SEED), *map(str, args),
           "TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", SYN_SCANS,
           "TPU.SYNTHETIC_NODES", SYN_NODES, "OUTPUT.LOG_DIR", d, "OUTPUT.TSBOARD_DIR", "",
           "OUTPUT.CKPT_DIR", os.path.join(d, "ckpt")]
    return subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_main(what, proc, d):
    """(launches, the log's trainer and epoch lines, the log) of a started
    ``main``."""
    text_out = proc.communicate(timeout=600)[0]
    text = "".join(open(f).read() for f in glob.glob(os.path.join(d, "*.log")))
    counts = [json.loads(ln.split(" ", 1)[1]) for ln in text_out.splitlines()
              if ln.startswith("launches ")]
    check(proc.returncode == 0 and "Training finished" in text and len(counts) == 1,
          f"main {what}: rc {proc.returncode}\n{text_out[-4000:]}")
    lines = [ln.split(": ", 1)[-1] for ln in text.splitlines() if "Epoch [" in ln or "Using" in ln]
    return counts[0], lines, text


def run_main(what, args, d):
    """``main`` with ``args`` in a process of its own, as a user runs it,
    logging under ``d``; (its launches, its log's lines, seconds)."""
    t0 = time.perf_counter()
    counts, lines, _ = finish_main(what, start_main(args, d), d)
    return counts, lines, time.perf_counter() - t0


def curriculum_data_phase(device, card):
    """Slice 9 on the pipeline's synthetic world at EnvDrop's full width,
    bf16, B = 64, T = 35: (a) AUTO on ``envdrop_cl_config.yaml`` (PACKED_RL
    3 as shipped, which AUTO turns off): one iteration through the kernels
    against the plain versions, then one epoch of the trainer with exact
    launches, its arms and log_w against a numpy recomputation; (b)
    EVAL_TRAIN: each round's train split scored in that epoch (K3), and
    one batch of 128 with each K3, K4 and K6 call against its plain
    version; (c) R4R with the path teacher: one iteration kernels vs
    plain; (d) the early exit on and off from the same seed: the same
    loss and gradients, the generator left in the same state, K4 / K6
    launches and times of each; (e) the Follower with a frozen GloVe table
    written as .npy: kernels vs plain, one Adam step, the table unchanged;
    (f) ``main`` with AUTO and the early exit, with R4R and the path
    teacher, and with the Follower's GloVe table."""
    import logging

    from curriculum_learning_for_vln_torch import main as main_mod
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.convert import params_from_jax
    from curriculum_learning_for_vln_torch.engine import auto_curriculum, loop
    from curriculum_learning_for_vln_torch.engine import trainer as trainer_mod
    from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn, packed_factor
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    def config(path, *opts):
        c = get_cfg_defaults()
        c.merge_from_file(path)
        c.merge_from_list(["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", SYN_SCANS,
                           "TPU.SYNTHETIC_NODES", SYN_NODES, *opts])
        return c

    cfg = config(CL_CONFIG, "TRAIN.CLMODE", "AUTO")
    T, prec = cfg.AGENT.MAX_EPISODE_LEN, cfg.TPU.PRECISION
    tok = pipeline.build_tokenizer(cfg)
    world, arms_env, valid, feat_dim = pipeline.build_environments(cfg, tok, seed=SEED,
                                                                   device=device)
    check(feat_dim == FEAT_DIM and isinstance(arms_env, dict) and len(arms_env) == 5,
          f"AUTO's arms on a {feat_dim}-d world: {sorted(arms_env)}")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    params0, _ = init_agent(agent, torch.Generator().manual_seed(SEED))
    tables = world.device_tables(prec, device)
    il_bucket = il_bucket_fn(cfg, agent)
    out, tmp = {}, tempfile.mkdtemp(prefix="chip_smoke_data_")
    launches = {}
    log(f"curriculum-data: {SYN_SCANS} x {SYN_NODES} synthetic world ({world.num_nodes} nodes x "
        f"36 views x {feat_dim}), rounds {[e.size() for e in arms_env.values()]} episodes, "
        f"{prec}, T = {T}")

    def fresh():
        return tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)

    def envdrop_grads(agent_, tables_, params, batch, il_len, seed=SEED + 7):
        leaves = tree.tree_leaves(params)

        def run():
            gen = torch.Generator(device=device).manual_seed(seed)
            total, _ = loop.iteration_loss(agent_, "sample", tables_, params, batch, gen,
                                           il_len=il_len)
            for p in leaves:
                p.grad = None
            total.backward()
            loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
            run.gen_state = gen.get_state()
            return total.item(), [p.grad.clone() for p in leaves]

        return run

    # (a) AUTO: the arms are the individual rounds (pipeline.build_environments);
    # then the same iteration in f32, where the kernels' summation order
    # alone sets the difference (a bf16 gradient leaf is one bf16 rounding
    # of the compute copy's gradient: an ulp there is up to 2^-7 of its max)
    batch = arms_env["round_3"].next_batch()
    il_len = il_bucket(arms_env["round_3"])
    params = fresh()
    names = leaf_paths(params)
    _, out["auto_vs_plain"], counts = kernel_vs_plain(
        f"curriculum-data (a): one AUTO iteration (round_3, {prec})",
        envdrop_grads(agent, tables, params, batch, il_len), names=names)
    check(counts == iteration_launches(il_len or T, T), f"AUTO iteration launches {counts}")
    c32 = cfg.clone()
    c32.merge_from_list(["TPU.PRECISION", "f32"])
    _, out["auto_vs_plain_f32"], _ = kernel_vs_plain(
        "curriculum-data (a): the same iteration in f32",
        envdrop_grads(build_agent(c32, tok.vocab_size(), feat_dim, vocab=tok.vocab),
                      world.device_tables("f32", device), fresh(), batch, il_len), names=names)
    del params
    # TRAIN.EVAL_TRAIN's envs as main.eval_train_envs builds them, over the arms' items
    eval_env = {k: R2RBatchEnv(world, e.data, 2 * BATCH, tok, SEED + 100 + int(k[-1]), "train",
                               device=device) for k, e in arms_env.items()}

    c = cfg.clone()
    c.merge_from_list(["TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", AUTO_ITERS,
                       "TRAIN.EVAL_INTERVAL", 1, "TRAIN.EVAL_TRAIN", True,
                       "OUTPUT.CKPT_DIR", tmp, "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", ""])
    trainer = main_mod.build_trainer(c, arms_env, logging.getLogger("chip_smoke"), seed=SEED)
    check(isinstance(trainer, auto_curriculum.AutoCurriculum), f"AUTO builds {type(trainer)}")
    check(packed_factor(c, agent, trainer) == 0, "AUTO turns packed RL off")
    record, epoch_losses = {}, trainer.on_epoch_losses

    def recording(losses):
        record["drawn"], record["losses"] = list(trainer._arms), list(losses)
        epoch_losses(losses)

    trainer.on_epoch_losses = recording
    per_iter, evals, summaries, times = [], {}, [], []
    one_iter, run_eval, prettyprint = (trainer_mod.one_iter, trainer_mod.run_eval,
                                       trainer_mod.prettyprint)

    def counted_iter(*args, **kwargs):
        before = launch_counts()
        t0 = time.perf_counter()
        logs = one_iter(*args, **kwargs)
        float(logs["loss"])  # a sync: the iteration has finished
        times.append(time.perf_counter() - t0)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in KERNELS}
        t_il = kwargs.get("il_len") or T
        check(got == iteration_launches(t_il, T), f"AUTO trainer iteration launches {got} "
                                                  f"(T_il {t_il})")
        per_iter.append((t_il, got))
        return logs

    def counted_eval(agent_, params_, tables_, env, *args):
        before = launch_counts()
        results = run_eval(agent_, params_, tables_, env, *args)
        after = launch_counts()
        key = next((k for k, e in eval_env.items() if e is env), env.name)
        evals[key] = {k: after[k] - before[k] for k in KERNELS}
        return results

    trainer_mod.one_iter, trainer_mod.run_eval = counted_iter, counted_eval
    trainer_mod.prettyprint = summaries.append
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        params, _ = trainer.train(c, agent, "", arms_env, valid, seed=SEED, device=device,
                                  eval_train=True, eval_train_env=eval_env)
        total_s = time.perf_counter() - t0
        launches["auto"] = launch_counts()
    finally:
        trainer_mod.one_iter, trainer_mod.run_eval = one_iter, run_eval
        trainer_mod.prettyprint = prettyprint
    keys = sorted(arms_env)
    drawn, losses = record["drawn"], record["losses"]
    ref_arms, ref_log_w = exp3s_reference(len(keys), trainer._cfg, losses)
    log_w_err = float(np.abs(trainer.bandit.log_w - ref_log_w).max())
    check(len(losses) == AUTO_ITERS and drawn == ref_arms, f"AUTO arms {drawn} vs numpy {ref_arms}")
    check(log_w_err <= 1e-12 and bool(np.any(ref_log_w != 0)),
          f"AUTO log_w {trainer.bandit.log_w} vs numpy {ref_log_w}")
    check(all(np.isfinite(losses)), f"finite AUTO losses {losses}")
    med = statistics.median(times[1:])
    out["auto"] = {"arms": [keys[a] for a in drawn], "losses": losses,
                   "log_w": trainer.bandit.log_w.tolist(), "log_w_err": log_w_err,
                   "ms": [t * 1e3 for t in times], "median_ms": med * 1e3,
                   "per_iteration": per_iter, "epoch_s": total_s}
    log(f"curriculum-data (a): AUTO, {AUTO_ITERS} iterations of one epoch: arms "
        f"{out['auto']['arms']}; losses {[round(x, 4) for x in losses]}; log_w "
        f"{[round(float(x), 6) for x in trainer.bandit.log_w]} (numpy recomputation: the same "
        f"arms, |log_w - numpy| {log_w_err:.3g}); ms per iteration median {med * 1e3:.2f} (all "
        f"{[round(t * 1e3, 2) for t in times]}); launches per iteration exact "
        f"{[(t_il, g['lstm_scan_train'], g['pano_attend']) for t_il, g in per_iter]} "
        f"(T_il, K1, K4) | {card}")

    # (b) EVAL_TRAIN in that epoch: every round scored, before the validation splits
    check(len(summaries) == 2 and list(summaries[0]) == keys
          and list(summaries[1]) == list(valid), f"EVAL_TRAIN summaries {summaries}")
    for k, env in eval_env.items():
        n = -(-env.size() // env.batch_size)  # eval batches
        want = launches_of(lstm_scan=2 * n, pano_attend=T * n, cand_score=T * n)
        check(evals.get(k) == want, f"EVAL_TRAIN {k} launches {evals.get(k)}, expected {want}")
        check(all(np.isfinite(summaries[0][k][mk]) for mk in ("success_rate", "spl")),
              f"EVAL_TRAIN {k} scores")
    launches["eval_train"] = {k: sum(evals[r][k] for r in keys) for k in KERNELS}
    out["eval_train"] = {r: {mk: summaries[0][r][mk] for mk in ("success_rate", "spl", "ndtw")}
                         for r in keys}
    scored = {r: (eval_env[r].size(), round(summaries[0][r]["success_rate"], 4),
                  round(summaries[0][r]["spl"], 4)) for r in keys}
    # one batch of 128 again, the trained parameters: each call against its plain version
    ep = next(iter(eval_env["round_1"].eval_batches()))
    check(ep.instr_tokens.shape[0] == 2 * BATCH, f"an EVAL_TRAIN batch of {2 * BATCH}")
    with checked_calls() as calls:
        res_k = loop.build_eval_rollout(agent)(tables, params, ep)
    with plain_kernels():
        res_p = loop.build_eval_rollout(agent)(tables, params, ep)
    b128 = {}
    for name, errs in calls.items():
        e, tol = max(errs, key=lambda x: x[0] - x[1])
        check(all(x <= t for x, t in errs), f"EVAL_TRAIN B = {2 * BATCH}: {name} |kernel - "
                                            f"plain| {e:.3g} > {tol:.3g} ({len(errs)} calls)")
        b128[name] = {"calls": len(errs), "max_abs_err": e, "tol": tol}
    check(b128["lstm_scan"]["calls"] == 2 and b128["pano_attend"]["calls"] == T
          and b128["cand_score"]["calls"] == T, f"EVAL_TRAIN B = {2 * BATCH} calls {b128}")
    same = int((res_k.steps.action == res_p.steps.action).all(0).sum())
    out["eval_train_b128"] = dict(b128, same_actions=same)
    log(f"curriculum-data (b): EVAL_TRAIN, each round's train split at B = {2 * BATCH}: "
        f"{scored} (episodes, SR, SPL); launches exact, in all {launches['eval_train']}; one "
        f"batch of {2 * BATCH} again, each call against its plain version on its inputs: "
        + ", ".join(f"{n} {v['calls']} calls, worst |kernel - plain| {v['max_abs_err']:.3g} "
                    f"(tol {v['tol']:.3g})" for n, v in b128.items())
        + f"; the whole rollout under the plain versions: the same actions in {same} of "
        f"{2 * BATCH} episodes")

    # (c) R4R with the path teacher: the pipeline's R4R branch, one iteration kernels vs plain
    rcfg = config(CONFIG, "DATA.NAME", "R4R", "AGENT.TEACHER", "path")
    rworld, r4r_env, _, _ = pipeline.build_environments(rcfg, tok, seed=SEED, device=device)
    ragent = build_agent(rcfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    rtables = rworld.device_tables(rcfg.TPU.PRECISION, device)
    batch = r4r_env.next_batch()
    il_len = il_bucket_fn(rcfg, ragent)(r4r_env)
    P = r4r_env.path_local.shape[1]
    check(r4r_env.teacher_mode == "path" and P > 2 and bool((batch.path_len > 2).all()),
          f"R4R waypoints: P = {P}")
    _, _, launches["r4r"] = kernel_vs_plain(
        f"curriculum-data (c): one R4R iteration, path teacher ({r4r_env.size()} episodes, "
        f"P = {P}, max hops {r4r_env.cur_batch_max_hops}, il_len {il_len})",
        envdrop_grads(ragent, rtables, fresh(), batch, il_len), names=names)
    check(launches["r4r"] == iteration_launches(il_len or T, T),
          f"R4R iteration launches {launches['r4r']}")
    del rtables

    # (d) the early exit, on and off, from the same seed, as the config sets it
    def early_exit(on):
        e = cfg.clone()
        e.merge_from_list(["TPU.SCAN_EARLY_EXIT", on])
        loop.configure_runtime(e)

    env = arms_env["round_5"]
    batch = env.next_batch()
    out["early_exit"] = {}
    for label, il in (("il_bucket", il_bucket(env)), ("il_full", None)):
        fn = envdrop_grads(agent, tables, fresh(), batch, il)
        runs, ms = {}, {False: [], True: []}
        try:
            for on in (False, True):
                early_exit(on)
                reset_launch_counts()
                loss, grads = fn()
                runs[on] = (loss, grads, launch_counts(), fn.gen_state)
                fn()  # warm
            for _ in range(EXIT_ROUNDS):  # in turns, so that drift falls on both
                for on in (False, True, True, False):
                    early_exit(on)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms[on].append((time.perf_counter() - t0) * 1e3)
            for on in (False, True):
                early_exit(on)
                runs[on] += profile(fn)[:2]
        finally:
            early_exit(False)
        (l0, g0, c0, s0, w0, b0), (l1, g1, c1, s1, w1, b1) = runs[False], runs[True]
        ms0, ms1 = statistics.median(ms[False]), statistics.median(ms[True])
        check(torch.equal(s0, s1), f"early exit {label}: the generator ends elsewhere")
        check(abs(l1 - l0) <= 1e-4 * max(1.0, abs(l0)), f"early exit {label}: loss {l1} vs {l0}")
        worst = 0.0
        for a, b in zip(g1, g0, strict=True):
            sc = max(float(b.abs().max()), 1e-6)
            e = float((a - b).abs().max())
            worst = max(worst, e / sc)
            check(e <= 1e-2 * sc, f"early exit {label}: a gradient leaf |on - off| {e:.3g}")
        check(c0 == iteration_launches(il or T, T) and c1["pano_attend"] <= c0["pano_attend"],
              f"early exit {label}: launches off {c0}, on {c1}")
        launches[f"early_exit_{label}_on"], launches[f"early_exit_{label}_off"] = c1, c0
        out["early_exit"][label] = {
            "il_len": il, "loss": [l0, l1], "grad_rel_err": worst,
            "K4_K6": {"off": [c0["pano_attend"], c0["cand_score"]],
                      "on": [c1["pano_attend"], c1["cand_score"]]},
            "wall_ms": {"off": ms[False], "on": ms[True]},
            "wall_ms_median": {"off": ms0, "on": ms1}, "device_busy_ms": {"off": b0, "on": b1},
            "profiled_wall_ms": {"off": w0, "on": w1}}
        log(f"curriculum-data (d): early exit, {label} (il_len {il}): loss off {l0:.6f} on "
            f"{l1:.6f}, worst gradient leaf |on - off| / max|off| {worst:.3g} (tol 1e-2), the "
            f"generator's state equal; K4 / K6 off {c0['pano_attend']} / {c0['cand_score']}, on "
            f"{c1['pano_attend']} / {c1['cand_score']} (K5 off {c0['pano_attend_bwd']}, on "
            f"{c1['pano_attend_bwd']}); wall ms an iteration, {2 * EXIT_ROUNDS} each in turns "
            f"(off, on, on, off): median off {ms0:.2f} on {ms1:.2f} (off "
            f"{[round(x, 2) for x in ms[False]]}, on {[round(x, 2) for x in ms[True]]}); device "
            f"busy ms off {b0:.2f} on {b1:.2f} | {card}")

    # (e) the Follower with a frozen GloVe table
    fcfg = agent_cfg(AGENT_CONFIGS["FOLLOWER"][0])
    dim = fcfg.MODEL.FOLLOWER.WORD_EMB_SIZE
    table = np.random.default_rng(SEED + 3).normal(0, 0.3, (tok.vocab_size(), dim))
    glove = os.path.join(tmp, "glove.npy")
    np.save(glove, table.astype(np.float32))
    fcfg.merge_from_list(["MODEL.FOLLOWER.GLOVE_PATH", glove])
    fagent = build_agent(fcfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    fparams0, fstate = init_agent(fagent, torch.Generator().manual_seed(SEED))
    fparams = tree.tree_map(lambda t: t.to(device).requires_grad_(True), fparams0)
    emb = fparams["encoder"]["embedding"]["w"]
    frozen = emb.detach().clone()
    check(torch.equal(frozen.cpu(), torch.from_numpy(table.astype(np.float32))),
          "the Follower's embedding is the GloVe table")
    fenv = R2RBatchEnv(world, arms_env["round_5"].data, BATCH, tok, SEED, device=device)
    fbatch = fenv.next_batch()
    zero = ZERO_GRAD["FOLLOWER"]
    fleaves = [(p, leaf) for p, leaf in zip(leaf_paths(fparams), tree.tree_leaves(fparams))
               if p not in zero and p != ("encoder", "embedding", "w")]

    def follower_grads():
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        total, _, _ = loop.agent_iteration_loss(fagent, fcfg.AGENT.FEEDBACK, tables, fparams,
                                                fstate, fbatch, gen)
        for p in tree.tree_leaves(fparams):
            p.grad = None
        total.backward()
        check(emb.grad is None, "no gradient reaches the GloVe table")
        return total.item(), [torch.zeros_like(leaf) if leaf.grad is None else leaf.grad.clone()
                              for _, leaf in fleaves]

    _, _, counts = kernel_vs_plain(f"curriculum-data (e): a Follower iteration with frozen GloVe "
                                   f"({tok.vocab_size()} x {dim})", follower_grads,
                                   names=[p for p, _ in fleaves])
    check(counts == agent_launches("FOLLOWER", False), f"GloVe Follower launches {counts}")
    optimizer = loop.make_optimizer(fcfg.TRAIN.OPTIM, fcfg.TRAIN.LR, fparams)
    before = [leaf.detach().clone() for _, leaf in fleaves]
    reset_launch_counts()
    logs, _ = loop.agent_one_iter(fagent, optimizer, fcfg.AGENT.FEEDBACK, tables, fparams, fstate,
                                  fbatch, torch.Generator(device=device).manual_seed(SEED + 1))
    launches["glove"] = launch_counts()
    check(launches["glove"] == agent_launches("FOLLOWER", False),
          f"GloVe Follower step launches {launches['glove']}")
    check(torch.equal(emb.detach(), frozen), "the GloVe table moved in an optimizer step")
    moved = sum(int(not torch.equal(b, leaf.detach())) for b, (_, leaf) in zip(before, fleaves))
    check(moved == len(fleaves), f"{moved} of {len(fleaves)} trained leaves moved")
    out["glove"] = {"loss": float(logs["loss"]), "optimizer": fcfg.TRAIN.OPTIM,
                    "leaves_moved": moved}
    log(f"curriculum-data (e): one {fcfg.TRAIN.OPTIM} step: loss {float(logs['loss']):.6f}, the "
        f"table unchanged bit for bit, {moved}/{len(fleaves)} trained leaves moved; launches "
        f"exact {launches['glove']}")

    # (f) main, as a user runs it, in processes of their own
    small = ("TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", MAIN_ITERS, "TRAIN.EVAL_INTERVAL", 2)
    runs = {
        "auto": (f"--config-file {CL_CONFIG} TRAIN.CLMODE AUTO TPU.SCAN_EARLY_EXIT True",
                 "Using AutoCurriculum (Exp3.S) trainer"),
        "r4r": (f"--config-file {CONFIG} DATA.NAME R4R AGENT.TEACHER path", "Using Classic trainer"),
        "glove": (f"--config-file {AGENT_CONFIGS['FOLLOWER'][0]} DATA.NAME R4R AGENT.TEACHER path "
                  f"MODEL.FOLLOWER.GLOVE_PATH {glove}", "Using Classic trainer"),
    }
    out["main"] = {}
    # the three run together, each in a process of its own
    t0 = time.perf_counter()
    procs = {what: start_main([*args.split(), *small], os.path.join(tmp, f"main_{what}"))
             for what, (args, _) in runs.items()}
    for what, (args, trainer_line) in runs.items():
        d = os.path.join(tmp, f"main_{what}")
        counts, lines, _ = finish_main(what, procs[what], d)
        secs = time.perf_counter() - t0
        iters = 2 * MAIN_ITERS  # K1 = K2 = 4 an iteration for either agent
        check(trainer_line in lines and sum("Epoch [" in ln for ln in lines) == 2,
              f"main {what}: log {lines}")
        check(counts["lstm_scan_train"] == counts["lstm_scan_bwd"] == 4 * iters
              and all(counts[k] > 0 for k in KERNELS if k not in OFF_PATH and
                      (what != "glove" or k not in ("cand_score", "cand_score_bwd"))),
              f"main {what}: launches {counts}")
        if what == "glove":  # the table, read back from the run's checkpoint, unchanged
            saved = params_from_jax(load_checkpoint(os.path.join(d, "ckpt", "latest.ckpt"))
                                    ["params"])["encoder"]["embedding"]["w"]
            check(torch.equal(torch.as_tensor(np.asarray(saved)),
                              torch.from_numpy(table.astype(np.float32))),
                  "main glove: the checkpoint's embedding is the GloVe table")
        launches[f"main_{what}"] = counts
        out["main"][what] = {"s": secs, "log": lines, "launches": counts}
        log(f"curriculum-data (f): main {args} (2 epochs of {MAIN_ITERS}; the three run "
            f"together, done {secs:.1f} s after their start): {' | '.join(lines)}; launches "
            f"{counts}")

    ran = {k for c in launches.values() for k in KERNELS if c.get(k, 0) > 0}
    missing = set(KERNELS) - set(OFF_PATH) - ran
    check(not missing, f"kernels not launched on this slice's paths: {missing}")
    out["launches"] = launches
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


def beam_phase(world, data, tok, cfg, m, params, device, card):
    """Beam search with speaker rescoring (``main --beam``) for EnvDrop at
    the full width of its config, TPU.PRECISION tables, the default
    ``AIDE.SPEAKER`` (RNN_DIM 512), seeded random weights, one batch of 64
    instructions, beam 30, max_iters 500: (a) the listener's encoder and
    one rescoring call through K3 against the plain versions, (b)
    ``beam_rollout`` timed (iterations, decode ms, host ms an iteration,
    rescoring ms) with exact launches, (c) the paths' checks, (d) ``main
    --beam 5`` on a synthetic 6 x 48 world."""

    from curriculum_learning_for_vln_torch.agents import beam as beam_mod
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.speaker import Speaker
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.models.encoder import encoder_apply
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    precision, T, s = cfg.TPU.PRECISION, cfg.AGENT.MAX_EPISODE_LEN, cfg.AIDE.SPEAKER
    dtype = PRECISIONS[precision]
    tables = world.device_tables(precision, device)
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=dtype)
    p = tree.tree_map(lambda t: t.to(device), params)
    speaker = Speaker(s, tok.vocab_size(), feat_dim=FEAT_DIM, episode_len=T, compute_dtype=dtype)
    spk_params, _ = speaker.init(torch.Generator().manual_seed(SEED + 1), device)
    items = expand_r2r_items(data, tok)
    env = R2RBatchEnv(world, items, BATCH, tok, seed=SEED, name="val_unseen", device=device)
    ep = next(env.eval_batches())
    out = {"precision": precision, "beam_size": BEAM_SIZE, "max_iters": BEAM_MAX_ITERS}
    log(f"beam: EnvDrop H={m.HIDDEN_SIZE} (decoding in f32 on {precision} tables), speaker "
        f"RNN_DIM {s.RNN_DIM} in {precision}, B={BATCH}, beam {BEAM_SIZE}, max_iters "
        f"{BEAM_MAX_ITERS}, speaker weight {cfg.TPU.BEAM_SPEAKER_WEIGHT}")

    # (a) the listener's encoder through K3 against the plain versions
    def encode():
        with torch.inference_mode():
            return encoder_apply(p["encoder"], ep.instr_tokens, ep.instr_len, False, m.DROP_RATE)

    reset_launch_counts()
    enc_k = encode()
    counts = launch_counts()
    check(counts == launches_of(lstm_scan=2), f"listener encoder launches {counts}")
    with plain_kernels():
        enc_p = encode()
    enc_err, enc_tol = compare(enc_k, enc_p, 1e-4)
    check(enc_err <= enc_tol, f"listener encoder |kernel - plain| {enc_err:.3g} > {enc_tol:.3g}")

    # (b) dijkstra + rescoring, each decode step and rescoring call timed
    search = beam_mod.BeamSearch(agent, world, tables, max_iters=BEAM_MAX_ITERS)
    rec = {"decode": [], "rescore": [], "first_rescore": None}
    make, rescore = beam_mod.make_beam_decoder, search.rescore

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args)
            torch.cuda.synchronize()
            rec[kind].append((time.perf_counter() - t0) * 1e3)
            if kind == "rescore" and rec["first_rescore"] is None:
                rec["first_rescore"] = args
            return r
        return run

    beam_mod.make_beam_decoder = lambda a, st: timed("decode", make(a, st))
    search.rescore = timed("rescore", rescore)
    try:
        # warm-up: a short search (the first launches of every op; its
        # truncation warning muted), then the timed one
        warm = beam_mod.BeamSearch(agent, world, tables, max_iters=3)
        warm.rescore = search.rescore
        beam_mod.logger.disabled = True
        try:
            warm.beam_rollout(p, {}, ep, items, speaker, spk_params, BEAM_SIZE)
        finally:
            beam_mod.logger.disabled = False
        for k in ("decode", "rescore"):
            rec[k].clear()
        rec["first_rescore"] = None
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = search.beam_rollout(p, {}, ep, items, speaker, spk_params, BEAM_SIZE)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
    finally:
        beam_mod.make_beam_decoder = make
    with_paths = sum(1 for r in results if r["paths"])
    want = launches_of(lstm_scan=2 + 4 * with_paths)  # listener 1 x 2 directions; speaker 2 x 2
    check(counts == want, f"beam launches {counts}, expected {want}")
    iters = search.iterations
    dec_ms, res_ms = sum(rec["decode"]), sum(rec["rescore"])
    check(len(rec["decode"]) == iters and len(rec["rescore"]) == with_paths,
          f"{len(rec['decode'])} decode steps in {iters} iterations, {len(rec['rescore'])} "
          f"rescoring calls for {with_paths} episodes")
    host_ms = (total_ms - dec_ms - res_ms) / iters

    # (a) one rescoring call (the first episode's paths) through K3 against plain
    args = rec["first_rescore"]
    reset_launch_counts()
    pw_k = rescore(*args)
    check(launch_counts() == launches_of(lstm_scan=4), "one rescoring call: K3 = 4")
    with plain_kernels():
        pw_p = rescore(*args)
    scale = float(np.abs(pw_p).max())
    res_err = float(np.abs(pw_k - pw_p).max())
    # f32 encoder states summed in another order, then bf16 weights downstream
    check(res_err <= 1e-3 * max(scale, 1.0), f"rescoring |kernel - plain| {res_err:.3g} of "
                                             f"scale {scale:.3g}")

    # (c) the paths
    n_paths, full = 0, 0
    for r in results:
        check(len(r["paths"]) >= 1, f"{r['instr_id']}: a finished path")
        full += int(len(r["paths"]) == BEAM_SIZE)
        for path in r["paths"]:
            n_paths += 1
            check("visual_feature" not in path and len(path["trajectory"]) == len(path["action"]) + 1,
                  "a rescored path")
            check(all(x <= 1e-6 for x in path["listener_scores"])
                  and bool(np.all(np.asarray(path["speaker_scores"]) <= 1e-6)),
                  "listener and speaker scores are log-probabilities")
        for a, b in zip(r["dijk_path"][:-1], r["dijk_path"][1:]):
            ga, gb = world.global_id(r["scan"], a), world.global_id(r["scan"], b)
            check(ga == gb or gb in world.cand_next[ga][world.cand_valid[ga]],
                  "dijk_path is a connected walk")
    out.update(iterations=iters, total_ms=total_ms, decode_ms=rec["decode"],
               decode_ms_median=statistics.median(rec["decode"]), host_ms_per_iteration=host_ms,
               rescore_ms=rec["rescore"], rescore_ms_median=statistics.median(rec["rescore"]),
               episodes_with_paths=with_paths, episodes_full_beam=full, paths=n_paths,
               launches=counts, encoder_err=(enc_err, enc_tol), rescore_err=res_err,
               rescore_scale=scale)
    log(f"beam (a): listener encoder |kernel - plain| {enc_err:.3g} (tol {enc_tol:.3g}); one "
        f"rescoring call ({len(args[2])} paths, T = {args[4]}) |kernel - plain| {res_err:.3g} "
        f"of scale {scale:.3g} (tol 1e-3 of it)")
    log(f"beam (b): beam_rollout of {BATCH} episodes in {total_ms:.2f} ms: {iters} iterations, "
        f"decode step median {out['decode_ms_median']:.3f} ms ({dec_ms:.2f} in all), host "
        f"{host_ms:.3f} ms an iteration, rescoring median {out['rescore_ms_median']:.2f} ms an "
        f"episode ({res_ms:.2f} in all); launches exact {counts} | {card}")
    log(f"beam (c): {with_paths} of {BATCH} episodes with paths, {full} with the full beam of "
        f"{BEAM_SIZE}, {n_paths} paths; scores are log-probabilities; dijk paths connected")

    # (d) main --beam 5 on a synthetic world
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--beam", "5",
               "--seed", str(SEED), "--config-file", CONFIG, "TPU.SYNTHETIC_WORLD", "True",
               "TPU.SYNTHETIC_SCANS", "6", "TPU.SYNTHETIC_NODES", "48", "OUTPUT.LOG_DIR", d,
               "OUTPUT.TSBOARD_DIR", "", "OUTPUT.CKPT_DIR", os.path.join(d, "ckpt"),
               "OUTPUT.RESULT_DIR", os.path.join(d, "results")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        main_s = time.perf_counter() - t0
        files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(d, "results", "*")))
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("beam(5)")]
    check(run.returncode == 0 and len(lines) == 2 and len(files) == 4,
          f"main --beam 5: rc {run.returncode}, {lines}, {files}\n{run.stdout[-2000:]}\n"
          f"{run.stderr[-4000:]}")
    out["main"] = {"s": main_s, "lines": lines, "files": files}
    log(f"beam (d): main --beam 5 (synthetic 6 x 48, val_seen and val_unseen) in {main_s:.1f} s: "
        + " | ".join(lines))
    return out


def vilbert_phase(world, data, tok, device, card):
    """The ViLBERT scorer at ``VilBertConfig``'s default widths (hidden 768,
    12 text and 3 vision layers, bi 1024 with 16 heads) with the shipped
    vocabulary and 2048-d features, seeded random weights: (a)
    ``score_paths`` on the card against the same parameters on the CPU in
    f32, (b) timed pretraining steps (B = 32) and the scoring of 1,000
    items, each with its device-busy share, (c) the loss falls over 20
    steps, (d) ``build_clr2r`` (the JAX script's small config) writes five
    rounds.  No kernel of the port runs on this path."""
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine.pretrain import (VLNBertPretrainer,
                                                                   pretrain_arrays,
                                                                   pretrain_batches,
                                                                   score_difficulty)
    from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig
    from curriculum_learning_for_vln_torch.utils import tree

    cfg = VilBertConfig(vocab_size=tok.vocab_size(), v_feature_size=FEAT_DIM)
    items = expand_r2r_items(data, tok)
    trainer = VLNBertPretrainer(cfg, mask_idx=1)
    reset_launch_counts()
    params, opt = trainer.init(torch.Generator().manual_seed(SEED), device)
    n_params = sum(t.numel() for t in tree.tree_leaves(params))
    out = {"parameters": n_params, "config": cfg.to_dict()}
    log(f"vilbert: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} text + "
        f"{cfg.v_num_hidden_layers} vision layers, bi {cfg.bi_hidden_size} x "
        f"{cfg.bi_num_attention_heads} heads, vocab {cfg.vocab_size}, features "
        f"{cfg.v_feature_size}, {n_params} parameters (f32, Adam)")

    # (a) score_paths on the card against the CPU, same parameters, f32
    scorer = VLNBertScorer(cfg)
    toks, feats, locs, rmask, _ = pretrain_arrays(world, items[:8], tok, VIL_PATH, FEAT_DIM)
    am = (toks != 0).astype(np.float32)
    host = [torch.from_numpy(a) for a in (toks, feats, locs, am, rmask)]
    s_gpu = scorer.score_paths(params, *(t.to(device) for t in host)).float().cpu()
    s_cpu = scorer.score_paths(tree.tree_map(lambda t: t.detach().cpu(), params), *host)
    scale = float(s_cpu.abs().max())
    err = float((s_gpu - s_cpu).abs().max())
    # f32 products summed in another order over 15 layers; TF32 is off
    check(err <= 1e-3 * scale, f"score_paths card vs CPU |diff| {err:.3g} of scale {scale:.3g}")
    out["score_check"] = {"err": err, "scale": scale}
    log(f"vilbert (a): score_paths of 8 items on the card vs the CPU (f32): |diff| {err:.3g} of "
        f"scale {scale:.3g} (tol 1e-3 of it)")

    # (b) + (c) pretraining steps, each timed; the loss falls over them
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    uniform = torch.full((world.features.shape[0], cfg.v_target_size), 1.0 / cfg.v_target_size,
                         device=device)  # no region labels: the region loss is inert
    batches = pretrain_batches(world, items, tok, VIL_BATCH, VIL_PATH, FEAT_DIM,
                               node_targets=uniform, epochs=2, seed=SEED, device=device)
    trainer.step(params, opt, next(batches), gen)  # warm-up
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(VIL_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        logs = trainer.step(params, opt, batch, gen)
        losses.append(float(logs["loss"]))  # a sync
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(tail < head, f"the pretraining loss falls: first five {head:.4f}, last five {tail:.4f}")
    batch = next(batches)
    wall, busy, rows = profile(lambda: trainer.step(params, opt, batch, gen))
    out["train"] = {"ms": times, "median_ms": statistics.median(times), "losses": losses,
                    "busy": (wall, busy)}
    log(f"vilbert (b, c): {VIL_STEPS} pretraining steps at B={VIL_BATCH}, ms a step median "
        f"{out['train']['median_ms']:.2f} (min {min(times):.2f}, max {max(times):.2f}); device "
        f"busy {100 * busy / wall:.1f}% under the profiler; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (mean of the first five {head:.4f}, of the last five {tail:.4f}) "
        f"| {card}")
    print_profile("one ViLBERT pretraining step", wall, busy, rows)

    # (b) scoring 1,000 items (their inputs built on the host, then 32 a batch)
    many = (items * (VIL_ITEMS // len(items) + 1))[:VIL_ITEMS]
    score_difficulty(scorer, params, world, many[:64], tok, VIL_PATH, FEAT_DIM)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = score_difficulty(scorer, params, world, many, tok, VIL_PATH, FEAT_DIM)
    score_s = time.perf_counter() - t0
    check(scores.shape == (VIL_ITEMS,) and bool(np.isfinite(scores).all()), "finite scores")
    s_wall, s_busy, s_rows = profile(
        lambda: score_difficulty(scorer, params, world, many, tok, VIL_PATH, FEAT_DIM))
    out["score"] = {"items": VIL_ITEMS, "s": score_s, "items_per_s": VIL_ITEMS / score_s,
                    "busy": (s_wall, s_busy)}
    log(f"vilbert (b): score_difficulty of {VIL_ITEMS} items in {score_s * 1e3:.1f} ms, "
        f"{VIL_ITEMS / score_s:.1f} items/s; device busy {100 * s_busy / s_wall:.1f}% under the "
        f"profiler | {card}")
    print_profile(f"score_difficulty of {VIL_ITEMS} items", s_wall, s_busy, s_rows)
    counts = launch_counts()
    check(counts == launches_of(), f"no kernel of the port on the ViLBERT path: {counts}")
    out["launches"] = counts
    del params, opt
    torch.cuda.empty_cache()

    # (d) the CLR2R construction end to end
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r",
                              "--out", d], capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        rounds = sorted(f for f in os.listdir(d) if f.endswith("_v3.json"))
    check(run.returncode == 0 and len(rounds) == 5,
          f"build_clr2r: rc {run.returncode}, {rounds}\n{run.stderr[-4000:]}")
    last = json.loads(run.stdout.strip().splitlines()[-1])
    out["build_clr2r"] = {"s": build_s, "last": last}
    log(f"vilbert (d): build_clr2r (120 steps of the small config) in {build_s:.1f} s: {last}")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Data-parallel phase
# ---------------------------------------------------------------------------

def dp_rank(rank, tmp, card, device_type):
    """One rank of the DP phase: joins the process group (gloo: the ranks
    share the card), runs ``dp_work`` and saves its results for the
    parent."""
    import torch.distributed as dist

    from curriculum_learning_for_vln_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False  # the one-process references run in full f32
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share this host's one card: their place among its ranks
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(DP_RANKS))
    device = M.init_process_group(f"file://{tmp}/store", DP_RANKS, rank, device=device_type,
                                  timeout_s=900)
    check(dist.get_backend() == "gloo", f"{DP_RANKS} ranks on one card take gloo")
    try:
        out = dp_work(rank, device, card)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@contextmanager
def split_batchnorm():
    """The BN-MLP's training BatchNorm with its batch sums taken over
    DP_RANKS equal row blocks and added, in one process: the ranks' order
    of summation without the ranks."""
    from curriculum_learning_for_vln_torch.models import attention, core

    def batchnorm(params, state, x, train, momentum=0.1, eps=1e-5):
        if not train:
            return core.batchnorm(params, state, x, train, momentum, eps)
        n, blocks = x.shape[0], x.chunk(DP_RANKS)
        mean = sum(b.sum(dim=0) for b in blocks) / n
        var = sum(((b - mean) ** 2).sum(dim=0) for b in blocks) / n
        new = {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
               "var": (1 - momentum) * state["var"] + momentum * var.detach() * n / (n - 1),
               "count": state["count"] + 1}
        return (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"], new

    saved, attention.batchnorm = attention.batchnorm, batchnorm
    try:
        yield
    finally:
        attention.batchnorm = saved


# Self-Monitor leaves whose gradient is set by rounding, not by the data:
# the ZERO_GRAD pair, and the bias of each BN-MLP hidden layer, whose
# BatchNorm sees B identical rows at t = 0 (a_prev starts at zeros): zero
# variance, so its ReLU input is the rounding of the batch mean times
# 1 / sqrt(eps), which any other order of summation (the ranks') flips
DP_ROUNDING = ZERO_GRAD["SELF-MONITOR"] | {
    ("decoder", "proj_navigable_mlp", "bn_layers", i, "bias") for i in range(4)}


def dp_compare(what, got, want, tol, names, elementwise=False):
    """(loss, leaves) of the ranks against one process's: the loss within
    ``tol`` of its scale, each leaf's |ranks - one| within ``tol`` of
    |one| in the L2 norm (``elementwise``: also each element within ``tol``
    of the leaf's largest), but the DP_ROUNDING leaves, printed only.
    Returns the worst relative leaf errors (L2, elementwise)."""
    (loss_n, g_n), (loss_1, g_1) = got, want
    check(abs(loss_n - loss_1) <= tol * max(1.0, abs(loss_1)),
          f"{what}: loss {loss_n} at {DP_RANKS} ranks, {loss_1} in one process")
    worst, worst_el, at, skipped = 0.0, 0.0, "", []
    for name, a, b in zip(names, g_n, g_1, strict=True):
        el = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        l2 = float((a - b).norm()) / max(float(b.norm()), 1e-12)
        if name in DP_ROUNDING:
            skipped.append(f"{'.'.join(map(str, name))} {l2:.3g}")
            continue
        if l2 >= worst:
            worst, at = l2, ".".join(map(str, name))
        worst_el = max(worst_el, el)
        check(l2 <= tol and (el <= tol or not elementwise),
              f"{what}: leaf {name} of shape {tuple(a.shape)}: |ranks - one| / |one| {l2:.3g} "
              f"(L2), {el:.3g} (largest element) > {tol}")
    log(f"{what}: loss {loss_n:.6f} at {DP_RANKS} ranks, {loss_1:.6f} in one process; worst "
        f"leaf |ranks - one| / |one| {worst:.3g} in L2 ({at}), {worst_el:.3g} elementwise "
        f"(tol {tol}{' both' if elementwise else ' in L2'}) over {len(g_n)} leaves"
        + (f"; set by rounding, not held: {', '.join(skipped)}" if skipped else ""))
    return worst, worst_el


def dp_work(rank, device, card):
    """(a) the classic EnvDrop iteration in bf16 and f32, (b) the SPCL packed
    iteration, (c) the Self-Monitor iteration, each at DP_RANKS ranks
    against one process on the same parameters, batch and generator seed;
    timed iterations at N = 1 and N = 2; (e) ViLBERT scoring over model =
    DP_RANKS against replicated scoring."""
    import torch.distributed as dist

    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.pretrain import pretrain_arrays
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig, vlnbert_init
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.parallel import vilbert_sharding as S
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, params0 = build_serving()
    items = expand_r2r_items(data, tok)
    mesh = M.make_mesh()
    check(mesh.data == DP_RANKS and mesh.model == 1, f"mesh {mesh}")
    T, main = cfg.AGENT.MAX_EPISODE_LEN, rank == 0
    out = {"launches": {}, "ms": {}, "worst": {}, "vs_plain": {}}

    def env_of(seed):
        env = R2RBatchEnv(world, items, BATCH, tok, seed=seed, device=device)
        env.set_sharding(mesh)
        return env

    def step_grads(params, loss_fn, mesh_, clip):
        """loss_fn() inside the sharded step of mesh_, its gradients summed
        over the ranks and clipped as the iteration does; the global logs
        and the gradient leaves."""
        leaves = tree.tree_leaves(params)
        with M.sharded_step(mesh_):
            total, logs = loss_fn()
        total.backward()
        M.all_reduce_grads(params, mesh_)
        if clip:
            loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return (loop.reduce_logs({k: v.detach() for k, v in logs.items()}, mesh_),
                [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in leaves])

    def fresh(p0):  # a copy of p0's leaves, whatever the device
        return tree.tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), p0)

    def held(what, run, tol, names):
        """``run()`` -> (loss, gradient leaves, ...) on this rank's rows, in
        the sharded step, through the kernels and again under their plain
        versions: every launch of the DP path, at its shapes, held against
        the plain versions (the loss within 1e-4 of its scale, each leaf
        within ``tol`` of its largest plain element; the DP_ROUNDING
        leaves, set by rounding, printed only).  Returns (the kernel run,
        its launches, the worst leaf)."""
        reset_launch_counts()
        got = run()
        counts = launch_counts()
        with plain_kernels():
            want = run()
        (loss_k, g_k), (loss_p, g_p) = got[:2], want[:2]
        check(abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)),
              f"{what}: loss kernels {loss_k} plain {loss_p}")
        worst, at, skipped = 0.0, "", []
        for name, a, b in zip(names, g_k, g_p, strict=True):
            e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
            if name in DP_ROUNDING:
                skipped.append(f"{'.'.join(map(str, name))} {e:.3g}")
                continue
            if e >= worst:
                worst, at = e, ".".join(map(str, name))
            check(e <= tol, f"{what}: leaf {name}: |kernel - plain| / max|plain| {e:.3g} > {tol}")
        log(f"{what}, kernels against plain on the rank's rows: loss {loss_k:.6f} / {loss_p:.6f}; "
            f"worst leaf |kernel - plain| / max|plain| {worst:.3g} ({at}; tol {tol}) over "
            f"{len(g_k)} leaves" + (f"; set by rounding, not held: {', '.join(skipped)}"
                                    if skipped else ""))
        return got, counts, worst

    # (a) the classic iteration, bf16 and f32
    for precision in ("bf16", "f32"):
        agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                             compute_dtype=PRECISIONS[precision], obs_masks="prng")
        tables = world.device_tables(precision, device)
        env = env_of(SEED)
        local = env.next_batch()
        whole, il_len = env.cur_full_batch, il_bucket_fn(cfg, agent)(env)

        def classic(ep, mesh_):
            params = fresh(params0)
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            logs, g = step_grads(params, lambda: loop.iteration_loss(
                agent, "sample", tables, params, ep, gen, il_len=il_len), mesh_, True)
            return float(logs["loss"]), g

        # one bf16 ulp is up to 2^-7 of a leaf's largest element; f32 differs
        # by the kernels' order of summation alone
        got, counts, out["vs_plain"][f"classic_{precision}"] = held(
            f"dp (a) rank {rank} classic {precision}", lambda: classic(local, mesh),
            1e-2 if precision == "bf16" else 1e-3, leaf_paths(params0))
        t_il = il_len or T
        check(counts == iteration_launches(t_il, T),
              f"rank {rank} classic {precision} launches {counts}, expected "
              f"{iteration_launches(t_il, T)}")
        out["launches"][f"classic_{precision}"] = counts
        if main:
            out["worst"][f"classic_{precision}"] = dp_compare(
                f"dp (a) classic EnvDrop iteration {precision}, B={BATCH} ({BATCH // DP_RANKS} a "
                f"rank), T={T}, T_il={t_il}, prng", got, classic(whole, None),
                1e-2 if precision == "bf16" else 1e-4, leaf_paths(params0),
                elementwise=precision == "f32")
        log(f"dp (a) rank {rank} {precision}: launches {counts} (exact)")
        dist.barrier()

        if precision != cfg.TPU.PRECISION:
            continue
        # timed iterations: one process (rank 0 alone), then every rank
        for n in (1, DP_RANKS):
            if n == 1 and not main:
                dist.barrier()
                continue
            params = fresh(params0)
            opt = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
            gen = torch.Generator(device=device).manual_seed(SEED + 1)
            env = env_of(SEED + 1)
            times = []
            for i in range(DP_ITERS + 1):
                b = env.next_batch()
                il = il_bucket_fn(cfg, agent)(env)
                reset_launch_counts()
                t0 = time.perf_counter()
                logs = loop.one_iter(agent, opt, "sample", tables, params,
                                     b if n > 1 else env.cur_full_batch, gen, il_len=il,
                                     mesh=mesh if n > 1 else None)
                float(logs["loss"])  # a sync: the iteration has finished
                torch.cuda.synchronize()
                if i:  # after one warm-up
                    times.append((time.perf_counter() - t0) * 1e3)
                    check(launch_counts() == iteration_launches(il or T, T),
                          f"rank {rank} N={n} launches {launch_counts()}")
            out["ms"][f"N={n}"] = times
            log(f"dp (a) rank {rank}, N = {n}: ms an iteration {[round(t, 2) for t in times]}, "
                f"median {statistics.median(times):.2f}; launches exact an iteration | {card}")
            if n == 1:
                dist.barrier()
        dist.barrier()

    # (b) the SPCL packed iteration, envdrop_cl_config.yaml as shipped, prng_shared
    cl = get_cfg_defaults()
    cl.merge_from_file(CL_CONFIG)
    check(cl.TPU.PACKED_RL == 3, "the CL config ships PACKED_RL 3")
    agent = EnvDropAgent(cl.MODEL.ENVDROP, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cl.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[cl.TPU.PRECISION],
                         obs_masks="prng_shared")
    tables = world.device_tables(cl.TPU.PRECISION, device)
    env = env_of(SEED + 3)
    local = env.next_batch()
    raws, idx, il_len = [env.cur_full_batch], [env.cur_batch_index], il_bucket_fn(cl, agent)(env)
    for _ in range(cl.TPU.PACKED_RL - 1):
        env.next_batch()
        raws.append(env.cur_full_batch)
        idx.append(env.cur_batch_index)
    pool = loop.concat_batches(raws)
    w = torch.rand(len(items), generator=torch.Generator().manual_seed(SEED)).to(device) + 0.5
    w_il = w[torch.from_numpy(idx[0]).to(device)]
    w_pool = w[torch.from_numpy(np.concatenate(idx)).to(device)]

    def packed(ep, mesh_):
        params = fresh(params0)
        gen = torch.Generator(device=device).manual_seed(SEED + 9)

        def loss():
            return loop.packed_iteration_loss(agent, tables, params, ep, pool, gen,
                                              M.local_rows(w_il), w_pool, il_len)

        logs, g = step_grads(params, loss, mesh_, True)
        return float(logs["loss"]), g, int(logs["episodes_started"]), int(logs["episodes_done"])

    got, out["launches"]["spcl_packed"], out["vs_plain"]["spcl_packed"] = held(
        f"dp (b) rank {rank} SPCL packed ({cl.TPU.PRECISION})", lambda: packed(local, mesh),
        1e-2 if cl.TPU.PRECISION == "bf16" else 1e-3, leaf_paths(params0))
    loss_n, g_n, started_n, done_n = got
    if main:
        loss_1, g_1, started_1, done_1 = packed(raws[0], None)
        check((started_n, done_n) == (started_1, done_1),
              f"packed episodes (started, done) {(started_n, done_n)} at {DP_RANKS} ranks, "
              f"{(started_1, done_1)} in one process")
        out["packed_episodes"] = (started_n, done_n)
        out["worst"]["spcl_packed"] = dp_compare(
            f"dp (b) SPCL packed iteration ({cl.TPU.PRECISION}, prng_shared, pool "
            f"{pool.valid.shape[0]}, {started_n} episodes started, {done_n} done in both)",
            (loss_n, g_n), (loss_1, g_1), 1e-2 if cl.TPU.PRECISION == "bf16" else 1e-4,
            leaf_paths(params0), elementwise=cl.TPU.PRECISION == "f32")
    log(f"dp (b) rank {rank}: launches {out['launches']['spcl_packed']}")
    dist.barrier()

    # (c) the Self-Monitor iteration in f32: loss, gradients, BN statistics
    mcfg = agent_cfg(AGENT_CONFIGS["SELF-MONITOR"][0], "TPU.PRECISION", "f32")
    agent = build_agent(mcfg, tok.vocab_size(), FEAT_DIM)
    p0, s0 = init_agent(agent, torch.Generator().manual_seed(SEED))
    tables = world.device_tables("f32", device)
    env = env_of(SEED + 5)
    local = env.next_batch()

    def monitor(ep, mesh_):
        params = fresh(p0)
        state = tree.tree_map(lambda t: t.to(device, copy=True), s0)
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        kept = {}

        def loss():
            total, logs, kept["state"] = loop.agent_iteration_loss(
                agent, "sample", tables, params, state, ep, gen,
                lamb=mcfg.TRAIN.PROGMONITOR_WEIGHT)
            return total, logs

        logs, g = step_grads(params, loss, mesh_, False)
        return float(logs["loss"]), g, tree.tree_leaves(kept["state"])

    # the BN-MLP's rsqrt(var + 1e-5) scales the kernels' rounding up: held
    # as the agents phase holds the Self-Monitor's kernels
    (loss_n, g_n, s_n), counts, out["vs_plain"]["monitor"] = held(
        f"dp (c) rank {rank} Self-Monitor (f32)", lambda: monitor(local, mesh), 1e-2,
        leaf_paths(p0))
    check(counts == agent_launches("SELF-MONITOR", False),
          f"rank {rank} Self-Monitor launches {counts}")
    out["launches"]["monitor"] = counts
    if main:
        loss_1, g_1, s_1 = monitor(env.cur_full_batch, None)
        # the rounding floor: one process again, its BatchNorm sums taken
        # over the ranks' halves of the rows and added, as the ranks do
        with split_batchnorm():
            loss_h, g_h, _ = monitor(env.cur_full_batch, None)
        names = leaf_paths(p0)
        floor = max(float((a - b).norm()) / max(float(b.norm()), 1e-12)
                    for n, a, b in zip(names, g_h, g_1) if n not in DP_ROUNDING)
        out["monitor_floor"] = floor
        log(f"dp (c): one process with its BN sums split over the ranks' rows against one "
            f"process: loss {loss_h:.6f}, worst leaf |split - one| / |one| {floor:.3g} in L2 "
            f"(the BatchNorm's rounding, which the ranks' sums change too)")
        # f32 through the BN-MLP's rsqrt(var + 1e-5): held at 1e-3 in L2
        out["worst"]["monitor"] = dp_compare(
            f"dp (c) Self-Monitor iteration (f32, sample feedback, T={AGENT_T})",
            (loss_n, g_n), (loss_1, g_1), 1e-3, names)
        bn = max(float(((a - b).abs() / (1.0 + b.abs())).max()) for a, b in zip(s_n, s_1))
        check(bn <= 1e-5, f"Self-Monitor BN running statistics |ranks - one| / (1 + |one|) {bn}")
        out["bn_err"] = bn
        log(f"dp (c): the BN running statistics ({len(s_n)} leaves) |ranks - one| / (1 + |one|) "
            f"{bn:.3g} (tol 1e-5)")
    dist.barrier()

    # (e) ViLBERT at VilBertConfig's defaults: score_paths over model = DP_RANKS
    vcfg = VilBertConfig(vocab_size=tok.vocab_size(), v_feature_size=FEAT_DIM)
    whole_p = tree.tree_map(lambda t: t.to(device),
                            vlnbert_init(torch.Generator().manual_seed(SEED), vcfg))
    tp_mesh = M.make_mesh(data=1, model=DP_RANKS)
    local_p = S.shard_vilbert_params(whole_p, tp_mesh)
    scorer = VLNBertScorer(vcfg)
    toks, feats, locs, rmask, _ = pretrain_arrays(world, items[:8], tok, VIL_PATH, FEAT_DIM)
    inputs = [torch.from_numpy(a).to(device)
              for a in (toks, feats, locs, (toks != 0).astype(np.float32), rmask)]
    tp = S.tensor_parallel(tp_mesh)
    s_tp = scorer.score_paths(local_p, *inputs, tp=tp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_tp = scorer.score_paths(local_p, *inputs, tp=tp)
    torch.cuda.synchronize()
    ms_tp = (time.perf_counter() - t0) * 1e3
    s_rep = scorer.score_paths(whole_p, *inputs)
    err, scale = float((s_tp - s_rep).abs().max()), float(s_rep.abs().max())
    check(err <= 1e-5, f"rank {rank}: TP score_paths |tp - replicated| {err:.3g}")
    out["vilbert"] = {"err": err, "scale": scale, "ms_tp": ms_tp,
                      "q_shape": tuple(local_p["bert"]["t_layers"][0]["attn"]["query"]["w"].shape)}
    log(f"dp (e) rank {rank}: ViLBERT score_paths of 8 items over model = {DP_RANKS}: |tp - "
        f"replicated| {err:.3g} (tol 1e-5) of scale {scale:.3g}; q slice "
        f"{out['vilbert']['q_shape']}; {ms_tp:.2f} ms a call (gloo all-reduces through the host)")
    dist.barrier()
    return out


def dp_main_runs(card, device_type):
    """(d) ``main`` as a user runs it (the Follower, f32, teacher feedback,
    SGD, one epoch of DP_MAIN_ITERS iterations): one process; DP_RANKS
    processes joined by the VLN_* variables (gloo: they share the card);
    and one process at world size 1 on NCCL.  Every process prints its
    launches; returns {run: (launches, events, log text)}.  With them,
    ``build_clr2r`` in one process and in DP_RANKS processes over a model
    axis of DP_RANKS: the same round sizes and final loss."""
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ports = (free_port(), free_port())
    runs = {"one": {}, "nccl_world1": {"VLN_COORDINATOR": f"127.0.0.1:{ports[0]}",
                                       "VLN_NUM_PROCESSES": "1", "VLN_PROCESS_ID": "0"}}
    for r in range(DP_RANKS):
        runs[f"rank{r}"] = {"VLN_COORDINATOR": f"127.0.0.1:{ports[1]}",
                            "VLN_NUM_PROCESSES": str(DP_RANKS), "VLN_PROCESS_ID": str(r),
                            "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(DP_RANKS)}
    root = tempfile.mkdtemp(prefix="dp_main_")
    procs = {}
    t0 = time.perf_counter()
    # build_clr2r, the scorer's entry point: one process, and DP_RANKS
    # processes with --mesh-model DP_RANKS (its heads over the ranks), run
    # with the mains
    port = free_port()
    clr2r = {"clr2r_one": {}}
    for r in range(DP_RANKS):
        clr2r[f"clr2r_tp{r}"] = {"VLN_COORDINATOR": f"127.0.0.1:{port}",
                                 "VLN_NUM_PROCESSES": str(DP_RANKS), "VLN_PROCESS_ID": str(r),
                                 "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(DP_RANKS)}
    for name, env in clr2r.items():
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r", "--device",
               device_type, "--out", os.path.join(root, name), "--steps", DP_CLR2R_STEPS,
               "--mesh-model", 1 if name == "clr2r_one" else DP_RANKS]
        procs[name] = subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True,
                                       env=dict(os.environ, **env))
    for name, env in runs.items():
        d = os.path.join(root, name)
        cmd = [sys.executable, "-c", MAIN_WRAPPER, "--device", device_type, "--seed", str(SEED),
               "--config-file",
               AGENT_CONFIGS["FOLLOWER"][0], "TPU.PRECISION", "f32", "AGENT.FEEDBACK", "teacher",
               "TRAIN.OPTIM", "sgd", "TRAIN.LR", "0.01", "TRAIN.MAX_EPOCH", "1",
               "TRAIN.ITER_PER_EPOCH", DP_MAIN_ITERS, "TRAIN.EVAL_INTERVAL", "1",
               "TRAIN.BATCH_SIZE", BATCH, "TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS",
               SYN_SCANS, "TPU.SYNTHETIC_NODES", SYN_NODES, "OUTPUT.LOG_DIR", d,
               "OUTPUT.TSBOARD_DIR", os.path.join(d, "tb"), "OUTPUT.CKPT_DIR",
               os.path.join(d, "ckpt")]
        procs[name] = subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True,
                                       env=dict(os.environ, **env))
    for name in clr2r:
        p = procs.pop(name)
        text_out = p.communicate(timeout=600)[0]
        check(p.returncode == 0, f"build_clr2r {name}: rc {p.returncode}\n{text_out[-4000:]}")
        clr2r[name] = [json.loads(ln) for ln in text_out.splitlines() if ln.startswith("{")]
    c_one, c_tp = clr2r["clr2r_one"][-1], clr2r["clr2r_tp0"][-1]
    check(not any(clr2r[f"clr2r_tp{r}"] for r in range(1, DP_RANKS)), "rank 0 alone prints")
    check(c_tp["rounds"] == c_one["rounds"] and abs(c_tp["final_loss"] - c_one["final_loss"])
          <= 1e-4 * max(1.0, c_one["final_loss"]),
          f"build_clr2r over model = {DP_RANKS}: {c_tp}, one process: {c_one}")
    moved = 0
    for k in range(1, 6):
        paths = [{it["path_id"] for it in
                  json.load(open(os.path.join(root, name, f"R2R_round_{k}_v3.json")))}
                 for name in ("clr2r_one", "clr2r_tp0")]
        moved += len(paths[0] - paths[1])
    log(f"dp (d) build_clr2r in {DP_RANKS} processes, --mesh-model {DP_RANKS}: {c_tp} (one "
        f"process: {c_one}); {moved} paths in another round than one process's (the "
        f"pretraining and the scores summed in another order)")
    res = {}
    for name, p in procs.items():
        text_out = p.communicate(timeout=600)[0]
        d = os.path.join(root, name)
        text = "".join(open(f).read() for f in glob.glob(os.path.join(d, "*.log")))
        counts = [json.loads(ln.split(" ", 1)[1]) for ln in text_out.splitlines()
                  if ln.startswith("launches ")]
        check(p.returncode == 0 and "Training finished" in text and len(counts) == 1,
              f"main {name}: rc {p.returncode}\n{text_out[-4000:]}")
        events = {}
        for f in glob.glob(os.path.join(d, "tb", "*", "events.jsonl")):
            for ln in open(f):
                e = json.loads(ln)
                if "value" in e and not e["tag"].startswith("perf/"):  # not the timings
                    events[e["tag"], e["step"]] = e["value"]
        res[name] = (counts[0], events, text)
    secs = time.perf_counter() - t0
    one = res["one"][1]
    check(("train/ml_epoch", 1) in one, "the one-process run logged its epoch loss")
    for name in ("rank0", "nccl_world1"):
        got = res[name][1]
        check(set(got) == set(one), f"main {name}: the scalars {sorted(set(got) ^ set(one))}")
        worst = max(abs(got[k] - one[k]) / (1.0 + abs(one[k])) for k in one)
        check(worst <= 1e-4, f"main {name}: scalars within 1e-4 of one process's: worst {worst}")
        log(f"dp (d) main {name}: {len(one)} scalars, worst |{name} - one| / (1 + |one|) "
            f"{worst:.3g} (tol 1e-4); epoch loss {got['train/ml_epoch', 1]:.6f} against "
            f"{one['train/ml_epoch', 1]:.6f}")
    check("Device mesh: data=2 model=1" in res["rank0"][2]
          and "backend gloo (ranks share a GPU)" in res["rank0"][2], "rank 0's mesh and backend")
    check("backend nccl (every rank owns its GPU)" in res["nccl_world1"][2]
          and "Device mesh: data=1 model=1" in res["nccl_world1"][2], "NCCL at world size 1")
    ckpts = {name: os.path.exists(os.path.join(root, name, "ckpt", "latest.ckpt")) for name in res}
    check(ckpts["rank0"] and not any(ckpts[f"rank{r}"] for r in range(1, DP_RANKS)),
          f"rank 0 alone writes the checkpoint: {ckpts}")
    for name, (counts, _, _) in res.items():
        log(f"dp (d) main {name}: launches {counts}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"dp (d): {len(res)} main and {len(clr2r)} build_clr2r processes in {secs:.1f} s (run "
        f"together) | {card}")
    return {name: counts for name, (counts, _, _) in res.items()}, secs


def dp_phase(card, device_type="cuda"):
    """The data-parallel phase: DP_RANKS rank processes sharing the card run
    ``dp_work``; then ``main`` in DP_RANKS processes and at world size 1 on
    NCCL.  Returns the ranks' results and the mains' launches.  (Another
    ``device_type`` rehearses it there: the launch checks then fail.)"""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(dp_rank, args=(tmp, card, device_type), nprocs=DP_RANKS,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]
    secs_ranks = time.perf_counter() - t0
    mains, secs_main = dp_main_runs(card, device_type)
    ms1 = statistics.median(ranks[0]["ms"]["N=1"])
    msn = [statistics.median(r["ms"][f"N={DP_RANKS}"]) for r in ranks]
    log(f"dp: iteration ms at N = 1 {ms1:.2f}, at N = {DP_RANKS} (each rank, {BATCH // DP_RANKS} "
        f"rows) {', '.join(f'{x:.2f}' for x in msn)}: the ranks share one card and gloo "
        f"reduces through the host, so N = {DP_RANKS} is expected to be no faster here | {card}")
    log(f"dp: ranks {secs_ranks:.1f} s, main runs {secs_main:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "mains": mains, "secs": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Slice 11: the rollout BPTT, the native solver, the roofline, memory
# ---------------------------------------------------------------------------

def bptt_launches(t_il, T, on):
    """A classic iteration's launches with TPU.FUSED_BPTT ``on``: the
    encoder's K1 = K2 = 4 and, inside the BPTT rollouts, no observation
    kernel; the A2C tail's bootstrap step alone runs K4 and K6 once."""
    if on:
        return launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=1, cand_score=1)
    return iteration_launches(t_il, T)


def bptt_memory(agent, world, items, tok, tables, params, il_bucket, device, card):
    """Device memory of one classic iteration (its loss, then its
    backward) with TPU.FUSED_BPTT off and on, in OBS_MASKS prng and ext,
    at each batch of BPTT_MEM_BATCHES: the MiB still allocated once the
    loss is formed (autograd's saved residuals, or the BPTT's per-step
    records) and the peak through the backward, both above what was
    allocated before the iteration."""
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    leaves = tree.tree_leaves(params)
    rows = []
    for B in BPTT_MEM_BATCHES:
        env = R2RBatchEnv(world, items, B, tok, seed=SEED + 5, device=device)
        batch = env.next_batch()
        il_len = il_bucket(env)
        for mode in ("prng", "ext"):
            agent.obs_masks = mode
            got = {}
            for on in (False, True):
                agent.use_fused_bptt = on
                for p in leaves:
                    p.grad = None
                gen = torch.Generator(device=device).manual_seed(SEED + 7)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                total, logs = loop.iteration_loss(agent, "sample", tables, params, batch, gen,
                                                  il_len=il_len)
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated() - base
                total.backward()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                check(math.isfinite(total.item()) and all(bool(torch.isfinite(p.grad).all())
                                                          for p in leaves),
                      f"memory B {B} {mode} FUSED_BPTT {on}: finite loss and gradients")
                del total, logs
                got[on] = {"held_mib": held / 2 ** 20, "peak_mib": peak / 2 ** 20}
            rows.append({"B": B, "obs_masks": mode, "t_il": il_len or agent.episode_len,
                         "off": got[False], "on": got[True]})
            log(f"bptt (e) memory B {B} {mode}: held after the loss off {got[False]['held_mib']:.1f} "
                f"MiB, on {got[True]['held_mib']:.1f} MiB; peak through the backward off "
                f"{got[False]['peak_mib']:.1f} MiB, on {got[True]['peak_mib']:.1f} MiB | {card}")
    agent.obs_masks = "prng"
    for p in leaves:
        p.grad = None
    return rows


def bptt_phase(world, data, requests, tok, cfg, m, params0, device, card):
    """(a) A classic EnvDrop iteration (prng, B = 64, T = 35) with
    TPU.FUSED_BPTT on against off, bf16 and f32, from the same parameters,
    batch and generator seed: losses, every gradient leaf in L2, the
    generator's state, exact launches; then timed iterations in turns with
    each one's device-busy share.  (b) ``main`` with the flag, one short
    epoch.  (c) The native solver on the serve world against scipy's.  (d)
    The roofline of the iteration and of a serve call.  (e) The peak
    device memory of an iteration, flag off against on."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.utils import roofline as R
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world import compiler, native, synthetic
    from curriculum_learning_for_vln_torch.world.graph import shortest_paths
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    t_phase = time.perf_counter()
    T = cfg.AGENT.MAX_EPISODE_LEN
    out = {"launches": {}}
    items = expand_r2r_items(data, tok)

    # (a) the BPTT iteration against the fused one
    timed = {}
    for prec in (cfg.TPU.PRECISION, "f32"):
        agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                             compute_dtype=PRECISIONS[prec], obs_masks="prng")
        tables = world.device_tables(prec, device)
        env = R2RBatchEnv(world, items, BATCH, tok, seed=SEED + 3, device=device)
        il_bucket = il_bucket_fn(cfg, agent)
        batch = env.next_batch()
        il_len = il_bucket(env)
        t_il = il_len or T
        params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
        leaves = tree.tree_leaves(params)
        paths = leaf_paths(params)
        runs = {}
        for on in (False, True):
            agent.use_fused_bptt = on
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            for p in leaves:
                p.grad = None
            reset_launch_counts()
            total, logs = loop.iteration_loss(agent, "sample", tables, params, batch, gen,
                                              il_len=il_len)
            total.backward()
            torch.cuda.synchronize()
            runs[on] = (total.item(), logs["rl_loss"].item(), launch_counts(),
                        gen.get_state(), [p.grad.detach().clone() for p in leaves])
            want = bptt_launches(t_il, T, on)
            check(runs[on][2] == want, f"{prec} FUSED_BPTT {on}: launches {runs[on][2]}, "
                                       f"expected {want} (T_il {t_il})")
        (l0, r0, c0, s0, g0), (l1, r1, c1, s1, g1) = runs[False], runs[True]
        check(torch.equal(s0, s1), f"{prec}: the generator ends elsewhere with the BPTT")
        loss_rel = abs(l1 - l0) / max(abs(l0), 1e-6)
        check(loss_rel <= 1e-5, f"{prec}: loss BPTT {l1} vs fused {l0}")
        tol = 1e-4 if prec == "f32" else 1e-2
        worst, worst_at = 0.0, ""
        for path, a, b in zip(paths, g0, g1, strict=True):
            rel = float((b - a).float().norm()) / max(float(a.float().norm()), 1e-12)
            if rel >= worst:
                worst, worst_at = rel, ".".join(map(str, path))
            check(rel <= tol, f"{prec}: gradient {'.'.join(map(str, path))} BPTT vs fused "
                              f"{rel:.3g} in L2 > {tol}")
        log(f"bptt (a) {prec}: loss BPTT {l1:.6f} fused {l0:.6f} (relative {loss_rel:.3g}); rl "
            f"loss {r1:.6f} / {r0:.6f}; worst leaf |BPTT - fused| / |fused| in L2 {worst:.3g} "
            f"({worst_at}; tol {tol}) over {len(leaves)} leaves; generator equal; T_il {t_il}; "
            f"launches off {c0}, on {c1}")
        out[prec] = {"loss": [l0, l1], "loss_rel": loss_rel, "worst_leaf_l2": worst,
                     "worst_leaf": worst_at, "t_il": t_il}
        out["launches"][f"iteration_off_{prec}"] = c0
        out["launches"][f"iteration_on_{prec}"] = c1
        if prec != cfg.TPU.PRECISION:
            continue

        # timed iterations in turns (off, on, on, off), each a one_iter
        # update from its own copy of the parameters and generator
        state = {}
        for on in (False, True):
            p = tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
            state[on] = (p, loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, p),
                         torch.Generator(device=device).manual_seed(SEED + 1))

        def iterate(on):
            agent.use_fused_bptt = on
            p, opt, gen = state[on]
            b = env.next_batch()
            return loop.one_iter(agent, opt, "sample", tables, p, b, gen, il_len=il_bucket(env))

        for on in (False, True):  # warm-up
            iterate(on)
        torch.cuda.synchronize()
        ms = {False: [], True: []}
        for _ in range(BPTT_ROUNDS):
            for on in (False, True, True, False):
                t0 = time.perf_counter()
                logs = iterate(on)
                float(logs["loss"])
                torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t0) * 1e3)
        for on in (False, True):
            wall, busy, rows = profile(lambda: iterate(on))
            print_profile(f"one {prec} classic iteration, FUSED_BPTT {on}", wall, busy, rows)
            timed[on] = {"ms": ms[on], "median_ms": statistics.median(ms[on]),
                         "busy_pct": 100 * busy / wall, "wall_ms": wall, "busy_ms": busy}
        log(f"bptt (a) timed {prec}: FUSED_BPTT off {timed[False]['median_ms']:.2f} ms "
            f"(busy {timed[False]['busy_pct']:.1f}%), on {timed[True]['median_ms']:.2f} ms "
            f"(busy {timed[True]['busy_pct']:.1f}%) an iteration, medians of {2 * BPTT_ROUNDS} "
            f"in turns (off, on, on, off) | {card}")
        out["timed"] = {str(k): v for k, v in timed.items()}

        # the same in mode ext, whose masks are one draw each: the BPTT
        # regenerates prng masks with plain Philox, the kernels in place
        agent.obs_masks = "ext"
        for on in (False, True):  # warm-up
            iterate(on)
        ext = {False: [], True: []}
        for on in (False, True, True, False):
            t0 = time.perf_counter()
            float(iterate(on)["loss"])
            torch.cuda.synchronize()
            ext[on].append((time.perf_counter() - t0) * 1e3)
        agent.obs_masks = "prng"
        log(f"bptt (a) timed {prec}, OBS_MASKS ext: FUSED_BPTT off "
            f"{statistics.median(ext[False]):.2f} ms, on {statistics.median(ext[True]):.2f} ms "
            f"an iteration, medians of 2 in turns | {card}")
        out["timed_ext"] = {str(k): v for k, v in ext.items()}

        # (e) the peak memory of an iteration with the flag off and on
        out["memory"] = bptt_memory(agent, world, items, tok, tables, params, il_bucket,
                                    device, card)

    # (b) main with the flag, one short epoch on the 6 x 160 synthetic world
    d = tempfile.mkdtemp(prefix="chip_smoke_bptt_")
    counts, lines, secs = run_main("bptt", ["--config-file", CONFIG, "TPU.FUSED_BPTT", "True",
                                            "TPU.PACKED_RL", 0, "TRAIN.MAX_EPOCH", 1,
                                            "TRAIN.ITER_PER_EPOCH", BPTT_MAIN_ITERS,
                                            "TRAIN.EVAL_INTERVAL", 1], d)
    check("Using Classic trainer" in lines and sum("Epoch [" in ln for ln in lines) == 1,
          f"main bptt: log {lines}")
    check(counts["lstm_scan_train"] == counts["lstm_scan_bwd"] == 4 * BPTT_MAIN_ITERS
          and counts["pano_attend_bwd"] == counts["cand_score_bwd"] == 0
          and counts["pano_attend"] >= BPTT_MAIN_ITERS and counts["lstm_scan"] > 0,
          f"main bptt: launches {counts}")
    shutil.rmtree(d, ignore_errors=True)
    out["launches"]["main"] = counts
    out["main"] = {"s": secs, "log": lines}
    log(f"bptt (b): main TPU.FUSED_BPTT True ({BPTT_MAIN_ITERS} iterations and an evaluation) in "
        f"{secs:.1f} s: {' | '.join(lines)}; launches {counts}")

    # (c) the native solver: the serve world's tables against scipy's
    check(native.native_available(), "the native graph library builds on this machine")
    graphs = synthetic.make_world_graphs(NUM_SCANS, NODES_PER_SCAN, seed=SEED)
    t0 = time.perf_counter()
    w_native = compiler.compile_world(graphs, 16)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_scipy = compiler.compile_world(graphs, 16, use_native=False)
    t_scipy = time.perf_counter() - t0
    for name in ("cand_next", "cand_valid", "cand_heading", "cand_elev", "cand_view", "n_cands"):
        check(np.array_equal(getattr(w_native, name), getattr(w_scipy, name)), f"native {name}")
    check(np.array_equal(w_native.next_hop, world.next_hop)
          and np.array_equal(w_native.dist, world.dist), "the serve world was compiled natively")
    dist_err = float(np.abs(w_native.dist - w_scipy.dist).max())
    check(dist_err <= 1e-4, f"native distances within 1e-4 of scipy's: {dist_err}")
    ties = 0
    for s_i, scan in enumerate(w_native.scan_ids):
        g, off = graphs[scan], int(w_native.scan_offset[s_i])
        V = g.num_nodes
        nh = w_native.next_hop[off:off + V, :V] - off
        sd = shortest_paths(g)[0]
        for a, b in zip(*np.nonzero(nh != w_scipy.next_hop[off:off + V, :V] - off)):
            ties += 1
            hop = nh[a, b]
            check(abs(sd[a, b] - np.linalg.norm(g.pos[a] - g.pos[hop]) - sd[hop, b]) <= 1e-3,
                  f"native next hop {a}->{b} via {hop} is on a shortest path")
    log(f"bptt (c): native solver available; serve world {world.num_nodes} nodes compiled "
        f"natively in {t_native:.2f} s (scipy {t_scipy:.2f} s, host); tables equal but distances "
        f"(max |native - scipy| {dist_err:.3g}) and {ties} next hops at equal-cost ties")
    out["native"] = {"dist_err": dist_err, "tie_next_hops": ties, "native_s": t_native,
                     "scipy_s": t_scipy}

    # (d) the roofline of the timed iteration and of a serve call
    prec = cfg.TPU.PRECISION
    wb = 2 if prec == "bf16" else 4
    shapes = R.EnvDropShapes(B=BATCH, T=T, L=tok.encoding_length, D=FEAT_DIM,
                             H=m.HIDDEN_SIZE, K=world.cand_next.shape[1] + 1,
                             emb=m.WORD_EMB_SIZE, act=m.ACT_EMB_SIZE, wb=wb, fb=wb)
    it = R.train_iter_cost(shapes, il_T=out[prec]["t_il"])
    roof = {}
    for on in (False, True):
        roof[f"iteration_bptt_{on}"] = R.roofline_summary(
            it["flops"], it["bytes"], timed[on]["median_ms"] / 1e3, "gpu")
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=PRECISIONS[prec])
    nav = Navigator(world, agent, params0, tok, max_batch=BATCH, precision=prec, device=device)
    nav.navigate_batch(requests[:BATCH])
    serve_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nav.navigate_batch(requests[i * BATCH:(i + 1) * BATCH])
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    rc = R.rollout_cost(shapes)
    roof["serve_call"] = R.roofline_summary(rc.flops, rc.bytes,
                                            statistics.median(serve_ms) / 1e3, "gpu")
    for what, r in roof.items():
        log(f"bptt (d) roofline {what}: {json.dumps(r)} | {card}")
    out["roofline"] = roof

    out["secs"] = time.perf_counter() - t_phase
    log(f"bptt: phase 14 in {out['secs']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Slice-12 phase: the plain route, the asynchronous checkpoints, write_results
# ---------------------------------------------------------------------------

def set_route(cfg, use_pallas: bool) -> None:
    """The route of the process, through ``loop.configure_runtime`` as the
    trainers set it, from ``cfg`` with TPU.USE_PALLAS ``use_pallas``."""
    from curriculum_learning_for_vln_torch.engine import loop

    c = cfg.clone()
    c.merge_from_list(["TPU.USE_PALLAS", use_pallas])
    loop.configure_runtime(c)


def turns(fn, rounds: int):
    """{True: ms, False: ms} of ``fn(on)`` timed in turns (kernels, plain,
    plain, kernels) ``rounds`` times, each call to a synchronize."""
    ms = {True: [], False: []}
    for _ in range(rounds):
        for on in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(on)
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) * 1e3)
    return ms


def route_compare(what, prec, loss_fn, leaves, paths, zero_paths=(), want=None):
    """``loss_fn()`` -> (loss, model-state leaves) with its backward, on the
    kernel route and on the plain one from the same inputs: the loss within
    1e-5 relative in f32 (1e-3 in bf16: the plain route contracts the
    attention in bf16, as the JAX package's XLA route does, where the
    kernels accumulate in f32), every gradient leaf within 1e-4 (f32) or
    1e-2 (bf16) of its own L2 norm, the leaves whose true gradient is 0
    (``zero_paths``) within 1e-3 (f32) or 1e-2 (bf16: a few bf16 ulps) of
    the largest element, the model state within 1e-3; the plain run
    launches nothing, the kernel run ``want``.
    Returns its readings."""
    runs = {}
    for on in (True, False):
        for p in leaves:
            p.grad = None
        reset_launch_counts()
        loss, state = loss_fn(on)
        loss.backward()
        torch.cuda.synchronize()
        runs[on] = (loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                  for p in leaves], [s.clone() for s in state], launch_counts())
    for p in leaves:
        p.grad = None
    (lk, gk, sk, ck), (lp, gp, sp, cp) = runs[True], runs[False]
    check(cp == dict.fromkeys(KERNELS, 0), f"{what} {prec}: the plain route launched {cp}")
    check(want is None or ck == want, f"{what} {prec}: kernel route launches {ck}, expected {want}")
    loss_rel = abs(lk - lp) / max(abs(lk), 1e-6)
    loss_tol = 1e-5 if prec == "f32" else 1e-3
    check(loss_rel <= loss_tol, f"{what} {prec}: loss kernels {lk} plain {lp} ({loss_rel:.3g})")
    tol = 1e-4 if prec == "f32" else 1e-2
    top = max(float(g.abs().max()) for g in gk)
    zero_tol = 1e-3 if prec == "f32" else 1e-2
    worst, worst_at, zero_worst = 0.0, "", 0.0
    for path, a, b in zip(paths, gk, gp, strict=True):
        if path in zero_paths:
            e = max(float(a.abs().max()), float(b.abs().max()))
            zero_worst = max(zero_worst, e / top)
            check(e <= zero_tol * top, f"{what} {prec}: the gradient of {'.'.join(map(str, path))} "
                                   f"{e:.3g} is not 0 against the largest, {top:.3g}")
            continue
        rel = float((b - a).float().norm()) / max(float(a.float().norm()), 1e-12)
        if rel >= worst:
            worst, worst_at = rel, ".".join(map(str, path))
        check(rel <= tol, f"{what} {prec}: gradient {'.'.join(map(str, path))} plain vs kernels "
                          f"{rel:.3g} in L2 > {tol}")
    state_err = 0.0
    for a, b in zip(sk, sp, strict=True):
        state_err = max(state_err, float((a - b).abs().max()) / max(float(a.abs().max()), 1.0))
    check(state_err <= 1e-3, f"{what} {prec}: model state |plain - kernels| {state_err:.3g}")
    log(f"slice12 (b) {what} {prec}: loss kernels {lk:.6f} plain {lp:.6f} (relative "
        f"{loss_rel:.3g}, tol {loss_tol}); worst leaf |plain - kernels| / |kernels| in L2 "
        f"{worst:.3g} ({worst_at}; tol {tol}) over {len(leaves) - len(zero_paths)} leaves"
        + (f", {len(zero_paths)} more 0 up to {zero_worst:.3g} of the largest" if zero_paths
           else "") + (f"; model state {state_err:.3g}" if sk else "")
        + f"; launches kernels {ck}, plain 0")
    return {"loss": [lk, lp], "loss_rel": loss_rel, "worst_leaf_l2": worst,
            "worst_leaf": worst_at, "state_err": state_err, "launches_kernels": ck}


def slice12_serve(world, requests, tok, m, params0, device, card, T):
    """(a) EnvDrop's Navigator on the plain route against the default one,
    f32 and bf16, on the same parameters and requests."""
    from curriculum_learning_for_vln_torch import ops
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    out, launches = {}, {}
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    per_call = launches_of(lstm_scan=2, pano_attend=T, cand_score=T)
    for prec in ("f32", "bf16"):
        agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                             compute_dtype=PRECISIONS[prec])
        navs = {on: Navigator(world, agent, params0, tok, max_batch=BATCH, precision=prec,
                              device=device, use_pallas=None if on else False)
                for on in (True, False)}
        for nav in navs.values():  # first calls: kernels loaded, allocator warm
            nav.navigate_batch(batches[0])
        # f32: the serve phase's tolerance; bf16: the plain route's attention
        # contracted in bf16, as JAX's is, against the kernels' f32 sums
        # (2.29e-3 on the H100 in its first run)
        tol = 1e-4 if prec == "f32" else 1e-2
        worst, ties, moves = 0.0, 0, 0
        for reqs in batches:
            ep = navs[True].episodes(reqs)
            res, counts = {}, {}
            for on in (True, False):
                reset_launch_counts()
                res[on] = navs[on].rollout(ep)
                torch.cuda.synchronize()
                counts[on] = launch_counts()
            check(counts[True] == per_call, f"serve {prec} kernels: launches {counts[True]}")
            check(counts[False] == dict.fromkeys(KERNELS, 0),
                  f"serve {prec} plain: launches {counts[False]}")
            l_k, l_p = res[True].steps.logits[0].float(), res[False].steps.logits[0].float()
            live = l_k > -1e29
            check(bool(torch.equal(live, l_p > -1e29)), "the same candidate slots are masked")
            scale = max(float(l_k[live].abs().max()), 1.0)
            rel = float((l_k - l_p)[live].abs().max()) / scale
            check(rel <= tol, f"serve {prec}: first-step logits |plain - kernels| / scale "
                              f"{rel:.3g}")
            worst = max(worst, rel)
            ties_b = compare_actions(res[True], res[False], tol * scale)
            ties += ties_b
            if ties_b == 0:
                outs = {on: navs[on].navigate_batch(reqs) for on in (True, False)}
                check(outs[True] == outs[False], f"serve {prec}: the same trajectories")
                moves += sum(len(o["trajectory"]) - 1 for o in outs[True])
        log(f"slice12 (a) serve {prec}: {len(batches)} micro-batches of {BATCH}, first-step logits "
            f"|plain - kernels| / scale at most {worst:.3g} (tol {tol}); samples cut short by a "
            f"tie {ties}; trajectories equal elsewhere ({moves} moves); launches a call kernels "
            f"{per_call}, plain 0")
        out[prec] = {"logit_rel_err": worst, "tol": tol, "ties": ties}
        if prec != "bf16":
            continue
        ms = turns(lambda on: navs[on].navigate_batch(batches[0]), S12_ROUNDS)
        for on in (True, False):
            wall, busy, rows = profile(lambda: navs[on].navigate_batch(batches[0]))
            print_profile(f"one bf16 serve call, USE_PALLAS {on}", wall, busy, rows)
            out[f"timed_{on}"] = {"ms": ms[on], "median_ms": statistics.median(ms[on]),
                                  "busy_pct": 100 * busy / wall, "wall_ms": wall,
                                  "busy_ms": busy}
        t_k, t_p = out["timed_True"], out["timed_False"]
        log(f"slice12 (a) timed bf16 serve call of {BATCH}: kernels {t_k['median_ms']:.2f} ms "
            f"(busy {t_k['busy_pct']:.1f}%), plain {t_p['median_ms']:.2f} ms (busy "
            f"{t_p['busy_pct']:.1f}%), medians of {2 * S12_ROUNDS} in turns (kernels, plain, "
            f"plain, kernels) | {card}")
    launches["serve_call_kernels"] = per_call
    launches["serve_call_plain"] = dict.fromkeys(KERNELS, 0)
    ops.set_kernels(True)
    return out, launches


def slice12_train(world, data, tok, cfg, m, params0, device, card):
    """(b) One classic EnvDrop iteration, then one Follower and one
    Self-Monitor iteration, on each route: kernels against plain at zero
    dropout with teacher feedback (f32 and bf16), then bf16 iterations with
    dropout on timed in turns."""
    from curriculum_learning_for_vln_torch import ops
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    T = cfg.AGENT.MAX_EPISODE_LEN
    items = expand_r2r_items(data, tok)
    out, launches = {}, {}
    m0 = m.clone()
    m0.DROP_RATE = m0.FEAT_DROP_RATE = 0.0
    for prec in ("f32", "bf16"):
        agent0 = EnvDropAgent(m0, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                              compute_dtype=PRECISIONS[prec])
        tables = world.device_tables(prec, device)
        env = R2RBatchEnv(world, items, BATCH, tok, seed=SEED + 4, device=device)
        il_bucket = il_bucket_fn(cfg, agent0)
        batch = env.next_batch()
        t_il = il_bucket(env) or T
        params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
        leaves = tree.tree_leaves(params)

        def loss_fn(on):
            set_route(cfg, on)
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            total, _ = loop.iteration_loss(agent0, "teacher", tables, params, batch, gen,
                                           il_len=t_il)
            return total, []

        want = launches_of(lstm_scan_train=2, lstm_scan_bwd=2, pano_attend=t_il,
                           cand_score=t_il, pano_attend_bwd=t_il, cand_score_bwd=t_il)
        out[f"envdrop_{prec}"] = route_compare("EnvDrop teacher iteration (IL)", prec, loss_fn,
                                               leaves, leaf_paths(params), want=want)
        launches[f"envdrop_teacher_kernels_{prec}"] = want
        launches[f"envdrop_teacher_plain_{prec}"] = dict.fromkeys(KERNELS, 0)
        if prec != "bf16":
            continue

        # timed classic iterations with dropout on (sample feedback, prng)
        agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                             compute_dtype=PRECISIONS[prec], obs_masks="prng")
        state = {}
        for on in (True, False):
            p = tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
            state[on] = (p, loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, p),
                         torch.Generator(device=device).manual_seed(SEED + 1))
        seen = {True: [], False: []}

        def iterate(on):
            set_route(cfg, on)
            p, opt, gen = state[on]
            b = env.next_batch()
            il = il_bucket(env) or T
            reset_launch_counts()
            logs = loop.one_iter(agent, opt, "sample", tables, p, b, gen, il_len=il)
            float(logs["loss"])
            seen[on].append((launch_counts(), il))
            return logs

        for on in (True, False):  # warm-up
            iterate(on)
        ms = turns(iterate, S12_ROUNDS)
        for on in (True, False):
            for counts, il in seen[on]:
                want = iteration_launches(il, T) if on else dict.fromkeys(KERNELS, 0)
                check(counts == want, f"timed EnvDrop {prec} USE_PALLAS {on}: launches {counts}, "
                                      f"expected {want} (T_il {il})")
        launches["envdrop_iteration_kernels"] = seen[True][-1][0]
        launches["envdrop_iteration_plain"] = dict.fromkeys(KERNELS, 0)
        out["envdrop_timed"] = timed_routes(f"one {prec} classic EnvDrop iteration", iterate, ms,
                                            card)
    for name, (config, _) in AGENT_CONFIGS.items():
        key = "FOLLOWER" if name == "FOLLOWER" else "MONITOR"
        cfg_a = agent_cfg(config)
        cfg_0 = agent_cfg(config, f"MODEL.{key}.DROP_RATE", 0.0)
        env = R2RBatchEnv(world, items, BATCH, tok, seed=SEED + 6, device=device)
        batch = env.next_batch()
        lamb = cfg_a.TRAIN.PROGMONITOR_WEIGHT
        for prec in ("f32", "bf16"):
            cfg_0.merge_from_list(["TPU.PRECISION", prec])
            agent0 = build_agent(cfg_0, tok.vocab_size(), FEAT_DIM)
            params0_a, state0 = init_agent(agent0, torch.Generator().manual_seed(SEED))
            tables = world.device_tables(prec, device)
            params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0_a)
            mstate = tree.tree_map(lambda t: t.to(device), state0)
            leaves = tree.tree_leaves(params)

            def loss_fn(on):
                set_route(cfg_a, on)
                gen = torch.Generator(device=device).manual_seed(SEED + 7)
                total, _, new_state = loop.agent_iteration_loss(
                    agent0, "teacher", tables, params, mstate, batch, gen, lamb=lamb)
                return total, tree.tree_leaves(new_state)

            want = agent_launches(name, False)
            out[f"{name.lower()}_{prec}"] = route_compare(
                f"{name} teacher iteration", prec, loss_fn, leaves, leaf_paths(params),
                ZERO_GRAD[name], want)
            launches[f"{name.lower()}_teacher_kernels_{prec}"] = want
            launches[f"{name.lower()}_teacher_plain_{prec}"] = dict.fromkeys(KERNELS, 0)
        # timed iterations with the config's dropout and feedback, bf16
        agent = build_agent(cfg_a, tok.vocab_size(), FEAT_DIM)
        state = {}
        for on in (True, False):
            p = tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
            state[on] = [p, loop.make_optimizer(cfg_a.TRAIN.OPTIM, cfg_a.TRAIN.LR, p),
                         torch.Generator(device=device).manual_seed(SEED + 1), mstate]
        tables = world.device_tables(cfg_a.TPU.PRECISION, device)
        seen = {True: [], False: []}

        def iterate(on):
            set_route(cfg_a, on)
            s = state[on]
            reset_launch_counts()
            logs, s[3] = loop.agent_one_iter(agent, s[1], cfg_a.AGENT.FEEDBACK, tables, s[0], s[3],
                                             env.next_batch(), s[2], lamb=lamb)
            float(logs["loss"])
            seen[on].append(launch_counts())
            return logs

        for on in (True, False):
            iterate(on)
        ms = turns(iterate, S12_ROUNDS)
        for on in (True, False):
            want = agent_launches(name, False) if on else dict.fromkeys(KERNELS, 0)
            check(all(c == want for c in seen[on]),
                  f"timed {name} USE_PALLAS {on}: launches {seen[on]}, expected {want}")
        launches[f"{name.lower()}_iteration_kernels"] = agent_launches(name, False)
        launches[f"{name.lower()}_iteration_plain"] = dict.fromkeys(KERNELS, 0)
        out[f"{name.lower()}_timed"] = timed_routes(
            f"one {cfg_a.TPU.PRECISION} {name} iteration ({cfg_a.AGENT.FEEDBACK})", iterate, ms,
            card)
    ops.set_kernels(True)
    return out, launches


def timed_routes(what, iterate, ms, card):
    """Each route's median of ``ms`` and the device-busy share of one more
    call of ``iterate`` under the profiler; logged with the card."""
    timed = {}
    for on in (True, False):
        wall, busy, rows = profile(lambda: iterate(on))
        print_profile(f"{what}, USE_PALLAS {on}", wall, busy, rows)
        timed[str(on)] = {"ms": ms[on], "median_ms": statistics.median(ms[on]),
                          "busy_pct": 100 * busy / wall, "wall_ms": wall, "busy_ms": busy}
    k, p = timed["True"], timed["False"]
    log(f"slice12 (b) timed {what}: kernels {k['median_ms']:.2f} ms (busy {k['busy_pct']:.1f}%), "
        f"plain {p['median_ms']:.2f} ms (busy {p['busy_pct']:.1f}%), medians of "
        f"{len(ms[True])} in turns (kernels, plain, plain, kernels) | {card}")
    return timed


def bundle_arrays(path):
    """The arrays and numbers of a checkpoint bundle (not its config text)."""
    from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint

    b = load_checkpoint(path)
    return {k: b[k] for k in ("params", "opt_state", "model_state", "rng", "curriculum", "epoch")}


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def slice12_phase(world, data, requests, tok, cfg, m, params0, device, card):
    """Phase 15: (a) serving and (b) training on the plain route (TPU.USE_PALLAS
    False) against the kernels, (c) ``main`` with TPU.CKPT_ASYNC against a
    synchronous run, (d) a results file written by ``write_results`` and
    scored."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.evaluator import Evaluation
    from curriculum_learning_for_vln_torch.engine.trainer import dedup_by_path
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    t_phase = time.perf_counter()
    T = cfg.AGENT.MAX_EPISODE_LEN
    out = {}
    out["serve"], launches = slice12_serve(world, requests, tok, m, params0, device, card, T)
    out["train"], train_launches = slice12_train(world, data, tok, cfg, m, params0, device, card)
    launches.update(train_launches)

    # (c) main with TPU.CKPT_ASYNC and without, two epochs each, run together
    root = tempfile.mkdtemp(prefix="chip_smoke_s12_")
    args = ["--config-file", CONFIG, "TPU.PACKED_RL", 0, "TRAIN.MAX_EPOCH", 2,
            "TRAIN.ITER_PER_EPOCH", S12_MAIN_ITERS, "TRAIN.EVAL_INTERVAL", 1]
    t0 = time.perf_counter()
    procs = {a: start_main([*args, "TPU.CKPT_ASYNC", a], os.path.join(root, str(a)))
             for a in (True, False)}

    # (d) while they run: an evaluation written by write_results, scored from the file
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=PRECISIONS[cfg.TPU.PRECISION])
    paths = data[:S12_EVAL_PATHS]
    henv = R2RBatchEnv(world, expand_r2r_items(paths, tok), BATCH, tok, seed=SEED, name="val",
                       device=device)
    params = tree.tree_map(lambda t: t.to(device), params0)
    reset_launch_counts()
    results = loop.run_eval(agent, params, world.device_tables(cfg.TPU.PRECISION, device), henv)
    eval_counts = launch_counts()
    path = loop.write_results(results, os.path.join(root, "results"), split="val")
    ev = Evaluation(world, dedup_by_path(henv.data))
    from_file, _ = ev.score(path)
    in_memory, _ = ev.score(results)
    check(from_file == in_memory, f"write_results: scored from the file {from_file}, in memory "
                                  f"{in_memory}")
    with open(path) as f:
        written = json.load(f)
    check(sorted(r["instr_id"] for r in written) == sorted(it["instr_id"] for it in henv.data),
          "the results file holds every instruction once")
    launches["eval_write_results"] = eval_counts
    out["write_results"] = {"items": len(written), "scores": from_file}
    log(f"slice12 (d): run_eval over {len(written)} instructions ({len(paths)} paths), "
        f"write_results -> {os.path.basename(path)}, scored from the file as in memory: SR "
        f"{from_file['success_rate']:.4f}, SPL {from_file['spl']:.4f}, nDTW "
        f"{from_file['ndtw']:.4f}; launches {eval_counts}")

    runs = {a: finish_main(f"CKPT_ASYNC {a}", procs[a], os.path.join(root, str(a)))
            for a in (True, False)}
    secs = time.perf_counter() - t0
    files = {}
    for a in (True, False):
        found = {}
        for d, _, names in os.walk(os.path.join(root, str(a), "ckpt")):
            for n in names:
                found[n] = os.path.join(d, n)
        files[a] = found
    check(sorted(files[True]) == sorted(files[False]),
          f"the rotation leaves the same files: {sorted(files[True])} / {sorted(files[False])}")
    check("latest.ckpt" in files[True] and "latest_ep2.ckpt" in files[True]
          and "latest_ep1.ckpt" not in files[True], f"the rotation ran: {sorted(files[True])}")
    for n in files[True]:
        check(trees_equal(bundle_arrays(files[True][n]), bundle_arrays(files[False][n])),
              f"{n}: the asynchronous bundle equals the synchronous one array by array")
    for a in (True, False):
        launches[f"main_ckpt_async_{a}"] = runs[a][0]
    out["main"] = {"s": secs, "files": sorted(files[True]),
                   "log": {str(a): runs[a][1] for a in (True, False)}}
    log(f"slice12 (c): main TPU.CKPT_ASYNC True and False (2 epochs of {S12_MAIN_ITERS} "
        f"iterations, run together in {secs:.1f} s): the same files {sorted(files[True])}, "
        f"every bundle equal array by array; {' | '.join(runs[True][1])}; launches "
        f"{runs[True][0]}")
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["secs"] = time.perf_counter() - t_phase
    log(f"slice12: phase 15 in {out['secs']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    kernels_only = "--kernels-only" in sys.argv[1:]
    dp_only = "--dp-only" in sys.argv[1:]
    bptt_only = "--bptt-only" in sys.argv[1:]
    slice12_only = "--slice12-only" in sys.argv[1:]
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
    lengths = first_lengths(requests, tok, device)
    log(f"instruction lengths of the first micro-batch: {int(lengths.min())} to "
        f"{int(lengths.max())} tokens of {tok.encoding_length}")
    if dp_only:
        dp = dp_phase(card)
        log(json.dumps({"dp_only": {"mains": dp["mains"], "secs": dp["secs"],
                                    "ranks": [{k: r[k] for k in ("launches", "ms", "worst",
                                                                 "vs_plain")}
                                              for r in dp["ranks"]]}}))
        return 0
    if bptt_only:
        bptt = bptt_phase(world, data, requests, tok, cfg, m, params, device, card)
        log(json.dumps({"bptt_only": {k: bptt[k] for k in ("launches", "memory", "secs")}}))
        return 0
    if slice12_only:
        s12 = slice12_phase(world, data, requests, tok, cfg, m, params, device, card)
        log(json.dumps({"slice12_only": {k: s12[k] for k in ("serve", "train", "launches",
                                                            "secs")}}))
        return 0
    if kernels_only:
        results = kernel_phases(world, lengths, device)
        log(json.dumps({"kernels_only": {f"{n}/{p}": {k: v for k, v in r.items()}
                                         for (n, p), r in results.items()}}))
        return 0

    # each phase's seconds, printed before the kernels line
    marks = [("", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

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
    mark("serve")
    del serve, nav

    train = train_phase(world, data, tok, cfg, m, params, requests, device)
    mark("train")
    tw, tb = train["busy"]
    log(f"train: {train['median_ms']:.2f} ms per iteration (median of {TRAIN_ITERS}), device "
        f"busy {100 * tb / tw:.1f}% under the profiler | {card}")

    cur = curriculum_phase(world, data, tok, params, device)
    mark("curriculum")
    pk = cur["packed"]
    pw, pb = pk["busy"]
    log(f"curriculum: {pk['median_ms']:.2f} ms per SPCL packed iteration (median of "
        f"{CURRICULUM_ITERS - 2}), {pk['episodes_per_s']:.1f} completed episodes/s, device busy "
        f"{100 * pb / pw:.1f}% under the profiler | {card}")

    cdata = curriculum_data_phase(device, card)
    mark("curriculum_data")

    agents = agents_phase(world, data, requests, tok, device, card)
    mark("agents")
    for name in AGENT_CONFIGS:
        a = agents[name]
        sw, sb = a["serve"]["busy"]
        tw, tb = a["train"]["busy"]
        log(f"agents {name}: serve {a['serve']['median_ms']:.2f} ms a call of {BATCH} (device busy "
            f"{100 * sb / sw:.1f}%), train {a['train']['median_ms']:.2f} ms an iteration (device "
            f"busy {100 * tb / tw:.1f}%) | {card}")

    spk = speaker_phase(world, data, tok, cfg, device, card)
    mark("speaker")
    sw, sb = spk["train"]["busy"]
    log(f"speaker: {spk['train']['median_ms']:.2f} ms a teacher-forcing step (device busy "
        f"{100 * sb / sw:.1f}%), greedy decode of {cfg.AIDE.SPEAKER.MAX_DECODE} steps "
        f"{spk['decode']['greedy']['ms']:.2f} ms, back_translate "
        f"{spk['decode']['back_translate']['ms']:.2f} ms a batch of {BATCH} | {card}")

    beam = beam_phase(world, data, tok, cfg, m, params, device, card)
    mark("beam")
    log(f"beam: {beam['total_ms']:.2f} ms a beam batch of {BATCH} at beam {BEAM_SIZE} "
        f"({beam['iterations']} iterations; decode {beam['decode_ms_median']:.3f} ms and host "
        f"{beam['host_ms_per_iteration']:.3f} ms an iteration; rescoring "
        f"{beam['rescore_ms_median']:.2f} ms an episode) | {card}")

    vil = vilbert_phase(world, data, tok, device, card)
    mark("vilbert")
    vw, vb = vil["train"]["busy"]
    log(f"vilbert: {vil['train']['median_ms']:.2f} ms a pretraining step of {VIL_BATCH} (device "
        f"busy {100 * vb / vw:.1f}%), {vil['score']['items_per_s']:.1f} items scored a second "
        f"| {card}")

    dp = dp_phase(card)
    mark("dp")
    dp_ranks = dp["ranks"]

    bptt = bptt_phase(world, data, requests, tok, cfg, m, params, device, card)
    mark("bptt")

    s12 = slice12_phase(world, data, requests, tok, cfg, m, params, device, card)
    mark("slice12")

    # after the timed path, so that the kernel phases' profiler sessions
    # do not come before the timed serve calls (whether a session leaves
    # host-side launch overhead behind is not settled)
    gc.collect()  # the card's cached blocks back, for the kernel phases' process
    torch.cuda.empty_cache()
    results, rescore_shapes = kernel_phases_apart()
    mark("kernel_phases")

    # each kernel's launches on its main path: the serve run for K3, the
    # SPCL packed training run for the others; K8 is on no path.  The
    # other paths' launches (agents, speaker, beam, ViLBERT) beside them
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
        check(name != "lstm_scan" or beam["launches"][name] > 0, "K3 launched on the beam path")
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
            "beam_launches": beam["launches"][name], "vilbert_launches": vil["launches"][name],
            "curriculum_data_launches": {k: v[name] for k, v in cdata["launches"].items()},
            "dp_launches": {
                **{f"{k}_rank{r}": v[name] for r, x in enumerate(dp_ranks)
                   for k, v in x["launches"].items()},
                **{f"main_{k}": v[name] for k, v in dp["mains"].items()}},
            "bptt_launches": {k: v[name] for k, v in bptt["launches"].items()},
            "slice12_launches": {k: v[name] for k, v in s12["launches"].items()},
        }
        if name in cdata["eval_train_b128"]:  # K3, K4, K6 on an EVAL_TRAIN batch of 128
            entry["eval_train_b128"] = cdata["eval_train_b128"][name]
        if "checks" in r:  # the LSTM kernels: each output group, and the long lengths
            keys = ("lengths", "valid_steps", "checks", *TIME_KEYS, "device_split", "bound_ms",
                    "bound_by")
            entry.update(lengths=r["lengths"], valid_steps=r["valid_steps"], checks=r["checks"],
                         device_split=r["device_split"])
            entry["f32"].update(checks=r32["checks"], device_split=r32["device_split"])
            entry["long_lengths"] = {prec: {k: x["long"][k] for k in keys}
                                     for prec, x in ((precision, r), ("f32", r32))}
            if "gemm_rates" in r:  # the input-side GEMM launches
                entry["gemm_rates"] = {precision: r["gemm_rates"], "f32": r32["gemm_rates"]}
            # the Follower's, the Self-Monitor's and the speaker's encoder layers
            for group, labels in (("agent_shapes", AGENT_LSTM_SHAPES),
                                  ("speaker_shapes", (*SPEAKER_LSTM_SHAPES, SPEAKER_RAGGED))):
                entry[group] = {
                    label: {prec: {k: x[group][label][k]
                                   for k in ("shape", *keys, "max_abs_err", "ragged", "plans",
                                             "gemm_rates")
                                   if k in x[group][label]}
                            for prec, x in ((precision, r), ("f32", r32))}
                    for label in labels}
        else:
            entry["tol"] = r["tol"]
        if "ragged" in r:  # K4-K7 at a short prng_shared group, K8 at ragged edges
            entry["ragged"] = {precision: r["ragged"], "f32": r32["ragged"]}
        if "plans" in r:  # K4, K5: the launch plans at B = 64, 61 and 1
            entry["plans"] = {precision: r["plans"], "f32": r32["plans"]}
        if name == "lstm_scan":  # the beam's rescoring shapes
            entry["beam_rescore_shapes"] = rescore_shapes
        if name in OFF_PATH:
            entry.update(shape=r["shape"], kernel_phase_launches=r["kernel_phase_launches"])
        if "modes" in r:
            entry["mask_mode"] = "prng (prng_shared on the SPCL path: under modes)"
            entry["modes"] = r["modes"]
        kernels.append(entry)
    log(json.dumps({"phase_seconds": {name: round(t - marks[i][1], 1)
                                      for i, (name, t) in enumerate(marks[1:])}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
