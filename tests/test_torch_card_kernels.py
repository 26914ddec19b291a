"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, in bf16 and f32.

* K3 (LSTM scan), K1 and K2 (training forward and backward of the scan),
  both directions: at EnvDrop's encoder shape (D = H = 256, L = 80, B = 64)
  over the serving requests' token lengths and over lengths up to
  MAX_ENC_LEN = 80; at the Follower's (D = 300 then 256 at H = 128) and
  the Self-Monitor's (D = 256, H = 512: the resident walks in bf16) encoder
  layers over lengths up to 80; at the speaker encoder's layers ((D, H) =
  (2176, 256) and (512, 256), L = 35) at full lengths, and its first layer
  over ragged lengths 1-35; and each at B = 61 over ragged lengths with a
  0 and an L (a short last cluster), the Self-Monitor's also at B = 40 and
  1 (one row group).  K2's d_xs is 0 at padded steps, and in bf16 differs
  from its plain version in under 1% of its valid elements (both round
  one f32 product once).  K3 also at the beam's rescoring shapes.
* The forward and backward walks' plans at the Self-Monitor's shape (B =
  64, 61 and 1) equal the C entry points' own plans, in one wave.
* K4 and K5 (observation step forward and backward), K6 and K7 (candidate
  scoring forward and backward) in the mask modes none, ext, prng and
  prng_shared (the plain prng modes draw the kernels' Philox bits, so
  they are held to the tolerance of the arithmetic); K4's candidate rows
  exactly; K4 and K5 again at B = 61 and 1, K6 and K7 at B = 61 in
  prng_shared; K4's and K5's launch plans equal the C entry points' own.
* K8 (the fused LSTM cell, which no path runs) at the EnvDrop decoder
  cell's shape and at (B, Din, H) = (37, 200, 48).
* The compiler's report of the resident LSTM walks: no spills, at most 128
  registers a thread.
"""
import subprocess

import pytest
import torch
from torch_card_world import (BATCH, FEAT_DIM, MODES, SEED, card, compare,  # noqa: F401
                              drop_spec, kernel_resources, lstm_inputs, long_lengths, modules,
                              serving)

PRECS = {"bf16": torch.bfloat16, "f32": torch.float32}
# (D, H, L, lengths) of K1-K3's cases at B = 64
LSTM_CASES = {
    "envdrop serve lengths": (256, 256, 80, "serve"),
    "envdrop 16-80": (256, 256, 80, "long"),
    "monitor 16-80": (256, 512, 80, "long"),
    "follower_l1 16-80": (300, 128, 80, "long"),
    "follower_l2 16-80": (256, 128, 80, "long"),
    "speaker_l1 full": (2176, 256, 35, "full"),
    "speaker_post full": (512, 256, 35, "full"),
    # the bf16 gates_x's tiles of valid steps then straddle batch rows
    "speaker_l1 1-35": (2176, 256, 35, "speaker"),
}
# (D, H, L, B) of K1-K3's cases over ragged lengths 0..L with a 0 and an L
RAGGED_CASES = {
    "envdrop B=61": (256, 256, 80, 61),
    "monitor B=61": (256, 512, 80, 61),
    "monitor B=40": (256, 512, 80, 40),  # one row group
    "monitor B=1": (256, 512, 80, 1),    # one cluster
    "follower_l1 B=61": (300, 128, 80, 61),
    "follower_l2 B=61": (256, 128, 80, 61),
    "speaker_l1 B=61": (2176, 256, 35, 61),
    "speaker_post B=61": (512, 256, 35, 61),
}
# K3 at the beam's rescoring shapes: the speaker encoder's first layer
# (bf16, the compute dtype) and its post-LSTM (f32, after the f32
# attention) over up to 30 paths of up to 16 steps
RESCORE_B, RESCORE_L = 30, 16
RESCORE_SHAPES = {"rescore_l1": (FEAT_DIM + 128, 256, torch.bfloat16),
                  "rescore_post": (512, 256, torch.float32)}
V, A, MC = 36, 128, 16
CELL = (BATCH, 64 + FEAT_DIM + 128, 512)  # EnvDrop's decoder cell: [action ; attended panorama]
RAGGED_CELL = (37, 200, 48)  # B < 64, K = 248 not a multiple of 16, H = 48 not of 64


def first_lengths(requests, tok, device):
    """The token lengths of the first micro-batch of requests."""
    return torch.tensor([tok.encode_sentence(r["instruction"])[1] for r in requests[:BATCH]],
                        device=device)


def assert_within(what, e):
    """``e`` = (error, tolerance) from ``compare``."""
    assert e[0] <= e[1], f"{what}: |kernel - plain| {e[0]:.3g} > {e[1]:.3g}"


def lengths_of(kind, B, L, gen, device, serve_lengths):
    if kind == "serve":
        return serve_lengths
    if kind == "long":
        return long_lengths(B, gen, device)
    if kind == "full":
        return torch.full((B,), L, dtype=torch.long, device=device)
    lengths = torch.randint(1, L + 1, (B,), generator=gen, device=device)
    lengths[0] = L
    return lengths


def check_lstm(what, dtype, device, gen, lengths, D, H, L):
    """K3, K1 and K2, both directions, against their plain versions: outs,
    hT, cT (and K1's residuals at valid steps) within 1e-4 of their scale
    (f32 state from the same rounded inputs: the order of the sums
    differs); K2 from K1's residuals, d_xs in the dtype of xs (1e-4 in f32,
    8e-3 in bf16, one ulp of which is 2^-8) and dW_ih, dW_hh, db within
    1e-4; d_xs 0 at padded steps; bf16 d_xs differing from plain in under
    1% of its valid elements."""
    k = modules()["lstm_scan"]
    B = lengths.shape[0]
    xs, w_ih, w_hh, b = lstm_inputs(dtype, device, gen, B, L, D, H)
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    d_out = torch.randn(B, L, H, generator=gen, device=device)
    dhT, dcT = (torch.randn(B, H, generator=gen, device=device) for _ in range(2))
    for reverse in (False, True):
        at = f"{what} {dtype} D={D} H={H} B={B} reverse={reverse}"
        out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        assert_within(f"K3 {at}: outs,hT,cT", compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4))
        tk = k.lstm_scan_train(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        tp = k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        assert_within(f"K1 {at}: outs,hT,cT,hprev,cprev,gates",
                      compare((tk[0], *tk[1], tk[2], tk[3], tk[4][valid]),
                              (tp[0], *tp[1], tp[2], tp[3], tp[4][valid]), 1e-4))
        gk = k.lstm_scan_bwd(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT,
                             reverse=reverse)
        gp = k.lstm_scan_bwd_plain(xs, lengths, w_ih, w_hh, tk[4], tk[2], tk[3], d_out, dhT, dcT,
                                   reverse=reverse)
        assert_within(f"K2 {at}: d_xs",
                      compare(gk[:1], gp[:1], 1e-4 if dtype == torch.float32 else 8e-3))
        assert_within(f"K2 {at}: dW_ih,dW_hh,db", compare(gk[1:], gp[1:], 1e-4))
        assert bool((gk[0].float()[~valid] == 0).all()), f"K2 {at}: d_xs is 0 at padded steps"
        if dtype == torch.bfloat16 and bool(valid.any()):
            differ = float((gk[0] != gp[0])[valid].float().mean())
            print(f"K2 {at}: bf16 d_xs differs from plain in {differ:.4%} of its valid elements")
            assert differ < 0.01, f"K2 {at}: bf16 d_xs differs from plain in {differ:.3%}"


@pytest.fixture(scope="module")
def serve_lengths(serving, card):
    _, _, requests, tok, *_ = serving
    return first_lengths(requests, tok, card)


@pytest.fixture(scope="module")
def tables(serving, card):
    """The serving world's feature table on the card, by precision."""
    features = torch.from_numpy(serving[0].features).to(card)
    return {prec: features.to(dtype) for prec, dtype in PRECS.items()}


@pytest.mark.parametrize("case", LSTM_CASES)
@pytest.mark.parametrize("prec", PRECS)
def test_lstm_scans_agree_with_plain(card, serve_lengths, prec, case):
    D, H, L, kind = LSTM_CASES[case]
    gen = torch.Generator(device=card).manual_seed(SEED)
    lengths = lengths_of(kind, BATCH, L, gen, card, serve_lengths)
    check_lstm(case, PRECS[prec], card, gen, lengths, D, H, L)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("prec", PRECS)
def test_lstm_scans_agree_with_plain_over_ragged_rows(card, prec, case):
    D, H, L, B = RAGGED_CASES[case]
    gen = torch.Generator(device=card).manual_seed(SEED + 1)
    lengths = torch.randint(0, L + 1, (B,), generator=gen, device=card)
    lengths[0], lengths[-1] = 0, L
    check_lstm(case, PRECS[prec], card, gen, lengths, D, H, L)


@pytest.mark.parametrize("prec", PRECS)
def test_lstm_walk_plans_are_the_c_plans_in_one_wave(card, prec):
    """The forward and the backward walks' plans at the Self-Monitor's
    encoder shape, B = 64, 61 and 1: ``lstm_scan_fwd_plan`` /
    ``lstm_scan_bwd_plan`` from the clusters the card holds at once equal
    the plans the C entry points compute (``plan_query`` /
    ``bwd_plan_query``), in one wave of clusters."""
    k = modules()["lstm_scan"]
    dtype, D, H, L = PRECS[prec], 256, 512, 80
    elem = torch.empty((), dtype=dtype).element_size()
    for way, query, plan_of in (("fwd", k.plan_query, k.lstm_scan_fwd_plan),
                                ("bwd", k.bwd_plan_query, k.lstm_scan_bwd_plan)):
        for B in (BATCH, BATCH - 3, 1):
            q = query(B, H, dtype)
            p = plan_of(B, L, D, H, elem, clusters_at_once=q[5])
            assert q[:5] == (p.cluster, p.rows, p.clusters, p.rec_threads, p.rec_smem), \
                f"lstm_scan {way} {dtype} H={H} at B = {B}: plan {p} is the C plan {q}"
            waves = -(-p.clusters // q[6])
            print(f"lstm_scan {way} walk {dtype} D={D} H={H} B={B}: W_hh {p.w_where}, cluster of "
                  f"{p.cluster} blocks, R = {p.rows}, {p.clusters} clusters; the card holds "
                  f"{q[6]} at once: {waves} wave(s)")
            assert waves == 1, (f"lstm_scan {way} {dtype} H={H} at B = {B}: {p.clusters} "
                                f"clusters of {p.cluster} need {waves} waves (the card holds "
                                f"{q[6]} at once)")


@pytest.mark.parametrize("label", RESCORE_SHAPES)
def test_lstm_scan_at_beam_rescoring_shapes(card, label):
    """K3 at B = 30 over ragged lengths 1..16 with a 16, both directions,
    within 1e-4 of its plain version's scale."""
    k = modules()["lstm_scan"]
    D, H, dtype = RESCORE_SHAPES[label]
    gen = torch.Generator(device=card).manual_seed(SEED + 7)
    lengths = torch.randint(1, RESCORE_L + 1, (RESCORE_B,), generator=gen, device=card)
    lengths[0] = RESCORE_L
    xs, w_ih, w_hh, b = lstm_inputs(dtype, card, gen, RESCORE_B, RESCORE_L, D, H)
    for reverse in (False, True):
        out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        assert_within(f"lstm_scan {dtype} D={D} H={H} at B = {RESCORE_B}, reverse={reverse}",
                      compare((out_k, h_k, c_k), (out_p, h_p, c_p), 1e-4))


def obs_inputs(features, gen, device, B=BATCH):
    """One decoder step's observation inputs over the world's table."""
    from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings

    N, _, D = features.shape
    nodes = torch.randint(0, N, (B,), generator=gen, device=device)
    views = torch.randint(0, V, (B,), generator=gen, device=device)
    cand_view = torch.randint(0, V, (B, MC), generator=gen, device=device)
    return {
        "loc": torch.from_numpy(all_loc_embeddings()).to(device),
        "nodes": nodes, "views": views, "cand_view": cand_view,
        "tv": torch.randn(B, D + A, generator=gen, device=device) / 32,  # scores of O(1)
        "d_vis": torch.randn(B, D + A, generator=gen, device=device),
        "cands": features[nodes[:, None], cand_view].contiguous(),
        # the angle rows in the table dtype, as env/env.py makes them
        "cand_angle": torch.randn(B, MC, A, generator=gen, device=device).to(features.dtype),
        "valid": torch.rand(B, MC, generator=gen, device=device) < 0.5,
        "q": torch.randn(B, D + A, generator=gen, device=device) / 32,
        "d_logits": torch.randn(B, MC + 1, generator=gen, device=device),
    }


def check_pano(what, features, x, drop):
    """K4 (candidate rows exactly, visual and alpha within 1e-4) and K5
    within 1e-4 of their plain versions' scale."""
    kp = modules()["pano_fused"]
    args = (x["nodes"], x["views"], x["cand_view"], features, x["loc"], x["tv"])
    got, want = kp.pano_attend(*args, drop), kp.pano_attend_plain(*args, drop)
    assert torch.equal(got[2], want[2]), f"pano_attend {what}: candidate rows are exact copies"
    assert_within(f"pano_attend {what}", compare(got[:2], want[:2], 1e-4))
    bargs = (x["nodes"], x["views"], features, x["loc"], got[1], x["d_vis"])
    assert_within(f"pano_attend_bwd {what}",
                  compare((kp.pano_attend_bwd(*bargs, drop),),
                          (kp.pano_attend_bwd_plain(*bargs, drop),), 1e-4))


def check_cand(what, x, drop):
    """K6 (the STOP slot 0) and K7 within 1e-4 of their plain versions'."""
    kc = modules()["cand_score"]
    cargs = (x["cands"], x["cand_angle"], x["valid"])
    got = kc.cand_score(*cargs, x["q"], drop)
    assert bool((got[:, MC] == 0).all()), f"cand_score {what}: the STOP slot scores 0"
    assert_within(f"cand_score {what}",
                  compare((got,), (kc.cand_score_plain(*cargs, x["q"], drop),), 1e-4))
    assert_within(f"cand_score_bwd {what}",
                  compare((kc.cand_score_bwd(*cargs, x["d_logits"], drop),),
                          (kc.cand_score_bwd_plain(*cargs, x["d_logits"], drop),), 1e-4))


def cut(x, B):
    return {k: v if k == "loc" else v[:B].contiguous() for k, v in x.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prec", PRECS)
def test_observation_kernels_agree_with_plain(card, tables, prec, mode):
    features = tables[prec]
    D = features.shape[-1]
    gen = torch.Generator(device=card).manual_seed(SEED + 2)
    x = obs_inputs(features, gen, card)
    check_pano(f"{prec} {mode} at B = {BATCH}", features, x,
               drop_spec(mode, BATCH, V, D, gen, card))
    check_cand(f"{prec} {mode} at B = {BATCH}", x, drop_spec(mode, BATCH, MC, D, gen, card))


@pytest.mark.parametrize("B", [BATCH - 3, 1])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prec", PRECS)
def test_pano_attend_at_short_batches(card, tables, prec, mode, B):
    """K4 and K5 at B = 61 (a short last prng_shared group, and blocks of 4
    samples whose seed is another block's) and at B = 1."""
    features = tables[prec]
    gen = torch.Generator(device=card).manual_seed(SEED + 3)
    x = cut(obs_inputs(features, gen, card), B)
    check_pano(f"{prec} {mode} at B = {B}", features, x,
               drop_spec(mode, B, V, features.shape[-1], gen, card))


@pytest.mark.parametrize("prec", PRECS)
def test_cand_score_at_a_short_prng_shared_group(card, tables, prec):
    """K6 and K7 at a batch that is not a multiple of 8."""
    features = tables[prec]
    B = BATCH - 3
    gen = torch.Generator(device=card).manual_seed(SEED + 4)
    x = cut(obs_inputs(features, gen, card), B)
    check_cand(f"{prec} prng_shared at B = {B}", x,
               drop_spec("prng_shared", B, MC, features.shape[-1], gen, card))


@pytest.mark.parametrize("prec", PRECS)
def test_pano_plans_are_the_c_plans(card, prec):
    """K4's and K5's launch plans at B = 64, 61 and 1: ``pano_plan``
    against the plan the C entry points compute (``plan_query``)."""
    kp = modules()["pano_fused"]
    dtype = PRECS[prec]
    for name, mc in (("pano_attend", MC), ("pano_attend_bwd", 0)):
        for B in (BATCH, BATCH - 3, 1):
            p = kp.pano_plan(B, V, FEAT_DIM, A, dtype, mc)
            q = kp.plan_query(B, V, FEAT_DIM, A, dtype, mc)
            assert q[:6] == (p.cluster, p.samples, p.grid[1], p.cols, p.ang_quads, p.smem), \
                f"{name} {dtype} at B = {B}: pano_plan {p} is the C plan {q[:6]}"


@pytest.mark.parametrize("shape", [RAGGED_CELL, CELL], ids=["ragged", "decoder"])
@pytest.mark.parametrize("prec", PRECS)
def test_lstm_cell_agrees_with_plain(card, prec, shape):
    """K8 beside its plain version: f32 sums of Din + H products in another
    order (1e-4); bf16 outputs rounded to bf16 (8e-3: one ulp is 2^-8)."""
    k = modules()["lstm_cell"]
    dtype = PRECS[prec]
    B, Din, H = shape
    gen = torch.Generator(device=card).manual_seed(SEED + 5)

    def u(*s):
        return ((torch.rand(*s, generator=gen, device=card) * 2 - 1) / H ** 0.5).to(dtype)

    x, h, c = (torch.randn(B, n, generator=gen, device=card).to(dtype) for n in (Din, H, H))
    w = (u(Din, 4 * H), u(H, 4 * H), u(4 * H))
    k.launches = 0
    got = k.lstm_cell(x, h, c, *w)
    assert k.launches == 1, "K8 launched"
    assert_within(f"lstm_cell {dtype} at (B, Din, H) = {shape}",
                  compare(got, k.lstm_cell_plain(x, h, c, *w), 1e-4 if prec == "f32" else 8e-3))


def test_resident_walks_build_without_spills(card, tmp_path):
    """The compiler's report of ``csrc/lstm_scan.cu`` (the build's own
    flags): each instantiation of the resident walks, which hold W_hh in
    registers, uses at most 128 registers a thread and spills nothing."""
    from curriculum_learning_for_vln_torch.ops.cuda import build

    run = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(tmp_path / "lstm_scan.so"), str(build.CSRC / "lstm_scan.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-4000:]
    for kernel in ("recurrence_res_kernel", "bwd_recurrence_res_kernel"):
        res = kernel_resources(run.stdout, kernel)
        assert len(res) == 2, f"{kernel}'s two instantiations in the build report: {res}"
        for entry, regs, st, ld in res:
            print(f"resident walk {entry}: {regs} registers a thread, spills {st} / {ld} B")
            assert st == ld == 0 and regs <= 128, f"{entry}: {regs} registers, spills {st} / {ld}"
