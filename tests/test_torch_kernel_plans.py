"""Launch geometry of the port's redesigned kernels, on the CPU.

K8 (``ops/cuda/lstm_cell.py::lstm_cell_plan``), K6 and K7
(``ops/cuda/cand_score.py::cand_score_plan``, ``cand_score_bwd_plan``) and
K2 (``ops/cuda/lstm_scan.py::lstm_scan_bwd_plan``, with ``valid_steps``
and ``split_bounds``) take their grid, cluster, K boxes, row order and
shared-memory bytes from pure functions, which the C entry points are
given or compute alike.  These tests hold those functions to what the
kernels assume: every K row in exactly one box of one CTA of a cluster,
every gate column in exactly one N tile, every batch row in one M tile,
every (sample, candidate) pair and every (sample, column) of K7 in exactly
one warp and lane, every valid step of K2 in exactly one split (and every
padded one in one zero tile), and shared memory within the H100's 232,448
bytes a block.  ``test_lstm_cell_split_k_matches_jax`` replays K8's
split-K sums box by box and CTA by CTA in f32, in the kernel's order,
against the JAX cell, so the slicing (the x/h boundary, ragged boxes at
the ends of x and h) is checked where no card is;
``test_lstm_bwd_split_tf32_matches_jax`` does the same for K2's TF32
tensor-core products with split operands.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import cand_score as t_cand
from curriculum_learning_for_vln_torch.ops.cuda import lstm_cell as t_cell
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_tpu.ops.pallas.lstm import lstm_cell_pallas
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_bwd_pallas,
                                                                  lstm_scan_train_pallas)

torch.set_num_threads(2)

ELEM = {"bf16": 2, "f32": 4}
DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32}
SMS = 132
MAX_SMEM = 232448  # shared memory a block can use on the H100
DECODER = (64, 64 + 2048 + 128, 512)  # EnvDrop decoder cell: B, Din, H
CELL_SHAPES = [DECODER, (37, 200, 48), (1, 8, 16), (200, 64, 16), (130, 1000, 256),
               (5, 24, 32), (64, 2816, 512)]


def _slice_rows(plan, rank, Din, H):
    """The K rows [k0, k1) of [x | h] that CTA ``rank`` of a cluster
    reduces, box by box: boxes of ``plan.box_rows`` rows over x, then over
    h (rows past Din or H in a box are zero-filled, so they are left out)."""
    kc, nbx = plan.box_rows, -(-Din // plan.box_rows)
    rows = []
    for bi in range(rank * plan.boxes, min((rank + 1) * plan.boxes, nbx + -(-H // kc))):
        if bi < nbx:
            rows.append((bi * kc, min(Din, (bi + 1) * kc)))
        else:
            rows.append((Din + (bi - nbx) * kc, Din + min(H, (bi - nbx + 1) * kc)))
    return rows


def _slices(plan, Din, H):
    """Each CTA's K row ranges, box by box."""
    return [_slice_rows(plan, r, Din, H) for r in range(plan.splits)]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_cell_plan_at_the_decoder_shape(prec):
    """K = 2752 in boxes of 128 bytes (43 of 64 rows in bf16, 86 of 32 in
    f32), split four ways: 128 CTAs, one wave on 132 SMs, 81 KB a CTA."""
    B, Din, H = DECODER
    plan = t_cell.lstm_cell_plan(B, Din, H, ELEM[prec])
    want = {"bf16": (4, 11, 64), "f32": (4, 22, 32)}[prec]
    assert (plan.splits, plan.boxes, plan.box_rows) == want
    assert plan.smem == 4 * 16384 + 16384 + 1024
    assert plan.grid == (plan.splits, H // 16, 1) and plan.threads == 128


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_lstm_cell_plan_covers_the_work(shape, prec):
    B, Din, H = shape
    K = Din + H
    plan = t_cell.lstm_cell_plan(B, Din, H, ELEM[prec])
    # K: the boxes of one cluster cover [0, K) exactly once, no CTA idle;
    # a box lies in x or in h, never across the boundary, and has a whole
    # number of mma steps of 16 rows
    assert plan.box_rows * ELEM[prec] == 128 and plan.box_rows % 16 == 0
    covered = np.zeros(K, np.int64)
    for rows in _slices(plan, Din, H):
        assert rows
        for k0, k1 in rows:
            assert k0 < k1 <= k0 + plan.box_rows and (k1 <= Din or k0 >= Din)
            covered[k0:k1] += 1
    assert (covered == 1).all()
    # the cluster is the grid's x extent, a power of two up to 8
    assert plan.grid[0] == plan.splits and plan.grid[0] % plan.splits == 0
    assert plan.splits in (1, 2, 4, 8)
    # N tiles of 16 units cover the 4H gate columns once (gate g, unit n*16+u)
    cols = np.zeros(4 * H, np.int64)
    for n in range(plan.grid[1]):
        for g in range(4):
            cols[g * H + n * 16: g * H + (n + 1) * 16] += 1
    assert (cols == 1).all()
    # M tiles of 64 rows cover the batch
    assert (plan.grid[2] - 1) * 64 < B <= plan.grid[2] * 64
    # two CTAs fit on an SM beside each other
    assert 2 * plan.smem <= MAX_SMEM


def test_lstm_cell_plan_fills_one_wave():
    """The split doubles while twice the CTAs still fit on the card's SMs
    (a single N tile spreads over a whole cluster of 8), and stops where a
    CTA would get no box."""
    assert t_cell.lstm_cell_plan(64, 2240, 16, 2).splits == 8
    assert t_cell.lstm_cell_plan(64, 2240, 512, 2, sms=256).splits == 8
    assert t_cell.lstm_cell_plan(64, 2240, 512, 2, sms=64).splits == 2
    assert t_cell.lstm_cell_plan(4, 8, 16, 2).splits == 2  # one box of x, one of h


@pytest.mark.parametrize("shape", [(37, 200, 48), (5, 24, 32), (70, 136, 16)])
def test_lstm_cell_split_k_matches_jax(shape):
    """K8's arithmetic as its plan cuts it: per-slice partial products of
    [x | h] and [W_ih ; W_hh] in f32, summed in rank order, then the cell
    update, against the Pallas cell in interpret mode (f32, atol 1e-5: the
    same products summed in another order)."""
    B, Din, H = shape
    rng = np.random.default_rng(5)
    x, h, c = (rng.standard_normal((B, n)).astype(np.float32) for n in (Din, H, H))
    w_ih = (rng.standard_normal((Din, 4 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    plan = t_cell.lstm_cell_plan(B, Din, H, 4)
    xh = torch.from_numpy(np.concatenate([x, h], axis=1))
    w = torch.from_numpy(np.concatenate([w_ih, w_hh], axis=0))
    gates = None
    for rows in _slices(plan, Din, H):
        part = sum(xh[:, k0:k1] @ w[k0:k1] for k0, k1 in rows)
        gates = part if gates is None else gates + part
    i, f, g, o = (gates + torch.from_numpy(b)).split(H, dim=-1)
    c_new = torch.sigmoid(f) * torch.from_numpy(c) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    h_j, c_j = lstm_cell_pallas(*(jnp.asarray(a) for a in (x, h, c, w_ih, w_hh, b)),
                                interpret=True)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(h_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c_new.numpy(), np.asarray(c_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [64, 61, 8, 1, 100])
def test_cand_score_plan_covers_every_pair_once(B):
    """Block (j, g), warp w scores sample 8g + w's candidate j; a short last
    group leaves its extra warps idle; the keep flags of one pass fit."""
    MC = 16
    plan = t_cand.cand_score_plan(B, MC)
    assert plan.grid == (MC, -(-B // 8)) and plan.threads == 8 * 32
    seen = np.zeros((B, MC), np.int64)
    for j in range(plan.grid[0]):
        for g in range(plan.grid[1]):
            for w in range(plan.threads // 32):
                if 8 * g + w < B:
                    seen[8 * g + w, j] += 1
    assert (seen == 1).all()
    # the prng_shared group of each warp is its block's: one draw per block
    assert all((8 * g + w) // 8 == g for g in range(plan.grid[1]) for w in range(8))
    assert plan.smem <= MAX_SMEM


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("B", [64, 61, 8, 1, 100])
def test_cand_score_bwd_plan_covers_every_column_once(B, prec):
    """K7: slices of 128 image columns, the angle columns spread over the
    slices four at a time (2 lanes a slice at D = 2048, A = 128); block
    (s, g) warp w sums sample 8g + w; a short last group leaves its extra
    warps idle; every lane's 16 staged rows and flags and a slice's
    prng_shared keep flags fit; at B = 64 the 16 x 8 blocks fit one wave of
    the H100's 132 SMs, one block an SM."""
    MC, D, A = 16, 2048, 128
    plan = t_cand.cand_score_bwd_plan(B, MC, D, A, DTYPE[prec])
    assert plan.grid == (D // 128, -(-B // 8)) and plan.threads == 8 * 32
    assert plan.load_bytes == 4 * ELEM[prec] and plan.cols == 32 * 4 and plan.ang_quads == 2
    seen = np.zeros((B, D + A), np.int64)
    for s in range(plan.grid[0]):
        for g in range(plan.grid[1]):
            for w in range(plan.threads // 32):
                b = 8 * g + w
                assert b // 8 == g  # one prng_shared group a block: one draw
                if b >= B:
                    continue
                for lane in range(32):
                    c = s * plan.cols + 4 * lane
                    if c < D:
                        seen[b, c: c + 4] += 1
                    a = 4 * (s * plan.ang_quads + lane)
                    if lane < plan.ang_quads and a < A:
                        seen[b, D + a: D + a + 4] += 1
    assert (seen == 1).all()
    # 16 rows x 8 warps x (32 + 2) lanes' loads, 16 x 256 flag words, 16 x 32 keep words
    assert plan.smem == 16 * (8 * 34 * 4 * ELEM[prec] + 256 * 4 + 32 * 4) <= MAX_SMEM
    if B == 64:
        assert plan.grid[0] * plan.grid[1] <= SMS


@pytest.mark.parametrize("D, A", [(64, 128), (2048, 4), (128, 0), (512, 100)])
def test_cand_score_bwd_plan_spreads_the_angle_columns(D, A):
    """Other widths: every angle quad in exactly one (slice, lane)."""
    plan = t_cand.cand_score_bwd_plan(8, 16, D, A, torch.float32)
    quads = [s * plan.ang_quads + lane for s in range(plan.grid[0])
             for lane in range(min(32, plan.ang_quads))]
    assert sorted(q for q in quads if q < A // 4) == list(range(A // 4))


def _row_of(starts, B, L, v, pad):
    """csrc/lstm_scan.cu's row_of: the row b of valid (pad: padded) step v,
    by the same binary search over the rows' starts."""
    lo, hi = 0, B
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if (mid * L - starts[mid] if pad else starts[mid]) <= v:
            lo = mid
        else:
            hi = mid
    return lo


_RNG = np.random.default_rng(2)
LENGTH_SETS = {
    "path": _RNG.integers(11, 21, 64).tolist(),
    "long": [80] + _RNG.integers(16, 81, 63).tolist(),
    "ragged": [80, 80, 0, 17, 80, 1, 0, 33],
    "past_L": [90, 3, 80],
    "empty": [0, 0, 0],
    "one_step": [1] * 61,
}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(LENGTH_SETS))
def test_lstm_scan_bwd_plan_covers_valid_steps_once(name, reverse):
    """K2's GEMMs number the valid steps row by row; the walk of either
    direction visits exactly those; the device's search maps each number
    back to its (b, t); dw_gemm's splits (f32) and dw_wgmma's (bf16, on
    K-tile boundaries) cut the numbers into contiguous runs in order, each
    step in one split; dx_gemm's grid holds the valid steps' tiles and then
    the padded steps' zero tiles, each padded step in one; dx_wgmma's holds
    the valid steps' tiles (the pack launch writes the padded steps'
    zeros)."""
    lengths, L = LENGTH_SETS[name], 80
    B = len(lengths)
    lens = [max(0, min(n, L)) for n in lengths]
    walk = {(b, t) for l in range(L) for b in range(B)
            for t in [l if reverse else L - 1 - l] if t < lens[b]}
    steps = t_lstm.valid_steps(lengths, L)
    assert len(steps) == len(set(steps)) and set(steps) == walk
    starts = np.concatenate([[0], np.cumsum(lens)]).tolist()
    for v, (b, t) in enumerate(steps):
        assert _row_of(starts, B, L, v, False) == b and v - starts[b] == t
    plan = t_lstm.lstm_scan_bwd_plan(B, L, 256, 256, 4)
    wg = t_lstm.lstm_scan_bwd_plan(B, L, 256, 256, 2)
    Mv, Mp = len(steps), B * L - len(steps)
    for bounds, splits in ((t_lstm.split_bounds(Mv, plan.splits), plan.dw_grid[2] // 2),
                           (t_lstm.wg_split_bounds(Mv, wg.splits), wg.dw_grid[1])):
        assert len(bounds) == splits
        assert bounds[0][0] == 0 and bounds[-1][1] == Mv
        assert all(a1 == b0 and a0 <= a1 for (a0, a1), (b0, _) in zip(bounds, bounds[1:]))
        covered = np.zeros(Mv, np.int64)
        for v0, v1 in bounds:
            covered[v0:v1] += 1
        assert (covered == 1).all()
    assert all(v0 % t_lstm.WG_DW_K == 0 for v0, _ in t_lstm.wg_split_bounds(Mv, wg.splits))
    assert -(-Mv // t_lstm.DX_TM) + -(-Mp // t_lstm.DX_TM) <= plan.dx_grid[1]
    assert -(-Mv // t_lstm.WG_M) <= wg.dx_grid[1]
    pads = set()
    for v in range(Mp):
        b = _row_of(starts, B, L, v, True)
        t = lens[b] + v - (b * L - starts[b])
        assert lens[b] <= t < L
        pads.add((b, t))
    assert len(pads) == Mp and not pads & walk


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_scan_bwd_plan_at_the_path_shape(prec):
    """B = 64, L = 80, D = H = 256: 8 clusters of 8 for the recurrence.
    f32: d_xs in 4 column tiles of 64 by 161 step tiles of 32 (160 over
    the 5,120 steps, one for the tile that valid and padded steps split);
    dW_ih and dW_hh in 64 tiles of 64 x 128, each reduced by a cluster of 8
    splits: 512 blocks at 2 an SM, more than a wave on 132 SMs.  bf16: the
    pack launch's 640 blocks of 8 sequence rows; d_xs in 2 column tiles of
    128 by 40 step tiles of 128, K split 2 ways, one block an SM (80
    tiles fill under 70% of a wave: the 11-20-token mix leaves 16 of them
    any valid step); dW_ih and dW_hh in 32
    tiles of 128 x 128, each reduced by a cluster of 8 splits: 256 blocks,
    one wave of two blocks an SM."""
    plan = t_lstm.lstm_scan_bwd_plan(64, 80, 256, 256, ELEM[prec])
    assert plan.rec_grid == 64
    if prec == "f32":
        assert plan.gemm == "mma.sync" and plan.pack_elems == 0
        assert plan.dx_grid == (4, 161) and plan.dw_grid == (8, 4, 16)
        assert plan.dw_blocks_per_sm == 2 and plan.splits == 8  # the portable cluster size
        assert np.prod(plan.dw_grid) >= SMS
    else:
        assert plan.gemm == "wgmma" and plan.pack_grid == 640
        assert plan.pack_elems == 64 * 80 * (256 + 15 * 256)
        assert plan.dx_grid == (2, 40, 2) and plan.dw_grid == (32, 8, 1)
        assert plan.dw_blocks_per_sm == 2 and plan.splits == 8
        assert np.prod(plan.dw_grid) <= 2 * SMS
        assert plan.dx_smem == 68 * 4 + 64 + 1024 + 12 * 16384
        assert plan.dw_smem == 68 * 4 + 64 + 1024 + 12 * 8192
        assert 2 * plan.dw_smem <= MAX_SMEM < 2 * plan.dx_smem
    assert max(plan.rec_smem, plan.dx_smem, plan.dw_smem) <= MAX_SMEM


@pytest.mark.parametrize("B", [1, 61, 100, 512])
@pytest.mark.parametrize("H", [32, 96, 256])
def test_lstm_scan_bwd_plan_fits_shared_memory(B, H):
    for elem in (2, 4):
        plan = t_lstm.lstm_scan_bwd_plan(B, 80, 64, H, elem)
        assert max(plan.rec_smem, plan.dx_smem, plan.dw_smem) <= MAX_SMEM
        if elem == 4:
            assert plan.dw_grid[0] * 128 == 4 * H and plan.dw_grid[1] * 64 >= max(64, H)
        else:  # dW_ih's one row of tiles, then dW_hh's
            assert plan.dw_grid[0] == (1 + -(-H // 128)) * (4 * H // 128)


def _bwd_emulated_and_jax(prec, reverse, B, L, D, H, lengths, seed=11):
    """K2's emulated outputs and the Pallas backward's, from the same
    numpy-seeded inputs and the Pallas forward's carries."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    w_ih, w_hh, b = u(D, 4 * H), u(H, 4 * H), u(4 * H)
    d_out = rng.standard_normal((B, L, H)).astype(np.float32)
    dhT, dcT = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    dtype = DTYPE[prec]
    jdt = jnp.bfloat16 if prec == "bf16" else jnp.float32
    xj, wij, whj, bj = (jnp.asarray(a).astype(jdt) for a in (xs, w_ih, w_hh, b))
    lj = jnp.asarray(lengths, jnp.int32)
    _, _, hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj, reverse=reverse,
                                              interpret=True)
    want = lstm_scan_bwd_pallas(xj, lj, wij, whj, bj, hp_j, cp_j, jnp.asarray(d_out),
                                jnp.asarray(dhT), jnp.asarray(dcT), reverse=reverse,
                                interpret=True)
    xt, wit, wht, bt = (torch.from_numpy(a).to(dtype) for a in (xs, w_ih, w_hh, b))
    lt = torch.from_numpy(np.asarray(lengths, np.int64))
    _, _, hprev, cprev, gates = t_lstm.lstm_scan_train_plain(xt, lt, wit, wht, bt, reverse)
    got = t_lstm.lstm_scan_bwd_emulated(xt, lt, wit, wht, gates, hprev, cprev,
                                        *(torch.from_numpy(a) for a in (d_out, dhT, dcT)),
                                        reverse=reverse)
    assert got[0].dtype == dtype
    return got, [np.asarray(jnp.asarray(w, jnp.float32)) for w in want]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_bwd_split_tf32_matches_jax(prec, reverse):
    """K2's arithmetic as its kernels cut it (``lstm_scan_bwd_emulated``):
    the walk's TF32 products with split operands on the tensor cores and
    its per-block partials summed in rank order; the GEMMs in f32 as split
    TF32 products, in bf16 as the wgmma launches' exact products of bf16
    terms (da and hprev as three); dW over the plan's splits in rank
    order; against the Pallas backward in interpret mode from the same
    inputs: d_xs within 1e-3 in bf16 (da split, as the reference's f32
    product needs: one bf16 ulp, 2^-8 relative, is 3.9e-3; da unsplit gave
    1.95e-3 here) and 1e-4 in f32, dW_ih, dW_hh and db 1e-4, each times
    max(1, max |JAX|)."""
    lengths = np.array([7, 1, 4, 0, 6], np.int64)
    got, want = _bwd_emulated_and_jax(prec, reverse, 5, 7, 32, 32, lengths)
    rtols = (1e-3 if prec == "bf16" else 1e-4, 1e-4, 1e-4, 1e-4)
    for g, w, rtol in zip(got, want, rtols):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rtol * max(1.0, float(np.abs(w).max())))


def test_lstm_bwd_bf16_d_xs_rounds_like_jax():
    """At 16 x 20 x 64 x 64, bf16 d_xs equals the Pallas backward's in all
    but under 1% of its elements: both round one f32 product to bf16 once,
    so they differ only where the sums straddle a rounding boundary (da
    unsplit differed in 6.2%)."""
    rng = np.random.default_rng(4)
    lengths = np.concatenate([[20, 0], rng.integers(1, 21, 14)]).astype(np.int64)
    got, want = _bwd_emulated_and_jax("bf16", False, 16, 20, 64, 64, lengths)
    differ = float((got[0].float().numpy() != want[0]).mean())
    assert differ < 0.01, f"{differ:.2%} of bf16 d_xs elements differ from JAX"
