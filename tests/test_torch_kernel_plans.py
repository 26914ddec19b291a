"""Launch geometry of the port's redesigned kernels, on the CPU.

K8 (``ops/cuda/lstm_cell.py::lstm_cell_plan``) and K6
(``ops/cuda/cand_score.py::cand_score_plan``) take their grid, cluster, K
boxes and shared-memory bytes from pure functions, which the C entry
points are given.  These tests hold those functions to what the kernels
assume: every K row in exactly one box of one CTA of a cluster, every gate
column in exactly one N tile, every batch row in one M tile, every
(sample, candidate) pair in exactly one warp, and shared memory within the
H100's 232,448 bytes a block.  ``test_lstm_cell_split_k_matches_jax``
replays K8's split-K sums box by box and CTA by CTA in f32, in the
kernel's order, against the JAX cell, so the slicing (the x/h boundary,
ragged boxes at the ends of x and h) is checked where no card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import cand_score as t_cand
from curriculum_learning_for_vln_torch.ops.cuda import lstm_cell as t_cell
from curriculum_learning_for_vln_tpu.ops.pallas.lstm import lstm_cell_pallas

torch.set_num_threads(2)

ELEM = {"bf16": 2, "f32": 4}
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
