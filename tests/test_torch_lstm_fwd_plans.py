"""The LSTM scan's forward kernels (K3, K1) as ``csrc/lstm_scan.cu`` cuts
them, on the CPU.

``lstm_scan_fwd_emulated`` replays the kernels' arithmetic: x . W_ih in
the kernel's precision (exact bf16 products, or TF32 with both f32
operands split) and the step product h . W_hh per block of a cluster in
TF32 with h split into two halves.  It is held against the Pallas
forward kernels in interpret mode, from the same numpy-seeded inputs,
within the tolerance ``chip_smoke.py`` holds the kernels to.
``lstm_scan_fwd_plan`` gives the launch geometry; the plan tests hold it
to what the kernels assume: shared memory and the W_hh fragments'
registers within the H100's, every valid step in one gates_x tile, every
gate column of W_hh in exactly one (block, warp, fragment row), and every
(row, unit) cell in exactly one lane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_pallas,
                                                                  lstm_scan_train_pallas)

torch.set_num_threads(2)

MAX_SMEM = 232448  # shared memory a block can use on the H100
MAX_REGS = 255     # registers a thread can hold
REGS_PER_SM = 65536
DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32}
JDTYPE = {"bf16": jnp.bfloat16, "f32": jnp.float32}
L, D, H = 7, 48, 64
# lengths with 0, L and one past L (clamped), at a batch that is not a multiple of 8
LENGTHS = {5: [L, 1, 4, 0, 6], 13: [0, L, 3, L + 2, 1, 5, 0, 6, 2, L, 4, 1, 3]}


def _inputs(B, prec):
    rng = np.random.default_rng(7 + B)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    return xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)


@pytest.mark.parametrize("B", sorted(LENGTHS))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_fwd_emulated_matches_jax(prec, reverse, B):
    """outs, hT, cT (K3 and K1), hprev, cprev and the gate pre-activations
    at the valid steps (K1), within 1e-4 x max(1, max |JAX|): f32 state
    from the same rounded operands, the sums in another order."""
    lengths = np.array(LENGTHS[B], np.int64)
    arrs = _inputs(B, prec)
    xj, wij, whj, bj = (jnp.asarray(a).astype(JDTYPE[prec]) for a in arrs)
    lj = jnp.asarray(lengths, jnp.int32)
    out_j, (h_j, c_j) = lstm_scan_pallas(xj, lj, wij, whj, bj, reverse=reverse, interpret=True)
    tout_j, (th_j, tc_j), hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj,
                                                              reverse=reverse, interpret=True)
    # the pre-activations the kernel keeps, from the Pallas carries: the
    # forward's own f32 dots
    f32 = jnp.float32
    gates_j = (jnp.einsum("bld,dg->blg", xj, wij, preferred_element_type=f32)
               + jnp.einsum("lbh,hg->blg", hp_j, whj.astype(f32), preferred_element_type=f32)
               + bj.astype(f32))
    xt, wit, wht, bt = (torch.from_numpy(a).to(DTYPE[prec]) for a in arrs)
    outs, (hT, cT), hprev, cprev, gates = t_lstm.lstm_scan_fwd_emulated(
        xt, torch.from_numpy(lengths), wit, wht, bt, reverse=reverse)
    valid = np.arange(L)[None, :] < lengths[:, None]
    pairs = [(outs, out_j), (hT, h_j), (cT, c_j), (outs, tout_j), (hT, th_j), (cT, tc_j),
             (hprev, hp_j), (cprev, cp_j), (gates.numpy()[valid], np.asarray(gates_j)[valid])]
    for got, want in pairs:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_fwd_emulated_is_the_plain_forward(prec):
    """The emulation and the plain twin, which the card's checks compare
    the kernel with, agree to f32 rounding at the same ragged lengths."""
    B = 13
    lengths = torch.tensor(LENGTHS[B])
    args = [torch.from_numpy(a).to(DTYPE[prec]) for a in _inputs(B, prec)]
    got = t_lstm.lstm_scan_fwd_emulated(args[0], lengths, *args[1:], reverse=True)
    want = t_lstm.lstm_scan_train_plain(args[0], lengths, *args[1:], reverse=True)
    for g, w in zip((got[0], *got[1], got[2], got[3]), (want[0], *want[1], want[2], want[3])):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [1, 61, 100, 512])
@pytest.mark.parametrize("H", [32, 96, 256])
def test_lstm_scan_fwd_plan_fits_the_h100(B, H):
    """Shared memory of both launches within a block's, and the W_hh
    fragments within a thread's registers with room for the rest (the
    step's accumulators and fragments: ~64), at 256 threads a block."""
    for elem in (2, 4):
        plan = t_lstm.lstm_scan_fwd_plan(B, 80, 256, H, elem)
        assert max(plan.gx_smem, plan.rec_smem) <= MAX_SMEM
        assert plan.w_regs + 64 <= MAX_REGS and t_lstm.THREADS * MAX_REGS <= REGS_PER_SM
        assert 1 <= plan.rec_warps <= t_lstm.WARPS and plan.rec_warps * 16 == 4 * H // t_lstm.CL
        assert plan.w_regs >= 4 * (H // 8)  # every k-step of the product a register set


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_lstm_scan_fwd_plan_at_the_path_shape(prec):
    """B = 64, L = 80, D = H = 256: gates_x in 16 column tiles by 32 blocks
    along the steps (the 80 tiles of 5,120 steps in three rounds, the 16
    of the path's ~1,000 valid steps in one); the walk in 8 clusters of 8
    blocks, all 8 warps holding an m-tile, 128 fragment registers a
    thread; 167 KB of shared memory a block (W_hh's 128 KB fragments)."""
    plan = t_lstm.lstm_scan_fwd_plan(64, 80, 256, 256, {"bf16": 2, "f32": 4}[prec])
    assert plan.gx_grid == (16, 32) and plan.rec_grid == 64
    assert plan.rec_warps == 8 and plan.w_regs == 128
    assert plan.rec_smem == 166928 and plan.gx_smem == 272 + 256 + 3 * 18432


def _valid_sets():
    rng = np.random.default_rng(3)
    return {"path": rng.integers(11, 21, 64).tolist(),
            "long": [80] + rng.integers(16, 81, 63).tolist(),
            "ragged": [80, 80, 0, 17, 80, 1, 0, 33],
            "past_L": [90, 3, 80], "empty": [0, 0, 0],
            "b61": [0] + rng.integers(0, 81, 60).tolist()}


@pytest.mark.parametrize("name", sorted(_valid_sets()))
def test_gates_x_grid_covers_the_valid_steps(name):
    """Block y of gates_x takes valid steps [y' GX_TM, +GX_TM) of the
    numbering ``valid_steps`` gives, for y' = y, y + Y, ... below their
    count: every valid step in one tile whatever the lengths; and the
    valid steps are exactly the (b, t) that the walk of either direction
    computes."""
    lengths, L_ = _valid_sets()[name], 80
    B = len(lengths)
    plan = t_lstm.lstm_scan_fwd_plan(B, L_, 256, 256, 2)
    steps = t_lstm.valid_steps(lengths, L_)
    seen = {}
    Y = plan.gx_grid[1]
    assert 1 <= Y <= t_lstm.GX_YMAX
    for y in range(Y):
        for v0 in range(y * t_lstm.GX_TM, len(steps), Y * t_lstm.GX_TM):
            for v in range(v0, min(v0 + t_lstm.GX_TM, len(steps))):
                seen[steps[v]] = seen.get(steps[v], 0) + 1
    assert len(seen) == len(steps) and set(seen.values()) <= {1}
    lens = [max(0, min(n, L_)) for n in lengths]
    # a cluster walks to its longest row; step l reads t = maxlen - 1 - l when reversed
    for reverse in (False, True):
        walk = set()
        for q in range(-(-B // t_lstm.R)):
            rows = range(q * t_lstm.R, min((q + 1) * t_lstm.R, B))
            maxlen = max(lens[b] for b in rows)
            for l in range(maxlen):
                t = maxlen - 1 - l if reverse else l
                walk |= {(b, t) for b in rows if t < lens[b]}
        assert walk == set(steps)
    assert plan.gx_grid[0] * t_lstm.GX_TN == 4 * 256


@pytest.mark.parametrize("H", [32, 96, 256])
def test_recurrence_owns_every_column_and_cell_once(H):
    """Block ``rank``'s warp w holds m-tile rows 4u + g = gate g of unit
    rank U + 4w + u (u < 4), the fragment order of the staging loop; lane l
    of warp w owns the cell (row l % 8, unit rank U + 4w + l / 8) and sends
    rows 4 (l % 2).. of unit l % 8 / 2 to blocks l / 8 and l / 8 + 4: every
    gate column of W_hh in one (block, warp, row), every cell of a
    cluster's R rows in one lane, every (unit, row quad) of h to every
    block once."""
    CL, R = t_lstm.CL, t_lstm.R
    U = H // CL
    plan = t_lstm.lstm_scan_fwd_plan(8, 4, 64, H, 2)
    cols = np.zeros(4 * H, np.int64)
    cells = np.zeros((R, H), np.int64)
    sent = np.zeros((CL, H, 2), np.int64)  # destination block, unit, row quad
    for rank in range(CL):
        for w in range(plan.rec_warps):
            for m in range(16):
                g, u = m % 4, m // 4
                cols[g * H + rank * U + 4 * w + u] += 1
            for lane in range(32):
                cells[lane % 8, rank * U + 4 * w + lane // 8] += 1
                su, sq = (lane % 8) // 2, lane % 2
                for d in range(lane // 8, CL, 4):
                    sent[d, rank * U + 4 * w + su, sq] += 1
    assert (cols == 1).all() and (cells == 1).all() and (sent == 1).all()
    # the bytes a block receives a step, which its mbarrier expects
    assert sent[0].sum() * 4 * 4 == H * R * 4
