"""K1-K3 at the Follower's and the Self-Monitor's encoder shapes, on the CPU.

The Self-Monitor's encoder is one LSTM at H = 512 a direction, past the
256 up to which a block keeps its eighth of W_hh in registers and shared
memory: ``csrc/lstm_scan.cu``'s bf16 walks there (forward and backward)
keep a sixteenth a block in registers (clusters of 16, the resident
walks), its other wide walks stream it every step from a copy that
``pack_whh_kernel`` lays out in fragment order (``lstm_scan.whh_pack_order``).  The Follower's first layer reads 300-wide
bf16 embeddings, 600-byte rows that the kernels' 16-byte loads cannot
take: the wrappers zero-pad them (``lstm_scan.pad_rows``) and cut d_xs and
dW_ih back.

* ``lstm_scan_fwd_emulated`` and ``lstm_scan_bwd_emulated`` (the
  kernels' arithmetic: per-block split-TF32 step products, or the resident
  walks' three bf16 terms of h summed by k-group and of da summed by
  block, the plans' GEMM orders)
  at H = 512, at H = 384 bf16 (the streaming forward) and at D = 300 bf16,
  against the Pallas kernels in interpret mode, from the same numpy-seeded
  inputs, at small B and L;
  the tolerances of ``tests/test_torch_lstm_fwd_plans.py`` (1e-4 x max(1,
  max |JAX|)) and ``tests/test_torch_kernel_plans.py`` (d_xs 1e-3 in
  bf16, 1e-4 in f32; dW and db 1e-4);
* ``pad_rows`` is exact: the plain forward and backward of the padded
  inputs, cut back, equal those of the unpadded ones;
* the wide plans: shared memory within the H100's, 512 threads; the bf16
  walks at H = 512 keep W_hh in registers (clusters of 16, nothing
  streamed), the other wide walks stream it (one warp an m-tile in the
  forward, two m-tiles a warp in the backward); and the pack order is a
  permutation of W_hh whose fragments are those of the streaming walks'
  tiles.  ``tests/test_torch_lstm_res.py`` and
  ``tests/test_torch_lstm_res_bwd.py`` hold the resident walks' plans.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_bwd_pallas,
                                                                  lstm_scan_pallas,
                                                                  lstm_scan_train_pallas)

torch.set_num_threads(2)

MAX_SMEM = 232448  # shared memory a block can use on the H100
DTYPE = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
L = 4
LENGTHS = np.array([L, 1, 0], np.int64)  # a full row, a short one and an empty one
# (prec, D, H): the Self-Monitor's H = 512 in both dtypes, the Follower's 300-wide bf16 rows
SHAPES = [("f32", 32, 512), ("bf16", 32, 512), ("bf16", 300, 32), ("bf16", 32, 384)]


def _inputs(D, H, seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    B = len(LENGTHS)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    cot = [rng.standard_normal((B, L, H)).astype(np.float32),
           *(rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))]
    return (xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)), cot


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec,D,H", SHAPES)
def test_wide_and_padded_emulation_matches_jax(prec, D, H, reverse):
    """K3/K1's outputs and residuals at the valid steps, and K2's gradients,
    as the kernels compute them, against the Pallas kernels."""
    dt, jdt = DTYPE[prec]
    arrs, cot = _inputs(D, H, 7 + D + H)
    xj, wij, whj, bj = (jnp.asarray(a).astype(jdt) for a in arrs)
    lj = jnp.asarray(LENGTHS, jnp.int32)
    out_j, (h_j, c_j) = lstm_scan_pallas(xj, lj, wij, whj, bj, reverse=reverse, interpret=True)
    _, _, hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj, reverse=reverse,
                                              interpret=True)
    grads_j = lstm_scan_bwd_pallas(xj, lj, wij, whj, bj, hp_j, cp_j,
                                   *(jnp.asarray(c) for c in cot), reverse=reverse,
                                   interpret=True)
    xt, wit, wht, bt = (torch.from_numpy(a).to(dt) for a in arrs)
    lt = torch.from_numpy(LENGTHS)
    outs, (hT, cT), hprev, cprev, gates = t_lstm.lstm_scan_fwd_emulated(xt, lt, wit, wht, bt,
                                                                        reverse=reverse)
    for got, want in ((outs, out_j), (hT, h_j), (cT, c_j), (hprev, hp_j), (cprev, cp_j)):
        _close(got, want, 1e-4)
    grads = t_lstm.lstm_scan_bwd_emulated(xt, lt, wit, wht, gates, hprev, cprev,
                                          *(torch.from_numpy(c) for c in cot), reverse=reverse)
    assert grads[0].dtype == dt
    for got, want, rtol in zip(grads, grads_j, (1e-3 if prec == "bf16" else 1e-4, 1e-4, 1e-4,
                                                1e-4)):
        _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), rtol)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_pad_rows_is_exact(prec):
    dt = DTYPE[prec][0]
    (xs, w_ih, w_hh, b), (d_out, dhT, dcT) = _inputs(300, 32, 3)
    xs, w_ih, w_hh, b = (torch.from_numpy(a).to(dt) for a in (xs, w_ih, w_hh, b))
    xp, wp = t_lstm.pad_rows(xs, w_ih)
    assert xp.shape[-1] * xp.element_size() % 16 == 0 and wp.shape[0] == xp.shape[-1]
    assert torch.equal(xp[..., :300], xs) and not xp[..., 300:].any() and not wp[300:].any()
    lt = torch.from_numpy(LENGTHS)
    f_pad = t_lstm.lstm_scan_train_plain(xp, lt, wp, w_hh, b)
    f_ref = t_lstm.lstm_scan_train_plain(xs, lt, w_ih, w_hh, b)
    for g, w in zip((f_pad[0], *f_pad[1], *f_pad[2:]), (f_ref[0], *f_ref[1], *f_ref[2:])):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    cot = [torch.from_numpy(c) for c in (d_out, dhT, dcT)]
    g_pad = t_lstm.lstm_scan_bwd_plain(xp, lt, wp, w_hh, f_ref[4], f_ref[2], f_ref[3], *cot)
    g_ref = t_lstm.lstm_scan_bwd_plain(xs, lt, w_ih, w_hh, f_ref[4], f_ref[2], f_ref[3], *cot)
    assert not g_pad[0][..., 300:].float().any() and not g_pad[1][300:].any()
    torch.testing.assert_close(g_pad[0][..., :300].float(), g_ref[0].float(), rtol=0, atol=1e-6)
    torch.testing.assert_close(g_pad[1][:300], g_ref[1], rtol=0, atol=1e-6)
    for g, w in zip(g_pad[2:], g_ref[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


MAX_REGS_512 = 128  # registers a thread at 512 threads (65,536 an SM)
# cudaOccupancyMaxActiveClusters of the resident walk on an H100 80GB HBM3
# (132 SMs, one block an SM; test_torch_card_kernels.py's walk plans with -s
# print the card's own count)
H100_RES_CLUSTERS = 7


@pytest.mark.parametrize("B", [1, 61, 64, 512])
@pytest.mark.parametrize("H", [288, 384, 512])
def test_wide_plans_fit_the_h100(B, H):
    for elem in (2, 4):
        f = t_lstm.lstm_scan_fwd_plan(B, 80, 256, H, elem, H100_RES_CLUSTERS)
        b = t_lstm.lstm_scan_bwd_plan(B, 80, 256, H, elem, H100_RES_CLUSTERS)
        assert max(f.gx_smem, f.rec_smem, b.rec_smem, b.dx_smem, b.dw_smem) <= MAX_SMEM
        assert f.rec_threads == b.rec_threads == t_lstm.WT == 512
        if t_lstm.resident(H, elem):
            # clusters of 16, every warp holding its W_hh fragments for the
            # whole walk: all of W_hh in the cluster's registers once, 64 a
            # thread at most (the step's working set takes the rest of 128),
            # nothing streamed
            assert elem == 2 and H == 512 and f.w_where == "registers"
            assert f.cluster == 16 and 1 <= f.rows <= 16 and f.rec_warps == 16
            assert f.w_regs * 4 * f.rec_threads * f.cluster == H * 4 * H * elem
            assert f.w_regs <= MAX_REGS_512 // 2 and f.w_stream == f.w_pack == 0
            assert f.clusters == -(-B // f.rows)
        else:
            # forward: one warp an m-tile of 16 gate columns of the block's 4H / 8
            assert f.cluster == t_lstm.CL and f.rows == t_lstm.R
            assert f.rec_warps * 16 == 4 * H // t_lstm.CL and f.rec_warps <= t_lstm.WW
            assert f.w_regs == 0 and f.w_stream == 4 * H * H // t_lstm.CL * elem
            assert f.w_pack == 4 * H * H
            assert (H // 8) % t_lstm.WFQ == 0
        if t_lstm.resident(H, elem):
            # backward: the same clusters of 16 rows' cells, W_hh in
            # registers, nothing streamed or packed
            assert (b.cluster, b.w_where, b.w_stream, b.w_pack) == (16, "registers", 0, 0)
            assert b.clusters == -(-B // b.rows) and b.rec_grid == 16 * b.clusters
        else:
            assert b.w_stream == 4 * H * H // t_lstm.CL * elem and b.w_pack == 4 * H * H
            assert b.cluster == t_lstm.CL and b.w_where == "streamed from L2"
        # backward: a thread a (row, unit) cell, two m-tiles of the H units a warp
        assert t_lstm.R * H // t_lstm.CL <= t_lstm.WT and 2 * t_lstm.WW * 16 >= H
        # the step product's k-steps come in whole groups
        assert (H // 16) % t_lstm.WBQ == 0


def test_wide_plans_at_the_monitor_shape():
    """B = 64, L = 80, D = 256, H = 512.  bf16: the resident walk, W_hh in
    registers (64 a thread), nothing streamed; on the H100's 7 clusters of
    16 at once, 7 clusters of 10 rows (112 blocks) at B = 64, 7 of 9 at
    B = 61, 1 of 1 row at B = 1; the 139,264 B staged slice (over which h
    and the partials land) and the mbarriers of two row groups, 139,520 B
    of shared memory a block, or of one, 139,392.  f32: 8 clusters of 8 blocks streaming 512 KB of
    W_hh a step through 128 KB of rings.  The backward: in bf16 the
    resident walk on the same clusters, 139,296 B (two row groups) or
    139,280 B (one) of shared memory a block, nothing streamed; in f32 8
    clusters streaming 512 KB a step."""
    f = t_lstm.lstm_scan_fwd_plan(64, 80, 256, 512, 4)
    assert (f.cluster, f.rows, f.rec_grid, f.rec_warps) == (8, 8, 64, 16)
    assert f.rec_smem == 178192 and f.w_stream == 4 * 64 * 512 * 4
    for B, rows, clusters, smem in ((64, 10, 7, 139520), (61, 9, 7, 139520),
                                    (1, 1, 1, 139392)):
        f = t_lstm.lstm_scan_fwd_plan(B, 80, 256, 512, 2, H100_RES_CLUSTERS)
        assert (f.cluster, f.rows, f.clusters, f.rec_grid) == (16, rows, clusters, clusters * 16)
        assert f.rec_smem == smem and f.w_stream == 0 and f.w_regs == 64
    b = t_lstm.lstm_scan_bwd_plan(64, 80, 256, 512, 4)
    assert b.rec_grid == 64 and b.rec_smem == 196624
    assert b.w_stream == 4 * 64 * 512 * 4
    for B, rows, clusters, smem in ((64, 10, 7, 139296), (61, 9, 7, 139296), (1, 1, 1, 139280)):
        b = t_lstm.lstm_scan_bwd_plan(B, 80, 256, 512, 2, H100_RES_CLUSTERS)
        assert (b.cluster, b.rows, b.clusters, b.rec_grid) == (16, rows, clusters, clusters * 16)
        assert b.rec_smem == smem and b.w_stream == b.w_pack == 0
    # the padded Follower rows: D = 300 bf16 is planned as 304 (3 column tiles of 128)
    assert t_lstm.lstm_scan_bwd_plan(64, 80, 304, 128, 2).dx_grid[0] == 3


@pytest.mark.parametrize("H", [320, 512])
@pytest.mark.parametrize("bwd", [False, True])
def test_pack_order_is_the_walks_fragments(H, bwd):
    """Every element of W_hh in the pack once, and each fragment element
    where the walk's tile puts it: forward tiles A[c][k'] (row 4u + g the
    gate g of unit rank U + 4 mt + u, the cell layout of recurrence_kernel),
    backward tiles A[k'][c] over the block's gate-major columns."""
    order = t_lstm.whh_pack_order(H, bwd).numpy()
    assert np.array_equal(np.sort(order), np.arange(4 * H * H))
    U = H // t_lstm.CL
    MT, KS = (H // 16, U // 2) if bwd else (U // 4, H // 8)
    frag = order.reshape(t_lstm.CL, MT, KS, 8, 4, 4)  # rank, mt, ks, g, q, e
    rows, cols = frag // (4 * H), frag % (4 * H)
    g = np.arange(8)[:, None, None]
    q = np.arange(4)[None, :, None]
    e = np.arange(4)[None, None, :]
    m, k = g + 8 * (e & 1), q + 4 * (e >> 1)  # the element's tile row and column
    for rank in range(t_lstm.CL):
        for mt in range(MT):
            for ks in range(KS):
                r, c = rows[rank, mt, ks], cols[rank, mt, ks]
                if bwd:
                    kk = ks * 8 + k
                    assert (r == mt * 16 + m).all()
                    assert (c == (kk // U) * H + rank * U + kk % U).all()
                else:
                    assert (r == ks * 8 + k).all()
                    assert (c == (m % 4) * H + rank * U + 4 * mt + m // 4).all()
