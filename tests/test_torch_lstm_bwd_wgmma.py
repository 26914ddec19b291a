"""K2's input-side GEMMs on the bf16 route (``csrc/lstm_scan.cu``: the
pack launch, ``dx_wgmma_kernel``, ``dw_wgmma_kernel``), on the CPU.

* ``lstm_scan_bwd_emulated`` in bf16 (da and hprev as three bf16 terms,
  exact products summed in f32, dW over ``wg_split_bounds``' splits and
  ``DW_TERM_PRODUCTS``) against the Pallas backward in interpret mode, in
  both directions, at ragged lengths with a 0 and a full row, at shapes
  whose tiles are partial (D and H not multiples of 128) and whose steps
  split several ways; d_xs rounded to bf16 like JAX's in all but under 1%
  of its elements.
* ``packed_rows`` (the pack launch's row of each sequence row) against
  ``valid_steps``: every valid step at its number, every packed row
  filled once.
* The plan: every output tile and every valid step covered exactly once,
  the split bounds on K-tile boundaries, shared memory within the H100's
  232,448 bytes at every bf16 shape of the paths, the TMA boxes inside
  their tensors; and the three term products that dW_hh leaves out below
  the tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_bwd_pallas,
                                                                  lstm_scan_train_pallas)

torch.set_num_threads(2)

MAX_SMEM = 232448  # shared memory a block can use on the H100
# (B, L, D, H) of K2 on the paths in bf16: EnvDrop's encoder, the agents'
# (the Follower's 300-wide rows padded to 304), the Self-Monitor's, the
# speaker's two layers, at their largest B and at a short last tile
PATH_SHAPES = [(64, 80, 256, 256), (61, 80, 256, 256), (64, 80, 304, 128), (64, 80, 256, 128),
               (64, 80, 256, 512), (40, 80, 256, 512), (1, 80, 256, 512), (64, 35, 2176, 256),
               (61, 35, 2176, 256), (64, 35, 512, 256), (100, 80, 64, 96)]
_RNG = np.random.default_rng(17)
LENGTH_SETS = {
    "ragged": [9, 0, 3, 9, 1, 6],
    "full": [9] * 6,
    "empty": [0] * 6,
    "path": _RNG.integers(1, 10, 6).tolist(),
}


def _emulated_and_jax(reverse, B, L, D, H, lengths, seed=3):
    """K2's emulated bf16 outputs and the Pallas backward's, from the same
    numpy-seeded inputs and the Pallas forward's carries."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    w_ih, w_hh, b = u(D, 4 * H), u(H, 4 * H), u(4 * H)
    d_out = rng.standard_normal((B, L, H)).astype(np.float32)
    dhT, dcT = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    xj, wij, whj, bj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (xs, w_ih, w_hh, b))
    lj = jnp.asarray(lengths, jnp.int32)
    _, _, hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj, reverse=reverse,
                                              interpret=True)
    want = lstm_scan_bwd_pallas(xj, lj, wij, whj, bj, hp_j, cp_j, jnp.asarray(d_out),
                                jnp.asarray(dhT), jnp.asarray(dcT), reverse=reverse,
                                interpret=True)
    xt, wit, wht, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (xs, w_ih, w_hh, b))
    lt = torch.from_numpy(np.asarray(lengths, np.int64))
    _, _, hprev, cprev, gates = t_lstm.lstm_scan_train_plain(xt, lt, wit, wht, bt, reverse)
    got = t_lstm.lstm_scan_bwd_emulated(xt, lt, wit, wht, gates, hprev, cprev,
                                        *(torch.from_numpy(a) for a in (d_out, dhT, dcT)),
                                        reverse=reverse)
    assert got[0].dtype == torch.bfloat16
    return got, [np.asarray(jnp.asarray(w, jnp.float32)) for w in want]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(6, 9, 200, 64), (6, 9, 136, 96)])
@pytest.mark.parametrize("name", ["ragged", "full", "empty"])
def test_bf16_wgmma_emulation_matches_jax(name, shape, reverse):
    """The wgmma launches' arithmetic against the Pallas backward: dW_ih,
    dW_hh and db within 1e-4, d_xs within one bf16 ulp of its largest
    element, 2^-8 (both round an f32 sum to bf16 once: a sum that straddles
    a rounding boundary flips one ulp, which at |d_xs| >= 0.25 exceeds
    ``test_lstm_bwd_split_tf32_matches_jax``'s 1e-3; the rounds-like-JAX
    test counts those flips), each times max(1, max |JAX|); the padded
    steps' d_xs 0."""
    B, L, D, H = shape
    lengths = np.asarray(LENGTH_SETS[name], np.int64)
    got, want = _emulated_and_jax(reverse, B, L, D, H, lengths)
    for g, w, rtol in zip(got, want, (2.0 ** -8, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rtol * max(1.0, float(np.abs(w).max())))
    pad = np.arange(L)[None, :] >= lengths[:, None]
    assert (got[0].float().numpy()[pad] == 0).all()


def test_bf16_wgmma_d_xs_rounds_like_jax():
    """At 16 x 20 x 144 x 64 over ragged lengths with a 0 and a 20, bf16
    d_xs equals the Pallas backward's in all but under 1% of its elements:
    both round one f32 sum of (nearly) exact products to bf16 once."""
    rng = np.random.default_rng(5)
    lengths = np.concatenate([[20, 0], rng.integers(1, 21, 14)]).astype(np.int64)
    got, want = _emulated_and_jax(False, 16, 20, 144, 64, lengths, seed=8)
    differ = float((got[0].float().numpy() != want[0]).mean())
    assert differ < 0.01, f"{differ:.2%} of bf16 d_xs elements differ from JAX"


@pytest.mark.parametrize("name", sorted(LENGTH_SETS))
@pytest.mark.parametrize("L", [9, 12])
def test_packed_rows_follow_the_valid_steps(name, L):
    """The pack launch fills packed row ``valid_steps``' number of (b, t)
    from each valid step, and from each padded step a row past the valid
    ones, row by row: every packed row [0, B L) once."""
    lengths = LENGTH_SETS[name]
    B = len(lengths)
    rows = t_lstm.packed_rows(lengths, L)
    steps = t_lstm.valid_steps(lengths, L)
    Mv = len(steps)
    assert sorted(rows) == list(range(B * L))
    for v, (b, t) in enumerate(steps):
        assert rows[b * L + t] == v
    padded = [rows[b * L + t] for b in range(B) for t in range(L) if t >= min(lengths[b], L)]
    assert padded == list(range(Mv, B * L))


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_wgmma_plan_covers_tiles_and_steps(shape):
    """Every d_xs element of a valid step in one dx tile; every dW_ih and
    dW_hh element in one dw tile, each of its rows summed by one block of
    the tile's cluster; the valid steps cut into the splits on K-tile
    boundaries; shared memory within the H100's: one dx block an SM, two
    dw blocks."""
    B, L, D, H = shape
    plan = t_lstm.lstm_scan_bwd_plan(B, L, D, H, 2, clusters_at_once=7)
    assert plan.gemm == "wgmma" and plan.dw_blocks_per_sm == 2
    assert max(plan.rec_smem, plan.dx_smem, plan.dw_smem) <= MAX_SMEM
    assert plan.dx_smem == t_lstm.wg_smem(B, t_lstm.WG_DX_RING)
    assert plan.dw_smem == t_lstm.wg_smem(B, t_lstm.WG_DW_RING)
    assert 2 * plan.dw_smem <= MAX_SMEM < 2 * plan.dx_smem
    assert plan.pack_grid * t_lstm.PACK_WARPS >= B * L > (plan.pack_grid - 1) * t_lstm.PACK_WARPS
    assert plan.pack_elems == B * L * (D + 15 * H)
    # dx: column tiles over D, step tiles over every possible valid step,
    # K split on K-tile boundaries, each split at least one K-tile
    nx, ny, sx = plan.dx_grid
    assert (nx - 1) * t_lstm.WG_N < D <= nx * t_lstm.WG_N
    assert (ny - 1) * t_lstm.WG_M < B * L <= ny * t_lstm.WG_M
    nk = 4 * H // t_lstm.WG_DX_K
    assert sx in (1, 2, 4, 8) and sx <= nk and t_lstm.WG_M % sx == 0
    ks = [nk * s // sx for s in range(sx + 1)]
    assert ks[0] == 0 and ks[-1] == nk and all(a < b for a, b in zip(ks, ks[1:]))
    # dw: dW_hh's tiles, then dW_ih's, each element once
    tiles, S, one = plan.dw_grid
    assert one == 1 and S == plan.splits in (1, 2, 4, 8) and t_lstm.WG_M % S == 0
    H4 = 4 * H
    seen = {"ih": np.zeros((D, H4), np.int64), "hh": np.zeros((H, H4), np.int64)}
    tj = H4 // t_lstm.WG_N
    tih = -(-H // t_lstm.WG_M)
    for x in range(tiles):
        hh = x < tih * tj
        tile = x if hh else x - tih * tj
        i0, j0 = tile // tj * t_lstm.WG_M, tile % tj * t_lstm.WG_N
        for s in range(S):  # block s of the cluster writes rows [s M / S, (s + 1) M / S)
            r0 = i0 + s * t_lstm.WG_M // S
            seen["hh" if hh else "ih"][r0:r0 + t_lstm.WG_M // S, j0:j0 + t_lstm.WG_N] += 1
    assert (seen["ih"] == 1).all() and (seen["hh"] == 1).all()
    assert tiles == t_lstm.dw_tiles(D, H)
    for Mv in (0, 1, t_lstm.WG_DW_K, B * L // 3, B * L):
        bounds = t_lstm.wg_split_bounds(Mv, S)
        assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == Mv
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
        assert all(v0 % t_lstm.WG_DW_K == 0 and v0 <= v1 for v0, v1 in bounds)


@pytest.mark.parametrize("shape", [(64, 35, 2176, 256), (6, 9, 200, 64), (64, 80, 304, 128),
                                   (3, 5, 64, 32)])
def test_wgmma_tma_boxes_inside_their_tensors(shape):
    """The maps (X, Hprev's and da's terms) tile the pack's scratch
    exactly, with whole 16-byte rows (TMA's rule); every box the launches
    ask for is 64 wide (128 bytes, the swizzle's width) and starts on its
    map's grid of boxes, inside the map or, on a tile's second half at a
    ragged edge, past it (TMA then fills zeros); and every row a dw box
    reads past the valid steps is one of the pack's zero rows or lies past
    the map: no padded step is multiplied."""
    B, L, D, H = shape
    P, Mv = B * L, (B * L * 2) // 3
    dims, boxes = t_lstm.wg_tma_boxes(B, L, D, H, Mv)
    pack = t_lstm.lstm_scan_bwd_plan(B, L, D, H, 2, clusters_at_once=7).pack_elems
    assert sum(c * r * n for name, (c, r, n, _) in dims.items()
               if name in ("x", "hprev", "da")) == pack
    assert dims["w_ih"][:3] == (4 * H, D, 1) and dims["da_dw"][:3] == dims["da"][:3]
    for cols, rows, terms, box_rows in dims.values():
        assert cols * 2 % 16 == 0 and rows > 0 and terms in (1, 3)
        assert box_rows in (t_lstm.WG_DX_K, t_lstm.WG_DW_K) and box_rows <= 256
    assert boxes
    zero_end = min(P, -(-Mv // t_lstm.WG_DW_K) * t_lstm.WG_DW_K)
    for name, (c0, c1, term) in boxes:
        cols, rows, terms, box_rows = dims[name]
        assert c0 % 64 == 0 and c1 % box_rows == 0 and 0 <= term < terms
        assert 0 <= c0 < -(-cols // 128) * 128 and 0 <= c1 < -(-rows // 128) * 128
        assert c0 < cols or c0 % 128 == 64  # wholly past the map: a tile's second half only
        if name in ("x", "hprev", "da_dw"):  # a dw K-tile, along the steps
            assert all(r < zero_end or r >= rows for r in range(max(c1, Mv), c1 + box_rows))


@pytest.mark.parametrize("B, L, D, H, S", [(64, 35, 2176, 256, 1), (64, 80, 256, 256, 2),
                                           (64, 80, 256, 512, 2), (64, 35, 512, 256, 2),
                                           (64, 80, 304, 128, 1), (1, 80, 256, 512, 8),
                                           (2, 5, 64, 32, 2)])
def test_dx_splits_fill_most_of_a_wave(B, L, D, H, S):
    """K splits of d_xs: none for the speaker's 306 tiles or the Follower's
    120, 2 for EnvDrop's, the Self-Monitor's and the speaker's second
    layer's 72-80 tiles, 8 for the Self-Monitor at B = 1 (2 tiles of 32
    K-tiles), and never more than the K-tiles (H = 32: 2)."""
    plan = t_lstm.lstm_scan_bwd_plan(B, L, D, H, 2, clusters_at_once=7)
    assert plan.dx_grid[2] == S
    tiles = plan.dx_grid[0] * plan.dx_grid[1]
    nk = 4 * H // t_lstm.WG_DX_K
    assert tiles * S * 10 >= 7 * t_lstm.WG_SMS or S in (8, nk)


@pytest.mark.parametrize("D, H, S", [(2176, 256, 4), (256, 256, 8), (256, 512, 2),
                                     (512, 256, 4), (304, 128, 8), (256, 128, 8)])
def test_dw_splits_fill_most_of_a_wave(D, H, S):
    """The splits the H100 ran fastest at the bf16 path shapes, of 1, 2, 4
    and 8 (EnvDrop's 32 tiles at 17-80 tokens): the Self-Monitor's 96
    tiles split 2 ways, the speaker's second layer's 48 and its first's
    152 4 ways (2 would fill 70% of a wave of two blocks an SM, 264, but
    leave a second wave of 40), EnvDrop's 32 8 ways; the Follower's 16 and
    12 tiles the most, 8."""
    tiles = t_lstm.dw_tiles(D, H)
    assert t_lstm.dw_splits(tiles) == S
    wave = 2 * t_lstm.WG_SMS
    assert tiles * S * 10 >= 7 * wave or S == 8
    first = S if S == 1 or tiles * (S // 2) * 10 < 7 * wave else S // 2
    assert S == first or wave < tiles * first <= 1.5 * wave


def test_dw_hh_dropped_term_products_are_below_the_tolerance():
    """dW_hh takes the six products Hp_i da_j with i + j <= 4; the three
    left out ((2, 3), (3, 2), (3, 3)) change it by under 1e-6 of max |dW_hh|
    at 2,240 steps of the speaker's scale, far inside K2's 1e-4."""
    g = torch.Generator().manual_seed(0)
    hp = torch.tanh(torch.randn(2240, 256, generator=g))
    da = torch.randn(2240, 1024, generator=g) * 0.05
    ht = [t.float() for t in t_lstm.split_bf16x3(hp)]
    dt = [t.float() for t in t_lstm.split_bf16x3(da)]
    kept = sum(ht[i].t() @ dt[j] for i, j in t_lstm.DW_TERM_PRODUCTS[3])
    dropped = sum(ht[i].t() @ dt[j] for i, j in ((1, 2), (2, 1), (2, 2)))
    exact = hp.double().t() @ da.double()
    scale = float(exact.abs().max())
    assert float(dropped.abs().max()) < 1e-6 * scale
    assert float((kept.double() - exact).abs().max()) < 1e-5 * scale
    assert sorted(i + j for i, j in t_lstm.DW_TERM_PRODUCTS[3]) == [0, 1, 1, 2, 2, 2]
