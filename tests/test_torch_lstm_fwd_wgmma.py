"""K1/K3's input-side GEMM on the bf16 route (``csrc/lstm_scan.cu``:
gx_wgmma_kernel), on the CPU.

* ``lstm_scan_fwd_emulated`` in bf16 (exact products summed in f32 over
  ``gx_splits``' splits of K = D, the splits in rank order) against the
  Pallas forward kernels in interpret mode, in both directions, at ragged
  and full lengths, at shapes whose K is split 1, 2 and 4 ways and whose
  last K-tile is partial.
* The plan: every (valid step, gate column) in one block's tile, its K-tiles
  summed once over the splits, whatever the lengths, at the paths' bf16
  shapes; a block with a split of K has one step tile; the TMA boxes of
  W_ih and x inside their tensors (x's only where every step is valid) and
  the gathered chunks of x exactly the valid steps' rows below D, the last
  K-tile's part past D zero-filled; shared memory for two blocks an SM;
  the split rule at the paths' shapes.
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
_RNG = np.random.default_rng(18)


def _lengths(kind, B, L):
    """Token lengths: "full", "short" (11-20), "long" (16-L with an L),
    "beam" (1-L with an L), "ragged" (0-L with a 0 and an L)."""
    if kind == "full":
        return [L] * B
    if kind == "short":
        return _RNG.integers(11, 21, B).tolist()
    lo = {"long": 16, "beam": 1, "ragged": 0}[kind]
    out = _RNG.integers(lo, L + 1, B).tolist()
    out[0] = L
    if kind == "ragged" and B > 1:
        out[-1] = 0
    return out


# (B, L, D, H, lengths) of K1 and K3 on the paths in bf16: EnvDrop's encoder
# at 11-20 and 17-80 tokens, the Self-Monitor's, the Follower's two layers
# (300-wide rows padded to 304), the speaker's first layer at full lengths
# and its post-LSTM, the beam's rescoring, B = 61 with a 0 and an 80, B = 1
PATH_SHAPES = [(64, 80, 256, 256, "short"), (64, 80, 256, 256, "long"),
               (64, 80, 256, 512, "long"), (64, 80, 304, 128, "long"),
               (64, 80, 256, 128, "long"), (64, 35, 2176, 256, "full"),
               (64, 35, 512, 256, "full"), (30, 16, 2176, 256, "beam"),
               (61, 80, 256, 256, "ragged"), (61, 35, 2176, 256, "ragged"),
               (1, 80, 256, 512, "long")]


def _plan(B, L, D, H):
    return t_lstm.lstm_scan_fwd_plan(B, L, D, H, 2, clusters_at_once=t_lstm.H100_RES_CLUSTERS)


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_gx_plan_covers_steps_columns_and_k_once(shape):
    """Block (x, y, z) takes column tile x, step tiles y, y + Y, ... below
    the valid steps and K-tiles [nk z / S, nk (z + 1) / S): every valid
    step's every gate column gets each K-tile once; with a split of K a
    block has one step tile (its partial is summed by its cluster); the
    valid steps are ``valid_steps``' (b, t), each once."""
    B, L, D, H, kind = shape
    lengths = _lengths(kind, B, L)
    plan = _plan(B, L, D, H)
    assert plan.gemm == "wgmma" and plan.gx_blocks_per_sm == 2
    nt, Y, S = plan.gx_grid
    WM, WN = t_lstm.WG_M, t_lstm.WG_N
    mt, nk = -(-B * L // WM), -(-D // t_lstm.WG_DX_K)
    assert nt * WN == 4 * H and Y == t_lstm.gx_rows(nt, mt, S) and 1 <= Y <= mt
    assert S == t_lstm.gx_splits(nt * mt, nk) and (S == 1 or Y == mt)
    steps = t_lstm.valid_steps(lengths, L)
    Mv = len(steps)
    assert len(set(steps)) == Mv == sum(max(0, min(n, L)) for n in lengths)
    cover = np.zeros((Mv, nt, nk), np.int64)
    for y in range(Y):
        tiles = list(range(y, -(-Mv // WM), Y))
        assert S == 1 or len(tiles) <= 1
        for z in range(S):
            ks = slice(nk * z // S, nk * (z + 1) // S)
            assert ks.start < ks.stop  # every split has a K-tile
            for t in tiles:
                cover[t * WM:(t + 1) * WM, :, ks] += 1  # every column tile x alike
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", PATH_SHAPES[:8] + [(3, 5, 64, 32, "ragged"),
                                                     (2, 7, 200, 64, "full")],
                         ids=lambda s: "-".join(map(str, s)))
def test_gx_loads_inside_their_tensors(shape):
    """The maps are whole 16-byte rows of W_ih [D][4H] and x [B L][D]
    (TMA's rule); every box is 64 wide (128 bytes, the swizzle's width) and
    64 deep, on its map's grid of boxes, inside the map or, on a tile's
    second half at a ragged edge, wholly past it (TMA then fills zeros);
    x's boxes only where every step is valid, and then over rows below B L
    of the valid steps' tiles; otherwise the gathered chunks are every
    valid step's row below D in chunks of 8, once for each column tile."""
    B, L, D, H, kind = shape
    lengths = _lengths(kind, B, L)
    Mv = len(t_lstm.valid_steps(lengths, L))
    P, nk = B * L, -(-D // t_lstm.WG_DX_K)
    dims, boxes, chunks = t_lstm.gx_loads(B, L, D, H, Mv)
    assert dims["w_ih"] == (4 * H, D, 1, 64) and dims["x"] == (D, P, 1, 64)
    for cols, rows, _, box in dims.values():
        assert cols * 2 % 16 == 0 and rows > 0 and box == t_lstm.WG_DX_K
    nt = 4 * H // t_lstm.WG_N
    seen_w = set()
    for block, got in boxes.items():
        for name, c0, c1 in got:
            cols, rows, _, box = dims[name]
            assert c0 % 64 == 0 and c1 % box == 0
            assert c0 < -(-cols // 128) * 128 and c1 < -(-rows // 128) * 128
            if name == "w_ih":
                assert c0 < cols and c1 < rows  # 4H is whole column tiles; K-tiles start below D
                seen_w.add((c0, c1))
            else:
                assert Mv == P and c0 < cols and (c1 < rows or c1 % 128 == 64)
    if Mv:
        assert seen_w == {(c, k) for c in range(0, 4 * H, 64) for k in range(0, nk * 64, 64)}
    if Mv == P:
        assert not chunks
        assert sum(name == "x" for got in boxes.values() for name, *_ in got) == \
            2 * nt * nk * -(-P // t_lstm.WG_M)
    else:
        assert not any(name == "x" for got in boxes.values() for name, *_ in got)
        assert sorted(chunks) == [(v, k) for v in range(Mv) for k in range(0, D, 8)]


@pytest.mark.parametrize("D", [304, 2176, 256])
def test_gx_last_k_tile_reads_zeros_past_d(D):
    """The last K-tile of D = 304 (the Follower's padded rows), 2176 (the
    speaker's) and 256: it starts below D, and its part past D (none at
    2176 and 256, 16 rows at 304) lies wholly past W_ih's rows, where TMA
    fills zeros, and past x's row, where the gather copies zeros."""
    nk = -(-D // t_lstm.WG_DX_K)
    k0 = (nk - 1) * t_lstm.WG_DX_K
    assert k0 < D <= k0 + t_lstm.WG_DX_K
    past = k0 + t_lstm.WG_DX_K - D
    assert past == {304: 16, 2176: 0, 256: 0}[D]
    # the gather's chunks past D: 8 elements each, none straddles D
    assert D % 8 == 0 and all(k >= D or k + 8 <= D for k in range(k0, k0 + 64, 8))


@pytest.mark.parametrize("B", [1, 61, 64, 100, 512])
def test_gx_smem_fits_two_blocks_an_sm(B):
    """Shared memory of a gx_wgmma block (starts, mbarriers, the ring of
    GX_ST stages of 32 KB) fits two blocks an SM at every batch up to 512,
    and the ring holds a split's f32 partial tile."""
    plan = _plan(B, 80, 256, 256)
    assert plan.gx_smem == t_lstm.wg_smem(B, t_lstm.WG_GX_RING)
    assert 2 * plan.gx_smem <= MAX_SMEM
    assert t_lstm.WG_M * (t_lstm.WG_N + 4) * 4 <= t_lstm.WG_GX_RING


@pytest.mark.parametrize("tiles, nk, S", [(144, 34, 1), (32, 34, 4), (8, 64, 8), (144, 8, 1),
                                          (320, 4, 1), (16, 4, 1), (1, 16, 2), (2, 17, 2),
                                          (1, 32, 4)])
def test_gx_splits_rule(tiles, nk, S):
    """K splits: none for the speaker's 144 tiles (S = 4 took 1.6x S = 1's
    time on the H100) or below 16 K-tiles; the beam's 32 tiles 4 ways; at
    most 8, each split at least 8 K-tiles, and a round of one block an SM."""
    assert t_lstm.gx_splits(tiles, nk) == S
    assert S == 1 or (nk // S >= 8 and tiles * S <= t_lstm.WG_SMS)


def _jax_and_emulated(reverse, B, L, D, H, lengths, seed=5):
    rng = np.random.default_rng(seed)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    arrs = (xs, u(D, 4 * H), u(H, 4 * H), u(4 * H))
    xj, wij, whj, bj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    lj = jnp.asarray(lengths, jnp.int32)
    out_j, (h_j, c_j) = lstm_scan_pallas(xj, lj, wij, whj, bj, reverse=reverse, interpret=True)
    tout_j, (th_j, tc_j), hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj,
                                                              reverse=reverse, interpret=True)
    f32 = jnp.float32
    gates_j = (jnp.einsum("bld,dg->blg", xj, wij, preferred_element_type=f32)
               + jnp.einsum("lbh,hg->blg", hp_j, whj.astype(f32), preferred_element_type=f32)
               + bj.astype(f32))
    xt, wit, wht, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = t_lstm.lstm_scan_fwd_emulated(xt, torch.tensor(lengths, dtype=torch.int64), wit, wht,
                                        bt, reverse=reverse)
    want = (out_j, (h_j, c_j), tout_j, (th_j, tc_j), hp_j, cp_j, gates_j)
    return got, want


# (B, L, D, H): K split 4 ways (D = 2048), 2 ways with a partial last K-tile
# (D = 1040), and unsplit with one (D = 200)
EMU_SHAPES = [(6, 9, 2048, 32), (6, 9, 1040, 64), (6, 9, 200, 64)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("kind", ["ragged", "full"])
def test_bf16_gx_emulation_matches_jax(kind, shape, reverse):
    """outs, hT, cT (K3 and K1), hprev, cprev and the gate pre-activations
    at the valid steps (K1) of the emulated gx_wgmma cut against the Pallas
    forward kernels, within 1e-4 x max(1, max |JAX|), as
    ``test_lstm_fwd_emulated_matches_jax``: f32 state from the same bf16
    operands, the sums in another order."""
    B, L, D, H = shape
    S = {2048: 4, 1040: 2, 200: 1}[D]
    assert _plan(B, L, D, H).gx_grid[2] == S  # the split the emulation cuts
    lengths = [L] * B if kind == "full" else [9, 0, 3, 9, 1, 6]
    (outs, (hT, cT), hprev, cprev, gates), want = _jax_and_emulated(reverse, B, L, D, H, lengths)
    out_j, (h_j, c_j), tout_j, (th_j, tc_j), hp_j, cp_j, gates_j = want
    valid = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    pairs = [(outs, out_j), (hT, h_j), (cT, c_j), (outs, tout_j), (hT, th_j), (cT, tc_j),
             (hprev, hp_j), (cprev, cp_j), (gates.numpy()[valid], np.asarray(gates_j)[valid])]
    for got, w in pairs:
        got, w = np.asarray(got, np.float32), np.asarray(w, np.float32)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())))


def test_gx_split_sum_is_the_kernels_order():
    """``_gx_wgmma`` sums the splits' partials in rank order, each over its
    whole K-tiles: the same sums as the per-split products added one by
    one, and within f32 rounding of the unsplit product."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(54, 2048, generator=g).to(torch.bfloat16).float()
    w = (torch.randn(2048, 128, generator=g) / 45).to(torch.bfloat16).float()
    S = t_lstm.gx_splits(1, 32)
    assert S == 4
    want = None
    for s in range(S):
        ks = slice(512 * s, 512 * (s + 1))
        part = x[:, ks] @ w[ks]
        want = part if want is None else want + part
    got = t_lstm._gx_wgmma(x, w, 54)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, x @ w, rtol=0, atol=1e-4)
