"""K4 and K5 (``ops/cuda/pano_fused.py``) on the CPU: their launch plan,
their arithmetic block by block, and their division.

``pano_plan`` gives the grid (slice of D, group of G samples), the
cluster of S blocks along D and the shared-memory bytes that the C entry
points compute for themselves.  These tests hold it to what the kernels
assume: every (sample, view, image column) and every (sample, angle
column) owned by exactly one block, no block's samples straddling a
prng_shared group of 8, the grid a whole number of clusters, the slices
whole 16-byte chunks and whole Philox quads, and shared memory within the
H100's 232,448 bytes a block.

``pano_attend_emulated`` and ``pano_attend_bwd_emulated`` replay the
kernels' arithmetic block by block (each element dropped once, partial
scores per slice summed over the cluster's ranks in order, the softmax or
its VJP per group, the weighted sum per slice; outputs no block writes
stay NaN).  They are held against the Pallas kernels in interpret mode on
the same numpy inputs and keep-mask (ext mode), in f32 and bf16, within
1e-4 x max(1, max|ref|): both sides sum the same f32 products in another
order.  The candidate rows are copies and must be equal.  In every mask
mode they are also held against the port's plain versions, at B = 1, 13
and 61 (a short last prng_shared group).

``test_div_by_is_the_division`` replays common.cuh's ``div_by`` (a
reciprocal, a product and two FMAs) in exact rational arithmetic and
checks it gives the IEEE quotient x / keep bit for bit (a zero's sign
aside) for x = 0 and every magnitude in [2^-100, 2^126], the range div_by
promises (below it the FMA's residual can lose bits, above it x * (1 /
keep) can overflow).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops import philox
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as t_pano
from curriculum_learning_for_vln_torch.ops.cuda.drop import DropSpec, divisor
from curriculum_learning_for_vln_tpu.ops.pallas.pano_fused import (pano_attend_bwd_pallas,
                                                                   pano_attend_fwd_pallas)
from curriculum_learning_for_vln_tpu.utils.angles import all_loc_embeddings

torch.set_num_threads(2)

V, A, MC = 36, 128, 16
MAX_SMEM = 232448   # shared memory a block can use on the H100
GROUP = 8           # rows of a prng_shared group
KEEP = 0.7          # 1 - MODEL.ENVDROP.FEAT_DROP_RATE as every config ships it
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
JNP = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _owners(plan, B, D):
    """How many blocks own each (sample, image column) and each (sample,
    angle column), from the plan's fields as the kernel reads them; every
    block of a cluster covers all V views of its samples."""
    S, groups = plan.grid
    G, cols, aq = plan.samples, plan.cols, plan.ang_quads
    img = np.zeros((B, D), np.int64)
    ang = np.zeros((B, A), np.int64)
    for y in range(groups):
        b0, b1 = y * G, min(B, (y + 1) * G)
        assert b0 < B, "a group of blocks with no sample"
        assert b0 // GROUP == (b0 + G - 1) // GROUP, "a block straddles a prng_shared group"
        for rank in range(S):
            assert (rank + 1) * cols <= D
            img[b0:b1, rank * cols:(rank + 1) * cols] += 1
            a0 = 4 * rank * aq
            ang[b0:b1, a0:min(A, a0 + 4 * aq)] += 1
    return img, ang


@pytest.mark.parametrize("mc", [MC, 0], ids=["K4", "K5"])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("D", [32, 64, 2048])
@pytest.mark.parametrize("B", [1, 7, 61, 64, 512])
def test_pano_plan_covers_the_work_once(B, D, prec, mc):
    dtype = DTYPES[prec]
    elem = torch.empty((), dtype=dtype).element_size()
    plan = t_pano.pano_plan(B, V, D, A, dtype, mc)
    S, groups = plan.grid
    assert plan.cluster == S and S in (1, 2, 4, 8)  # the grid is whole clusters along x
    assert plan.samples in (1, 2, 4, 8) and groups == -(-B // plan.samples)
    assert (plan.cols * elem) % 16 == 0 and plan.cols % 4 == 0  # 16-byte chunks, Philox quads
    assert plan.smem <= MAX_SMEM
    assert plan.smem == t_pano.pano_smem(S, plan.samples, V, plan.cols, plan.ang_quads, mc,
                                         elem)
    img, ang = _owners(plan, B, D)
    assert (img == 1).all() and (ang == 1).all()
    # no G of 1, 2, 4, 8 that fits takes fewer waves, nor as few with fewer samples
    for G in (1, 2, 4, 8):
        smem = t_pano.pano_smem(S, G, V, plan.cols, plan.ang_quads, mc, elem)
        if smem <= MAX_SMEM:
            waves = -(-(-(-B // G)) // t_pano.clusters_at_once(S, smem))
            assert waves > plan.waves or (waves == plan.waves and G >= plan.samples)


@pytest.mark.parametrize("prec, G, blocks", [("bf16", 2, 256), ("f32", 1, 512)])
def test_pano_plan_at_the_path_shape(prec, G, blocks):
    """B = 64, D = 2048: clusters of 8 blocks of 256 image and 16 angle
    columns.  bf16: 2 samples a block (63 KB, three blocks an SM), 256
    blocks in one wave; 4 samples a block (126 KB) would leave one SM a
    block and the card 15 of the 16 clusters at once.  f32: no G fits one
    wave, so the smallest of the fewest waves, 1."""
    for mc in (MC, 0):
        plan = t_pano.pano_plan(64, V, 2048, A, DTYPES[prec], mc)
        S, groups = plan.grid
        assert (S, plan.samples, plan.cols, plan.ang_quads) == (8, G, 256, 4)
        assert S * groups == blocks >= 128
        assert plan.waves == (1 if prec == "bf16" else 2)


def _obs_inputs(B, N, D, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, V, D)).astype(np.float32)
    nodes, views = rng.integers(0, N, B), rng.integers(0, V, B)
    cand_view = rng.integers(0, V, (B, MC))
    tv = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    d_vis = (rng.standard_normal((B, D + A)) * 0.2).astype(np.float32)
    mask = rng.random((B, V, D)) < KEEP
    return feats, nodes, views, cand_view, tv, d_vis, mask


def _close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert not np.isnan(got).any(), "an output no block wrote"
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("B, D", [(13, 64), (10, 32)])
def test_emulation_matches_pallas_ext(prec, B, D):
    """K4's and K5's arithmetic under their plans against the Pallas
    kernels (ext mask; the JAX kernels get the 40-view padded table)."""
    feats, nodes, views, cand_view, tv, d_vis, mask = _obs_inputs(B, 7, D, seed=B + D)
    loc = all_loc_embeddings()
    j_feats = jnp.asarray(np.pad(feats, ((0, 0), (0, 40 - V), (0, 0)))).astype(JNP[prec])
    t_feats = torch.from_numpy(feats).to(DTYPES[prec])
    idx_j = [jnp.asarray(a, jnp.int32) for a in (nodes, views, cand_view)]
    vi_j, va_j, alpha_j, cand_j = pano_attend_fwd_pallas(
        *idx_j, j_feats, jnp.asarray(loc), jnp.asarray(tv[:, :D]), jnp.asarray(tv[:, D:]),
        mask=jnp.asarray(mask), keep=KEEP, interpret=True)
    di_j, da_j, _ = pano_attend_bwd_pallas(
        *idx_j, j_feats, jnp.asarray(loc), alpha_j, jnp.asarray(d_vis[:, :D]),
        jnp.asarray(d_vis[:, D:]), mask=jnp.asarray(mask), keep=KEEP, interpret=True)

    drop = DropSpec("ext", mask=torch.from_numpy(mask), keep=KEEP)
    idx_t = [torch.from_numpy(a) for a in (nodes, views, cand_view)]
    loc_t = torch.from_numpy(loc)
    vis, alpha, cand = t_pano.pano_attend_emulated(*idx_t, t_feats, loc_t, torch.from_numpy(tv),
                                                   drop)
    _close(vis, np.concatenate([np.asarray(vi_j, np.float32), np.asarray(va_j, np.float32)], -1))
    _close(alpha, alpha_j)
    np.testing.assert_array_equal(cand.float().numpy(), np.asarray(cand_j, np.float32))
    d_tv = t_pano.pano_attend_bwd_emulated(idx_t[0], idx_t[1], t_feats, loc_t,
                                           torch.from_numpy(np.array(alpha_j)),
                                           torch.from_numpy(d_vis), drop)
    _close(d_tv, np.concatenate([np.asarray(di_j, np.float32), np.asarray(da_j, np.float32)], -1))


@pytest.mark.parametrize("mode", ["none", "ext", "prng", "prng_shared"])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 13, 61])
def test_emulation_matches_plain(B, prec, mode):
    """Every mask mode, against ``pano_attend_plain`` / ``_bwd_plain``;
    at B = 61 the last prng_shared group is short and, at D = 64, blocks of
    2 or 4 samples take the seed of their group's first row."""
    feats, nodes, views, cand_view, tv, d_vis, mask = _obs_inputs(B, 9, 64, seed=B)
    g = torch.Generator().manual_seed(B)
    drop = {"none": DropSpec(), "ext": DropSpec("ext", mask=torch.from_numpy(mask), keep=KEEP)
            }.get(mode) or DropSpec(mode, seeds=philox.draw_seeds(B, g, "cpu"), keep=KEEP)
    args = (*(torch.from_numpy(a) for a in (nodes, views, cand_view)),
            torch.from_numpy(feats).to(DTYPES[prec]), torch.from_numpy(all_loc_embeddings()))
    tv_t, d_vis_t = torch.from_numpy(tv), torch.from_numpy(d_vis)
    want = t_pano.pano_attend_plain(*args, tv_t, drop)
    got = t_pano.pano_attend_emulated(*args, tv_t, drop)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert torch.equal(got[2], want[2])
    bargs = (args[0], args[1], args[3], args[4], want[1], d_vis_t, drop)
    _close(t_pano.pano_attend_bwd_emulated(*bargs), t_pano.pano_attend_bwd_plain(*bargs))


def _rn32(v: Fraction) -> Fraction:
    """v rounded to the nearest f32 (ties to even), subnormals included."""
    if v == 0:
        return v
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n = a / quantum
    whole = n.numerator // n.denominator
    rest = n - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    return (-1 if v < 0 else 1) * whole * quantum


def _div_by(x: Fraction, d: Fraction, inv: Fraction) -> Fraction:
    """common.cuh div_by: q = x * inv; fma(fma(-q, d, x), inv, q), each
    product and FMA rounded once to f32."""
    q = _rn32(x * inv)
    return _rn32(_rn32(x - q * d) * inv + q)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_div_by_is_the_division(prec):
    """x / keep for the keep divisor of each table dtype (bf16(0.7) =
    0.69921875 for a bf16 table), bit for bit, over every x that div_by
    promises: 0 and magnitudes in [2^-100, 2^126].  Random f32 bit patterns
    of every exponent in that range (both signs), the bf16 values among
    them, values just inside both ends of it, and values of O(1), as
    features are."""
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2 ** 32, 3000, dtype=np.uint64).astype(np.uint32)
    ends = np.concatenate([rng.uniform(2.0 ** -100, 2.0 ** -96, 300),
                           rng.uniform(2.0 ** 122, 2.0 ** 126, 300)]) * rng.choice([-1, 1], 600)
    xs = np.concatenate([bits.view(np.float32), (bits & 0xFFFF0000).view(np.float32)[:500],
                         ends.astype(np.float32), rng.standard_normal(500).astype(np.float32),
                         np.array([0.0, -0.0, 1.0, -3.5, 2.0 ** -100, 2.0 ** 126], np.float32)])
    xs = xs[np.isfinite(xs)]
    mag = np.abs(xs.astype(np.float64))
    xs = xs[(mag == 0) | ((mag >= 2.0 ** -100) & (mag <= 2.0 ** 126))]
    assert len(xs) > 3000
    for p in (KEEP, 0.5, 0.8, 0.9):
        d = np.float32(divisor(p, DTYPES[prec]))
        inv = np.float32(1.0) / d
        want = xs / d  # the IEEE f32 quotient
        got = np.array([float(_div_by(Fraction(float(x)), Fraction(float(d)),
                                      Fraction(float(inv)))) for x in xs], np.float32)
        # bit for bit, but for the sign of a zero quotient: div_by(-0) is +0
        # (q + r inv adds -0 to +0), which no sum can tell from -0
        bad = (got.view(np.uint32) != want.view(np.uint32)) & ~((got == 0) & (want == 0))
        assert not bad.any(), f"keep {p}: {xs[bad][:5]} -> {got[bad][:5]}, not {want[bad][:5]}"
