"""The training kernels' plain twins (which the CPU runs) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs; the
port's three ``torch.autograd.Function``s under ``gradcheck``; and the
plain Philox4x32-10 that draws the prng mode's masks.

K1 ``lstm_scan_train_pallas`` and K2 ``lstm_scan_bwd_pallas`` (both
directions, ragged lengths), K5 ``pano_attend_bwd_pallas`` and K7
``cand_score_bwd_pallas``, and K4 / K6 in their "ext" mask mode, all in
f32.  B = 10 is not a multiple of the JAX kernels' G = 8; the JAX
observation kernels get the 40-view padded feature table, the port the
36-view one, and both the same numpy keep-mask.

Tolerances:
* f32 kernels: atol 1e-5 — both sides accumulate in f32 from the same f32
  values; only the order of the sums differs.
* gradcheck: f64 on the CPU, torch's default tolerances.
* prng mode: atol 1e-5 against autograd through the explicit mask the
  plain Philox makes — the same f32 arithmetic, only the order of the
  sums differs.  The JAX interpreter stubs its hardware PRNG to all-keep
  (pano_fused.py:207-214), so JAX cannot say more about prng.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.ops import philox
from curriculum_learning_for_vln_torch.ops import rnn as t_rnn
from curriculum_learning_for_vln_torch.ops.cuda import cand_score as t_cand
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as t_pano
from curriculum_learning_for_vln_torch.ops.cuda.drop import DropSpec
from curriculum_learning_for_vln_tpu.ops.pallas.cand_score import (cand_score_bwd_pallas,
                                                                   cand_score_fwd_pallas)
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_bwd_pallas,
                                                                  lstm_scan_train_pallas)
from curriculum_learning_for_vln_tpu.ops.pallas.pano_fused import (pano_attend_bwd_pallas,
                                                                   pano_attend_fwd_pallas)
from curriculum_learning_for_vln_tpu.utils.angles import all_loc_embeddings

torch.set_num_threads(2)

ATOL = 1e-5
B, L, D_IN, H = 10, 12, 24, 32
N, V, D, A, MC = 7, 36, 64, 128, 16
LENGTHS = np.array([12, 1, 5, 12, 7, 3, 9, 12, 2, 6], np.int64)
KEEP = 0.7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _lstm_inputs(seed=3):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, L, D_IN)).astype(np.float32)
    w_ih = (rng.standard_normal((D_IN, 4 * H)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    d_out = rng.standard_normal((B, L, H)).astype(np.float32)
    dhT, dcT = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    return xs, w_ih, w_hh, b, d_out, dhT, dcT


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_train_and_bwd_match_pallas(reverse):
    """K1: outputs, final carries and the pre-step carries (hprev, cprev,
    padded steps included); K2: d_xs and the f32 weight gradients."""
    xs, w_ih, w_hh, b, d_out, dhT, dcT = _lstm_inputs()
    lj = jnp.asarray(LENGTHS, jnp.int32)
    out_j, (h_j, c_j), hp_j, cp_j = lstm_scan_train_pallas(
        jnp.asarray(xs), lj, *_j(w_ih, w_hh, b), reverse=reverse, interpret=True)
    lt = torch.from_numpy(LENGTHS)
    out_t, (h_t, c_t), hp_t, cp_t, gates = t_lstm.lstm_scan_train(
        torch.from_numpy(xs), lt, *_t(w_ih, w_hh, b), reverse=reverse)
    assert tuple(hp_t.shape) == (L, B, H)
    for got, want in ((out_t, out_j), (h_t, h_j), (c_t, c_j), (hp_t, hp_j), (cp_t, cp_j)):
        _close(got, want)

    grads_j = lstm_scan_bwd_pallas(*_j(xs), lj, *_j(w_ih, w_hh, b), hp_j, cp_j,
                                   *_j(d_out, dhT, dcT), reverse=reverse, interpret=True)
    grads_t = t_lstm.lstm_scan_bwd(*_t(xs), lt, *_t(w_ih, w_hh), gates, hp_t, cp_t,
                                   *_t(d_out, dhT, dcT), reverse=reverse)
    assert grads_t[0].dtype == torch.float32 and tuple(grads_t[1].shape) == (D_IN, 4 * H)
    for got, want in zip(grads_t, grads_j):
        _close(got, want)
    # padded steps pass no gradient to their inputs
    assert np.all(_np(grads_t[0])[np.arange(L)[None, :] >= LENGTHS[:, None]] == 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bwd_matches_autograd(reverse):
    """K2's plain twin equals torch autograd through the plain forward."""
    xs, w_ih, w_hh, b, d_out, dhT, dcT = _lstm_inputs(seed=4)
    lt = torch.from_numpy(LENGTHS)
    leaves = [t.requires_grad_(True) for t in _t(xs, w_ih, w_hh, b)]
    outs, (hT, cT) = t_lstm.lstm_scan_plain(leaves[0], lt, *leaves[1:], reverse=reverse)
    want = torch.autograd.grad((outs, hT, cT), leaves, _t(d_out, dhT, dcT))
    with torch.no_grad():
        _, _, hp, cp, gates = t_lstm.lstm_scan_train(*_t(xs), lt, *_t(w_ih, w_hh, b),
                                                     reverse=reverse)
    got = t_lstm.lstm_scan_bwd(*_t(xs), lt, *_t(w_ih, w_hh), gates, hp, cp,
                               *_t(d_out, dhT, dcT), reverse=reverse)
    for g, w in zip(got, want):
        _close(g, w)


def _obs_inputs(seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, V, D)).astype(np.float32)
    nodes, views = rng.integers(0, N, B), rng.integers(0, V, B)
    cand_view = rng.integers(0, V, (B, MC))
    tv = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    d_vis = (rng.standard_normal((B, D + A)) * 0.2).astype(np.float32)
    pano_mask = rng.random((B, V, D)) < KEEP
    feats_padded = np.pad(feats, ((0, 0), (0, 40 - V), (0, 0)))  # the JAX table's layout
    return feats, feats_padded, nodes, views, cand_view, tv, d_vis, pano_mask


def test_pano_ext_fwd_and_bwd_match_pallas():
    """K4 and K5 in the ext mask mode, the same keep-mask on both sides."""
    feats, feats_p, nodes, views, cand_view, tv, d_vis, mask = _obs_inputs()
    loc = all_loc_embeddings()
    idx_j = [jnp.asarray(a, jnp.int32) for a in (nodes, views, cand_view)]
    vi_j, va_j, alpha_j, cand_j = pano_attend_fwd_pallas(
        *idx_j, jnp.asarray(feats_p), jnp.asarray(loc), jnp.asarray(tv[:, :D]),
        jnp.asarray(tv[:, D:]), mask=jnp.asarray(mask), keep=KEEP, interpret=True)
    drop = DropSpec("ext", mask=torch.from_numpy(mask), keep=KEEP)
    idx_t = _t(nodes, views, cand_view)
    vis_t, alpha_t, cand_t = t_pano.pano_attend(*idx_t, *_t(feats, loc, tv), drop)
    _close(vis_t, np.concatenate([_np(vi_j), _np(va_j)], -1))
    _close(alpha_t, alpha_j)
    np.testing.assert_array_equal(_np(cand_t), _np(cand_j))  # raw rows, not dropped

    di_j, da_j, _ = pano_attend_bwd_pallas(
        idx_j[0], idx_j[1], idx_j[2], jnp.asarray(feats_p), jnp.asarray(loc), alpha_j,
        jnp.asarray(d_vis[:, :D]), jnp.asarray(d_vis[:, D:]), mask=jnp.asarray(mask),
        keep=KEEP, interpret=True)
    d_tv = t_pano.pano_attend_bwd(idx_t[0], idx_t[1], *_t(feats, loc), alpha_t,
                                  torch.from_numpy(d_vis), drop)
    _close(d_tv, np.concatenate([_np(di_j), _np(da_j)], -1))


def test_cand_ext_fwd_and_bwd_match_pallas():
    """K6 and K7 in the ext mask mode, the same keep-mask on both sides."""
    rng = np.random.default_rng(9)
    img = rng.standard_normal((B, MC, D)).astype(np.float32)
    ang = rng.standard_normal((B, MC, A)).astype(np.float32)
    valid = rng.random((B, MC)) < 0.6
    q = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    d_logits = rng.standard_normal((B, MC + 1)).astype(np.float32)
    mask = rng.random((B, MC, D)) < KEEP
    jin = (jnp.asarray(img), jnp.asarray(ang), jnp.asarray(valid))
    out_j = cand_score_fwd_pallas(*jin, jnp.asarray(q[:, :D]), jnp.asarray(q[:, D:]),
                                  mask=jnp.asarray(mask), keep=KEEP, interpret=True)
    dqi_j, dqa_j = cand_score_bwd_pallas(*jin, jnp.asarray(d_logits), mask=jnp.asarray(mask),
                                         keep=KEEP, interpret=True)
    drop = DropSpec("ext", mask=torch.from_numpy(mask), keep=KEEP)
    tin = _t(img, ang, valid)
    _close(t_cand.cand_score(*tin, torch.from_numpy(q), drop), out_j)
    _close(t_cand.cand_score_bwd(*tin, torch.from_numpy(d_logits), drop),
           np.concatenate([_np(dqi_j), _np(dqa_j)], -1))


def test_autograd_functions_gradcheck():
    """MaskedLSTM, PanoAttend and CandAttend in f64: their backward (the
    plain K2, K5, K7) against finite differences."""
    rng = np.random.default_rng(11)
    b_, l_, d_, h_ = 3, 4, 3, 4
    lengths = torch.tensor([4, 1, 3])

    def f64(*shape, scale=0.5):
        return torch.from_numpy(rng.standard_normal(shape) * scale).requires_grad_(True)

    for reverse in (False, True):
        args = (f64(b_, l_, d_), lengths, f64(d_, 4 * h_), f64(h_, 4 * h_), f64(4 * h_), reverse)
        assert torch.autograd.gradcheck(t_rnn.MaskedLSTM.apply, args)

    n, v, dd, a, mc = 4, 36, 8, 128, 5
    feats = torch.from_numpy(rng.standard_normal((n, v, dd)))
    loc = torch.from_numpy(all_loc_embeddings()).double()
    nodes, views = torch.tensor([0, 3, 1]), torch.tensor([5, 0, 35])
    c_view = torch.from_numpy(rng.integers(0, v, (b_, mc)))
    drop = DropSpec("ext", mask=torch.from_numpy(rng.random((b_, v, dd)) < KEEP), keep=KEEP)
    tv = f64(b_, dd + a, scale=0.2)
    assert torch.autograd.gradcheck(
        lambda t: t_fused.pano_attend_cands(nodes, views, c_view, feats, loc, t, drop)[0], (tv,))

    img = torch.from_numpy(rng.standard_normal((b_, mc, dd)))
    ang = torch.from_numpy(rng.standard_normal((b_, mc, a)))
    valid = torch.from_numpy(rng.random((b_, mc)) < 0.6)
    cdrop = DropSpec("prng", seeds=torch.tensor([1, -2, 3 << 40]), keep=KEEP)
    q = f64(b_, dd + a, scale=0.2)
    assert torch.autograd.gradcheck(
        lambda t: t_fused.cand_attend_logits(img, ang, valid, t, cdrop), (q,))


def test_philox_known_answers():
    """Random123's known-answer vectors of philox4x32-10."""
    def run(counter, key):
        c = [torch.tensor([x]) for x in counter]
        k = [torch.tensor([x]) for x in key]
        return [int(w) for w in philox.philox4x32_10(c, k)]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                                         0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_keep_rate_and_layout():
    """The keep rate lies within binomial bounds; element e takes word e % 4
    of counter e // 4; one seed's mask is the same whatever the batch."""
    seeds = torch.tensor([0, 1, -5, 1 << 62, 12345678901])
    n = 36 * 64
    mask = philox.keep_mask(seeds, (36, 64), KEEP)
    p, count = mask.double().mean().item(), mask.numel()
    assert abs(p - KEEP) < 5 * (KEEP * (1 - KEEP) / count) ** 0.5
    assert mask.float().mean(dim=(1, 2)).min() > 0.6  # no degenerate sample
    bits = philox.random_bits(seeds[2:3], n)
    k0, k1 = int(seeds[2]) & 0xFFFFFFFF, (int(seeds[2]) >> 32) & 0xFFFFFFFF
    for e in (0, 1, 6, 2303):
        c = [torch.tensor([e // 4]), torch.tensor([0]), torch.tensor([0]), torch.tensor([0])]
        words = philox.philox4x32_10(c, (torch.tensor([k0]), torch.tensor([k1])))
        assert int(bits[0, e]) == int(words[e % 4])
    assert torch.equal(philox.keep_mask(seeds[2:3], (36, 64), KEEP), mask[2:3])
    assert philox.keep_threshold(1.0) == 0xFFFFFFFF and philox.keep_threshold(0.5) == 1 << 31


def test_prng_mode_matches_autograd_through_its_mask():
    """K4-K7's prng mode, forward and backward, equals the ext mode (and
    autograd through the plain formulation) with the explicit mask the
    plain Philox draws from the same seeds."""
    feats, _, nodes, views, cand_view, tv, d_vis, _ = _obs_inputs(seed=6)
    loc = torch.from_numpy(all_loc_embeddings())
    idx = _t(nodes, views, cand_view)
    seeds = torch.arange(B, dtype=torch.int64) * 7919 - 3
    prng = DropSpec("prng", seeds=seeds, keep=KEEP)
    ext = DropSpec("ext", mask=philox.keep_mask(seeds, (V, D), KEEP), keep=KEEP)
    assert 0.5 < ext.mask.float().mean() < 0.9

    def pano(drop):
        t = torch.from_numpy(tv).requires_grad_(True)
        vis, cand = t_fused.pano_attend_cands(*idx, torch.from_numpy(feats), loc, t, drop)
        (g,) = torch.autograd.grad(vis, t, torch.from_numpy(d_vis))
        return vis, cand, g

    def plain(t):
        img = torch.where(ext.mask, torch.from_numpy(feats)[idx[0]] / KEEP, 0.0)
        rows = torch.cat([img, loc[idx[1]]], dim=-1)
        alpha = torch.softmax(torch.einsum("bvf,bf->bv", rows, t), dim=-1)
        return torch.einsum("bv,bvf->bf", alpha, rows)

    t = torch.from_numpy(tv).requires_grad_(True)
    vis_w = plain(t)
    (g_w,) = torch.autograd.grad(vis_w, t, torch.from_numpy(d_vis))
    for got in (pano(prng), pano(ext)):
        _close(got[0], vis_w)
        _close(got[2], g_w)

    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.standard_normal((B, MC, D)).astype(np.float32))
    ang = torch.from_numpy(rng.standard_normal((B, MC, A)).astype(np.float32))
    valid = torch.from_numpy(rng.random((B, MC)) < 0.6)
    d_log = torch.from_numpy(rng.standard_normal((B, MC + 1)).astype(np.float32))
    cmask = philox.keep_mask(seeds, (MC, D), KEEP)

    def cand(drop):
        q = torch.from_numpy(tv).requires_grad_(True)
        out = t_fused.cand_attend_logits(img, ang, valid, q, drop)
        return out, torch.autograd.grad(out, q, d_log)[0]

    q = torch.from_numpy(tv).requires_grad_(True)
    rows = torch.cat([torch.where(cmask, img / KEEP, 0.0), ang], dim=-1)
    s = torch.where(valid, torch.einsum("bkf,bf->bk", rows, q), 0.0)
    want = torch.cat([s, s.new_zeros((B, 1))], dim=1)
    (g_want,) = torch.autograd.grad(want, q, d_log)
    for got in (cand(DropSpec("prng", seeds=seeds, keep=KEEP)),
                cand(DropSpec("ext", mask=cmask, keep=KEEP))):
        _close(got[0], want)
        _close(got[1], g_want)


def test_wrappers_reject_bad_masks():
    """The CUDA wrappers check a mode's mask or seeds before any launch."""
    feats, _, nodes, views, cand_view, tv, _, mask = _obs_inputs()
    args = (*_t(nodes, views, cand_view), *_t(feats, all_loc_embeddings(), tv))
    with pytest.raises(ValueError, match="ext mask"):
        t_pano.pano_attend_cuda(*args, DropSpec("ext", mask=torch.from_numpy(mask[:, :, :8]),
                                                keep=KEEP))
    with pytest.raises(ValueError, match="seeds"):
        t_pano.pano_attend_cuda(*args, DropSpec("prng", seeds=torch.zeros(B, dtype=torch.int32),
                                                keep=KEEP))
    with pytest.raises(ValueError, match="gates"):
        xs, w_ih, w_hh, b, d_out, dhT, dcT = _lstm_inputs()
        t_lstm.lstm_scan_bwd_cuda(*_t(xs), torch.from_numpy(LENGTHS), *_t(w_ih, w_hh),
                                  torch.zeros(B, L, H), torch.zeros(L, B, H), torch.zeros(L, B, H),
                                  *_t(d_out, dhT, dcT))
