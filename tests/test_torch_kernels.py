"""The port's kernels (plain PyTorch twins, which the CPU runs) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

K3 ``lstm_scan_pallas`` (both directions), K4 ``pano_attend_fwd_pallas``
and K6 ``cand_score_fwd_pallas``, each with an f32 and a bf16 table or
compute dtype.  B = 10 exercises the JAX kernels' G = 8 batch padding,
L = 12 with ragged lengths the packed-sequence masking.  The JAX kernels
get the 40-view padded feature table, the port the 36-view one.

Tolerances:
* f32: atol 1e-5 — both sides accumulate in f32 from the same f32
  values; only the order of the sums differs.
* bf16: atol 2e-2 — about one bf16 rounding step of an O(1) value.
  Both sides widen the same bf16 numbers to f32, so today they differ by
  summation order only; the bound leaves room for a kernel that rounds
  an intermediate to bf16.  Candidate rows are copies of table rows and
  must match exactly in either dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import cand_score as t_cand
from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as t_pano
from curriculum_learning_for_vln_tpu.ops.pallas.cand_score import cand_score_fwd_pallas
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
from curriculum_learning_for_vln_tpu.ops.pallas.pano_fused import pano_attend_fwd_pallas
from curriculum_learning_for_vln_tpu.utils.angles import all_loc_embeddings

torch.set_num_threads(2)

ATOL = {"f32": 1e-5, "bf16": 2e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}

B, L, D_IN, H = 10, 12, 24, 32
N, V, D, A, MC = 7, 36, 64, 128, 16


def _pair(a: np.ndarray, prec: str):
    """The same numbers as a JAX array and a torch tensor in ``prec``
    (both round f32 to bf16 to nearest even)."""
    return jnp.asarray(a).astype(JNP[prec]), torch.from_numpy(a).to(TORCH[prec])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_pallas(prec, reverse):
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((B, L, D_IN)).astype(np.float32)
    lengths = np.array([12, 1, 5, 12, 7, 3, 9, 12, 2, 6], np.int64)
    w_ih = (rng.standard_normal((D_IN, 4 * H)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    (jx, tx), (jwi, twi), (jwh, twh), (jb, tb) = (_pair(a, prec) for a in (xs, w_ih, w_hh, b))

    out_j, (h_j, c_j) = lstm_scan_pallas(jx, jnp.asarray(lengths, jnp.int32), jwi, jwh, jb,
                                         reverse=reverse, interpret=True)
    out_t, (h_t, c_t) = t_lstm.lstm_scan(tx, torch.from_numpy(lengths), twi, twh, tb,
                                         reverse=reverse)

    assert out_t.dtype == h_t.dtype == c_t.dtype == torch.float32
    assert tuple(out_t.shape) == (B, L, H) and tuple(h_t.shape) == (B, H)
    for got, want in ((out_t, out_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL[prec])
    # past its length a row outputs exactly zero
    pad = np.arange(L)[None, :] >= lengths[:, None]
    assert np.all(_np(out_t)[pad] == 0.0)


def _obs_inputs(prec: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, V, D)).astype(np.float32)
    nodes = rng.integers(0, N, B)
    views = rng.integers(0, V, B)
    cand_view = rng.integers(0, V, (B, MC))
    tv = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    feats_padded = np.pad(feats, ((0, 0), (0, 40 - V), (0, 0)))  # the JAX table's layout
    return feats, feats_padded, nodes, views, cand_view, tv


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_pano_attend_matches_pallas(prec):
    feats, feats_padded, nodes, views, cand_view, tv = _obs_inputs(prec)
    loc = all_loc_embeddings()
    j_feats, _ = _pair(feats_padded, prec)
    _, t_feats = _pair(feats, prec)

    vi_j, va_j, alpha_j, cand_j = pano_attend_fwd_pallas(
        jnp.asarray(nodes, jnp.int32), jnp.asarray(views, jnp.int32),
        jnp.asarray(cand_view, jnp.int32), j_feats, jnp.asarray(loc),
        jnp.asarray(tv[:, :D]), jnp.asarray(tv[:, D:]), interpret=True)
    vis_t, alpha_t, cand_t = t_pano.pano_attend(
        torch.from_numpy(nodes), torch.from_numpy(views), torch.from_numpy(cand_view),
        t_feats, torch.from_numpy(loc), torch.from_numpy(tv))

    assert vis_t.dtype == alpha_t.dtype == torch.float32 and cand_t.dtype == TORCH[prec]
    np.testing.assert_allclose(_np(vis_t), np.concatenate([_np(vi_j), _np(va_j)], -1),
                               rtol=0, atol=ATOL[prec])
    np.testing.assert_allclose(_np(alpha_t), _np(alpha_j), rtol=0, atol=ATOL[prec])
    # candidate rows are copies of table rows: exact in either dtype
    np.testing.assert_array_equal(_np(cand_t), _np(cand_j))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_cand_score_matches_pallas(prec):
    rng = np.random.default_rng(9)
    img = rng.standard_normal((B, MC, D)).astype(np.float32)
    ang = rng.standard_normal((B, MC, A)).astype(np.float32)
    valid = rng.random((B, MC)) < 0.6
    q = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    j_img, t_img = _pair(img, prec)

    # the angle features arrive in f32 and each side rounds them to the table dtype
    out_j = cand_score_fwd_pallas(j_img, jnp.asarray(ang), jnp.asarray(valid),
                                  jnp.asarray(q[:, :D]), jnp.asarray(q[:, D:]), interpret=True)
    out_t = t_cand.cand_score(t_img, torch.from_numpy(ang), torch.from_numpy(valid),
                              torch.from_numpy(q))

    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == (B, MC + 1)
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=0, atol=ATOL[prec])
    assert np.all(_np(out_t)[:, MC] == 0.0)          # the STOP slot
    assert np.all(_np(out_t)[:, :MC][~valid] == 0.0)  # invalid candidates


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The CUDA wrappers check dtype and shape before any launch; a bad
    call raises here as it would on the card."""
    feats, _, nodes, views, cand_view, tv = _obs_inputs("f32")
    with pytest.raises(ValueError, match="tv"):
        t_pano.pano_attend_cuda(torch.from_numpy(nodes), torch.from_numpy(views),
                                torch.from_numpy(cand_view), torch.from_numpy(feats),
                                torch.from_numpy(all_loc_embeddings()),
                                torch.from_numpy(tv[:, :D]))
    x = torch.zeros(B, L, D_IN)
    with pytest.raises(ValueError, match="w_hh"):
        t_lstm.lstm_scan_cuda(x, torch.ones(B, dtype=torch.int64), torch.zeros(D_IN, 4 * H),
                              torch.zeros(H, 4 * H, dtype=torch.bfloat16), torch.zeros(4 * H))
    with pytest.raises(TypeError):
        t_cand.cand_score_cuda(torch.zeros(B, MC, D, dtype=torch.float16), torch.zeros(B, MC, A),
                               torch.ones(B, MC, dtype=torch.bool), torch.zeros(B, D + A))
