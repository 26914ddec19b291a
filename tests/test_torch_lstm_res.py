"""The resident walk of the LSTM scan's forward (K3, K1 in bf16 at H =
512, the Self-Monitor's encoder), as ``csrc/lstm_scan.cu`` lays it
out, on the CPU.

* ``split_bf16x3``, the three bf16 terms in which the walk sends h: a
  property over f32 values in (-1, 1), h's range, with ±0, subnormals and
  values near 2^-126: h1 + h2 + h3 reconstructs h to within 2^-24 |h|,
  and to within 2^-134 (half of bf16's subnormal spacing) where the last
  terms fall below bf16's normal range (|h| < 2^-110);
* ``res_rows`` and the plan: fed the clusters the card holds at once,
  below and at the count that 8 rows a cluster (one n-tile) need, the plan
  spreads the rows over the clusters that fit in one wave; without that
  count it refuses to plan the resident walk.

The kernel's indices (fragments, cells, the exchange) are held only on
the card, by ``test_torch_card_kernels.py``'s comparison with the plain
version.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm

MAX_SMEM = 232448  # shared memory a block can use on the H100
# cudaOccupancyMaxActiveClusters of the resident walk on an H100 80GB HBM3
# (132 SMs, one block an SM; test_torch_card_kernels.py's walk plans with -s
# print the card's own count)
H100_RES_CLUSTERS = 7
TINY = [0.0, -0.0, 2.0 ** -149, 2.0 ** -126, -(2.0 ** -126) * (1 + 2.0 ** -23),
        2.0 ** -125 * 1.7, 2.0 ** -110, -(2.0 ** -110) * 1.3, 2.0 ** -109 * 1.9]


def _split_error(x: float) -> float:
    terms = t_lstm.split_bf16x3(torch.tensor([x], dtype=torch.float32))
    assert all(t.dtype == torch.bfloat16 for t in terms)
    xf = float(np.float32(x))
    return abs(xf - sum(float(t.double()) for t in terms))


@settings(max_examples=300, deadline=None, database=None)
@given(st.floats(min_value=-1.0, max_value=1.0, width=32, allow_nan=False,
                 allow_subnormal=True, exclude_min=True, exclude_max=True))
@example(0.9999999403953552)
@example(-0.5000000596046448)
@example(1e-30)
def test_split_bf16x3_reconstructs_h(x):
    """|h - (h1 + h2 + h3)| <= max(2^-24 |h|, 2^-134): each term is the
    rounding of an exact residual, 8 significant bits each."""
    assert _split_error(x) <= max(2.0 ** -24 * abs(x), 2.0 ** -134)
    if abs(x) >= 2.0 ** -110:
        assert _split_error(x) <= 2.0 ** -24 * abs(x)


@pytest.mark.parametrize("x", TINY)
def test_split_bf16x3_near_the_smallest_normals(x):
    """±0 split to zeros; near 2^-126 the second and third terms are bf16
    subnormals, and the error stays within half their spacing."""
    err = _split_error(x)
    assert err <= max(2.0 ** -24 * abs(x), 2.0 ** -134)
    if x == 0:
        assert err == 0


def test_split_bf16x3_is_exact_on_bf16_values():
    h = torch.linspace(-1, 1, 4097).to(torch.bfloat16).float()
    t1, t2, t3 = t_lstm.split_bf16x3(h)
    assert torch.equal(t1.float(), h) and not t2.float().any() and not t3.float().any()


@pytest.mark.parametrize("B", [1, 40, 56, 61, 64, 128])
@pytest.mark.parametrize("at_once", [1, 3, 4, 6, 7, 8, 14])
def test_res_plan_takes_the_layout_that_fits_one_wave(B, at_once):
    """ceil(B / clusters at once) rows a cluster, at most 16: one wave
    whenever 16 rows a cluster can make one, and then the fewest rows (the
    fewest bytes of h a block receives a step)."""
    f = t_lstm.lstm_scan_fwd_plan(B, 80, 256, 512, 2, clusters_at_once=at_once)
    assert f.rows == min(-(-B // at_once), 16) == t_lstm.res_rows(B, at_once)
    assert f.clusters == -(-B // f.rows) and f.rec_grid == 16 * f.clusters
    assert (f.clusters <= at_once) == (-(-B // 16) <= at_once)
    if f.clusters <= at_once:  # no fewer rows fit in one wave
        assert f.rows == 1 or -(-B // (f.rows - 1)) > at_once
    assert f.rec_smem == t_lstm.res_smem(512, f.rows) <= MAX_SMEM


@pytest.mark.parametrize("B", [64, 61, 1])
def test_res_plan_below_and_at_the_count_needed(B):
    """At the count 8 rows a cluster need (8 clusters at B = 64 and 61, 1 at
    B = 1) the plan takes one n-tile (at most 8 rows) and those clusters;
    one below, two n-tiles (9 to 16 rows) in the clusters the card holds."""
    need8 = -(-B // 8)
    at = t_lstm.lstm_scan_fwd_plan(B, 80, 256, 512, 2, clusters_at_once=need8)
    assert at.rows <= 8 and at.clusters <= need8
    assert at.rec_smem == t_lstm.res_smem(512, 8)
    if need8 > 1:
        below = t_lstm.lstm_scan_fwd_plan(B, 80, 256, 512, 2, clusters_at_once=need8 - 1)
        assert 8 < below.rows <= 16 and below.clusters <= need8 - 1
        assert below.rec_smem == t_lstm.res_smem(512, 16) > at.rec_smem


def test_res_plan_needs_the_clusters_the_card_holds():
    """The resident walk's rows follow from the card (``plan_query``); the
    plan has no count of its own to fall back on.  The other walks do not
    ask for one."""
    with pytest.raises(ValueError, match="clusters the card holds"):
        t_lstm.lstm_scan_fwd_plan(64, 80, 256, 512, 2)
    for H, elem in ((512, 4), (256, 2), (384, 2)):
        assert t_lstm.lstm_scan_fwd_plan(64, 80, 256, H, elem).cluster == t_lstm.CL


@pytest.mark.parametrize("H", [256, 288, 384, 512])
@pytest.mark.parametrize("elem", [2, 4])
def test_resident_walk_is_bf16_at_whole_chunks(H, elem):
    """The resident walk takes bf16 at H = 512 only; f32 and other H keep
    their walks (registers up to 256, streamed above)."""
    plan = t_lstm.lstm_scan_fwd_plan(64, 80, 256, H, elem, H100_RES_CLUSTERS)
    assert t_lstm.resident(H, elem) == (elem == 2 and H == 512)
    assert (plan.cluster == 16) == t_lstm.resident(H, elem)
    assert (plan.w_stream > 0) == (H > t_lstm.WIDE_H and not t_lstm.resident(H, elem))
    assert math.prod(plan.gx_grid) > 0
