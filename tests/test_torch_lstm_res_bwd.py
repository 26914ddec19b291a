"""The resident walk of the LSTM scan's backward (K2 in bf16 at H = 512,
the Self-Monitor's encoder), as ``csrc/lstm_scan.cu`` lays it out, on the
CPU.

* ``lstm_scan_bwd_emulated`` on the resident plan (per block of 16 its 128
  gate columns, da as three bf16 terms times the bf16 W_hh, the blocks'
  partials summed in rank order; db over the plan's clusters of ``rows``
  rows) against the Pallas backward in interpret mode, from the same
  numpy-seeded inputs and the Pallas forward's carries, both directions,
  at row counts that give one row group (B = 3 on the H100's 7 clusters
  at once: 3 clusters of 1 row) and two (B = 17 on 1: 16 rows, then 1),
  with the tolerances of ``tests/test_torch_lstm_wide.py`` (d_xs 1e-3 in
  bf16, dW and db 1e-4, each times max(1, max |JAX|));
* the backward plan: rows = ``res_rows(B, at_once)`` from the backward's
  own count, clusters = ceil(B / rows), one row of db's partial sums a
  cluster (at B = 40 on 7 clusters at once, 7 rows, more than the
  ceil(40 / 8) = 5 of clusters of 8), shared memory within the H100's at
  one and two row groups, W_hh in registers with nothing streamed or
  packed; without the count it refuses; f32 at H = 512 and bf16 at other
  H keep clusters of 8.

The kernel's indices (fragments, cells, the exchange) are held only on
the card, by chip_smoke.py's comparison with the plain version.
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
H100_RES_CLUSTERS = 7  # the resident walks' clusters at once on an H100 80GB HBM3
D, H = 32, 512
# (B, L, clusters at once, lengths): one row group; two row groups of 8 + 1
CASES = {
    "one_group": (3, 5, H100_RES_CLUSTERS, [5, 2, 0]),
    "two_groups": (17, 4, 1, [4, 1, 0, 3, 4, 2, 4, 1, 3, 0, 2, 4, 4, 1, 2, 3, 4]),
}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_bwd_emulation_matches_jax(case, reverse):
    B, L, at_once, lengths = CASES[case]
    plan = t_lstm.lstm_scan_bwd_plan(B, L, D, H, 2, clusters_at_once=at_once)
    assert (plan.cluster, plan.rows) == (16, t_lstm.res_rows(B, at_once))
    assert (-(-plan.rows // 8) == 2) == (case == "two_groups")
    rng = np.random.default_rng(5 + B + int(reverse))
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    arrs = (rng.standard_normal((B, L, D)).astype(np.float32), u(D, 4 * H), u(H, 4 * H), u(4 * H))
    cot = (rng.standard_normal((B, L, H)).astype(np.float32),
           *(rng.standard_normal((B, H)).astype(np.float32) for _ in range(2)))
    xj, wij, whj, bj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    lj = jnp.asarray(lengths, jnp.int32)
    _, _, hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj, reverse=reverse,
                                              interpret=True)
    want = lstm_scan_bwd_pallas(xj, lj, wij, whj, bj, hp_j, cp_j, *(jnp.asarray(c) for c in cot),
                                reverse=reverse, interpret=True)
    xt, wit, wht, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    lt = torch.tensor(lengths, dtype=torch.int64)
    _, _, hprev, cprev, gates = t_lstm.lstm_scan_fwd_emulated(xt, lt, wit, wht, bt, reverse)
    got = t_lstm.lstm_scan_bwd_emulated(xt, lt, wit, wht, gates, hprev, cprev,
                                        *(torch.from_numpy(c) for c in cot), reverse=reverse,
                                        clusters_at_once=at_once)
    assert got[0].dtype == torch.bfloat16
    for g, w, rtol in zip(got, want, (1e-3, 1e-4, 1e-4, 1e-4)):
        _close(g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)), rtol)


@pytest.mark.parametrize("B", [1, 3, 17, 40, 56, 61, 64, 128])
@pytest.mark.parametrize("at_once", [1, 4, 7, 8])
def test_resident_bwd_plan(B, at_once):
    """Rows from the backward's own count, one wave whenever 16 rows a
    cluster can make one, a row of db's partials a cluster, and shared
    memory within the H100's at either number of row groups."""
    p = t_lstm.lstm_scan_bwd_plan(B, 80, 256, H, 2, clusters_at_once=at_once)
    assert p.rows == t_lstm.res_rows(B, at_once) == min(-(-B // at_once), 16)
    assert p.clusters == -(-B // p.rows) and p.rec_grid == 16 * p.clusters
    assert (p.clusters <= at_once) == (-(-B // 16) <= at_once)
    assert (p.cluster, p.rec_threads, p.w_where) == (16, 512, "registers")
    assert p.w_stream == p.w_pack == 0
    assert p.rec_smem == t_lstm.bwd_res_smem(H, p.rows) <= MAX_SMEM
    assert max(p.dx_smem, p.dw_smem) <= MAX_SMEM


def test_resident_bwd_db_rows_follow_the_plan():
    """B = 40 on the H100's 7 clusters at once: 7 clusters of 6 rows, so
    db's partials need 7 rows, more than the 5 that clusters of 8 rows
    would give; one row group takes 139,280 B of shared memory, two
    139,296 B."""
    p = t_lstm.lstm_scan_bwd_plan(40, 80, 256, H, 2, clusters_at_once=H100_RES_CLUSTERS)
    assert (p.rows, p.clusters) == (6, 7) and p.clusters > -(-40 // t_lstm.R)
    assert t_lstm.bwd_res_smem(H, 8) == 139280 and t_lstm.bwd_res_smem(H, 16) == 139296


def test_resident_bwd_plan_needs_the_clusters_the_card_holds():
    """The resident backward's rows follow from the card
    (``bwd_plan_query``); the plan has no count of its own to fall back
    on.  The other walks do not ask for one and keep clusters of 8."""
    with pytest.raises(ValueError, match="clusters the card holds"):
        t_lstm.lstm_scan_bwd_plan(64, 80, 256, H, 2)
    for h, elem in ((512, 4), (256, 2), (384, 2), (128, 4)):
        p = t_lstm.lstm_scan_bwd_plan(64, 80, 256, h, elem)
        assert p.cluster == t_lstm.CL and p.rows == t_lstm.R and p.clusters == 8
        assert (p.w_where == "streamed from L2") == (h > t_lstm.WIDE_H)
