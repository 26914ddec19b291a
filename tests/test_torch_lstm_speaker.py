"""K1-K3 at the speaker encoder's shapes, on the CPU.

The speaker's encoder runs its first BiLSTM over the chosen candidates'
features, D = 2048 + 128 = 2176 at H = 256 a direction, and its post-LSTM
at D = 512, H = 256 (in f32 even in bf16 compute: its input mixes the f32
LSTM state), at full lengths over T = 35 steps.  The JAX package never
ran its Pallas kernels at D = 2176 on the TPU (its VMEM budget sends that
layer to XLA, speaker_model.py:27-38); the port has no such budget, so
the kernels take it.

* ``lstm_scan_fwd_emulated`` and ``lstm_scan_bwd_emulated`` (the kernels'
  arithmetic) against the Pallas kernels in interpret mode, from the same
  numpy-seeded inputs, at (B, L) = (2, 4), one row full and one short,
  both directions, bf16 and f32, D = 2176 and 512 at H = 256: the
  tolerances of ``tests/test_torch_lstm_wide.py`` (outputs 1e-4 x max(1,
  max |JAX|); d_xs 1e-3 in bf16, 1e-4 in f32; dW and db 1e-4);
* the plans at the speaker's shapes (B = 64 and 61, L = 35): rows of
  whole 16-byte chunks (``pad_rows`` leaves them), shared memory within
  the H100's and independent of D, dx_gemm's 34 column tiles and
  dw_gemm's 34 row tiles at D = 2176.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as t_lstm
from curriculum_learning_for_vln_tpu.ops.pallas.lstm_scan import (lstm_scan_bwd_pallas,
                                                                  lstm_scan_pallas,
                                                                  lstm_scan_train_pallas)
from test_torch_lstm_wide import DTYPE, MAX_SMEM, _close

torch.set_num_threads(2)

L = 4
LENGTHS = np.array([L, 2], np.int64)
SPEAKER_SHAPES = [(2176, 256), (512, 256)]  # (D, H): the first layer, the post-LSTM


def _inputs(D, H, seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: ((rng.random(shape) * 2 - 1) / H ** 0.5).astype(np.float32)
    B = len(LENGTHS)
    xs = rng.standard_normal((B, L, D)).astype(np.float32)
    cot = [rng.standard_normal((B, L, H)).astype(np.float32),
           *(rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))]
    return (xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)), cot


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("D,H", SPEAKER_SHAPES)
def test_speaker_shape_emulation_matches_jax(D, H, prec, reverse):
    dt, jdt = DTYPE[prec]
    arrs, cot = _inputs(D, H, 11 + D)
    xj, wij, whj, bj = (jnp.asarray(a).astype(jdt) for a in arrs)
    lj = jnp.asarray(LENGTHS, jnp.int32)
    out_j, (h_j, c_j) = lstm_scan_pallas(xj, lj, wij, whj, bj, reverse=reverse, interpret=True)
    _, _, hp_j, cp_j = lstm_scan_train_pallas(xj, lj, wij, whj, bj, reverse=reverse,
                                              interpret=True)
    grads_j = lstm_scan_bwd_pallas(xj, lj, wij, whj, bj, hp_j, cp_j,
                                   *(jnp.asarray(c) for c in cot), reverse=reverse,
                                   interpret=True)
    xt, wit, wht, bt = (torch.from_numpy(a).to(dt) for a in arrs)
    assert t_lstm.pad_rows(xt, wit)[0] is xt  # whole 16-byte rows: nothing padded
    lt = torch.from_numpy(LENGTHS)
    outs, (hT, cT), hprev, cprev, gates = t_lstm.lstm_scan_fwd_emulated(xt, lt, wit, wht, bt,
                                                                        reverse=reverse)
    for got, want in ((outs, out_j), (hT, h_j), (cT, c_j), (hprev, hp_j), (cprev, cp_j)):
        _close(got, want, 1e-4)
    grads = t_lstm.lstm_scan_bwd_emulated(xt, lt, wit, wht, gates, hprev, cprev,
                                          *(torch.from_numpy(c) for c in cot), reverse=reverse)
    assert grads[0].dtype == dt and tuple(grads[1].shape) == (D, 4 * H)
    for got, want, rtol in zip(grads, grads_j, (1e-3 if prec == "bf16" else 1e-4, 1e-4, 1e-4,
                                                1e-4)):
        _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), rtol)


@pytest.mark.parametrize("B", [64, 61])
@pytest.mark.parametrize("elem", [2, 4])
def test_speaker_shape_plans(B, elem):
    T, H = 35, 256
    base_f = t_lstm.lstm_scan_fwd_plan(B, T, 256, H, elem)
    base_b = t_lstm.lstm_scan_bwd_plan(B, T, 256, H, elem)
    for D, _ in SPEAKER_SHAPES:
        assert D * elem % 16 == 0
        f = t_lstm.lstm_scan_fwd_plan(B, T, D, H, elem)
        b = t_lstm.lstm_scan_bwd_plan(B, T, D, H, elem)
        assert max(f.gx_smem, f.rec_smem, b.rec_smem, b.dx_smem, b.dw_smem) <= MAX_SMEM
        # the staging buffers do not grow with D: the K loops do
        assert (f.gx_smem, f.rec_smem, b.dx_smem, b.dw_smem) == (
            base_f.gx_smem, base_f.rec_smem, base_b.dx_smem, base_b.dw_smem)
        assert f.gx_grid == base_f.gx_grid and f.w_where == base_f.w_where
        assert b.dx_grid == (-(-D // t_lstm.DX_TN), base_b.dx_grid[1])
        assert b.dw_grid == (4 * H // t_lstm.DW_TJ, -(-D // t_lstm.DW_TI), 2 * t_lstm.DW_SPLITS)
    big = t_lstm.lstm_scan_bwd_plan(B, T, 2176, H, elem)
    assert big.dx_grid[0] == 34 and big.dw_grid[1] == 34
