"""The operation, byte and bound arithmetic against hand counts at tiny
shapes."""
import pytest

from benchmark.lib import costs as C

BW, BF16 = 3.35e12, 989.4e12


def test_lstm_bounds_hand_count():
    # B 2, L 3, D 4, H 2, 5 valid steps, bf16: weights (4*8 + 2*8 + 8) * 2 + lengths 2 * 8
    b = C.lstm_bounds(2, 3, 4, 2, 5, "bf16")
    assert b["infer"] == pytest.approx(max((40 + 128 + 48 + 32) / BW, 480 / BF16))
    assert b["train"] == pytest.approx(max((248 + 96) / BW, 480 / BF16))
    assert b["bwd"] == pytest.approx(max((40 + 128 + 32 + 280 + 48 + 224) / BW, 960 / BF16))


def test_observation_bounds_hand_count():
    # B 2 at 1 distinct panorama in 2 distinct views, V 3, D 4, A 2, MC 2, bf16, seeded:
    # rows 24 + angle rows 48 + indices 32 + seeds 16
    p = C.pano_bounds(2, 1, 2, 3, 4, 2, 2, "bf16", seeded=True)
    assert p["fwd"] == pytest.approx(max((120 + 32 + 48 + 48 + 24 + 32) / BW, 144 / BF16))
    assert p["bwd"] == pytest.approx(max((120 + 24 + 48 + 48) / BW, 144 / BF16))
    # two distinct panoramas read twice the rows
    assert C.pano_bounds(2, 2, 2, 3, 4, 2, 2, "bf16", seeded=True)["bwd"] == pytest.approx(
        max((144 + 24 + 48 + 48) / BW, 144 / BF16))
    c = C.cand_bounds(2, 4, 2, 2, "bf16", seeded=True)
    assert c["fwd"] == pytest.approx(max((68 + 48 + 24) / BW, 48 / BF16))
    assert c["bwd"] == pytest.approx(max((68 + 24 + 48) / BW, 48 / BF16))
    # 3 distinct rows read, 4 written, indices
    assert C.pano_cands_bound(2, 3, 4, 2, "bf16") == pytest.approx((24 + 32 + 32 + 32) / BW)


def mm(m, k, n):
    return 2 * m * k * n


W = {"hidden": 4, "feature": 6, "angle": 2, "action_emb": 3, "views": 5, "max_candidates": 2,
     "word_emb": 3, "mlp_hidden": 5, "max_enc_len": 7}


def test_envdrop_step_hand_count():
    F, L = 8, 7
    hand = (mm(1, 4, F) + 2 * mm(1, 5, F) + mm(1, 2, 3) + mm(1, 3 + F, 16) + mm(1, 4, 16)
            + mm(1, 4, 4) + 2 * mm(1, L, 4) + mm(1, 8, 4) + mm(1, 4, F) + mm(1, 2, F))
    assert C.envdrop_step_flops(1, W, L) == hand
    assert C.envdrop_step_flops(3, W, L) == 3 * hand


def test_monitor_call_hand_count():
    F, K, L, tokens, B, T = 8, 3, 7, 10, 2, 3
    step = (mm(1 + K, F, 5) + mm(1, 4, 4) + 2 * mm(1, L, 4) + mm(1, 4, 5) + 2 * mm(1, K, 5)
            + mm(1, 10 + 4, 16) + mm(1, 4, 16) + mm(1, 8, 5) + mm(1, K, 5) + mm(1, 9, 4)
            + mm(1, 11, 1))
    hand = mm(tokens, 3 + 4, 16) + mm(B, 4, 4) + B * T * step
    assert C.monitor_call_flops(W, tokens, B, T, L) == hand


def test_iteration_counts_backward_twice():
    # no tokens and no steps: the encoders' output projections (B + N rows)
    # forward and backward, the A2C bootstrap step forward only, RMSprop
    tail = C.envdrop_step_flops(2, W, 5.0) + C.critic_flops(2, 4)
    it = C.envdrop_iteration_flops(W, 0, 0, 2, 6, 0, 0, 5.0, 5.0)
    assert it == 3 * mm(2 + 6, 4, 4) + tail + 10.0 * C.envdrop_params(W)
