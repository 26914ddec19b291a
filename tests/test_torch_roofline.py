"""The port's analytic roofline model (``utils/roofline.py``) against the
JAX package's: every cost function gives JAX's FLOPs and bytes exactly
at EnvDrop's default shapes (bf16 and f32 byte widths, T = 10 and 35) and
at ViLBERT's default config (forward with and without the heads, the
training step), since neither depends on the hardware; and
``roofline_summary`` on "gpu" measures against the H100's published
dense peaks (``mfu_bf16_pct`` the bf16 tensor-core share), while any other
platform gets no peak fields."""
import dataclasses

import numpy as np
import pytest

from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig as TVil
from curriculum_learning_for_vln_torch.utils import roofline as t_rf
from curriculum_learning_for_vln_tpu.models.vilbert import VilBertConfig as JVil
from curriculum_learning_for_vln_tpu.utils import roofline as j_rf

PEAK_FIELDS = ("mfu_bf16_pct", "pct_hbm_roofline", "roofline_floor_ms", "x_over_floor",
               "roofline_bound")


def _same(a, b):
    assert (a.flops, a.bytes) == (b.flops, b.bytes)


@pytest.mark.parametrize("wb", [2, 4])
def test_envdrop_costs_equal_jax(wb):
    ts, js = t_rf.EnvDropShapes(wb=wb, fb=wb), j_rf.EnvDropShapes(wb=wb, fb=wb)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js) and ts.F == js.F
    assert t_rf.n_params(ts) == j_rf.n_params(js)
    _same(t_rf.matmul(4, 8, 16, 2, 3), j_rf.matmul(4, 8, 16, 2, 3))
    for name in ("encoder_cost", "decoder_step_cost", "critic_cost", "rollout_cost"):
        _same(getattr(t_rf, name)(ts), getattr(j_rf, name)(js))
    for T in (10, 35):
        _same(t_rf.rollout_cost(ts, T), j_rf.rollout_cost(js, T))
    for il_T in (8, 35):
        assert t_rf.train_iter_cost(ts, il_T) == j_rf.train_iter_cost(js, il_T)
    c = t_rf.Cost(1.0, 2.0) + 3 * t_rf.Cost(3.0, 4.0)
    assert (c.flops, c.bytes) == (10.0, 14.0)


def test_vilbert_costs_equal_jax():
    tc, jc = TVil(), JVil()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for heads in (True, False):
        _same(t_rf.vilbert_forward_cost(tc, 32, 80, 8, compute_heads=heads),
              j_rf.vilbert_forward_cost(jc, 32, 80, 8, compute_heads=heads))
    _same(t_rf.vilbert_train_cost(tc, 32, 80, 8, 144_000_000),
          j_rf.vilbert_train_cost(jc, 32, 80, 8, 144_000_000))


def test_gpu_summary_fields():
    it = t_rf.train_iter_cost(t_rf.EnvDropShapes())
    measured = 0.25
    out = t_rf.roofline_summary(it["flops"], it["bytes"], measured, platform="gpu")
    assert set(out) == {"model_gflops", "min_hbm_gbytes", "achieved_tflops", *PEAK_FIELDS}
    t_tensor = it["flops"] / 989.4e12
    t_hbm = it["bytes"] / 3.35e12
    assert out["roofline_bound"] == ("hbm" if t_hbm > t_tensor else "tensor")
    np.testing.assert_allclose(out["mfu_bf16_pct"], 100 * t_tensor / measured, atol=0.05)
    np.testing.assert_allclose(out["pct_hbm_roofline"], 100 * t_hbm / measured, atol=0.05)
    np.testing.assert_allclose(out["roofline_floor_ms"], 1e3 * max(t_tensor, t_hbm), atol=0.005)
    np.testing.assert_allclose(out["x_over_floor"], measured / max(t_tensor, t_hbm), rtol=0.01)
    # a tensor-bound program: many FLOPs over few bytes
    big = t_rf.roofline_summary(1e15, 1e9, 2.0, platform="gpu")
    assert big["roofline_bound"] == "tensor" and big["x_over_floor"] > 1.0
    assert (t_rf.H100_PEAK_BF16_FLOPS, t_rf.H100_PEAK_F32_FLOPS,
            t_rf.H100_HBM_BYTES_PER_S) == (989.4e12, 66.9e12, 3.35e12)


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
def test_other_platforms_have_no_peak_fields(platform):
    rc = t_rf.rollout_cost(t_rf.EnvDropShapes())
    out = t_rf.roofline_summary(rc.flops, rc.bytes, 1.0, platform=platform)
    assert set(out) == {"model_gflops", "min_hbm_gbytes", "achieved_tflops"}
    j_out = j_rf.roofline_summary(rc.flops, rc.bytes, 1.0, platform="cpu")
    assert out == j_out
