"""Analytic roofline model of the EnvDrop training and rollout programs.

The port of ``curriculum_learning_for_vln_tpu/utils/roofline.py``.  It
enumerates the matmul inventory of the EnvDrop agent (models/decoders.py,
models/encoder.py; ref shapes: policy.py:173-246, units.py:12-74) and of
the ViLBERT scorer and returns each program's FLOPs and its *minimum*
device-memory traffic (weight streams, feature-table reads, the major
sequence tensors).  ``bytes`` is a floor, not the bytes achieved: the
measured time over the floor's time says how far the implementation
sits from the memory wall.  ``Cost``, ``matmul``, ``EnvDropShapes``,
``n_params`` and the cost functions compute what the JAX package's do:
they do not depend on the hardware.  The floor counts each weight read
once a rollout, not once a step (a step loop's bf16 weights at the
default widths fit in the card's L2 cache).

``roofline_summary(..., platform="gpu")`` measures against the published
dense peaks of the H100 SXM5 80GB (NVIDIA's data sheet; the rates assume
its 700 W power limit): bf16 989.4 TFLOP/s on the tensor cores, f32 66.9
TFLOP/s outside them, HBM3 3.35 TB/s.  Any other platform gets no peak
fields.  ``benchmark/lib/costs.py`` holds the same constants for the
kernels' bounds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

H100_PEAK_BF16_FLOPS = 989.4e12
H100_PEAK_F32_FLOPS = 66.9e12
H100_HBM_BYTES_PER_S = 3.35e12


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


def matmul(m: int, k: int, n: int, w_bytes: int = 2, act_bytes: int = 0) -> Cost:
    """2*m*k*n FLOPs; bytes = one stream of the [k, n] weight (w_bytes per
    element) plus optional activation traffic.

    Per-step costs pass w_bytes=0 and the per-rollout cost adds each
    weight stream once: the floor reads a loop's weights once."""
    return Cost(2.0 * m * k * n, float(k * n * w_bytes + act_bytes))


@dataclass
class EnvDropShapes:
    """Production bench shapes (bench.py / BASELINE.md)."""
    B: int = 64           # batch
    T: int = 35           # episode steps
    L: int = 80           # instruction tokens
    D: int = 2048         # image feature dim
    A: int = 128          # angle feature dim
    H: int = 512          # hidden
    K: int = 17           # candidate slots incl. STOP
    V: int = 36           # panorama views
    emb: int = 256        # word embedding
    act: int = 64         # action embedding
    wb: int = 2           # weight bytes (bf16 compute weights)
    fb: int = 2           # feature-table bytes (bf16 tables)

    @property
    def F(self) -> int:   # full per-view feature
        return self.D + self.A


def n_params(s: EnvDropShapes) -> int:
    """Matmul parameters of encoder+decoder+critic (~7.6M at production
    shapes; biases and the vocab embedding table are negligible here)."""
    return (
        2 * (s.emb * 4 * s.H + s.H * 4 * s.H)            # encoder biLSTM
        + 2 * (2 * s.H * s.H)                            # enc2dec h0/c0
        + (s.act + s.F + s.H) * 4 * s.H                  # decoder lstm
        + s.H * s.F * 2 + s.H * s.H + 2 * s.H * s.H      # attns + scorer
        + s.A * s.act + s.H * s.H                        # act emb + critic
    )


def encoder_cost(s: EnvDropShapes) -> Cost:
    """Bi-LSTM instruction encoder FLOPs + per-rollout tensor traffic, one
    rollout (units.py:12-74).  Weight bytes are counted in rollout_cost
    (once per program, not per token — see matmul docstring)."""
    per_tok_dir = matmul(s.B, s.emb, 4 * s.H, 0) + matmul(s.B, s.H, 4 * s.H, 0)
    c = 2 * s.L * per_tok_dir                       # 2 directions, L tokens
    c += matmul(s.B, 2 * s.H, s.H, 0) * 2           # enc2dec h0/c0 projections
    c += Cost(0.0, float(s.B * s.L * s.emb * s.fb))  # embedding rows
    c += Cost(0.0, 2 * float(s.B * s.L * s.H * 2))  # ctx write + decoder read
    return c


def decoder_step_cost(s: EnvDropShapes) -> Cost:
    """One decoder step: fused-observation chain + LSTM cell + text attn +
    candidate scorer (policy.py:208-246).  Weight bytes excluded (read
    once a rollout, in rollout_cost)."""
    c = Cost()
    # fused observation: feature rows read from device memory once per step
    c += Cost(0.0, float(s.B * s.V * s.D * s.fb))
    # visual attn: query proj + scores + weighted sum
    c += matmul(s.B, s.H, s.F, 0)                       # linear_in (h -> F)
    c += Cost(2.0 * 2 * s.B * s.V * s.F, 0.0)           # dot + weighted
    # candidate rows emitted (K x F per sample, written then read by scorer)
    c += Cost(0.0, 2.0 * s.B * s.K * s.F * s.fb)
    # action embedding
    c += matmul(s.B, s.A, s.act, 0)
    # LSTM cell on [act; visual]
    c += matmul(s.B, s.act + s.F, 4 * s.H, 0) + matmul(s.B, s.H, 4 * s.H, 0)
    # text attention over ctx (ctx counted in encoder_cost)
    c += matmul(s.B, s.H, s.H, 0)                       # linear_in
    c += Cost(2.0 * 2 * s.B * s.L * s.H, 0.0)           # scores + weighted
    c += matmul(s.B, 2 * s.H, s.H, 0)                   # linear_out
    # candidate scorer
    c += matmul(s.B, s.H, s.F, 0)                       # cand_attn dense
    c += Cost(2.0 * s.B * s.K * s.F, 0.0)               # logits dot
    return c


def critic_cost(s: EnvDropShapes) -> Cost:
    return (matmul(s.B, s.H, s.H, 0) + matmul(s.B, s.H, 1, 0)) * s.T


def rollout_cost(s: EnvDropShapes, T: int | None = None) -> Cost:
    T = s.T if T is None else T
    c = encoder_cost(s) + T * decoder_step_cost(s)
    c += Cost(0.0, float(n_params(s) * s.wb))  # weights streamed once
    return c


def train_iter_cost(s: EnvDropShapes, il_T: int = 8) -> Dict[str, float]:
    """Full production iteration: teacher IL rollout (bucketed T) + sampled
    RL rollout (full T) + backward + RMSprop.

    Backward matmul FLOPs = 2x forward (dx and dW).  Backward minimum
    bytes: re-read of the forward's per-step streams (residuals) + gate
    activations saved f32 (write fwd, read bwd) + one dW write: a dW
    accumulated through device memory step by step (the decoder LSTM's
    [2240, 2048] f32 alone) is traffic over this floor, which
    the hand-written backward (ops/bptt.py) avoids by forming each dW
    once after its reverse loop."""
    fwd = rollout_cost(s, il_T) + rollout_cost(s, s.T) + critic_cost(s)
    steps = il_T + s.T
    resid = Cost(0.0, 2.0 * steps * s.B * 4 * s.H * 4)   # gates f32 save+load
    bwd = Cost(2.0 * fwd.flops, fwd.bytes + resid.bytes + n_params(s) * 4.0)
    # RMSprop: read p/g/v + write p/v in f32
    opt = Cost(10.0 * n_params(s), 5.0 * n_params(s) * 4)
    tot = fwd + bwd + opt
    return {"flops": tot.flops, "bytes": tot.bytes,
            "fwd_flops": fwd.flops, "fwd_bytes": fwd.bytes}


# ---------------------------------------------------------------------------
# ViLBERT scorer (reference scale: vilbert.py:129-272 defaults)
# ---------------------------------------------------------------------------

def _transformer_layer_cost(B: int, L: int, H: int, inter: int, wb: int) -> Cost:
    """One post-LN BERT layer: qkv + attn-out + FFN matmuls, plus the
    quadratic attention einsums.  ViLBERT has no step loop: every weight
    is read once a forward, so weight bytes are counted here (unlike the
    EnvDrop decoder's, read once a rollout)."""
    c = matmul(B * L, H, H, wb) * 4                    # q, k, v, attn_out
    c += Cost(2.0 * 2 * B * L * L * H, 0.0)            # scores + ctx einsums
    c += matmul(B * L, H, inter, wb) + matmul(B * L, inter, H, wb)
    return c


def _connection_layer_cost(B: int, Lt: int, Lv: int, Ht: int, Hv: int,
                           bi: int, it: int, iv: int, wb: int) -> Cost:
    c = matmul(B * Lv, Hv, bi, wb) * 3 + matmul(B * Lt, Ht, bi, wb) * 3   # q/k/v both streams
    c += Cost(2.0 * 2 * B * Lt * Lv * bi * 2, 0.0)     # two cross-attn score+ctx pairs
    c += matmul(B * Lv, bi, Hv, wb) + matmul(B * Lt, bi, Ht, wb)          # biOutput
    c += matmul(B * Lv, Hv, iv, wb) + matmul(B * Lv, iv, Hv, wb)          # v FFN
    c += matmul(B * Lt, Ht, it, wb) + matmul(B * Lt, it, Ht, wb)          # t FFN
    return c


def vilbert_forward_cost(cfg, B: int, Lt: int, Lv: int, wb: int = 2,
                         compute_heads: bool = True) -> Cost:
    """Analytic FLOPs + minimum HBM bytes of one vlnbert_apply forward at
    reference scale (models/vilbert.py; ref vilbert.py:129-272 defaults)."""
    c = Cost()
    c += Cost(0.0, float(B * Lt * cfg.hidden_size * wb))           # word emb rows
    c += matmul(B * Lv, cfg.v_feature_size, cfg.v_hidden_size, wb) # image emb
    c += Cost(0.0, float(B * Lv * cfg.v_feature_size * wb))        # feature reads
    for _ in range(cfg.num_hidden_layers):
        c += _transformer_layer_cost(B, Lt, cfg.hidden_size, cfg.intermediate_size, wb)
    for _ in range(cfg.v_num_hidden_layers):
        c += _transformer_layer_cost(B, Lv, cfg.v_hidden_size, cfg.v_intermediate_size, wb)
    for _ in range(len(cfg.v_biattention_id)):
        c += _connection_layer_cost(B, Lt, Lv, cfg.hidden_size, cfg.v_hidden_size,
                                    cfg.bi_hidden_size, cfg.intermediate_size,
                                    cfg.v_intermediate_size, wb)
    c += matmul(B, cfg.hidden_size, cfg.bi_hidden_size, wb)        # t pooler
    c += matmul(B, cfg.v_hidden_size, cfg.bi_hidden_size, wb)      # v pooler
    c += matmul(B, cfg.bi_hidden_size, 1, wb)                      # vil_logit
    if compute_heads:
        c += matmul(B * Lt, cfg.hidden_size, cfg.hidden_size, wb)  # LM transform
        c += matmul(B * Lt, cfg.hidden_size, cfg.vocab_size, wb)   # tied decoder
        c += matmul(B * Lv, cfg.v_hidden_size, cfg.v_hidden_size, wb)
        c += matmul(B * Lv, cfg.v_hidden_size, cfg.v_target_size, wb)
        c += matmul(B, cfg.bi_hidden_size, 2, wb)                  # seq relationship
    return c


def vilbert_train_cost(cfg, B: int, Lt: int, Lv: int, n_params_: int,
                       wb: int = 2) -> Cost:
    """Pretrain step floor: fwd + 2x-FLOPs backward (each weight re-read
    for dx and its dW written once, f32) + adam moment traffic."""
    fwd = vilbert_forward_cost(cfg, B, Lt, Lv, wb, compute_heads=True)
    bwd = Cost(2.0 * fwd.flops, fwd.bytes + n_params_ * 4.0)
    opt = Cost(12.0 * n_params_, 7.0 * n_params_ * 4)  # m/v/p read + m/v/p write + g read
    return fwd + bwd + opt


def roofline_summary(flops: float, min_bytes: float, measured_s: float,
                     platform: str) -> Dict[str, float]:
    """A program's FLOPs and minimum bytes against its measured time; on
    ``platform`` "gpu" also its share of the H100's bf16 tensor-core peak
    (``mfu_bf16_pct``) and of its memory rate, the floor (the larger of
    the two times) and which of the two bounds it."""
    out = {
        "model_gflops": round(flops / 1e9, 2),
        "min_hbm_gbytes": round(min_bytes / 1e9, 3),
        "achieved_tflops": round(flops / measured_s / 1e12, 2),
    }
    if platform == "gpu":
        t_tensor = flops / H100_PEAK_BF16_FLOPS
        t_hbm = min_bytes / H100_HBM_BYTES_PER_S
        out.update({
            "mfu_bf16_pct": round(100 * flops / measured_s / H100_PEAK_BF16_FLOPS, 1),
            "pct_hbm_roofline": round(100 * min_bytes / measured_s / H100_HBM_BYTES_PER_S, 1),
            "roofline_floor_ms": round(max(t_tensor, t_hbm) * 1e3, 2),
            "x_over_floor": round(measured_s / max(t_tensor, t_hbm), 2),
            "roofline_bound": "hbm" if t_hbm > t_tensor else "tensor",
        })
    return out
