"""Operations, bytes and bounds of the measured work, from its shapes.

The published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
its 700 W power limit): 989.4 TFLOP/s in bf16 on the tensor cores, 66.9
TFLOP/s in f32 outside them, 3.35 TB/s of HBM3.  A bound is the least
time of a piece of work: its bytes over the memory rate or its
operations over the dtype's peak, whichever is longer, counting each
input read once and each output written once.

The model inventories count the matrix products an EnvDrop training
iteration and a Self-Monitor serving call need for their inputs (the
LSTM encoders over the valid tokens only; every slot of every decoder
step, as the agents define a step over the whole batch); a backward is
twice its forward.  Copied and extended from the port's
``utils/roofline.py`` (EnvDrop) with the Self-Monitor added.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989.4e12, "f32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bf16": 2, "f32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------------------
# LSTM scans (csrc/lstm_scan.cu): K3 forward, K1 forward with residuals, K2
# ---------------------------------------------------------------------------

def lstm_bounds(B: int, L: int, D: int, H: int, steps: int, dtype: str) -> dict:
    """Bounds (s) of one direction's launch over B rows of L positions with
    ``steps`` valid steps in all: "infer" (K3), "train" (K1, which also
    writes the h and c of every step for its backward), "bwd" (K2).  A
    per-step input is read at the valid steps only; outputs count whole."""
    e, f32 = BYTES[dtype], 4
    weights = (D * 4 * H + H * 4 * H + 4 * H) * e + B * 8
    fwd_bytes = steps * D * e + weights + B * L * H * f32 + 2 * B * H * f32
    train_bytes = fwd_bytes + 2 * L * B * H * f32
    bwd_bytes = (steps * D * e + weights + 2 * B * H * f32 + steps * 7 * H * f32
                 + B * L * D * e + (D + H + 1) * 4 * H * f32)
    fwd_flops = 2 * steps * (D + H) * 4 * H
    bwd_flops = 2 * steps * 4 * H * (2 * H + 2 * D)
    return {"infer": bound_s(fwd_bytes, fwd_flops, dtype),
            "train": bound_s(train_bytes, fwd_flops, dtype),
            "bwd": bound_s(bwd_bytes, bwd_flops, dtype)}


# ---------------------------------------------------------------------------
# The observation step (csrc/pano_fused.cu K4 / K5, csrc/cand_score.cu K6 / K7)
# ---------------------------------------------------------------------------

def pano_bounds(B: int, nodes: int, views: int, V: int, D: int, A: int, MC: int, dtype: str,
                seeded: bool) -> dict:
    """K4 (attention over each sample's panorama, and its candidate rows)
    and K5 (the query's gradient) over B samples standing at ``nodes``
    distinct panoramas in ``views`` distinct views: the distinct
    panoramas' V view rows and the distinct views' angle rows read once,
    indices, query, seeds; the outputs written once; 4 operations an
    element of [rows; angle] a sample (a dot and a weighted sum)."""
    e, f32, F = BYTES[dtype], 4, D + A
    rows = nodes * V * D * e + views * V * A * f32 + 2 * B * 8 + (B * 8 if seeded else 0)
    flops = 4 * B * V * F
    fwd = rows + B * MC * 8 + B * F * f32 + B * F * f32 + B * V * f32 + B * MC * D * e
    bwd = rows + B * V * f32 + B * F * f32 + B * F * f32
    return {"fwd": bound_s(fwd, flops, dtype), "bwd": bound_s(bwd, flops, dtype)}


def pano_cands_bound(B: int, rows: int, D: int, MC: int, dtype: str) -> float:
    """K4 called for the candidate rows alone (the Self-Monitor): the
    ``rows`` distinct (panorama, view) rows it returns read once, the B x
    MC rows written once, with their indices."""
    e = BYTES[dtype]
    return bound_s((rows + B * MC) * D * e + B * MC * 8 + 2 * B * 8, 0.0, dtype)


def cand_bounds(B: int, D: int, A: int, MC: int, dtype: str, seeded: bool) -> dict:
    """K6 (candidate logits) and K7 (the query's gradient)."""
    e, f32, F = BYTES[dtype], 4, D + A
    inputs = B * MC * (D + A) * e + B * MC + (B * 8 if seeded else 0)
    flops = 2 * B * MC * F
    return {"fwd": bound_s(inputs + B * F * f32 + B * (MC + 1) * f32, flops, dtype),
            "bwd": bound_s(inputs + B * (MC + 1) * f32 + B * F * f32, flops, dtype)}


# ---------------------------------------------------------------------------
# Model inventories
# ---------------------------------------------------------------------------

def lstm_flops(tokens: int, D: int, H: int) -> float:
    return 2.0 * tokens * (D + H) * 4 * H


def envdrop_step_flops(rows: int, w: dict, ctx_len: float) -> float:
    """One EnvDrop decoder step over ``rows`` slots (``ctx_len`` the mean
    instruction length the text attention reads)."""
    H, F, A, act, V, MC = (w["hidden"], w["feature"] + w["angle"], w["angle"], w["action_emb"],
                           w["views"], w["max_candidates"])
    per = (2 * H * F + 4 * V * F + 2 * A * act + 2 * (act + F) * 4 * H + 2 * H * 4 * H
           + 2 * H * H + 4 * ctx_len * H + 2 * 2 * H * H + 2 * H * F + 2 * MC * F)
    return float(rows) * per


def critic_flops(rows: int, H: int) -> float:
    return float(rows) * (2 * H * H + 2 * H)


def envdrop_iteration_flops(w: dict, il_tokens: int, pool_tokens: int, B: int, N: int,
                            il_len: int, T: int, il_ctx: float, pool_ctx: float) -> float:
    """An SPCL packed iteration: the encoders of the IL batch and the pool
    (bidirectional, H / 2 a direction), ``il_len`` IL steps and T RL steps
    of B slots with their critic, forward and backward (2x); the A2C
    bootstrap step forward only; RMSprop."""
    H, E = w["hidden"], w["word_emb"]
    enc = (2 * lstm_flops(il_tokens, E, H // 2) + 2 * lstm_flops(pool_tokens, E, H // 2)
           + 2.0 * (B + N) * H * H)
    grad = (enc + envdrop_step_flops(B, w, il_ctx) * il_len
            + envdrop_step_flops(B, w, pool_ctx) * T + critic_flops(B * T, H))
    tail = envdrop_step_flops(B, w, pool_ctx) + critic_flops(B, H)
    return 3.0 * grad + tail + 10.0 * envdrop_params(w)


def envdrop_params(w: dict) -> int:
    H, F, A, act, E = (w["hidden"], w["feature"] + w["angle"], w["angle"], w["action_emb"],
                       w["word_emb"])
    return (2 * (E + H // 2 + 1) * 4 * (H // 2) + H * H + A * act + (act + F + H + 1) * 4 * H
            + H * H + 2 * H * H + 2 * H * F + H * H + H)


def monitor_call_flops(w: dict, tokens: int, B: int, T: int, ctx_len: float) -> float:
    """A served Self-Monitor call: the unidirectional encoder over the valid
    tokens and T decoder steps of B rows."""
    H, F, M, E, MC = (w["hidden"], w["feature"] + w["angle"], w["mlp_hidden"], w["word_emb"],
                      w["max_candidates"])
    K = MC + 1
    step = (2 * F * M * (1 + K) + 2 * H * H + 4 * ctx_len * H + 2 * H * M + 4 * K * M
            + 2 * (2 * M + H) * 4 * H + 2 * H * 4 * H + 2 * 2 * H * M + 2 * K * M
            + 2 * (H + M) * H + 2 * (w["max_enc_len"] + H))
    return lstm_flops(tokens, E, H) + 2.0 * B * H * H + float(B) * T * step
