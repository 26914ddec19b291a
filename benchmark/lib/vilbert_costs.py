"""The matrix-product operations of a ViLBERT pretraining step, from its
shapes.

Every matrix product of the forward (each linear map, the attention
scores and contexts of every head, the tied LM decoder over every text
position, the region decoder over every path slot), counted as 2 M K N
over the padded rows the step computes, and of the backward: twice the
forward's where the input needs its gradient, once (the weights') where
it does not (the image features and the locations, which come from the
data).  What ``torch.utils.flop_counter.FlopCounterMode`` counts of a
step: elementwise work, softmaxes, LayerNorms and the optimizer are left
out.  ``c`` holds the published configuration file's keys.
"""
from __future__ import annotations


def step_flops(c: dict, B: int, Lt: int, R: int) -> float:
    """Forward and backward matrix-product FLOPs of one step over B pairs
    of Lt text positions and R path slots."""
    D, Ft = c["hidden_size"], c["intermediate_size"]
    Dv, Fv, Bi = c["v_hidden_size"], c["v_intermediate_size"], c["bi_hidden_size"]
    T, V = B * Lt, B * R
    total = 0.0

    def gemm(m: int, k: int, n: int, input_grad: bool = True) -> None:
        nonlocal total
        total += 2.0 * m * k * n * (3 if input_grad else 2)

    def attention(len_q: int, len_k: int, width: int) -> None:
        # scores [len_q x len_k] and context over all heads: 2 products of B len_q len_k width
        gemm(B * len_q, width, len_k)
        gemm(B * len_q, len_k, width)

    def layer(rows: int, length: int, d: int, f: int) -> None:
        for _ in range(4):  # query, key, value, output
            gemm(rows, d, d)
        attention(length, length, d)
        gemm(rows, d, f)
        gemm(rows, f, d)

    # the image embeddings: the feature and the location maps, inputs from the data
    for k in (c["v_feature_size"], 5, 4, 2):
        gemm(V, k, Dv, input_grad=False)
    for _ in range(c["num_hidden_layers"]):
        layer(T, Lt, D, Ft)
    for _ in range(c["v_num_hidden_layers"]):
        layer(V, R, Dv, Fv)
    for _ in range(len(c["v_biattention_id"])):
        for _ in range(3):
            gemm(V, Dv, Bi)
            gemm(T, D, Bi)
        attention(Lt, R, Bi)  # text queries against the image
        attention(R, Lt, Bi)  # image queries against the text
        gemm(V, Bi, Dv)
        gemm(T, Bi, D)
        gemm(V, Dv, Fv)
        gemm(V, Fv, Dv)
        gemm(T, D, Ft)
        gemm(T, Ft, D)
    # poolers, the LM head (transform, tied decoder), the region head, alignment, vil_logit
    gemm(B, D, Bi)
    gemm(B, Dv, Bi)
    gemm(T, D, D)
    gemm(T, D, c["vocab_size"])
    gemm(V, Dv, Dv)
    gemm(V, Dv, c["v_target_size"])
    gemm(B, Bi, 2)
    gemm(B, Bi, 1)
    return total
