"""The port's word-embedding lookup (``models.core.embedding``) and its
gradient, on the CPU.

The lookup runs through ``F.embedding``, whose backward on the card sums
each id's gradient rows in f32 and rounds a row once; advanced indexing's
backward walked each id's duplicates one by one.  What must hold on every
route:

* the forward is ``w[ids]`` bit for bit;
* each row's gradient is the sum of its positions' gradients, the padding
  row's included (no ``padding_idx`` drops id 0's terms), held against an
  f64 ``index_add_``.  In f32 the routes differ only by the order of the
  sums, so the limit is 8 f32 epsilons times the sum of the terms'
  magnitudes, element by element (the first-order rounding error of any
  summation order is at most (n - 1) epsilons times that sum; a dropped
  N(0, 1) term is ~1 against 0.02 on the padding row).  In bf16 torch's
  CPU kernels add each duplicate in bf16 on both routes, so there the
  gradient equals advanced indexing's bit for bit, and the CPU tests
  against the JAX package do not move;
* at the training cell's pattern (V = 992, D = 256, 512 x 80 ids, 60% of
  them the padding id 0), with a gradient only at padding positions, and
  at the speaker's step (64 x 1 ids).
"""
import pytest
import torch

from curriculum_learning_for_vln_torch.models import core

V, D = 992, 256


def _ids(case: str, gen: torch.Generator) -> torch.Tensor:
    if case == "speaker":
        return torch.randint(0, V, (64, 1), generator=gen)
    ids = torch.randint(1, V, (512, 80), generator=gen)
    ids[torch.rand(ids.shape, generator=gen) < 0.6] = 0
    return ids


def _upstream(case: str, ids: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    g = torch.randn(*ids.shape, D, generator=gen)
    if case == "padding":
        g = g * (ids == 0).unsqueeze(-1)
    return g


@pytest.mark.parametrize("case", ["forward", "cell", "padding", "speaker"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_embedding_lookup_and_gradient(dtype, case):
    gen = torch.Generator().manual_seed(22)
    ids = _ids(case, gen)
    table = torch.randn(V, D, generator=gen).to(dtype)
    if case == "forward":
        got = core.embedding({"w": table}, ids)
        assert got.dtype == dtype and torch.equal(got, table[ids])
        return
    g = _upstream(case, ids, gen)
    w = table.clone().requires_grad_(True)
    core.embedding({"w": w}, ids).backward(g.to(dtype))
    assert w.grad.dtype == dtype

    flat_ids, flat_g = ids.reshape(-1), g.reshape(-1, D).double()
    want = torch.zeros(V, D, dtype=torch.float64).index_add_(0, flat_ids, flat_g)
    mass = torch.zeros(V, D, dtype=torch.float64).index_add_(0, flat_ids, flat_g.abs())
    eps = torch.finfo(dtype).eps
    assert torch.all((w.grad.double() - want).abs() <= 8 * eps * mass)
    if case == "padding":
        assert bool((want[1:] == 0).all()) and bool((w.grad[1:] == 0).all())
        assert bool((w.grad[0] != 0).all())
    if dtype == torch.bfloat16:
        old = table.clone().requires_grad_(True)
        old[ids].backward(g.to(dtype))
        assert torch.equal(w.grad, old.grad)
