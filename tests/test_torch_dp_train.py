"""The port's trainers at N = 2 CPU ranks (gloo, spawned) against one
process, as ``tests/test_parallel.py`` holds the JAX package's DP
trainers against one device.

Each scenario trains 2 epochs x 2 iterations at B = 8 on a tiny synthetic
world in f32, evaluating every epoch (``tests/torch_dp_workers.py``):
EnvDrop's classic iteration (sample feedback, dropout and prng env-dropout
on), the same through the hand-written rollout BPTT (TPU.FUSED_BPTT), SPCL with packed RL as shipped (prng_shared, a pool of 3 batches),
the Follower under SPCL (teacher feedback), AUTO's Exp3.S bandit, and the
Self-Monitor (its BN statistics over every rank's rows), with SGD; and
``engine.self_train`` (the speaker's steps, a back-translated iteration).
Held: every scalar the run logs (the epoch losses, the evaluations, the
packed pool's episode counts) within rtol / atol 1e-4 of one process's;
the trained parameters equal on both ranks; SPCL's weights and loss
record, AUTO's arms, and the Self-Monitor's BN running statistics in the
checkpoint rank 0 wrote, against one process's; the ranks load no JAX.
The trained parameters are not held to one process's: after 4 steps a
candidate row that the ranks' other order of summation puts on the other
side of a ReLU moves a BN bias by far more than f32 rounding (one DP
step is held leaf by leaf in tests/test_torch_parallel.py); the BatchNorm
alone is, forward and backward.
"""
import numpy as np
import pytest
import torch
import torch_dp_workers as W

torch.set_num_threads(2)

NAMES = tuple(W.SCENARIOS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one = {name: W.run_scenario(name, str(tmp_path_factory.mktemp(f"one_{name}")))
           for name in NAMES}
    one["self_train"] = W.run_self_train()
    two = W.spawn("scenarios", 2, {"names": NAMES, "out": str(tmp_path_factory.mktemp("two"))})
    return one, two


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_train_as_one_process(runs, name):
    one, two = runs
    assert not any(r["jax_loaded"] for r in two)
    want, got = one[name], two[0][name]
    assert set(got["events"]) == set(want["events"])
    for key in sorted(want["events"]):
        assert W.close(got["events"][key], want["events"][key]), (key, got["events"][key],
                                                                  want["events"][key])
    for a, b in zip(got["leaves"], two[1][name]["leaves"], strict=True):
        assert torch.equal(a, b)  # both ranks stepped on the same gradient


def test_batchnorm_statistics_and_gradients_span_the_ranks():
    """The Self-Monitor's BatchNorm at N = 2: the batch statistics, the
    unbiased running variance and every gradient are one process's over
    the whole batch (forward and backward through the ranks' sums)."""
    gen = torch.Generator().manual_seed(0)
    x, g = torch.randn(12, 5, generator=gen) * 3 + 1, torch.randn(12, 5, generator=gen)
    one = W.bn_of(None, x, g)
    two = W.spawn("bn", 2, {"x": x, "g": g})
    assert not any(r["jax_loaded"] for r in two)
    for r, rows in zip(two, (slice(0, 6), slice(6, 12))):
        assert W.close(r["y"], one["y"][rows], 1e-6)
        assert W.close(r["dx"], one["dx"][rows], 1e-6)
        for k in ("mean", "var", "count"):
            assert W.close(r["state"][k], one["state"][k], 1e-6), k
        for k in ("scale", "bias"):
            assert W.close(r["dparams"][k], one["dparams"][k], 1e-5), k


def test_packed_pool_counts_are_global(runs):
    one, two = runs
    for tag in ("train/episodes_done", "train/episodes_started"):
        for ep in (1, 2):
            got = two[0]["packed"]["events"][tag, ep]
            assert got == one["packed"]["events"][tag, ep] and got > 0


@pytest.mark.parametrize("name", ["packed", "spcl_follower"])
def test_spcl_state_is_one_process(runs, name):
    one, two = runs
    want = one[name]["curriculum"]
    for rank in two:
        got = rank[name]["curriculum"]
        assert W.close(got["lamb"], want["lamb"]) and W.close(got["weight"], want["weight"])
        assert W.close(got["loss_for_item"], want["loss_for_item"])
        assert np.count_nonzero(got["loss_for_item"]) > 0


def test_auto_arms_are_one_process(runs):
    one, two = runs
    want = one["auto"]["curriculum"]
    for rank in two:
        assert rank["auto"]["arms"] == one["auto"]["arms"] and len(rank["auto"]["arms"]) == 4
        got = rank["auto"]["curriculum"]
        assert W.close(got["log_w"], want["log_w"]) and W.close(got["history"], want["history"])


def test_monitor_bn_statistics_are_one_process(runs):
    one, two = runs
    want = one["monitor"]["ckpt"]["model_state"]
    got = two[0]["monitor"]["ckpt"]["model_state"]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree)]

    pairs = list(zip(leaves(got), leaves(want), strict=True))
    assert len(pairs) >= 6
    for a, b in pairs:
        assert W.close(a, b)
    assert any(np.abs(a).max() > 0 and not np.allclose(a, 1.0) for a, _ in pairs)


def test_monitor_iteration_gradients_span_the_ranks():
    """One Self-Monitor iteration (sample feedback, dropout on) at N = 2: the
    loss and every gradient leaf within 1e-4 of one process's in L2, but
    three leaves whose gradient rounding sets: the BN-MLP's input bias and
    first-layer bias (the BatchNorm takes out their shift) and its hidden
    BatchNorm's bias, whose t = 0 input rows are all alike (a_prev starts
    at zeros), so the sign of its ReLU input is the rounding of the mean."""
    one = W.monitor_grads(None)
    two = W.spawn("monitor", 2)
    assert not any(r["jax_loaded"] for r in two)
    rounding = {("decoder", "proj_navigable_mlp", "bn_in", "bias"),
                ("decoder", "proj_navigable_mlp", "layers", 0, "b"),
                ("decoder", "proj_navigable_mlp", "bn_layers", 0, "bias")}
    assert W.close(two[0]["loss"], one["loss"], 1e-5)
    held = 0
    for path, a, b, c in zip(one["paths"], two[0]["grads"], two[1]["grads"], one["grads"],
                             strict=True):
        assert torch.equal(a, b)
        if path not in rounding:
            assert float((a - c).norm()) <= 1e-4 * float(c.norm()), path
            held += 1
    assert held == len(one["paths"]) - len(rounding)


def test_self_train_is_one_process(runs):
    """Back-translation (``--self-train``) at N = 2: the speaker's steps and
    EnvDrop's real and back-translated iterations on the gradient summed
    over the ranks; each logged loss within 1e-4 of one process's."""
    one, two = runs
    for rank in two:
        got, want = rank["self_train"], one["self_train"]
        assert len(got["real"]) == len(want["real"]) == 1 and len(want["bt"]) == 1
        assert W.close(got["real"], want["real"]) and W.close(got["bt"], want["bt"])
