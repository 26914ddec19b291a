"""EnvDrop trained on the card: the serving world and width, ``PACKED_RL
0``, ``OBS_MASKS prng``, bf16, B = 64, T = 35.

* One iteration's loss and clipped gradients through the kernels against
  the plain versions on the card, from the same parameters, batch and
  generator seed.
* Iterations of ``engine.loop.one_iter`` with the launches of each exact
  (K1 = K2 = 4, K3 = 0, K4 = K6 = T_il + 36, K5 = K7 = T_il + 35), finite
  losses, and every parameter leaf moved.
* A checkpoint written by the port, served by the port's ``Navigator``.
"""
import os

import pytest
import torch
from torch_card_world import (BATCH, FEAT_DIM, SEED, assert_trajectories, card,  # noqa: F401
                              finite, iteration_launches, launch_counts, moved_leaves,
                              plain_kernels, reset_launch_counts, serving)

ITERS = 6  # iterations after one warm-up


@pytest.fixture(scope="module")
def setup(serving, card):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, _ = serving
    precision = cfg.TPU.PRECISION
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[precision],
                         obs_masks=cfg.TPU.OBS_MASKS)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=card)
    return agent, world.device_tables(precision, card), env, il_bucket_fn(cfg, agent)


def fresh(params0, device):
    from curriculum_learning_for_vln_torch.utils import tree

    return tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)


def test_iteration_agrees_with_plain_versions(setup, serving, card):
    """The loss within 1e-4 of its scale (f32 sums in another order over the
    same bf16-rounded operands); each clipped gradient leaf within 1e-2 of
    its largest plain element (gradients reach the embedding through d_xs
    rounded to bf16, one ulp of which is 2^-8 relative)."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    agent, tables, env, il_bucket = setup
    params = fresh(serving[6], card)
    leaves = tree.tree_leaves(params)
    batch = env.next_batch()
    il_len = il_bucket(env)

    def grads():
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        total, _ = loop.iteration_loss(agent, "sample", tables, params, batch, gen, il_len=il_len)
        for p in leaves:
            p.grad = None
        total.backward()
        loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return total.item(), [p.grad.clone() for p in leaves]

    loss_k, g_k = grads()
    with plain_kernels():
        loss_p, g_p = grads()
    assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
        f"training loss kernels {loss_k} vs plain {loss_p}"
    for gk, gp in zip(g_k, g_p):
        e, tol = float((gk - gp).abs().max()), 1e-2 * max(float(gp.abs().max()), 1e-6)
        assert e <= tol, f"a gradient leaf of shape {tuple(gk.shape)}: |kernel - plain| {e:.3g}"


@pytest.fixture(scope="module")
def trained(setup, serving, card):
    """ITERS iterations of ``one_iter`` after a warm-up: (params, optimizer,
    generator, the leaves before, losses, [(launches, T_il)])."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    agent, tables, env, il_bucket = setup
    cfg = serving[4]
    params = fresh(serving[6], card)
    optimizer = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
    before = [p.detach().clone() for p in tree.tree_leaves(params)]
    gen = torch.Generator(device=card).manual_seed(SEED + 1)

    def iterate():
        b = env.next_batch()
        il = il_bucket(env)
        return loop.one_iter(agent, optimizer, "sample", tables, params, b, gen, il_len=il), il

    iterate()  # warm-up
    losses, seen = [], []
    for _ in range(ITERS):
        reset_launch_counts()
        logs, il = iterate()
        losses.append(float(logs["loss"]))
        seen.append((launch_counts(), il or agent.episode_len))
    return params, optimizer, gen, before, losses, seen


def test_training_iteration_launches_are_exact(trained, setup):
    T = setup[0].episode_len
    for counts, t_il in trained[5]:
        want = iteration_launches(t_il, T)
        assert counts == want, f"train launches {counts}, expected {want} (T_il {t_il})"


def test_training_losses_are_finite_and_every_leaf_moves(trained):
    from curriculum_learning_for_vln_torch.utils import tree

    params, _, _, before, losses, _ = trained
    leaves = tree.tree_leaves(params)
    assert finite(losses), f"finite losses {losses}"
    moved = moved_leaves(before, leaves)
    assert moved == len(leaves), f"{moved} of {len(leaves)} parameter leaves changed"


def test_checkpoint_written_by_the_port_is_served(trained, setup, serving, card, tmp_path):
    from curriculum_learning_for_vln_torch.engine.checkpoint import save_checkpoint
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.utils import tree

    world, _, requests, tok, cfg, *_ = serving
    agent = setup[0]
    params, optimizer, gen, *_ = trained
    path = os.path.join(tmp_path, "latest.ckpt")
    save_checkpoint(path, params, optimizer, gen, epoch=1, cfg_yaml=cfg.dump())
    nav = Navigator.from_checkpoint(world, agent, path, tok, max_batch=BATCH,
                                    precision=cfg.TPU.PRECISION, device=card)
    outs = nav.navigate_batch(requests[:BATCH])
    served = tree.tree_leaves(nav.params)
    assert all(torch.equal(a.detach().to(b.dtype), b)
               for a, b in zip(tree.tree_leaves(params), served)), \
        "the served weights are the trained ones"
    assert_trajectories(world, requests[:BATCH], outs, agent.episode_len)
