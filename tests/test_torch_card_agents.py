"""The Follower (``configs/follower/follower_config.yaml``) and the
Self-Monitor (``configs/monitor/selfmonitor_config.yaml``) on the card at
the full width of their configs, bf16, B = 64, T = 10, seeded random
weights, on the serving world.

* ``Navigator.navigate_batch`` on 64-request micro-batches: the launches
  of every call exact (Follower K3 = 4, K4 = 10; Self-Monitor K3 = 1, K4 =
  10), the trajectories, the first step's logits against the plain
  versions.
* One sample-feedback training iteration through the kernels against the
  plain versions from the same parameters, batch and generator seed: the
  loss, every gradient leaf and the Self-Monitor's BN running statistics.
* Classic iterations (``engine.loop.agent_one_iter``) with exact launches
  (Follower K1 = K2 = 4, K4 = K5 = 10; Self-Monitor K1 = K2 = 1, K4 = 10,
  K5 = 0) and finite losses.
* One SPCL-weighted iteration on the ``_cl_`` config as shipped (PACKED_RL
  ignored for these agents): its loss is dot(w, ml_vec) / sum(w)
  recomputed in numpy, and the SPCL record the unscaled vector.
* ``check_the_code`` on the synthetic val_unseen split: SR 1.0.
"""
import numpy as np
import pytest
import torch
from torch_card_world import (AGENT_CONFIGS, AGENT_T, BATCH, FEAT_DIM, SEED,  # noqa: F401
                              ZERO_GRAD, agent_cfg, agent_launches, assert_trajectories, card,
                              curriculum_setup, finite, first_step_logits, launch_counts,
                              leaf_paths, length_rounds, plain_kernels, reset_launch_counts,
                              serving)

ITERS = 6  # classic iterations after one warm-up


@pytest.fixture(scope="module", params=list(AGENT_CONFIGS))
def agent(request, serving, card):
    """(name, config, agent, f32 parameters, model state)."""
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent

    name = request.param
    cfg = agent_cfg(AGENT_CONFIGS[name][0])
    a = build_agent(cfg, serving[3].vocab_size(), FEAT_DIM)
    assert a.name == name, f"{AGENT_CONFIGS[name][0]} builds {name}"
    params0, state0 = init_agent(a, torch.Generator().manual_seed(SEED))
    return name, cfg, a, params0, state0


def on_card(params0, state0, device):
    from curriculum_learning_for_vln_torch.utils import tree

    return (tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0),
            tree.tree_map(lambda t: t.to(device), state0))


def train_env(serving, device):
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv

    world, data, _, tok, *_ = serving
    return R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=device)


def test_serve_launches_trajectories_and_logits(agent, serving, card):
    """Every call's launches exact; first-step logits within 1e-3 of their
    scale (f32 encoder and observation outputs summed in another order,
    then bf16 weights downstream: well inside a bf16 ulp, 2^-8)."""
    from curriculum_learning_for_vln_torch.serve import Navigator

    name, cfg, a, params0, state0 = agent
    world, _, requests, tok, *_ = serving
    nav = Navigator(world, a, params0, tok, max_batch=BATCH, precision=cfg.TPU.PRECISION,
                    device=card, model_state=state0)
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    outs = []
    for reqs in batches:
        reset_launch_counts()
        outs += nav.navigate_batch(reqs)
        counts = launch_counts()
        assert counts == agent_launches(name, True), \
            f"{name} serve launches {counts}, expected {agent_launches(name, True)}"
    assert_trajectories(world, requests, outs, AGENT_T)
    ep = nav.episodes(batches[0])
    res_k = nav.rollout(ep)
    with plain_kernels():
        res_p = nav.rollout(ep)
    err, scale = first_step_logits(res_k, res_p)
    assert err <= 1e-3 * max(scale, 1.0), \
        f"{name}: first-step logits |kernel - plain| {err:.3g} of scale {scale:.3g}"


def test_iteration_agrees_with_plain_versions(agent, serving, card):
    """The loss within 1e-4 of its scale, every gradient leaf within 1e-2 of
    its largest plain element, the leaves whose gradient is 0 (a shift that
    every score of a softmax, or every row of a BatchNorm, takes out) within
    1e-3 of the largest gradient, the BN running statistics within 1e-3;
    the kernel run's launches exact."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    name, cfg, a, params0, state0 = agent
    world = serving[0]
    tables = world.device_tables(cfg.TPU.PRECISION, card)
    params, state = on_card(params0, state0, card)
    leaves = tree.tree_leaves(params)
    batch = train_env(serving, card).next_batch()

    def grads():
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        total, _, new_state = loop.agent_iteration_loss(
            a, cfg.AGENT.FEEDBACK, tables, params, state, batch, gen,
            lamb=cfg.TRAIN.PROGMONITOR_WEIGHT)
        for p in leaves:
            p.grad = None
        total.backward()
        # a leaf outside the graph (the Follower's b_v) has no gradient
        return (total.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                               for p in leaves], tree.tree_leaves(new_state))

    reset_launch_counts()
    loss_k, g_k, s_k = grads()
    counts = launch_counts()
    assert counts == agent_launches(name, False), \
        f"{name} train launches {counts}, expected {agent_launches(name, False)}"
    with plain_kernels():
        loss_p, g_p, s_p = grads()
    assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
        f"{name} loss kernels {loss_k} plain {loss_p}"
    top = max(float(g.abs().max()) for g in g_p)
    for path, gk, gp in zip(leaf_paths(params), g_k, g_p):
        at = "/".join(map(str, path))
        if path in ZERO_GRAD[name]:
            e = max(float(gk.abs().max()), float(gp.abs().max()))
            assert e <= 1e-3 * top, \
                f"{name}: the gradient of {at} {e:.3g} is not 0 against {top:.3g}"
            continue
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        assert e <= 1e-2 * sc, f"{name}: the gradient leaf {at}: |kernel - plain| {e:.3g}"
    for sa, sb in zip(s_k, s_p):  # the Self-Monitor's BN running statistics
        e = float((sa - sb).abs().max()) / max(float(sb.abs().max()), 1.0)
        assert e <= 1e-3, f"{name}: BN running statistics |kernel - plain| {e:.3g}"


def test_classic_iterations_launch_exactly(agent, serving, card):
    from curriculum_learning_for_vln_torch.engine import loop

    name, cfg, a, params0, state0 = agent
    tables = serving[0].device_tables(cfg.TPU.PRECISION, card)
    params, state = on_card(params0, state0, card)
    optimizer = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
    gen = torch.Generator(device=card).manual_seed(SEED + 1)
    env = train_env(serving, card)
    losses = []
    for i in range(ITERS + 1):
        reset_launch_counts()
        logs, state = loop.agent_one_iter(a, optimizer, cfg.AGENT.FEEDBACK, tables, params,
                                          state, env.next_batch(), gen,
                                          lamb=cfg.TRAIN.PROGMONITOR_WEIGHT)
        losses.append(float(logs["loss"]))
        counts = launch_counts()
        assert counts == agent_launches(name, False), \
            f"{name} iteration {i} launches {counts}, expected {agent_launches(name, False)}"
    assert finite(losses), f"{name}: finite losses {losses}"


def test_spcl_weighted_iteration_matches_numpy(agent, serving, card):
    from curriculum_learning_for_vln_torch.engine import curriculum, loop
    from curriculum_learning_for_vln_torch.engine.trainer import packed_factor
    from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv

    name, _, a, params0, state0 = agent
    world, data, _, tok, *_ = serving
    cl_config = AGENT_CONFIGS[name][1]
    ccfg = agent_cfg(cl_config, "TPU.PACKED_RL", 3)
    assert ccfg.TRAIN.CLMODE == "SELF-PACE", f"{cl_config} ships SELF-PACE"
    spcl_env = CLR2RBatchEnv(world, length_rounds(data, tok), BATCH, ccfg.TRAIN.SELF_PACE.CRATE,
                             tok, SEED, device=card)
    spcl = curriculum.SelfPacedCurriculum.from_config(ccfg, spcl_env, device=card)
    assert packed_factor(ccfg, a, spcl) == 0, f"PACKED_RL is ignored for {name}"
    params, state = on_card(params0, state0, card)
    optimizer = loop.make_optimizer(ccfg.TRAIN.OPTIM, ccfg.TRAIN.LR, params)
    b = spcl_env.next_batch()
    idx = spcl_env.cur_batch_index
    w = spcl.batch_weights(idx)
    assert bool((w != w[0]).any()), "the SPCL weights differ across the batch"
    logs, _ = loop.agent_one_iter(a, optimizer, ccfg.AGENT.FEEDBACK,
                                  world.device_tables(ccfg.TPU.PRECISION, card), params, state,
                                  b, torch.Generator(device=card).manual_seed(SEED + 1),
                                  weights=w, lamb=ccfg.TRAIN.PROGMONITOR_WEIGHT)
    spcl.record_losses(idx, logs["loss_per_sample"])
    vec, w_np = logs["loss_per_sample"].cpu().numpy(), w.cpu().numpy()
    ref = float(np.dot(w_np.astype(np.float64), vec) / w_np.astype(np.float64).sum())
    assert abs(float(logs["loss"]) - ref) <= 1e-5 * max(1.0, abs(ref)), \
        f"{name} SPCL loss {float(logs['loss'])} vs numpy {ref}"
    recorded = spcl.loss_for_item[spcl._rows(idx)].cpu().numpy()
    assert np.array_equal(recorded, vec.astype(np.float32)), \
        "the SPCL record is the unscaled per-sample vector"


def test_check_the_code_reaches_every_goal(serving, card):
    from curriculum_learning_for_vln_torch.engine.trainer import check_the_code

    world, data, _, tok, *_ = serving
    _, _, _, valid = curriculum_setup(world, data, tok, card)
    summary = check_the_code(agent_cfg(AGENT_CONFIGS["FOLLOWER"][0]),
                             world.device_tables("bf16", card), valid)
    assert summary["success_rate"] == 1.0 and summary["nav_error"] == 0.0, \
        f"check_the_code: SR {summary['success_rate']}, NE {summary['nav_error']}"
