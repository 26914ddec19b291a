"""The plain route (``TPU.USE_PALLAS False``: the encoders' autograd step
loop, the agents' unfused decode) against the kernels on the card, the
asynchronous checkpoint writer and ``write_results``, on the serving
world.

* EnvDrop's ``Navigator(use_pallas=False)`` against the default one at
  full width, f32 and bf16, 64 requests a call: first-step logits within
  1e-4 of their scale in f32 (1e-2 in bf16, where the plain route
  contracts the attention in bf16 as JAX's XLA route does), trajectories
  equal but after a tie, launches a call exact (kernels: K3 = 2, K4 = K6 =
  T; plain: every K 0).
* One classic EnvDrop iteration (B = 64, T = 35) and one Follower and one
  Self-Monitor iteration (their configs' full widths, T = 10), each
  through ``loop.configure_runtime`` with USE_PALLAS True and False, from
  the same parameters, batch and generator seed, at DROP_RATE (and
  FEAT_DROP_RATE) 0 with teacher feedback, f32 and bf16: the loss within
  1e-5 relative (bf16 1e-3), every gradient leaf within 1e-4 in L2 (bf16
  1e-2), the leaves whose gradient is 0 within 1e-3 (bf16 1e-2) of the
  largest, the Self-Monitor's BN statistics within 1e-3; launches exact
  (EnvDrop's IL: K1 = K2 = 2, K4-K7 = T_il; plain 0); then iterations with
  the configs' dropout and feedback on each route, their launches exact.
* ``main`` with TPU.CKPT_ASYNC True and False (PACKED_RL 0, 2 epochs of 2
  iterations, run together on the 6 x 160 world): the same checkpoint
  files after the rotation, every bundle equal array by array.
* ``run_eval`` over 32 paths written by ``write_results`` and scored from
  the file: the same scores as in memory.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch_card_world import (AGENT_CONFIGS, BATCH, CONFIG, FEAT_DIM, KERNELS, SEED,  # noqa: F401
                              ZERO_GRAD, agent_cfg, agent_launches, card, compare_actions,
                              finish_main, first_step_logits, iteration_launches, launch_counts,
                              launches_of, leaf_paths, reset_launch_counts, serving, start_main)

NONE = dict.fromkeys(KERNELS, 0)
MAIN_ITERS = 2   # iterations an epoch of the two ``main`` runs (2 epochs each)
EVAL_PATHS = 32  # paths (3 instructions each) of the results file
ITERS = 2        # iterations with dropout on each route


def bundle_arrays(path):
    """The arrays and numbers of a checkpoint bundle (not its config text)."""
    from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint

    b = load_checkpoint(path)
    return {k: b[k] for k in ("params", "opt_state", "model_state", "rng", "curriculum", "epoch")}


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.fixture(autouse=True)
def kernels_after(card):
    """The process's route back on the kernels after each test."""
    from curriculum_learning_for_vln_torch import ops

    yield
    ops.set_kernels(True)


def set_route(cfg, use_pallas: bool) -> None:
    """The route of the process, through ``loop.configure_runtime`` as the
    trainers set it, from ``cfg`` with TPU.USE_PALLAS ``use_pallas``."""
    from curriculum_learning_for_vln_torch.engine import loop

    c = cfg.clone()
    c.merge_from_list(["TPU.USE_PALLAS", use_pallas])
    loop.configure_runtime(c)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_navigator_plain_route_agrees_with_the_kernels(serving, card, prec):
    """f32: the serve tests' tolerance; bf16: the plain route's attention
    contracted in bf16, as JAX's is, against the kernels' f32 sums."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, _, requests, tok, cfg, m, params0 = serving
    T = cfg.AGENT.MAX_EPISODE_LEN
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=PRECISIONS[prec])
    navs = {on: Navigator(world, agent, params0, tok, max_batch=BATCH, precision=prec,
                          device=card, use_pallas=None if on else False)
            for on in (True, False)}
    per_call = launches_of(lstm_scan=2, pano_attend=T, cand_score=T)
    tol = 1e-4 if prec == "f32" else 1e-2
    for reqs in (requests[i:i + BATCH] for i in range(0, len(requests), BATCH)):
        ep = navs[True].episodes(reqs)
        res, counts = {}, {}
        for on in (True, False):
            reset_launch_counts()
            res[on] = navs[on].rollout(ep)
            counts[on] = launch_counts()
        assert counts[True] == per_call, f"serve {prec} kernels: launches {counts[True]}"
        assert counts[False] == NONE, f"serve {prec} plain: launches {counts[False]}"
        err, scale = first_step_logits(res[True], res[False])
        scale = max(scale, 1.0)
        assert err / scale <= tol, f"serve {prec}: first-step logits |plain - kernels| / scale " \
                                   f"{err / scale:.3g}"
        if compare_actions(res[True], res[False], tol * scale) == 0:
            outs = {on: navs[on].navigate_batch(reqs) for on in (True, False)}
            assert outs[True] == outs[False], f"serve {prec}: the same trajectories"


def route_compare(what, prec, loss_fn, leaves, paths, zero_paths=(), want=None):
    """``loss_fn(on)`` -> (loss, model-state leaves) with its backward, on
    the kernel route and on the plain one from the same inputs: the loss
    within 1e-5 relative in f32 (1e-3 in bf16: the plain route contracts
    the attention in bf16, as the JAX package's XLA route does, where the
    kernels accumulate in f32), every gradient leaf within 1e-4 (f32) or
    1e-2 (bf16) of its own L2 norm, the leaves whose true gradient is 0
    (``zero_paths``) within 1e-3 (f32) or 1e-2 (bf16: a few bf16 ulps) of
    the largest element, the model state within 1e-3; the plain run
    launches nothing, the kernel run ``want``."""
    runs = {}
    for on in (True, False):
        for p in leaves:
            p.grad = None
        reset_launch_counts()
        loss, state = loss_fn(on)
        loss.backward()
        runs[on] = (loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                  for p in leaves], [s.clone() for s in state], launch_counts())
    for p in leaves:
        p.grad = None
    (lk, gk, sk, ck), (lp, gp, sp, cp) = runs[True], runs[False]
    assert cp == NONE, f"{what} {prec}: the plain route launched {cp}"
    assert want is None or ck == want, f"{what} {prec}: kernel route launches {ck}, expected {want}"
    loss_rel = abs(lk - lp) / max(abs(lk), 1e-6)
    assert loss_rel <= (1e-5 if prec == "f32" else 1e-3), \
        f"{what} {prec}: loss kernels {lk} plain {lp} ({loss_rel:.3g})"
    tol = 1e-4 if prec == "f32" else 1e-2
    top = max(float(g.abs().max()) for g in gk)
    zero_tol = 1e-3 if prec == "f32" else 1e-2
    for path, a, b in zip(paths, gk, gp, strict=True):
        at = ".".join(map(str, path))
        if path in zero_paths:
            e = max(float(a.abs().max()), float(b.abs().max()))
            assert e <= zero_tol * top, f"{what} {prec}: the gradient of {at} {e:.3g} is not 0 " \
                                        f"against the largest, {top:.3g}"
            continue
        rel = float((b - a).float().norm()) / max(float(a.float().norm()), 1e-12)
        assert rel <= tol, f"{what} {prec}: gradient {at} plain vs kernels {rel:.3g} in L2 > {tol}"
    for a, b in zip(sk, sp, strict=True):
        e = float((a - b).abs().max()) / max(float(a.abs().max()), 1.0)
        assert e <= 1e-3, f"{what} {prec}: model state |plain - kernels| {e:.3g}"


def envdrop_setup(serving, device, prec, m):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, _, params0 = serving
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[prec],
                         obs_masks="prng")
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED + 4, device=device)
    params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
    return agent, world.device_tables(prec, device), env, params


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_envdrop_teacher_iteration_on_both_routes(serving, card, prec):
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.utils import tree

    cfg, m = serving[4], serving[5]
    m0 = m.clone()
    m0.DROP_RATE = m0.FEAT_DROP_RATE = 0.0
    agent0, tables, env, params = envdrop_setup(serving, card, prec, m0)
    batch = env.next_batch()
    t_il = il_bucket_fn(cfg, agent0)(env) or cfg.AGENT.MAX_EPISODE_LEN

    def loss_fn(on):
        set_route(cfg, on)
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        total, _ = loop.iteration_loss(agent0, "teacher", tables, params, batch, gen, il_len=t_il)
        return total, []

    want = launches_of(lstm_scan_train=2, lstm_scan_bwd=2, pano_attend=t_il, cand_score=t_il,
                       pano_attend_bwd=t_il, cand_score_bwd=t_il)
    route_compare("EnvDrop teacher iteration (IL)", prec, loss_fn, tree.tree_leaves(params),
                  leaf_paths(params), want=want)


def test_envdrop_iterations_with_dropout_launch_by_route(serving, card):
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn

    cfg, m = serving[4], serving[5]
    T = cfg.AGENT.MAX_EPISODE_LEN
    agent, tables, env, params = envdrop_setup(serving, card, "bf16", m)
    il_bucket = il_bucket_fn(cfg, agent)
    for on in (True, False):
        opt = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
        gen = torch.Generator(device=card).manual_seed(SEED + 1)
        for _ in range(ITERS):
            set_route(cfg, on)
            b = env.next_batch()
            il = il_bucket(env) or T
            reset_launch_counts()
            logs = loop.one_iter(agent, opt, "sample", tables, params, b, gen, il_len=il)
            float(logs["loss"])
            want = iteration_launches(il, T) if on else NONE
            counts = launch_counts()
            assert counts == want, f"EnvDrop bf16 USE_PALLAS {on}: launches {counts}, " \
                                   f"expected {want} (T_il {il})"


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(AGENT_CONFIGS))
def test_agent_teacher_iteration_on_both_routes(serving, card, name, prec):
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree

    world, data, _, tok, *_ = serving
    config = AGENT_CONFIGS[name][0]
    key = "FOLLOWER" if name == "FOLLOWER" else "MONITOR"
    cfg_a = agent_cfg(config)
    cfg_0 = agent_cfg(config, f"MODEL.{key}.DROP_RATE", 0.0, "TPU.PRECISION", prec)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED + 6, device=card)
    batch = env.next_batch()
    agent0 = build_agent(cfg_0, tok.vocab_size(), FEAT_DIM)
    params0, state0 = init_agent(agent0, torch.Generator().manual_seed(SEED))
    tables = world.device_tables(prec, card)
    params = tree.tree_map(lambda t: t.to(card).requires_grad_(True), params0)
    mstate = tree.tree_map(lambda t: t.to(card), state0)

    def loss_fn(on):
        set_route(cfg_a, on)
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        total, _, new_state = loop.agent_iteration_loss(
            agent0, "teacher", tables, params, mstate, batch, gen,
            lamb=cfg_a.TRAIN.PROGMONITOR_WEIGHT)
        return total, tree.tree_leaves(new_state)

    route_compare(f"{name} teacher iteration", prec, loss_fn, tree.tree_leaves(params),
                  leaf_paths(params), ZERO_GRAD[name], agent_launches(name, False))


@pytest.mark.parametrize("name", list(AGENT_CONFIGS))
def test_agent_iterations_with_dropout_launch_by_route(serving, card, name):
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree

    world, data, _, tok, *_ = serving
    cfg_a = agent_cfg(AGENT_CONFIGS[name][0])
    agent = build_agent(cfg_a, tok.vocab_size(), FEAT_DIM)
    params0, state0 = init_agent(agent, torch.Generator().manual_seed(SEED))
    tables = world.device_tables(cfg_a.TPU.PRECISION, card)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED + 6, device=card)
    for on in (True, False):
        params = tree.tree_map(lambda t: t.to(card).requires_grad_(True), params0)
        state = tree.tree_map(lambda t: t.to(card), state0)
        opt = loop.make_optimizer(cfg_a.TRAIN.OPTIM, cfg_a.TRAIN.LR, params)
        gen = torch.Generator(device=card).manual_seed(SEED + 1)
        want = agent_launches(name, False) if on else NONE
        for _ in range(ITERS):
            set_route(cfg_a, on)
            reset_launch_counts()
            logs, state = loop.agent_one_iter(agent, opt, cfg_a.AGENT.FEEDBACK, tables, params,
                                              state, env.next_batch(), gen,
                                              lamb=cfg_a.TRAIN.PROGMONITOR_WEIGHT)
            float(logs["loss"])
            counts = launch_counts()
            assert counts == want, f"{name} USE_PALLAS {on}: launches {counts}, expected {want}"


@pytest.fixture(scope="module")
def async_mains(card, tmp_path_factory):
    """``main`` with TPU.CKPT_ASYNC True and False, started together."""
    root = tmp_path_factory.mktemp("ckpt_async")
    args = ["--config-file", CONFIG, "TPU.PACKED_RL", 0, "TRAIN.MAX_EPOCH", 2,
            "TRAIN.ITER_PER_EPOCH", MAIN_ITERS, "TRAIN.EVAL_INTERVAL", 1]
    procs = {a: start_main([*args, "TPU.CKPT_ASYNC", a], str(root / str(a))) for a in (True, False)}
    for a, proc in procs.items():
        finish_main(f"CKPT_ASYNC {a}", proc, str(root / str(a)))
    files = {}
    for a in (True, False):
        files[a] = {n: os.path.join(d, n)
                    for d, _, names in os.walk(root / str(a) / "ckpt") for n in names}
    return files


def test_async_checkpoints_equal_the_synchronous_ones(async_mains):
    files = async_mains
    assert sorted(files[True]) == sorted(files[False]), \
        f"the rotation leaves the same files: {sorted(files[True])} / {sorted(files[False])}"
    assert "latest.ckpt" in files[True] and "latest_ep2.ckpt" in files[True] \
        and "latest_ep1.ckpt" not in files[True], f"the rotation ran: {sorted(files[True])}"
    for n in files[True]:
        assert trees_equal(bundle_arrays(files[True][n]), bundle_arrays(files[False][n])), \
            f"{n}: the asynchronous bundle equals the synchronous one array by array"


def test_write_results_scores_as_in_memory(serving, card, tmp_path):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.evaluator import Evaluation
    from curriculum_learning_for_vln_torch.engine.trainer import dedup_by_path
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, params0 = serving
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[cfg.TPU.PRECISION])
    henv = R2RBatchEnv(world, expand_r2r_items(data[:EVAL_PATHS], tok), BATCH, tok, seed=SEED,
                       name="val", device=card)
    params = tree.tree_map(lambda t: t.to(card), params0)
    results = loop.run_eval(agent, params, world.device_tables(cfg.TPU.PRECISION, card), henv)
    path = loop.write_results(results, str(tmp_path / "results"), split="val")
    ev = Evaluation(world, dedup_by_path(henv.data))
    from_file, _ = ev.score(path)
    in_memory, _ = ev.score(results)
    assert from_file == in_memory, f"write_results: scored from the file {from_file}, in memory " \
                                   f"{in_memory}"
    with open(path) as f:
        written = json.load(f)
    assert sorted(r["instr_id"] for r in written) == sorted(it["instr_id"] for it in henv.data), \
        "the results file holds every instruction once"
