"""The Exp3.S curriculum, the per-round train evaluation, R4R with the
path teacher, the rollout early exit and the Follower's frozen GloVe
table on the card, on the port's own synthetic world at EnvDrop's full
width (``pipeline.build_environments`` with ``TPU.SYNTHETIC_WORLD``, 6
scans of 160 nodes: 2048-d features), bf16, B = 64, T = 35.

* ``TRAIN.CLMODE AUTO`` on ``envdrop_cl_config.yaml`` (its PACKED_RL 3
  turned off by AUTO), the five rounds as the bandit's arms: one iteration
  through the kernels against the plain versions (bf16 and f32), then one
  epoch of the trainer ``main.build_trainer`` returns, each iteration's
  launches exact, its arms and ``log_w`` against a numpy Exp3.S.
* ``TRAIN.EVAL_TRAIN`` in that epoch: each round's train split scored at
  B = 128 (K3 twice and K4 = K6 = T a batch, exactly) before the
  validation splits, and one batch of 128 evaluated again with every K3,
  K4 and K6 call held against its plain version on the same inputs.
* ``DATA.NAME R4R`` with ``AGENT.TEACHER path``: one iteration kernels vs
  plain.
* ``TPU.SCAN_EARLY_EXIT`` on and off from the same seed, the IL rollout
  bucketed and at the full T: the same loss and gradients, the generator
  left in the same state, no more K4 launches on than off.
* The Follower with a GloVe table written as ``.npy``: kernels vs plain,
  one Adam step with exact launches, the table unchanged bit for bit.
* ``main`` as a user runs it, three processes run together, each printing
  its launches: AUTO with the early exit, EnvDrop on R4R with the path
  teacher, and the Follower with the GloVe table on R4R (the table read
  back from its checkpoint unchanged).  Every kernel but K8 launches on
  these paths.
"""
import logging
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch_card_world import (AGENT_CONFIGS, BATCH, CL_CONFIG, CONFIG, FEAT_DIM,  # noqa: F401
                              KERNELS, OFF_PATH, SEED, SYN_NODES, SYN_SCANS, ZERO_GRAD, agent_cfg,
                              agent_launches, card, compare, finish_main, iteration_launches,
                              launch_counts, launches_of, leaf_paths, modules, moved_leaves,
                              plain_kernels, reset_launch_counts, start_main)

AUTO_ITERS = 8  # AUTO iterations in one epoch: 8 draws of 5 arms repeat some, so
                # the epoch's end rewards the bandit
MAIN_ITERS = 3  # iterations an epoch of each ``main`` run


def kernel_vs_plain(what, grads_fn, tol=1e-2):
    """``grads_fn()`` -> (loss, gradient leaves) through the kernels and
    through their plain versions: the loss within 1e-4 of its scale, each
    leaf within ``tol`` of its largest plain element.  Returns the kernel
    run's launches."""
    reset_launch_counts()
    loss_k, g_k = grads_fn()
    counts = launch_counts()
    with plain_kernels():
        loss_p, g_p = grads_fn()
    assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
        f"{what}: loss kernels {loss_k} plain {loss_p}"
    for gk, gp in zip(g_k, g_p, strict=True):
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        assert e <= tol * sc, (f"{what}: a gradient leaf of shape {tuple(gk.shape)}: "
                               f"|kernel - plain| {e:.3g} > {tol * sc:.3g}")
    return counts


def config(path, *opts):
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    c = get_cfg_defaults()
    c.merge_from_file(path)
    c.merge_from_list(["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", SYN_SCANS,
                       "TPU.SYNTHETIC_NODES", SYN_NODES, *opts])
    return c


@pytest.fixture(scope="module")
def auto(card):
    """AUTO's config, tokenizer, world, arms, validation splits, agent,
    parameters and tables."""
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent

    cfg = config(CL_CONFIG, "TRAIN.CLMODE", "AUTO")
    tok = pipeline.build_tokenizer(cfg)
    world, arms_env, valid, feat_dim = pipeline.build_environments(cfg, tok, seed=SEED,
                                                                   device=card)
    assert feat_dim == FEAT_DIM and isinstance(arms_env, dict) and len(arms_env) == 5, \
        f"AUTO's arms on a {feat_dim}-d world: {sorted(arms_env)}"
    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    params0, _ = init_agent(agent, torch.Generator().manual_seed(SEED))
    return {"cfg": cfg, "tok": tok, "world": world, "arms": arms_env, "valid": valid,
            "agent": agent, "params0": params0, "T": cfg.AGENT.MAX_EPISODE_LEN,
            "tables": world.device_tables(cfg.TPU.PRECISION, card)}


def fresh(params0, device):
    from curriculum_learning_for_vln_torch.utils import tree

    return tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)


def envdrop_grads(agent, tables, params, batch, il_len, device):
    """run() -> (loss, clipped gradient leaves) of one sample-feedback
    iteration from one generator seed; run.gen_state, the generator's
    state after it."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    leaves = tree.tree_leaves(params)

    def run():
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        total, _ = loop.iteration_loss(agent, "sample", tables, params, batch, gen,
                                       il_len=il_len)
        for p in leaves:
            p.grad = None
        total.backward()
        loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        run.gen_state = gen.get_state()
        return total.item(), [p.grad.clone() for p in leaves]

    return run


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_auto_iteration_agrees_with_plain_versions(auto, card, prec):
    """One iteration on round_3 through the kernels against the plain
    versions; in f32 the kernels' summation order alone sets the
    difference (a bf16 gradient leaf is one bf16 rounding of the compute
    copy's gradient: an ulp there is up to 2^-7 of its max)."""
    from curriculum_learning_for_vln_torch.agents import build_agent
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn

    cfg, T = auto["cfg"], auto["T"]
    env = auto["arms"]["round_3"]
    batch = env.next_batch()
    il_len = il_bucket_fn(cfg, auto["agent"])(env)
    agent, tables = auto["agent"], auto["tables"]
    if prec != cfg.TPU.PRECISION:
        c = cfg.clone()
        c.merge_from_list(["TPU.PRECISION", prec])
        agent = build_agent(c, auto["tok"].vocab_size(), FEAT_DIM, vocab=auto["tok"].vocab)
        tables = auto["world"].device_tables(prec, card)
    counts = kernel_vs_plain(f"one AUTO iteration (round_3, {prec})",
                             envdrop_grads(agent, tables, fresh(auto["params0"], card), batch,
                                           il_len, card))
    assert counts == iteration_launches(il_len or T, T), f"AUTO iteration launches {counts}"


def exp3s_reference(n, kw, losses):
    """Exp3.S (fixed-share exponential weights, the loss decrease of an
    arm as its reward, rescaled against the quantiles of the recent
    rewards) recomputed in numpy over one epoch's losses: (the arms drawn,
    log_w after the epoch's rewards)."""
    rng = np.random.default_rng(kw["seed"])
    log_w, window, last, arms = np.zeros(n), [], {}, []

    def pi():
        w = np.exp(log_w - log_w.max())
        return (1.0 - kw["eps"]) * w / w.sum() + kw["eps"] / n

    for _ in losses:
        arms.append(int(rng.choice(n, p=pi())))
    for arm, loss in zip(arms, losses):
        if arm in last:
            r = last[arm] - loss
            window = (window + [r])[-max(2, kw["rrsize"]):]
            lo, hi = np.quantile(window, kw["beta"]), np.quantile(window, 1.0 - kw["beta"])
            r = 0.0 if hi <= lo else float(np.clip(2.0 * (r - lo) / (hi - lo) - 1.0, -1.0, 1.0))
            p = pi()
            v = log_w.copy()
            v[arm] += kw["eta"] * (r / max(p[arm], 1e-8))
            ew = np.exp(v - v.max())
            mixed = (1.0 - kw["alpha"]) * ew + kw["alpha"] / max(n - 1, 1) * (ew.sum() - ew)
            log_w = v.max() + np.log(np.maximum(mixed, 1e-300))
        last[arm] = loss
    return arms, log_w


@pytest.fixture(scope="module")
def auto_epoch(auto, card, tmp_path_factory):
    """One epoch of the AUTO trainer with EVAL_TRAIN, every iteration's and
    every evaluation's launches recorded."""
    from curriculum_learning_for_vln_torch import main as main_mod
    from curriculum_learning_for_vln_torch.engine import auto_curriculum
    from curriculum_learning_for_vln_torch.engine import trainer as trainer_mod
    from curriculum_learning_for_vln_torch.engine.trainer import packed_factor
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv

    cfg, tok, world, arms_env = auto["cfg"], auto["tok"], auto["world"], auto["arms"]
    # TRAIN.EVAL_TRAIN's envs as main.eval_train_envs builds them, over the arms' items
    eval_env = {k: R2RBatchEnv(world, e.data, 2 * BATCH, tok, SEED + 100 + int(k[-1]), "train",
                               device=card) for k, e in arms_env.items()}
    c = cfg.clone()
    c.merge_from_list(["TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", AUTO_ITERS,
                       "TRAIN.EVAL_INTERVAL", 1, "TRAIN.EVAL_TRAIN", True,
                       "OUTPUT.CKPT_DIR", str(tmp_path_factory.mktemp("auto")),
                       "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", ""])
    trainer = main_mod.build_trainer(c, arms_env, logging.getLogger(__name__), seed=SEED)
    assert isinstance(trainer, auto_curriculum.AutoCurriculum), f"AUTO builds {type(trainer)}"
    assert packed_factor(c, auto["agent"], trainer) == 0, "AUTO turns packed RL off"
    record, epoch_losses = {}, trainer.on_epoch_losses

    def recording(losses):
        record["drawn"], record["losses"] = list(trainer._arms), list(losses)
        epoch_losses(losses)

    trainer.on_epoch_losses = recording
    per_iter, evals, summaries = [], {}, []
    one_iter, run_eval, prettyprint = (trainer_mod.one_iter, trainer_mod.run_eval,
                                       trainer_mod.prettyprint)

    def counted_iter(*args, **kwargs):
        before = launch_counts()
        logs = one_iter(*args, **kwargs)
        float(logs["loss"])  # a sync: the iteration has finished
        after = launch_counts()
        per_iter.append((kwargs.get("il_len") or auto["T"],
                         {k: after[k] - before[k] for k in KERNELS}))
        return logs

    def counted_eval(agent_, params_, tables_, env, *args):
        before = launch_counts()
        results = run_eval(agent_, params_, tables_, env, *args)
        after = launch_counts()
        key = next((k for k, e in eval_env.items() if e is env), env.name)
        evals[key] = {k: after[k] - before[k] for k in KERNELS}
        return results

    trainer_mod.one_iter, trainer_mod.run_eval = counted_iter, counted_eval
    trainer_mod.prettyprint = summaries.append
    try:
        reset_launch_counts()
        params, _ = trainer.train(c, auto["agent"], "", arms_env, auto["valid"], seed=SEED,
                                  device=card, eval_train=True, eval_train_env=eval_env)
        totals = launch_counts()
    finally:
        trainer_mod.one_iter, trainer_mod.run_eval = one_iter, run_eval
        trainer_mod.prettyprint = prettyprint
    return {"trainer": trainer, "record": record, "per_iter": per_iter, "evals": evals,
            "summaries": summaries, "params": params, "eval_env": eval_env, "totals": totals}


def test_auto_trainer_launches_are_exact(auto_epoch, auto):
    for t_il, got in auto_epoch["per_iter"]:
        assert got == iteration_launches(t_il, auto["T"]), \
            f"AUTO trainer iteration launches {got} (T_il {t_il})"


def test_auto_arms_and_log_w_match_numpy_exp3s(auto_epoch, auto):
    trainer = auto_epoch["trainer"]
    drawn, losses = auto_epoch["record"]["drawn"], auto_epoch["record"]["losses"]
    ref_arms, ref_log_w = exp3s_reference(len(auto["arms"]), trainer._cfg, losses)
    assert len(losses) == AUTO_ITERS and drawn == ref_arms, f"AUTO arms {drawn} vs numpy {ref_arms}"
    assert float(np.abs(trainer.bandit.log_w - ref_log_w).max()) <= 1e-12 \
        and bool(np.any(ref_log_w != 0)), f"AUTO log_w {trainer.bandit.log_w} vs numpy {ref_log_w}"
    assert all(np.isfinite(losses)), f"finite AUTO losses {losses}"


def test_eval_train_scores_every_round_with_exact_launches(auto_epoch, auto):
    keys, summaries, T = sorted(auto["arms"]), auto_epoch["summaries"], auto["T"]
    assert len(summaries) == 2 and list(summaries[0]) == keys \
        and list(summaries[1]) == list(auto["valid"]), f"EVAL_TRAIN summaries {summaries}"
    for k, env in auto_epoch["eval_env"].items():
        n = -(-env.size() // env.batch_size)  # eval batches
        want = launches_of(lstm_scan=2 * n, pano_attend=T * n, cand_score=T * n)
        assert auto_epoch["evals"].get(k) == want, \
            f"EVAL_TRAIN {k} launches {auto_epoch['evals'].get(k)}, expected {want}"
        assert all(np.isfinite(summaries[0][k][mk]) for mk in ("success_rate", "spl")), \
            f"EVAL_TRAIN {k} scores"


@contextmanager
def checked_calls():
    """Hold every call of K3, K4 and K6 against its plain version on the
    same inputs, as the calls are made (1e-4 of each output's scale, K4's
    candidate rows exact).  Yields {name: [(max |kernel - plain|, tol)]}."""
    mods = modules()
    where = {"lstm_scan": "lstm_scan", "pano_attend": "pano_fused", "cand_score": "cand_score"}
    saved = {n: getattr(mods[m], n) for n, m in where.items()}
    calls = {n: [] for n in where}

    def flat(out):  # the output tensors, nested tuples opened
        if not isinstance(out, tuple):
            return [out]
        return [t for x in out for t in flat(x)]

    def wrap(name, fn):
        def call(*args, **kwargs):
            got = fn(*args, **kwargs)
            want = getattr(mods[where[name]], name + "_plain")(*args, **kwargs)
            g, w = flat(got), flat(want)
            if name == "pano_attend":  # (visual, alpha, candidate rows)
                assert torch.equal(g[2], w[2]), "K4's candidate rows are exact copies"
                g, w = g[:2], w[:2]
            calls[name].append(compare(g, w, 1e-4))
            return got

        return call

    for name, fn in saved.items():
        setattr(mods[where[name]], name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(mods[where[name]], name, fn)


def test_eval_train_batch_agrees_with_plain_call_by_call(auto_epoch, auto):
    """One EVAL_TRAIN batch of 128 again, the trained parameters: each K3,
    K4 and K6 call against its plain version on its own inputs."""
    from curriculum_learning_for_vln_torch.engine import loop

    ep = next(iter(auto_epoch["eval_env"]["round_1"].eval_batches()))
    assert ep.instr_tokens.shape[0] == 2 * BATCH, f"an EVAL_TRAIN batch of {2 * BATCH}"
    with checked_calls() as calls:
        loop.build_eval_rollout(auto["agent"])(auto["tables"], auto_epoch["params"], ep)
    for name, errs in calls.items():
        assert all(x <= t for x, t in errs), \
            f"EVAL_TRAIN B = {2 * BATCH}: {name} |kernel - plain| {max(errs)} ({len(errs)} calls)"
    n = {name: len(errs) for name, errs in calls.items()}
    assert n == {"lstm_scan": 2, "pano_attend": auto["T"], "cand_score": auto["T"]}, \
        f"EVAL_TRAIN B = {2 * BATCH} calls {n}"


def test_r4r_iteration_with_path_teacher_agrees_with_plain_versions(auto, card):
    """The pipeline's R4R branch: waypoints past the goal, one iteration
    kernels vs plain."""
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn

    tok, T = auto["tok"], auto["T"]
    rcfg = config(CONFIG, "DATA.NAME", "R4R", "AGENT.TEACHER", "path")
    rworld, r4r_env, _, _ = pipeline.build_environments(rcfg, tok, seed=SEED, device=card)
    ragent = build_agent(rcfg, tok.vocab_size(), FEAT_DIM, vocab=tok.vocab)
    batch = r4r_env.next_batch()
    il_len = il_bucket_fn(rcfg, ragent)(r4r_env)
    P = r4r_env.path_local.shape[1]
    assert r4r_env.teacher_mode == "path" and P > 2 and bool((batch.path_len > 2).all()), \
        f"R4R waypoints: P = {P}"
    counts = kernel_vs_plain(
        "one R4R iteration, path teacher",
        envdrop_grads(ragent, rworld.device_tables(rcfg.TPU.PRECISION, card),
                      fresh(auto["params0"], card), batch, il_len, card))
    assert counts == iteration_launches(il_len or T, T), f"R4R iteration launches {counts}"


@pytest.mark.parametrize("bucketed", [True, False], ids=["il_bucket", "il_full"])
def test_early_exit_gives_the_same_update(auto, card, bucketed):
    """``TPU.SCAN_EARLY_EXIT`` on and off (``loop.configure_runtime``) from
    the same seed: the loss within 1e-4 of its scale, every gradient leaf
    within 1e-2 of its largest element, the generator in the same state;
    off launches exactly, on no more K4 than off."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn

    cfg, T = auto["cfg"], auto["T"]

    def early_exit(on):
        e = cfg.clone()
        e.merge_from_list(["TPU.SCAN_EARLY_EXIT", on])
        loop.configure_runtime(e)

    env = auto["arms"]["round_5"]
    batch = env.next_batch()
    il = il_bucket_fn(cfg, auto["agent"])(env) if bucketed else None
    fn = envdrop_grads(auto["agent"], auto["tables"], fresh(auto["params0"], card), batch, il,
                       card)
    runs = {}
    try:
        for on in (False, True):
            early_exit(on)
            reset_launch_counts()
            loss, grads = fn()
            runs[on] = (loss, grads, launch_counts(), fn.gen_state)
    finally:
        early_exit(False)
    (l0, g0, c0, s0), (l1, g1, c1, s1) = runs[False], runs[True]
    assert torch.equal(s0, s1), "early exit: the generator ends elsewhere"
    assert abs(l1 - l0) <= 1e-4 * max(1.0, abs(l0)), f"early exit: loss {l1} vs {l0}"
    for a, b in zip(g1, g0, strict=True):
        sc = max(float(b.abs().max()), 1e-6)
        e = float((a - b).abs().max())
        assert e <= 1e-2 * sc, f"early exit: a gradient leaf |on - off| {e:.3g}"
    assert c0 == iteration_launches(il or T, T) and c1["pano_attend"] <= c0["pano_attend"], \
        f"early exit: launches off {c0}, on {c1}"


@pytest.fixture(scope="module")
def glove(auto, tmp_path_factory):
    """A GloVe table for the Follower, written as .npy: (path, table)."""
    fcfg = agent_cfg(AGENT_CONFIGS["FOLLOWER"][0])
    dim = fcfg.MODEL.FOLLOWER.WORD_EMB_SIZE
    table = np.random.default_rng(SEED + 3).normal(0, 0.3, (auto["tok"].vocab_size(), dim))
    table = table.astype(np.float32)
    path = str(tmp_path_factory.mktemp("glove") / "glove.npy")
    np.save(path, table)
    return path, table


def test_follower_with_frozen_glove_table(auto, glove, card):
    """Kernels vs plain, then one optimizer step with exact launches: no
    gradient reaches the table, the table is unchanged bit for bit, and
    every trained leaf moves."""
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree

    tok, tables = auto["tok"], auto["tables"]
    path, table = glove
    fcfg = agent_cfg(AGENT_CONFIGS["FOLLOWER"][0], "MODEL.FOLLOWER.GLOVE_PATH", path)
    fagent = build_agent(fcfg, tok.vocab_size(), FEAT_DIM, vocab=tok.vocab)
    fparams0, fstate = init_agent(fagent, torch.Generator().manual_seed(SEED))
    fparams = fresh(fparams0, card)
    emb = fparams["encoder"]["embedding"]["w"]
    frozen = emb.detach().clone()
    assert torch.equal(frozen.cpu(), torch.from_numpy(table)), \
        "the Follower's embedding is the GloVe table"
    fenv = R2RBatchEnv(auto["world"], auto["arms"]["round_5"].data, BATCH, tok, SEED, device=card)
    fbatch = fenv.next_batch()
    fleaves = [leaf for p, leaf in zip(leaf_paths(fparams), tree.tree_leaves(fparams))
               if p not in ZERO_GRAD["FOLLOWER"] and p != ("encoder", "embedding", "w")]

    def follower_grads():
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        total, _, _ = loop.agent_iteration_loss(fagent, fcfg.AGENT.FEEDBACK, tables, fparams,
                                                fstate, fbatch, gen)
        for p in tree.tree_leaves(fparams):
            p.grad = None
        total.backward()
        assert emb.grad is None, "no gradient reaches the GloVe table"
        return total.item(), [torch.zeros_like(leaf) if leaf.grad is None else leaf.grad.clone()
                              for leaf in fleaves]

    counts = kernel_vs_plain("a Follower iteration with frozen GloVe", follower_grads)
    assert counts == agent_launches("FOLLOWER", False), f"GloVe Follower launches {counts}"
    optimizer = loop.make_optimizer(fcfg.TRAIN.OPTIM, fcfg.TRAIN.LR, fparams)
    before = [leaf.detach().clone() for leaf in fleaves]
    reset_launch_counts()
    loop.agent_one_iter(fagent, optimizer, fcfg.AGENT.FEEDBACK, tables, fparams, fstate, fbatch,
                        torch.Generator(device=card).manual_seed(SEED + 1))
    counts = launch_counts()
    assert counts == agent_launches("FOLLOWER", False), f"GloVe Follower step launches {counts}"
    assert torch.equal(emb.detach(), frozen), "the GloVe table moved in an optimizer step"
    moved = moved_leaves(before, fleaves)
    assert moved == len(fleaves), f"{moved} of {len(fleaves)} trained leaves moved"


MAIN_RUNS = {
    "auto": (f"--config-file {CL_CONFIG} TRAIN.CLMODE AUTO TPU.SCAN_EARLY_EXIT True",
             "Using AutoCurriculum (Exp3.S) trainer"),
    "r4r": (f"--config-file {CONFIG} DATA.NAME R4R AGENT.TEACHER path", "Using Classic trainer"),
    "glove": (f"--config-file {AGENT_CONFIGS['FOLLOWER'][0]} DATA.NAME R4R AGENT.TEACHER path",
              "Using Classic trainer"),
}


@pytest.fixture(scope="module")
def mains(glove, card, tmp_path_factory):
    """The three ``main`` runs, started together, each in a process of its
    own: {run: (directory, launches, log lines)}."""
    small = ("TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", MAIN_ITERS, "TRAIN.EVAL_INTERVAL", 2)
    root = tmp_path_factory.mktemp("main")
    procs = {}
    for what, (args, _) in MAIN_RUNS.items():
        extra = ("MODEL.FOLLOWER.GLOVE_PATH", glove[0]) if what == "glove" else ()
        d = str(root / what)
        procs[what] = (d, start_main([*args.split(), *extra, *small], d))
    return {what: (d, *finish_main(what, proc, d)[:2]) for what, (d, proc) in procs.items()}


@pytest.mark.parametrize("what", MAIN_RUNS)
def test_main_runs_as_a_user_runs_it(mains, glove, what):
    """Two epochs of MAIN_ITERS iterations: its trainer, K1 = K2 = 4 an
    iteration, and every other kernel on its path launched (the Follower
    scores no candidates by K6 / K7)."""
    from curriculum_learning_for_vln_torch.convert import params_from_jax
    from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint

    d, counts, lines = mains[what]
    iters = 2 * MAIN_ITERS
    assert MAIN_RUNS[what][1] in lines and sum("Epoch [" in ln for ln in lines) == 2, \
        f"main {what}: log {lines}"
    assert counts["lstm_scan_train"] == counts["lstm_scan_bwd"] == 4 * iters \
        and all(counts[k] > 0 for k in KERNELS if k not in OFF_PATH and
                (what != "glove" or k not in ("cand_score", "cand_score_bwd"))), \
        f"main {what}: launches {counts}"
    if what == "glove":  # the table, read back from the run's checkpoint, unchanged
        saved = params_from_jax(load_checkpoint(os.path.join(d, "ckpt", "latest.ckpt"))
                                ["params"])["encoder"]["embedding"]["w"]
        assert torch.equal(torch.as_tensor(np.asarray(saved)), torch.from_numpy(glove[1])), \
            "main glove: the checkpoint's embedding is the GloVe table"


def test_every_kernel_but_k8_launches_on_these_paths(auto_epoch, mains):
    ran = {k for c in (auto_epoch["totals"], *(m[1] for m in mains.values()))
           for k in KERNELS if c.get(k, 0) > 0}
    missing = set(KERNELS) - set(OFF_PATH) - ran
    assert not missing, f"kernels not launched on this slice's paths: {missing}"
