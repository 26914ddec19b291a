"""The paper's curriculum recipe on the card: ``configs/envdrop/
envdrop_cl_config.yaml`` as shipped (PACKED_RL 3), the serving world and
width, its request paths cut into 5 rounds by length, bf16, B = 64, T =
35.

* ``NaiveCurriculum(switch_epoch=1)``, 2 epochs x 2 packed iterations and
  an evaluation: round_1, then the cumulative round_2.
* One SPCL packed weighted iteration in ``OBS_MASKS prng_shared`` through
  the kernels against the plain versions (loss and every gradient leaf).
* ``SelfPacedCurriculum.train``, one epoch of packed iterations, each with
  its launches exact (K1 = K2 = 4, K4 = K6 = T_il + 36, K5 = K7 = T_il +
  35), and the SPCL update at the epoch's end (BURN_IN 0, INTERVAL 1)
  against a numpy recomputation.
"""
import numpy as np
import pytest
import torch
from torch_card_world import (BATCH, FEAT_DIM, KERNELS, OFF_PATH, SEED, card,  # noqa: F401
                              curriculum_setup, iteration_launches, launch_counts, plain_kernels,
                              reset_launch_counts, serving)

ITERS = 8  # SPCL packed iterations of the trainer's epoch


@pytest.fixture(scope="module")
def setup(serving, card, tmp_path_factory):
    world, data, _, tok, *_ = serving
    cfg, naive_envs, spcl_env, valid = curriculum_setup(world, data, tok, card)
    tmp = str(tmp_path_factory.mktemp("ckpt"))

    def run_cfg(*extra):
        c = cfg.clone()
        c.merge_from_list(["OUTPUT.CKPT_DIR", tmp, "OUTPUT.TSBOARD_DIR", "",
                           "OUTPUT.LOG_DIR", "", *extra])
        return c

    return cfg, naive_envs, spcl_env, valid, run_cfg


def agent_for(cfg, tok, masks):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    return EnvDropAgent(cfg.MODEL.ENVDROP, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                        cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[cfg.TPU.PRECISION],
                        obs_masks=masks)


def test_naive_rounds_switch_every_epoch(setup, serving, card):
    from curriculum_learning_for_vln_torch.engine import curriculum

    cfg, naive_envs, _, valid, run_cfg = setup
    tok = serving[3]

    class Naive(curriculum.NaiveCurriculum):
        def select_env(self, train_env, ep):
            env = super().select_env(train_env, ep)
            self.used.append((ep, env))
            return env

    naive = Naive(switch_epoch=1)
    naive.used = []
    reset_launch_counts()
    c = run_cfg("TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.EVAL_INTERVAL", 2)
    naive.train(c, agent_for(cfg, tok, "prng"), "", naive_envs, valid, seed=SEED, device=card)
    counts = launch_counts()
    used = {ep: env for ep, env in naive.used if ep > 0}
    r1, r2 = naive_envs["round_1"], naive_envs["round_2"]
    assert used.get(1) is r1 and used.get(2) is r2, "NAIVE epoch 1 on round_1, epoch 2 on round_2"
    assert r2.data[:r1.size()] == r1.data and r2.size() > r1.size(), "round_2 holds round_1"
    assert counts["lstm_scan_train"] == 4 * 4, f"NAIVE: 4 packed iterations {counts}"


def test_spcl_packed_iteration_agrees_with_plain_versions(setup, serving, card):
    """prng_shared: the loss within 1e-4 of its scale, every gradient leaf
    within 1e-2 of its largest plain element."""
    from curriculum_learning_for_vln_torch.engine import curriculum, loop
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.utils import tree

    cfg, _, spcl_env, _, _ = setup
    world, _, _, tok, _, _, params0 = serving
    agent = agent_for(cfg, tok, "prng_shared")
    spcl = curriculum.SelfPacedCurriculum.from_config(cfg, spcl_env, device=card)
    tables = world.device_tables(cfg.TPU.PRECISION, card)
    il_bucket = il_bucket_fn(cfg, agent)
    params = tree.tree_map(lambda t: t.to(card).requires_grad_(True), params0)
    leaves = tree.tree_leaves(params)
    raws, idx = [], []
    for _ in range(cfg.TPU.PACKED_RL):
        raws.append(spcl_env.next_batch())
        idx.append(spcl_env.cur_batch_index)
        if len(raws) == 1:
            il_len = il_bucket(spcl_env)
    pool = loop.concat_batches(raws)
    loop.check_pool_valid(pool)
    w_il, w_pool = spcl.batch_weights(idx[0]), spcl.batch_weights(np.concatenate(idx))
    assert bool((w_pool != w_pool[0]).any()), "the SPCL weights differ across the pool"

    def grads():
        gen = torch.Generator(device=card).manual_seed(SEED + 9)
        total, _ = loop.packed_iteration_loss(agent, tables, params, raws[0], pool, gen,
                                              w_il, w_pool, il_len)
        for p in leaves:
            p.grad = None
        total.backward()
        loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return total.item(), [p.grad.clone() for p in leaves]

    loss_k, g_k = grads()
    with plain_kernels():
        loss_p, g_p = grads()
    assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
        f"SPCL packed loss kernels {loss_k} vs plain {loss_p}"
    for gk, gp in zip(g_k, g_p):
        scale = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        assert e <= 1e-2 * scale, (f"an SPCL packed gradient leaf of shape {tuple(gk.shape)}: "
                                   f"|kernel - plain| {e:.3g} > {1e-2 * scale:.3g}")


@pytest.fixture(scope="module")
def spcl_epoch(setup, serving, card):
    """One epoch of ``SelfPacedCurriculum.train`` with every packed
    iteration's launches recorded, and the weights, lambda and losses just
    before the epoch's update."""
    from curriculum_learning_for_vln_torch.engine import curriculum, loop
    from curriculum_learning_for_vln_torch.engine import trainer as trainer_mod

    cfg, _, spcl_env, valid, run_cfg = setup
    tok = serving[3]
    per_iter, snap = [], {}
    packed_one_iter = loop.packed_one_iter

    def counted(*args):
        before = launch_counts()
        logs = packed_one_iter(*args)
        int(logs["episodes_done"])  # a sync: the iteration has finished
        after = launch_counts()
        per_iter.append((args[9], {k: after[k] - before[k] for k in KERNELS}))  # il_len
        return logs

    class Spcl(curriculum.SelfPacedCurriculum):
        def end_epoch(self, ep, writer):
            snap.update(w=self.weight.cpu().numpy(), lamb=float(self.lamb),
                        loss=self.loss_for_item.cpu().numpy())
            super().end_epoch(ep, writer)

    c = run_cfg("TRAIN.CLMODE", "SELF-PACE", "TPU.OBS_MASKS", "prng_shared",
                "TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", ITERS, "TRAIN.EVAL_INTERVAL", 100,
                "TRAIN.SELF_PACE.BURN_IN", 0, "TRAIN.SELF_PACE.INTERVAL", 1)
    trainer = Spcl.from_config(c, spcl_env, device=card)
    trainer_mod.packed_one_iter = counted
    try:
        reset_launch_counts()
        trainer.train(c, agent_for(cfg, tok, "prng_shared"), "", spcl_env, valid, seed=SEED,
                      device=card)
        totals = launch_counts()
    finally:
        trainer_mod.packed_one_iter = packed_one_iter
    return c, trainer, per_iter, totals, snap


def test_spcl_trainer_launches_are_exact(spcl_epoch, setup):
    T = setup[0].AGENT.MAX_EPISODE_LEN
    _, _, per_iter, totals, _ = spcl_epoch
    assert len(per_iter) == ITERS, f"{len(per_iter)} packed iterations"
    for il, got in per_iter:
        t_il = il or T
        want = iteration_launches(t_il, T)
        assert got == want, f"packed iteration launches {got}, expected {want} (T_il {t_il})"
    for name in KERNELS:
        assert totals[name] > 0 or name in OFF_PATH or name == "lstm_scan", \
            f"{name} launched on its main path, SPCL packed training"


def spcl_reference(lamb0, loss, a, c, mu, pace):
    """One SPCL update (lambda, then weights) in numpy f32."""
    f32 = np.float32
    lamb = f32(lamb0 + mu) if lamb0 < loss.max() else f32(lamb0 + f32(mu / 2))
    easy = {"linear": lambda: 1 - loss / lamb, "binary": lambda: np.ones_like(loss),
            "log": lambda: np.log(loss + (1 - lamb)) / np.log(1 - lamb)}[pace]()
    w = np.maximum(np.where(loss >= lamb, f32(0.01), easy), f32(0.01)).astype(f32)
    aw = np.dot(a, w)
    if aw > c:
        w = w + a * (c - aw) / np.dot(a, a)
        w = np.where(w <= 0, f32(0.001), w)
    return w.astype(f32), lamb


def test_spcl_update_on_the_card_matches_numpy(spcl_epoch, setup):
    c, trainer, _, _, snap = spcl_epoch
    spcl_env = setup[2]
    w_ref, lamb_ref = spcl_reference(snap["lamb"], snap["loss"], spcl_env.a,
                                     np.float32(spcl_env.c), c.TRAIN.SELF_PACE.MIU,
                                     c.TRAIN.SELF_PACE.FUNC)
    w_err = float(np.abs(trainer.weight.cpu().numpy() - w_ref).max())
    lamb_err = abs(float(trainer.lamb) - float(lamb_ref))
    recorded = int((snap["loss"] > 0).sum())
    assert recorded >= BATCH and w_err <= 1e-6 and lamb_err <= 1e-6, \
        (f"SPCL update on the card: |w - numpy| {w_err:.3g}, |lambda - numpy| {lamb_err:.3g}, "
         f"{recorded} items recorded")
    assert not np.array_equal(trainer.weight.cpu().numpy(), snap["w"]), "the weights moved"
