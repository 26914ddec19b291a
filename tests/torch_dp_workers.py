"""Rank processes for the port's data-parallel tests.

A test spawns N CPU ranks (``spawn``: torch.multiprocessing, gloo over a
file store) that each run one of the jobs below on a payload the test
saved, and save what they computed; the test compares it with one
process.  This module imports torch and the port only, so the ranks
never load JAX (each reports ``jax_loaded``), and it runs the same
training scenarios in one process (``run_scenario``) for the reference.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_RANKS = 4

# a tiny synthetic world and model widths for every scenario
TINY = ["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3, "TPU.SYNTHETIC_NODES", 24,
        "TPU.SYNTHETIC_TRAIN_PATHS", 20, "TPU.SYNTHETIC_VAL_PATHS", 6, "TRAIN.BATCH_SIZE", 8,
        "AGENT.MAX_EPISODE_LEN", 6, "DATA.MAX_ENC_LEN", 16, "TPU.PRECISION", "f32",
        "TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.EVAL_INTERVAL", 1,
        "MODEL.ENVDROP.HIDDEN_SIZE", 32, "MODEL.ENVDROP.WORD_EMB_SIZE", 16,
        "MODEL.ENVDROP.ACT_EMB_SIZE", 16, "MODEL.FOLLOWER.WORD_EMB_SIZE", 30,
        "MODEL.FOLLOWER.HIDDEN_SIZE", 32, "MODEL.MONITOR.WORD_EMB_SIZE", 16,
        "MODEL.MONITOR.HIDDEN_SIZE", 32, "MODEL.MONITOR.MLP_HIDDEN", "(48,)",
        "OUTPUT.LOG_DIR", "",
        # SGD: the update is linear in the gradient, so the ranks' other
        # order of summation stays at f32 rounding (Adam's and RMSprop's
        # first steps are about lr * sign(g), which a near-zero gradient
        # element flips)
        "TRAIN.OPTIM", "sgd", "TRAIN.LR", 0.005]

# name -> (config, overrides): what each trainer scenario exercises
SCENARIOS = {
    # EnvDrop IL + A2C, sample feedback, dropout and prng env-dropout on
    "classic": ("envdrop/envdrop_config.yaml", ["TPU.PACKED_RL", 0]),
    # the same through the hand-written rollout BPTT (its backward redraws
    # the global batch's masks)
    "bptt": ("envdrop/envdrop_config.yaml", ["TPU.PACKED_RL", 0, "TPU.FUSED_BPTT", True]),
    # SPCL with packed RL as shipped (a pool of 3 batches), prng_shared
    "packed": ("envdrop/envdrop_cl_config.yaml",
               ["TRAIN.CLMODE", "SELF-PACE", "TPU.OBS_MASKS", "prng_shared",
                "TRAIN.SELF_PACE.INTERVAL", 1]),
    # the Follower under SPCL, teacher feedback
    "spcl_follower": ("follower/follower_cl_config.yaml",
                      ["TRAIN.CLMODE", "SELF-PACE", "AGENT.FEEDBACK", "teacher",
                       "TRAIN.SELF_PACE.INTERVAL", 1]),
    # the Exp3.S bandit over the rounds
    "auto": ("envdrop/envdrop_cl_config.yaml", ["TRAIN.CLMODE", "AUTO"]),
    # the Self-Monitor's BN statistics, sample feedback
    "monitor": ("monitor/selfmonitor_config.yaml", ["AGENT.FEEDBACK", "sample"]),
}


def spawn(job: str, n: int, payload=None) -> list:
    """Run ``job`` on ``n`` CPU ranks; returns each rank's result."""
    assert n <= MAX_RANKS
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(payload, os.path.join(tmp, "payload.pt"))
        mp.start_processes(_rank_main, args=(n, tmp, job), nprocs=n, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
                for r in range(n)]


def _rank_main(rank: int, n: int, tmp: str, job: str) -> None:
    import torch.distributed as dist

    from curriculum_learning_for_vln_torch.parallel import mesh as M

    torch.set_num_threads(1)
    os.chdir(REPO)
    M.init_process_group(f"file://{tmp}/store", n, rank, device="cpu", timeout_s=300)
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = JOBS[job](payload)
    finally:
        dist.destroy_process_group()
    out["jax_loaded"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def step_job(p: dict) -> dict:
    """For each case: one SGD step of its agent with teacher feedback over
    this rank's rows of its batch (engine.loop with the mesh); the
    updated leaves and the logs."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.utils.tree import tree_leaves, tree_map

    mesh = M.make_mesh()
    steps = []
    for c in p["cases"]:
        params = M.replicate(tree_map(lambda t: t.clone().requires_grad_(True), c["params"]))
        tables = c["world"].device_tables("f32", device="cpu")
        ep = M.shard_batch(c["ep"], mesh)
        opt = loop.make_optimizer("sgd", c["lr"], params)
        gen = torch.Generator().manual_seed(3)
        agent = c["agent"]
        if agent.name == "ENVDROP":
            logs = loop.one_iter(agent, opt, "teacher", tables, params, ep, gen, mesh=mesh)
        else:
            logs, _ = loop.agent_one_iter(agent, opt, "teacher", tables, params, {}, ep, gen,
                                          mesh=mesh)
        steps.append({"leaves": [t.detach().clone() for t in tree_leaves(params)],
                      "logs": {k: v.clone() for k, v in logs.items()}})
    return {"steps": steps}


def draws_of(mesh, rows: int, agent) -> dict:
    """A rollout's kinds of draws from one generator, in a sharded step of
    ``mesh`` (None: one process) whose ranks hold ``rows`` rows: dropout on
    [B, H] and on [T, B, H] (batch axis 1), Gumbel noise, and each mask
    mode's env-dropout of ``agent``."""
    from curriculum_learning_for_vln_torch.agents.common import gumbel_noise
    from curriculum_learning_for_vln_torch.models.core import dropout
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    gen = torch.Generator().manual_seed(11)
    out = {}
    with M.sharded_step(mesh):
        out["dropout"] = dropout(torch.ones(rows, 5), 0.5, True, gen, batch_dim=0)
        out["dropout_t"] = dropout(torch.ones(3, rows, 5), 0.5, True, gen, batch_dim=1)
        out["gumbel"] = gumbel_noise((rows, 7), gen, "cpu")
        for mode in ("prng", "prng_shared", "ext"):
            agent.obs_masks = mode
            out[mode] = agent._obs_drop(rows, 4, 6, True, "cpu", gen)
        out["generator"] = gen.get_state()
    return out


def scenario_job(p: dict) -> dict:
    out = {name: run_scenario(name, os.path.join(p["out"], name)) for name in p["names"]}
    out["self_train"] = run_self_train()
    return out


def tp_job(p: dict) -> dict:
    """The ViLBERT scorer's vil_logit over (data 1, model N), the
    parameters cut by ``shard_vilbert_params``."""
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.parallel import vilbert_sharding as S

    mesh = M.make_mesh(data=1, model=M.world_size())
    scorer = VLNBertScorer(p["cfg"])
    local = S.shard_vilbert_params(p["params"], mesh)
    logit = scorer.score_paths(local, *p["inputs"], tp=S.tensor_parallel(mesh))
    q = local["bert"]["t_layers"][0]["attn"]["query"]["w"]
    return {"logit": logit.clone(), "q_shape": tuple(q.shape)}


def scoring_inputs(n_paths: int = 20):
    """A tiny synthetic world, its items and tokenizer, and a seeded ViLBERT
    scorer over its features, as build_clr2r scores them."""
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig, vlnbert_init
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, build_vocab
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    feat = 32
    graphs = synthetic.make_world_graphs(2, 16, seed=0)
    world = compiler.compile_world(graphs, max_candidates=16)
    rooms = synthetic.assign_rooms(world, seed=0)
    synthetic.attach_grounded_features(world, rooms, feature_dim=feat, seed=0)
    items = synthetic.make_grounded_dataset(graphs, world, rooms, num_paths=n_paths, seed=1)
    tok = Tokenizer(build_vocab(items, min_count=1), encoding_length=16)
    cfg = VilBertConfig(
        vocab_size=tok.vocab_size(), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=32,
        v_feature_size=feat, v_target_size=len(synthetic.ROOM_TYPES), v_hidden_size=32,
        v_num_hidden_layers=2, v_num_attention_heads=4, v_intermediate_size=64,
        bi_hidden_size=32, bi_num_attention_heads=4, v_biattention_id=(0, 1),
        t_biattention_id=(0, 1), initializer_range=0.3)
    params = vlnbert_init(torch.Generator().manual_seed(0), cfg)
    return VLNBertScorer(cfg), params, world, expand_r2r_items(items, tok), tok, feat


def score_job(p: dict) -> dict:
    """``engine.pretrain.score_difficulty`` over a (data, model = p["model"])
    mesh: each batch of ``p["batch"]`` padded to the data axis and split
    over it, the heads over the model axis; every score on every rank."""
    from curriculum_learning_for_vln_torch.engine.pretrain import score_difficulty
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    scorer, params, world, data, tok, feat = scoring_inputs()
    mesh = M.make_mesh(model=p["model"])
    scores = score_difficulty(scorer, params, world, data, tok, max_path_len=6, feat_dim=feat,
                              batch_size=p["batch"], mesh=mesh)
    return {"scores": scores, "mesh": (mesh.data, mesh.model)}


def bn_job(p: dict) -> dict:
    """BatchNorm in training over this rank's rows of ``p["x"]``: the output,
    the new running statistics, and the gradients of sum(y * p["g"]) (its
    parameters' summed over the ranks, x's the rank's rows)."""
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    mesh = M.make_mesh()
    return bn_of(mesh, M.shard_batch(p["x"], mesh), M.shard_batch(p["g"], mesh))


def bn_of(mesh, x: torch.Tensor, g: torch.Tensor) -> dict:
    from curriculum_learning_for_vln_torch.models.core import batchnorm, batchnorm_init
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    params, state = batchnorm_init(x.shape[1])
    params = {k: (v + 0.5).requires_grad_(True) for k, v in params.items()}
    x = x.clone().requires_grad_(True)
    with M.sharded_step(mesh):
        y, new_state = batchnorm(params, state, x, True)
        (y * g).sum().backward()
    M.all_reduce_grads(params, mesh)
    return {"y": y.detach(), "state": new_state, "dx": x.grad,
            "dparams": {k: v.grad for k, v in params.items()}}


def monitor_job(p: dict) -> dict:
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    return monitor_grads(M.make_mesh())


def monitor_grads(mesh) -> dict:
    """One Self-Monitor iteration of the "monitor" scenario (sample feedback,
    dropout on) over this rank's rows (mesh None: one process): the global
    loss and the gradient leaves summed over the ranks, with their paths."""
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.utils import tree

    cfg = scenario_cfg("monitor", tempfile.mkdtemp())
    tok = pipeline.build_tokenizer(cfg)
    world, env, _, feat_dim = pipeline.build_environments(cfg, tok, seed=3, device="cpu")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    params, state = init_agent(agent, torch.Generator().manual_seed(0))
    params = tree.tree_map(lambda t: t.requires_grad_(True), params)
    env.set_sharding(mesh)
    ep = env.next_batch()
    with M.sharded_step(mesh):
        total, logs, _ = loop.agent_iteration_loss(
            agent, "sample", world.device_tables("f32", "cpu"), params, state, ep,
            torch.Generator().manual_seed(5))
    total.backward()
    M.all_reduce_grads(params, mesh)
    logs = loop.reduce_logs({k: v.detach() for k, v in logs.items()}, mesh)

    def paths(t, pre=()):
        if isinstance(t, dict):
            return [q for k in sorted(t) for q in paths(t[k], pre + (k,))]
        if isinstance(t, (list, tuple)):
            return [q for i, v in enumerate(t) for q in paths(v, pre + (i,))]
        return [] if t is None else [pre]

    return {"loss": float(logs["loss"]), "paths": paths(params),
            "grads": [torch.zeros_like(q) if q.grad is None else q.grad
                      for q in tree.tree_leaves(params)]}


JOBS = {"step": step_job, "scenarios": scenario_job, "tp": tp_job, "bn": bn_job,
        "monitor": monitor_job, "score": score_job}


# ---------------------------------------------------------------------------
# trainer scenarios (any number of ranks)
# ---------------------------------------------------------------------------

def scenario_cfg(name: str, out: str):
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    config, extra = SCENARIOS[name]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "configs", config))
    cfg.merge_from_list([*TINY, *extra, "OUTPUT.CKPT_DIR", os.path.join(out, "ckpt"),
                         "OUTPUT.TSBOARD_DIR", os.path.join(out, "tb")])
    return cfg


def run_scenario(name: str, out: str, seed: int = 3) -> dict:
    """Train scenario ``name`` as ``main`` does, on this rank (or one
    process); returns the trained leaves, the curriculum state, and from
    rank 0 (the writer) the scalar events and the latest checkpoint."""
    from curriculum_learning_for_vln_torch import main as t_main
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent
    from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.utils.tree import tree_leaves

    cfg = scenario_cfg(name, out)
    tok = pipeline.build_tokenizer(cfg)
    world, train_env, valid_env, feat_dim = pipeline.build_environments(cfg, tok, seed=seed,
                                                                        device="cpu")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    trainer = t_main.build_trainer(cfg, train_env, logging.getLogger("dp"), seed=seed)
    arms = []  # AUTO's drawn arms, in order
    if hasattr(trainer, "bandit"):
        draw = trainer.iter_env

        def iter_env(epoch_env, envs):
            env = draw(epoch_env, envs)
            arms.append(trainer._arms[-1])
            return env

        trainer.iter_env = iter_env
    params, _ = trainer.train(cfg, agent, cfg.OUTPUT.TSBOARD_DIR, train_env, valid_env,
                              seed=seed, device="cpu")
    out_ = {"leaves": [t.detach().clone() for t in tree_leaves(params)],
            "curriculum": trainer.curriculum_state(), "arms": arms}
    if M.is_main():
        out_["events"] = read_events(cfg.OUTPUT.TSBOARD_DIR)
        out_["ckpt"] = load_checkpoint(os.path.join(cfg.OUTPUT.CKPT_DIR, "latest.ckpt"))
    return out_


def run_self_train(seed: int = 1) -> dict:
    """``engine.self_train`` (the speaker's 2 steps, then a real and a
    back-translated EnvDrop iteration) on this rank; its losses."""
    from curriculum_learning_for_vln_torch import pipeline
    from curriculum_learning_for_vln_torch.agents import build_agent
    from curriculum_learning_for_vln_torch.agents.speaker import Speaker
    from curriculum_learning_for_vln_torch.engine.self_train import self_train

    cfg = scenario_cfg("classic", tempfile.mkdtemp())
    cfg.merge_from_list(["AIDE.SPEAKER.RNN_DIM", 32, "AIDE.SPEAKER.WEMB", 16,
                         "AIDE.SPEAKER.MAX_DECODE", 8])
    tok = pipeline.build_tokenizer(cfg)
    world, env, _, feat_dim = pipeline.build_environments(cfg, tok, seed=seed, device="cpu")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=feat_dim,
                      episode_len=cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=torch.float32)
    _, _, _, losses = self_train(cfg, agent, speaker, env, env,
                                 world.device_tables("f32", "cpu"), seed=seed, speaker_iters=2,
                                 epochs=1, iters_per_epoch=2)
    return losses


def read_events(tb: str, timings: bool = False) -> dict:
    """{(tag, step): value} of a run's scalars (histograms left out, and the
    trainer's wall-clock ``perf/`` timings unless ``timings``)."""
    (sub,) = os.listdir(tb)
    with open(os.path.join(tb, sub, "events.jsonl")) as f:
        return {(e["tag"], e["step"]): e["value"] for e in map(json.loads, f)
                if "value" in e and (timings or not e["tag"].startswith("perf/"))}


def close(a, b, tol: float = 1e-4) -> bool:
    return bool(np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol,
                            atol=tol))
