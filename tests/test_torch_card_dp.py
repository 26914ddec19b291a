"""Data-parallel training on the card: DP_RANKS = 2 rank processes share
the one card (gloo over CUDA tensors; NCCL refuses two ranks on one GPU),
each on its rows of the same batches.

* The classic EnvDrop iteration at full width, B = 64 (32 a rank), T = 35,
  prng, in bf16 and f32: the loss and every gradient leaf after the sum
  over the ranks against one process on the same parameters, batch and
  generator seed (f32: 1e-4 of each leaf, in L2 and element by element;
  bf16: 1e-2 in L2, each leaf's gradient being summed in bf16 over the
  steps); each rank's launches exact (K1 = K2 = 4, K4 = K6 = T_il + 36, K5
  = K7 = T_il + 35), also over ``one_iter`` iterations at N = 1 (rank 0
  alone) and N = 2.
* One SPCL packed iteration of ``envdrop_cl_config.yaml`` (prng_shared, a
  pool of 3 x 64 in every rank): the episodes started and done equal, the
  loss and gradients as above.
* One Self-Monitor iteration in f32: the loss and every gradient leaf
  within 1e-3 in L2, the BN running statistics within 1e-5.
* Each of these also on the rank's rows through the kernels against their
  plain versions: every launch of the DP path, at its shapes.
* ViLBERT at ``VilBertConfig``'s defaults: ``score_paths`` over model = 2
  against replicated scoring within 1e-5 (f32, TF32 off).
* ``main`` (the Follower, f32, teacher feedback, SGD, 3 iterations) as four
  processes run together: one process, 2 ranks joined by the VLN_*
  variables, and world size 1 on NCCL: every scalar within 1e-4 of the one
  process's, rank 0 alone writing the checkpoint; with them
  ``build_clr2r`` in one process and in 2 over model = 2: the same round
  sizes and final loss.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch_card_world import (AGENT_CONFIGS, BATCH, CL_CONFIG, FEAT_DIM,  # noqa: F401
                              MAIN_WRAPPER, REPO, SEED, SYN_NODES, SYN_SCANS, ZERO_GRAD,
                              agent_cfg, agent_launches, build_serving, card, iteration_launches,
                              launch_counts, leaf_paths, plain_kernels, reset_launch_counts)

DP_RANKS = 2          # rank processes, sharing the one card
DP_ITERS = 3          # iterations at N = 1 and at N = DP_RANKS (after one warm-up)
DP_MAIN_ITERS = 3     # iterations of each ``main`` run
DP_CLR2R_STEPS = 20   # pretraining steps of the build_clr2r runs
VIL_PATH = 8

# Self-Monitor leaves whose gradient is set by rounding, not by the data:
# the ZERO_GRAD pair, and the bias of each BN-MLP hidden layer, whose
# BatchNorm sees B identical rows at t = 0 (a_prev starts at zeros): zero
# variance, so its ReLU input is the rounding of the batch mean times
# 1 / sqrt(eps), which any other order of summation (the ranks') flips
DP_ROUNDING = ZERO_GRAD["SELF-MONITOR"] | {
    ("decoder", "proj_navigable_mlp", "bn_layers", i, "bias") for i in range(4)}
# (precision of the comparisons with plain, with one process; element by element)
CASES = {"classic_bf16": (1e-2, 1e-2, False), "classic_f32": (1e-3, 1e-4, True),
         "spcl_packed": (1e-2, 1e-2, False), "monitor": (1e-2, 1e-3, False)}


def dp_rank(rank, tmp):
    """One rank: joins the process group (gloo: the ranks share the card),
    runs ``dp_work`` and saves its readings for the parent."""
    import torch.distributed as dist

    from curriculum_learning_for_vln_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False  # the one-process references run in full f32
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share this host's one card: their place among its ranks
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(DP_RANKS))
    device = M.init_process_group(f"file://{tmp}/store", DP_RANKS, rank, device="cuda",
                                  timeout_s=900)
    try:
        out = dp_work(rank, device)
        out["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def leaf_errors(names, got, want, floor):
    """[(leaf, |got - want| / max |want|, L2 |got - want| / |want|)], each
    denominator at least ``floor``."""
    return [(name, float((a - b).abs().max()) / max(float(b.abs().max()), floor),
             float((a - b).norm()) / max(float(b.norm()), floor))
            for name, a, b in zip(names, got, want, strict=True)]


def dp_work(rank, device):
    """The readings of one rank: each case on the rank's rows through the
    kernels and through their plain versions (``held``), its launches,
    and on rank 0 the ranks' sum against one process (``vs_one``)."""
    import torch.distributed as dist

    from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.engine.pretrain import pretrain_arrays
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig, vlnbert_init
    from curriculum_learning_for_vln_torch.parallel import mesh as M
    from curriculum_learning_for_vln_torch.parallel import vilbert_sharding as S
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, params0 = build_serving()
    items = expand_r2r_items(data, tok)
    mesh = M.make_mesh()
    T, main = cfg.AGENT.MAX_EPISODE_LEN, rank == 0
    out = {"mesh": (mesh.data, mesh.model), "launches": {}, "held": {}, "vs_one": {},
           "iterations": []}

    def env_of(seed):
        env = R2RBatchEnv(world, items, BATCH, tok, seed=seed, device=device)
        env.set_sharding(mesh)
        return env

    def step_grads(params, loss_fn, mesh_, clip):
        """loss_fn() inside the sharded step of mesh_, its gradients summed
        over the ranks and clipped as the iteration does; the global logs
        and the gradient leaves."""
        leaves = tree.tree_leaves(params)
        with M.sharded_step(mesh_):
            total, logs = loss_fn()
        total.backward()
        M.all_reduce_grads(params, mesh_)
        if clip:
            loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
        return (loop.reduce_logs({k: v.detach() for k, v in logs.items()}, mesh_),
                [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in leaves])

    def fresh(p0):  # a copy of p0's leaves, whatever the device
        return tree.tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), p0)

    def held(key, run, names, want):
        """``run()`` -> (loss, gradient leaves, ...) on this rank's rows, in
        the sharded step, through the kernels and again under their plain
        versions; the kernel run's launches against ``want``."""
        reset_launch_counts()
        got = run()
        out["launches"][key] = (launch_counts(), want)
        with plain_kernels():
            plain = run()
        out["held"][key] = {"loss": (got[0], plain[0]),
                            "leaves": leaf_errors(names, got[1], plain[1], 1e-6)}
        return got

    def vs_one(key, got, want, names):
        out["vs_one"][key] = {"loss": (got[0], want[0]),
                              "leaves": leaf_errors(names, got[1], want[1], 1e-12)}

    # the classic iteration, bf16 and f32
    for precision in ("bf16", "f32"):
        agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                             compute_dtype=PRECISIONS[precision], obs_masks="prng")
        tables = world.device_tables(precision, device)
        env = env_of(SEED)
        local = env.next_batch()
        whole, il_len = env.cur_full_batch, il_bucket_fn(cfg, agent)(env)

        def classic(ep, mesh_):
            params = fresh(params0)
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            logs, g = step_grads(params, lambda: loop.iteration_loss(
                agent, "sample", tables, params, ep, gen, il_len=il_len), mesh_, True)
            return float(logs["loss"]), g

        key = f"classic_{precision}"
        got = held(key, lambda: classic(local, mesh), leaf_paths(params0),
                   iteration_launches(il_len or T, T))
        if main:
            vs_one(key, got, classic(whole, None), leaf_paths(params0))
        dist.barrier()

        if precision != cfg.TPU.PRECISION:
            continue
        # iterations: one process (rank 0 alone), then every rank
        for n in (1, DP_RANKS):
            if n == 1 and not main:
                dist.barrier()
                continue
            params = fresh(params0)
            opt = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)
            gen = torch.Generator(device=device).manual_seed(SEED + 1)
            env = env_of(SEED + 1)
            for i in range(DP_ITERS + 1):
                b = env.next_batch()
                il = il_bucket_fn(cfg, agent)(env)
                reset_launch_counts()
                logs = loop.one_iter(agent, opt, "sample", tables, params,
                                     b if n > 1 else env.cur_full_batch, gen, il_len=il,
                                     mesh=mesh if n > 1 else None)
                float(logs["loss"])  # a sync: the iteration has finished
                out["iterations"].append((n, launch_counts(), iteration_launches(il or T, T)))
            if n == 1:
                dist.barrier()
        dist.barrier()

    # the SPCL packed iteration, envdrop_cl_config.yaml as shipped, prng_shared
    cl = get_cfg_defaults()
    cl.merge_from_file(CL_CONFIG)
    out["packed_rl"] = cl.TPU.PACKED_RL
    agent = EnvDropAgent(cl.MODEL.ENVDROP, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cl.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[cl.TPU.PRECISION],
                         obs_masks="prng_shared")
    tables = world.device_tables(cl.TPU.PRECISION, device)
    env = env_of(SEED + 3)
    local = env.next_batch()
    raws, idx, il_len = [env.cur_full_batch], [env.cur_batch_index], il_bucket_fn(cl, agent)(env)
    for _ in range(cl.TPU.PACKED_RL - 1):
        env.next_batch()
        raws.append(env.cur_full_batch)
        idx.append(env.cur_batch_index)
    pool = loop.concat_batches(raws)
    w = torch.rand(len(items), generator=torch.Generator().manual_seed(SEED)).to(device) + 0.5
    w_il = w[torch.from_numpy(idx[0]).to(device)]
    w_pool = w[torch.from_numpy(np.concatenate(idx)).to(device)]

    def packed(ep, mesh_):
        params = fresh(params0)
        gen = torch.Generator(device=device).manual_seed(SEED + 9)

        def loss():
            return loop.packed_iteration_loss(agent, tables, params, ep, pool, gen,
                                              M.local_rows(w_il), w_pool, il_len)

        logs, g = step_grads(params, loss, mesh_, True)
        return float(logs["loss"]), g, int(logs["episodes_started"]), int(logs["episodes_done"])

    t_il = il_len or cl.AGENT.MAX_EPISODE_LEN
    got = held("spcl_packed", lambda: packed(local, mesh), leaf_paths(params0),
               iteration_launches(t_il, cl.AGENT.MAX_EPISODE_LEN))
    if main:
        one = packed(raws[0], None)
        vs_one("spcl_packed", got, one, leaf_paths(params0))
        out["packed_episodes"] = (got[2:], one[2:])
    dist.barrier()

    # the Self-Monitor iteration in f32: loss, gradients, BN statistics
    mcfg = agent_cfg(AGENT_CONFIGS["SELF-MONITOR"][0], "TPU.PRECISION", "f32")
    agent = build_agent(mcfg, tok.vocab_size(), FEAT_DIM)
    p0, s0 = init_agent(agent, torch.Generator().manual_seed(SEED))
    tables = world.device_tables("f32", device)
    env = env_of(SEED + 5)
    local = env.next_batch()

    def monitor(ep, mesh_):
        params = fresh(p0)
        state = tree.tree_map(lambda t: t.to(device, copy=True), s0)
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        kept = {}

        def loss():
            total, logs, kept["state"] = loop.agent_iteration_loss(
                agent, "sample", tables, params, state, ep, gen,
                lamb=mcfg.TRAIN.PROGMONITOR_WEIGHT)
            return total, logs

        logs, g = step_grads(params, loss, mesh_, False)
        return float(logs["loss"]), g, tree.tree_leaves(kept["state"])

    got = held("monitor", lambda: monitor(local, mesh), leaf_paths(p0),
               agent_launches("SELF-MONITOR", False))
    if main:
        one = monitor(env.cur_full_batch, None)
        vs_one("monitor", got, one, leaf_paths(p0))
        out["monitor_bn"] = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                                for a, b in zip(got[2], one[2]))
    dist.barrier()

    # ViLBERT at VilBertConfig's defaults: score_paths over model = DP_RANKS
    vcfg = VilBertConfig(vocab_size=tok.vocab_size(), v_feature_size=FEAT_DIM)
    whole_p = tree.tree_map(lambda t: t.to(device),
                            vlnbert_init(torch.Generator().manual_seed(SEED), vcfg))
    tp_mesh = M.make_mesh(data=1, model=DP_RANKS)
    local_p = S.shard_vilbert_params(whole_p, tp_mesh)
    scorer = VLNBertScorer(vcfg)
    toks, feats, locs, rmask, _ = pretrain_arrays(world, items[:8], tok, VIL_PATH, FEAT_DIM)
    inputs = [torch.from_numpy(a).to(device)
              for a in (toks, feats, locs, (toks != 0).astype(np.float32), rmask)]
    s_tp = scorer.score_paths(local_p, *inputs, tp=S.tensor_parallel(tp_mesh))
    s_rep = scorer.score_paths(whole_p, *inputs)
    out["vilbert_err"] = float((s_tp - s_rep).abs().max())
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks(card):
    """Every rank's readings."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(dp_rank, args=(tmp,), nprocs=DP_RANKS, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_RANKS)]


def test_ranks_share_the_card_over_gloo(ranks):
    for r in ranks:
        assert r["backend"] == "gloo", f"{DP_RANKS} ranks on one card take gloo"
        assert r["mesh"] == (DP_RANKS, 1), f"mesh {r['mesh']}"
        assert r["packed_rl"] == 3, "the CL config ships PACKED_RL 3"


@pytest.mark.parametrize("key", CASES)
def test_each_rank_launches_exactly(ranks, key):
    for rank, r in enumerate(ranks):
        got, want = r["launches"][key]
        assert got == want, f"rank {rank} {key} launches {got}, expected {want}"


def test_each_rank_launches_exactly_in_one_iter(ranks):
    for rank, r in enumerate(ranks):
        assert len(r["iterations"]) == (2 if rank == 0 else 1) * (DP_ITERS + 1)
        for n, got, want in r["iterations"]:
            assert got == want, f"rank {rank} N={n} launches {got}, expected {want}"


@pytest.mark.parametrize("key", CASES)
def test_each_rank_agrees_with_plain_versions_on_its_rows(ranks, key):
    """The loss within 1e-4 of its scale, every leaf within the case's
    tolerance of its largest plain element (one bf16 ulp is up to 2^-7 of
    it; f32 differs by the kernels' order of summation alone; the
    Self-Monitor's BN-MLP rsqrt(var + 1e-5) scales the kernels' rounding
    up); the leaves set by rounding are not held."""
    tol = CASES[key][0]
    for rank, r in enumerate(ranks):
        (loss_k, loss_p), leaves = r["held"][key]["loss"], r["held"][key]["leaves"]
        assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
            f"rank {rank} {key}: loss kernels {loss_k} plain {loss_p}"
        for name, el, _ in leaves:
            if name not in DP_ROUNDING:
                assert el <= tol, \
                    f"rank {rank} {key}: leaf {name} |kernel - plain| {el:.3g} > {tol}"


@pytest.mark.parametrize("key", CASES)
def test_ranks_sum_to_one_process(ranks, key):
    """The loss within the case's tolerance of its scale, each leaf's
    |ranks - one| within it of |one| in L2 (f32 EnvDrop: also each element
    within it of the leaf's largest)."""
    _, tol, elementwise = CASES[key]
    (loss_n, loss_1), leaves = ranks[0]["vs_one"][key]["loss"], ranks[0]["vs_one"][key]["leaves"]
    assert abs(loss_n - loss_1) <= tol * max(1.0, abs(loss_1)), \
        f"{key}: loss {loss_n} at {DP_RANKS} ranks, {loss_1} in one process"
    for name, el, l2 in leaves:
        if name not in DP_ROUNDING:
            assert l2 <= tol and (el <= tol or not elementwise), \
                f"{key}: leaf {name}: |ranks - one| / |one| {l2:.3g} (L2), {el:.3g} > {tol}"


def test_spcl_packed_episodes_match_one_process(ranks):
    got, one = ranks[0]["packed_episodes"]
    assert got == one, f"packed episodes (started, done) {got} at {DP_RANKS} ranks, {one} in one"


def test_self_monitor_bn_statistics_match_one_process(ranks):
    bn = ranks[0]["monitor_bn"]
    assert bn <= 1e-5, f"Self-Monitor BN running statistics |ranks - one| / (1 + |one|) {bn}"


def test_vilbert_scoring_over_the_model_axis_is_replicated_scoring(ranks):
    for rank, r in enumerate(ranks):
        assert r["vilbert_err"] <= 1e-5, f"rank {rank}: |tp - replicated| {r['vilbert_err']:.3g}"


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mains(card, tmp_path_factory):
    """``main`` as a user runs it (the Follower, f32, teacher feedback, SGD,
    one epoch of DP_MAIN_ITERS iterations): one process; DP_RANKS processes
    joined by the VLN_* variables (gloo: they share the card); one process
    at world size 1 on NCCL; and ``build_clr2r`` in one process and in
    DP_RANKS processes over a model axis of DP_RANKS, all run together.
    Returns ({run: (scalars, log, checkpoint written)}, {run: JSON lines},
    root)."""
    root = str(tmp_path_factory.mktemp("dp_main"))
    ports = (free_port(), free_port(), free_port())

    def ranks_env(port, r):
        return {"VLN_COORDINATOR": f"127.0.0.1:{port}", "VLN_NUM_PROCESSES": str(DP_RANKS),
                "VLN_PROCESS_ID": str(r), "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(DP_RANKS)}

    runs = {"one": {}, "nccl_world1": {"VLN_COORDINATOR": f"127.0.0.1:{ports[0]}",
                                       "VLN_NUM_PROCESSES": "1", "VLN_PROCESS_ID": "0"},
            **{f"rank{r}": ranks_env(ports[1], r) for r in range(DP_RANKS)}}
    clr2r = {"clr2r_one": {}, **{f"clr2r_tp{r}": ranks_env(ports[2], r) for r in range(DP_RANKS)}}
    procs = {}
    for name, env in clr2r.items():
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r", "--device",
               "cuda", "--out", os.path.join(root, name), "--steps", DP_CLR2R_STEPS,
               "--mesh-model", 1 if name == "clr2r_one" else DP_RANKS]
        procs[name] = subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True, cwd=REPO,
                                       env=dict(os.environ, **env))
    for name, env in runs.items():
        d = os.path.join(root, name)
        cmd = [sys.executable, "-c", MAIN_WRAPPER, "--device", "cuda", "--seed", str(SEED),
               "--config-file", AGENT_CONFIGS["FOLLOWER"][0], "TPU.PRECISION", "f32",
               "AGENT.FEEDBACK", "teacher", "TRAIN.OPTIM", "sgd", "TRAIN.LR", "0.01",
               "TRAIN.MAX_EPOCH", "1", "TRAIN.ITER_PER_EPOCH", DP_MAIN_ITERS,
               "TRAIN.EVAL_INTERVAL", "1", "TRAIN.BATCH_SIZE", BATCH, "TPU.SYNTHETIC_WORLD",
               "True", "TPU.SYNTHETIC_SCANS", SYN_SCANS, "TPU.SYNTHETIC_NODES", SYN_NODES,
               "OUTPUT.LOG_DIR", d, "OUTPUT.TSBOARD_DIR", os.path.join(d, "tb"),
               "OUTPUT.CKPT_DIR", os.path.join(d, "ckpt")]
        procs[name] = subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True, cwd=REPO,
                                       env=dict(os.environ, **env))
    printed = {}
    for name in clr2r:
        p = procs.pop(name)
        text_out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, f"build_clr2r {name}: rc {p.returncode}\n{text_out[-4000:]}"
        printed[name] = [json.loads(ln) for ln in text_out.splitlines() if ln.startswith("{")]
    res = {}
    for name, p in procs.items():
        text_out = p.communicate(timeout=600)[0]
        d = os.path.join(root, name)
        text = "".join(open(os.path.join(d, f)).read() for f in os.listdir(d)
                       if f.endswith(".log"))
        launches = [ln for ln in text_out.splitlines() if ln.startswith("launches ")]
        assert p.returncode == 0 and "Training finished" in text and len(launches) == 1, \
            f"main {name}: rc {p.returncode}\n{text_out[-4000:]}"
        scalars = {}
        tb = os.path.join(d, "tb")
        for sub in os.listdir(tb) if os.path.isdir(tb) else ():
            path = os.path.join(tb, sub, "events.jsonl")
            for ln in open(path) if os.path.exists(path) else ():
                e = json.loads(ln)
                if "value" in e and not e["tag"].startswith("perf/"):  # not the timings
                    scalars[e["tag"], e["step"]] = e["value"]
        res[name] = (scalars, text, os.path.exists(os.path.join(d, "ckpt", "latest.ckpt")))
    return res, printed, root


def test_build_clr2r_over_the_model_axis_matches_one_process(mains):
    _, printed, _ = mains
    c_one, c_tp = printed["clr2r_one"][-1], printed["clr2r_tp0"][-1]
    assert not any(printed[f"clr2r_tp{r}"] for r in range(1, DP_RANKS)), "rank 0 alone prints"
    assert c_tp["rounds"] == c_one["rounds"] and abs(c_tp["final_loss"] - c_one["final_loss"]) \
        <= 1e-4 * max(1.0, c_one["final_loss"]), \
        f"build_clr2r over model = {DP_RANKS}: {c_tp}, one process: {c_one}"


@pytest.mark.parametrize("name", ["rank0", "nccl_world1"])
def test_main_scalars_match_one_process(mains, name):
    res = mains[0]
    one, got = res["one"][0], res[name][0]
    assert ("train/ml_epoch", 1) in one, "the one-process run logged its epoch loss"
    assert set(got) == set(one), f"main {name}: the scalars {sorted(set(got) ^ set(one))}"
    worst = max(abs(got[k] - one[k]) / (1.0 + abs(one[k])) for k in one)
    assert worst <= 1e-4, f"main {name}: scalars within 1e-4 of one process's: worst {worst}"


def test_main_backends_meshes_and_checkpoint(mains):
    res = mains[0]
    assert "Device mesh: data=2 model=1" in res["rank0"][1] \
        and "backend gloo (ranks share a GPU)" in res["rank0"][1], "rank 0's mesh and backend"
    assert "backend nccl (every rank owns its GPU)" in res["nccl_world1"][1] \
        and "Device mesh: data=1 model=1" in res["nccl_world1"][1], "NCCL at world size 1"
    assert res["rank0"][2] and not any(res[f"rank{r}"][2] for r in range(1, DP_RANKS)), \
        "rank 0 alone writes the checkpoint"
