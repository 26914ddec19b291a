"""EnvDrop SPCL training: ``engine/loop.packed_one_iter`` as the trainer
drives it, checked against the plain reference (``reference/envdrop.py``).

Set-up builds one trainer state (the port's world, CLR2R environment,
SPCL curriculum, agent, RMSprop and generator) from the seed and runs
its first ``checked_iterations`` iterations exactly as the window does,
reading their sampled actions (``lib/spy``), each iteration's loss, the
first step's gradient as RMSprop's state holds it, and the parameters'
change; then ``warmup_iterations`` more.  The window runs iterations
until ``--seconds`` have passed on the host clock, then waits for the
card.  An iteration: the next IL batch and two more for the pool from
the CLR2R environment, SPCL's weights of both, ``packed_one_iter``, the
IL batch's losses recorded.  One window iteration, drawn from the seed
after the traced ones and before ``sample_from``, is checked too: the
parameters, RMSprop's state and the generator's state are copied before
it, its sampled actions read, and the parameters and RMSprop's state
copied after it.  With ``--trace`` the profiler records the window's
first ``trace_iterations`` iterations.

After the window and the program's state freed, the reference runs the
checked iterations again in f32 (TF32 off) along the program's sampled
actions: the set-up's from the same weights, batches and draws; the
window's from the program's parameters, RMSprop state and generator
state before it (PERF.md, "Correctness").  With ``run.control`` the
reference in that narrower type takes the program's place in both.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..lib import costs, port
from ..lib import harness as H
from ..lib import world as W
from ..lib.launches import observation_bounds
from ..lib.spy import ActionSpy
from ..reference import data as RD
from ..reference import envdrop as RE
from ..reference import nets as RN
from ..reference import params as RP
from ..reference import world as RW


KIND = "train"  # which faults of lib/faults.py apply

class Inputs:
    """Everything the seed makes, which both sides read."""

    def __init__(self, run: H.Run):
        cfgd, traffic, seed = run.config, run.traffic, run.seed
        self.widths = cfgd["widths"]
        self.vocab = W.read_vocab(H.BENCH / cfgd["vocab"])
        self.graphs = W.make_graphs(traffic["world"], H.sub_seed(seed, "world"))
        scans = W.split_scans(self.graphs, traffic["world"])
        self.paths = W.make_paths(self.graphs, scans["train"], traffic["data"], self.vocab,
                                  H.sub_seed(seed, "paths"))
        n = sum(len(g["node_ids"]) for g in self.graphs.values())
        self.features = H.make_features(n, self.widths["views"], self.widths["feature"],
                                        H.sub_seed(seed, "features"), run.device, torch.bfloat16)
        self.params = RP.make_params(RP.envdrop_layout(self.widths, len(self.vocab)),
                                     H.sub_seed(seed, "params"), run.device)
        self.env_seed = H.sub_seed(seed, "batches") % (2 ** 32)
        self.draw_seed = H.sub_seed(seed, "draws")
        rng = np.random.default_rng(H.sub_seed(seed, "sample"))
        self.window_checked = int(rng.integers(traffic["trace_iterations"],
                                               traffic["sample_from"]))


class Program:
    """The port's trainer state, stepped as ``engine/trainer.py`` steps it."""

    def __init__(self, run: H.Run, inp: Inputs):
        from curriculum_learning_for_vln_torch.agents import build_agent
        from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
        from curriculum_learning_for_vln_torch.engine import loop
        from curriculum_learning_for_vln_torch.engine.curriculum import SelfPacedCurriculum
        from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
        from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv

        self.loop = loop
        cfg = self.cfg = port.cfg_of(run.config)
        _world, self.tables = port.world(inp.graphs, inp.features, cfg, run.device)
        tok = port.tokenizer(inp.vocab, cfg)
        rounds = {f"round_{k}": expand_r2r_items([p for p in inp.paths if p["round"] == k], tok)
                  for k in range(1, run.traffic["data"]["rounds"] + 1)}
        self.env = CLR2RBatchEnv(_world, rounds, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.SELF_PACE.CRATE,
                                 tok, inp.env_seed, teacher_mode=cfg.AGENT.TEACHER,
                                 device=run.device)
        self.trainer = SelfPacedCurriculum.from_config(cfg, self.env, run.device)
        self.agent = build_agent(cfg, tok.vocab_size(), feat_dim=inp.widths["feature"])
        loop.configure_runtime(cfg)
        self.params = port.trainable(inp.params)
        self.optimizer = loop.make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, self.params)
        self.generator = torch.Generator(device=run.device).manual_seed(inp.draw_seed)
        self.il_bucket = il_bucket_fn(cfg, self.agent)
        self.packed = cfg.TPU.PACKED_RL
        self.decay = self.optimizer.param_groups[0]["decay"]
        self.pool_checked = False

    def iteration(self):
        """One iteration; (logs, IL rows, pool rows, IL length)."""
        env = self.env
        with H.span("next_batch"):
            batch = env.next_batch()
            idx = env.cur_batch_index
            il_len = self.il_bucket(env)
            raws, pool_idx = [env.cur_full_batch], [idx]
            for _ in range(self.packed - 1):
                env.next_batch()
                raws.append(env.cur_full_batch)
                pool_idx.append(env.cur_batch_index)
            pool = self.loop.concat_batches(raws)
        if not self.pool_checked:
            self.loop.check_pool_valid(pool)
            self.pool_checked = True
        with H.span("batch_weights"):
            pool_idx = np.concatenate(pool_idx)
            w_il, w_pool = self.trainer.batch_weights(idx), self.trainer.batch_weights(pool_idx)
        with H.span("packed_one_iter"):
            logs = self.loop.packed_one_iter(self.agent, self.optimizer, self.tables, self.params,
                                             batch, pool, self.generator, w_il, w_pool, il_len)
        with H.span("record_losses"):
            self.trainer.record_losses(idx, logs["loss_per_sample"])
        return logs, idx, pool_idx, il_len

    def leaves(self):
        from curriculum_learning_for_vln_torch.utils.tree import tree_leaves

        return tree_leaves(self.params)

    def nu(self) -> list:
        """RMSprop's state of each leaf (zeros where it holds none yet)."""
        state = self.optimizer.state
        return [state[p]["nu"] if "nu" in state[p] else torch.zeros_like(p)
                for p in self.leaves()]

    def snapshot(self) -> dict:
        """Copies of the parameters, RMSprop's state and the generator's, in
        host memory (so that they take no part in the card's peak)."""
        return {"params": [p.detach().to("cpu", copy=True) for p in self.leaves()],
                "nu": [n.to("cpu", copy=True) for n in self.nu()],
                "generator": self.generator.get_state()}



def step_grad_norms(nu_after: list, nu_before: list, decay: float) -> list:
    """Each leaf's gradient of one RMSprop step, from its state before and
    after: nu_after = decay nu_before + (1 - decay) g^2."""
    return [float(torch.sqrt((a - decay * b).clamp_min(0).sum() / (1 - decay)))
            for a, b in zip(nu_after, nu_before)]


def reference_batches(run: H.Run, inp: Inputs, tab: dict, which) -> tuple:
    """The reference's own data, batches and SPCL weights of the
    iterations numbered ``which`` (from 0, in order)."""
    cfgd, spec = run.config, run.traffic["data"]
    data = RD.expand(inp.paths, inp.vocab, inp.widths["max_enc_len"], spec["rounds"])
    weights = torch.from_numpy(RD.spcl_weights(data["round"], cfgd["TRAIN.SELF_PACE.WCTRL"]))
    sampler = RD.Batches(data["lengths"], cfgd["TRAIN.BATCH_SIZE"], inp.env_seed)
    out, rows = [], []
    for i in range(max(which) + 1):
        batches = [sampler.next() for _ in range(cfgd["TPU.PACKED_RL"])]
        if i not in which:
            continue
        idx, pool_idx = batches[0], np.concatenate(batches)
        il_len = RE.il_length(int(data["hops"][idx].max()), cfgd["TPU.IL_BUCKETS"],
                              cfgd["AGENT.MAX_EPISODE_LEN"])
        ep = RE.episodes_of(data, inp.paths, tab, idx, run.device)
        pool = RE.episodes_of(data, inp.paths, tab, pool_idx, run.device)
        out.append((ep, pool, weights[idx].to(run.device), weights[pool_idx].to(run.device),
                    il_len))
        rows.append((idx, pool_idx, il_len))
    return out, rows


def agent_of(run: H.Run, tab: dict, features: torch.Tensor, q) -> RE.Agent:
    c = run.config
    m = {"DROP_RATE": c["MODEL.ENVDROP.DROP_RATE"],
         "FEAT_DROP_RATE": c["MODEL.ENVDROP.FEAT_DROP_RATE"],
         "ML_WEIGHT": c["MODEL.ENVDROP.ML_WEIGHT"], "GAMMA": c["MODEL.ENVDROP.GAMMA"],
         "MAX_EPISODE_LEN": c["AGENT.MAX_EPISODE_LEN"]}
    return RE.Agent(m, tab, features, q)


def gaps(prog: dict, ref: RE.Run) -> tuple:
    """(loss gap, gradient gap, change gap, action mismatch) of one side's
    first iteration, or iterations, against the reference's.  The loss and
    the sampled actions are compared in the first iteration from the same
    weights: RMSprop's first steps (about lr * 10 a weight, whatever the
    gradient's size) carry round-off in small gradients into the later
    iterations' weights, whose losses and near-tie actions then differ by
    more.  The actions are compared by the share that are not the
    reference's first choice; the widest gap below it, which one near-tie
    sets, is logged (PERF.md, "Correctness").  Leaves the reference moves
    by round-off alone stay out of the change."""
    med = sorted(ref.grad_norms.values())[len(ref.grad_norms) // 2]
    still = [k for k, v in ref.grad_norms.items() if v < 1e-3 * med]
    grad_gap, grad_leaf = RE.worst_leaf_gap(prog["grad_norms"], ref.grad_norms)
    change_gap, change_leaf = RE.worst_leaf_gap(prog["change_norms"], ref.change_norms,
                                                exclude=still)
    H.log(f"losses {prog['losses']} reference {ref.losses}; action gaps by iteration "
          f"{ref.action_gaps}, mismatches {ref.mismatches}; worst leaves: gradient {grad_leaf}, "
          f"change {change_leaf}; left out of the change: {still}")
    return (RE.relative_gap(prog["losses"][0], ref.losses[0], 0.0), grad_gap, change_gap,
            ref.mismatches[0])


def compare(setup: tuple, window: tuple, done_diff: int, differ: int, limits: dict) -> list:
    """The numbers compared, each beside its limit, from ``gaps`` of the
    set-up's checked iterations and of the window's.  The set-up's
    gradient and change gaps are logged, not compared: the first step's
    gradient swings with bf16 round-off on some seeds, where a plain bf16
    computation departs from f32 as far; the window's step, from weights a
    few updates on, is steady from seed to seed (PERF.md, "Correctness")."""
    loss, grad, change, mismatch = setup
    H.log(f"set-up gaps (logged, not compared): gradient {grad!r}, change {change!r}")
    named = (("first_loss_gap", loss), ("first_action_mismatch", mismatch),
             *zip(("window_loss_gap", "window_grad_gap", "window_change_gap",
                   "window_action_mismatch"), window))
    return ([H.Check(n, v, limits[n]) for n, v in named]
            + [H.Check("episodes_done_diff", float(done_diff), 0.0),
               H.Check("batches_differ", float(differ), 0.0)])


def run(run: H.Run) -> H.Outcome:
    traffic = run.traffic
    n_checked = traffic["checked_iterations"]
    phases = [("start", time.perf_counter() - run.t0)]
    if run.device.type == "cuda":
        port.build_kernels()
    phases.append(("kernels", time.perf_counter()))
    inp = Inputs(run)
    phases.append(("inputs", time.perf_counter()))
    prog = Program(run, inp)
    phases.append(("program", time.perf_counter()))
    names = [n for n, _ in RE.leaves(inp.params)]
    horizon = run.config["AGENT.MAX_EPISODE_LEN"]

    def spied():
        """One iteration with its sampled actions read: (logs, actions, rows)."""
        with ActionSpy() as spy:
            logs, idx, pool_idx, il_len = prog.iteration()
        if len(spy.actions) != horizon:
            raise RuntimeError(f"read {len(spy.actions)} sampled steps of an iteration, not "
                               f"{horizon}")
        return logs, torch.stack(spy.actions), (idx, pool_idx, il_len or horizon)

    # the checked iterations, then the warm-up
    checked = {"losses": [], "actions": [], "episodes_done": [], "rows": []}
    for i in range(n_checked):
        logs, actions, rows = spied()
        checked["losses"].append(float(logs["loss"]))
        checked["episodes_done"].append(int(logs["episodes_done"]))
        checked["actions"].append(actions)
        checked["rows"].append(rows)
        if i == 0:
            checked["grad_norms"] = dict(zip(names, step_grad_norms(
                prog.nu(), [torch.zeros_like(p) for p in prog.leaves()], prog.decay)))
    start = dict(RE.leaves(inp.params))
    checked["change_norms"] = {n: float((p.detach() - start[n]).norm())
                               for n, p in zip(names, prog.leaves())}
    phases.append(("checked iterations", time.perf_counter()))
    for _ in range(traffic["warmup_iterations"]):
        prog.iteration()
    H.sync(run.device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - run.t0
    H.log_phases(phases, run.t0)
    setup_peak = H.peak_bytes(run.device, reset=True)

    # the window
    done, iters, stamps, window = [], 0, [], None
    tracing = H.TracedSteps(run, traffic["trace_iterations"])
    t_start = time.perf_counter()
    while True:
        if iters == inp.window_checked:
            before = prog.snapshot()
            logs, actions, rows = spied()
            window = dict(prog.snapshot(), before=before, logs=logs, actions=actions, rows=rows)
        else:
            logs, *_ = prog.iteration()
        done.append(logs["episodes_done"])
        iters += 1
        stamps.append(time.perf_counter())
        tracing.done(iters)
        if (not tracing.open and window is not None
                and time.perf_counter() - t_start >= run.seconds):
            break
    H.sync(run.device)
    elapsed = time.perf_counter() - t_start
    episodes = iters * prog.cfg.TRAIN.BATCH_SIZE + int(torch.stack(done).sum())
    window_peak = H.peak_bytes(run.device)
    work = (traced_work(run, inp, traffic["trace_iterations"], tracing.launches) if run.trace
            else {})
    window = program_window(prog, window, names)
    del prog, done, logs
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check(run, inp, checked, window)
    H.log(f"setup {setup_s:.3f} s, window {elapsed:.3f} s ({iters} iterations), reference "
          f"{time.perf_counter() - t_ref:.3f} s; host s an iteration "
          f"{H.quartiles(np.diff([t_start] + stamps))}")
    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               "train_episodes_per_s": {"value": episodes / elapsed, "unit": "episodes/s"},
               "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"}}
    return H.Outcome(metrics, checks, iters, 0, max(setup_peak, window_peak), tracing.read(),
                     work)


def program_window(prog: Program, window: dict, names: list) -> dict:
    """The checked window iteration's readings, and its start for the
    reference: the parameters, RMSprop's state and the generator's."""
    before = window["before"]
    return {"rows": window["rows"], "actions": [window["actions"]],
            "losses": [float(window["logs"]["loss"])],
            "episodes_done": [int(window["logs"]["episodes_done"])],
            "grad_norms": dict(zip(names, step_grad_norms(window["nu"], before["nu"],
                                                          prog.decay))),
            "change_norms": {k: float((a - b).norm())
                             for k, a, b in zip(names, window["params"], before["params"])},
            "params": before["params"], "nu": before["nu"], "generator": before["generator"]}


def side(run: H.Run, inp: Inputs, tab: dict, p0: dict, nu0, generator, batches, actions,
         control) -> tuple:
    """(the judged side's readings, the f32 reference along its actions)
    over ``batches`` from the parameters ``p0``, RMSprop's state ``nu0``
    and the generator's state ``generator`` (the seed's start where None).
    The judged side is the program (its ``actions`` given), or with
    ``control`` the reference in that type, sampling its own."""
    lr = run.config["TRAIN.LR"]

    def draws():
        d = RN.Draws(inp.draw_seed, run.device)
        if generator is not None:
            d.gen.set_state(generator)
        return d

    ctl = None
    if control is not None:
        ctl = RE.train(agent_of(run, tab, inp.features, RN.quantizer(control)), p0, batches,
                       draws(), lr, nu0=nu0)
        actions = ctl.actions
    ref = RE.train(agent_of(run, tab, inp.features, RN.quantizer(None)), p0, batches, draws(),
                   lr, actions=actions, nu0=nu0)
    return ctl, ref


def check(run: H.Run, inp: Inputs, checked: dict, window: dict) -> list:
    """The reference's iterations along the judged side's actions, compared:
    the set-up's checked iterations from the start, and the window's from
    the program's state before it."""
    tab = RW.compile_tables(inp.graphs, run.config["widths"]["max_candidates"], run.device)
    n = len(checked["losses"])
    first_window = n + run.traffic["warmup_iterations"]
    which = list(range(n)) + [first_window + inp.window_checked]
    batches, rows = reference_batches(run, inp, tab, which)
    differ = sum(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2])
                 for a, b in zip(rows, checked["rows"] + [window["rows"]]))
    control = getattr(torch, run.control) if run.control else None
    p_window = RE.replace_leaves(inp.params, [p.to(run.device) for p in window["params"]])
    nu_window = dict(zip([k for k, _ in RE.leaves(inp.params)],
                         [n.to(run.device) for n in window["nu"]]))
    out = []
    for prog, p0, nu0, gen, bs in ((checked, inp.params, None, None, batches[:n]),
                                   (window, p_window, nu_window, window["generator"],
                                    batches[n:])):
        ctl, ref = side(run, inp, tab, p0, nu0, gen, bs, prog["actions"], control)
        judged = prog if ctl is None else {
            "losses": ctl.losses, "grad_norms": ctl.grad_norms,
            "change_norms": ctl.change_norms, "episodes_done": ctl.episodes_done}
        done_diff = sum(abs(a - b) for a, b in zip(judged["episodes_done"], ref.episodes_done))
        out.append((gaps(judged, ref), done_diff))
    (setup, d1), (win, d2) = out
    return compare(setup, win, d1 + d2, 0 if control is not None else differ,
                   run.traffic["limits"])


def traced_work(run: H.Run, inp: Inputs, n: int, launches) -> dict:
    """The work of the ``n`` traced iterations: model FLOPs and K1/K2's
    bounds from their batches' shapes, K4-K7's from the launches
    recorded (s)."""
    w, cfg = inp.widths, run.config
    B, T = cfg["TRAIN.BATCH_SIZE"], cfg["AGENT.MAX_EPISODE_LEN"]
    # the traced iterations are the window's first: after the checked and the warm-up ones
    skip = run.traffic["checked_iterations"] + run.traffic["warmup_iterations"]
    data = RD.expand(inp.paths, inp.vocab, w["max_enc_len"], run.traffic["data"]["rounds"])
    sampler = RD.Batches(data["lengths"], B, inp.env_seed)
    for _ in range(skip * cfg["TPU.PACKED_RL"]):
        sampler.next()
    flops, lstm = 0.0, {"fwd": 0.0, "bwd": 0.0}
    H_, E, L = w["hidden"], w["word_emb"], w["max_enc_len"]
    for _ in range(n):
        batches = [sampler.next() for _ in range(cfg["TPU.PACKED_RL"])]
        idx, pool_idx = batches[0], np.concatenate(batches)
        il_tok, pool_tok = int(data["lengths"][idx].sum()), int(data["lengths"][pool_idx].sum())
        il_len = RE.il_length(int(data["hops"][idx].max()), cfg["TPU.IL_BUCKETS"], T)
        flops += costs.envdrop_iteration_flops(w, il_tok, pool_tok, B, len(pool_idx), il_len, T,
                                               il_tok / B, pool_tok / len(pool_idx))
        for rows, tok in ((B, il_tok), (len(pool_idx), pool_tok)):
            b = costs.lstm_bounds(rows, L, E, H_ // 2, tok, "bf16")
            lstm["fwd"] += 2 * b["train"]
            lstm["bwd"] += 2 * b["bwd"]
    return {"steps": n, "flops": flops, "peak_flops": costs.PEAK_FLOPS["bf16"],
            "bounds_s": {"lstm_scan": lstm, "obs": observation_bounds(launches)},
            "launches": launches}
