"""ViLBERT pretraining: ``engine/pretrain.py::VLNBertPretrainer.step`` over
``pretrain_batches``, checked against the plain reference
(``reference/vilbert.py``).

Set-up builds the world, its (path, instruction) pairs and the port's
pretrainer at the published widths (random weights from the seed, Adam)
and runs ``warmup_steps`` + 1 steps, of which one after the first, drawn
from the seed, is checked: the parameters and Adam's state are copied before it, its
random draws read as they are made (``DrawSpy``: the token and region
masks' and every dropout site's), and its batch, loss, gradients and
the parameters after it copied.  The copies go to host memory, so that
they take no part in the card's peak.  The window runs steps until
``--seconds`` have passed on the host clock, then waits for the card;
with ``--trace`` the profiler records its first ``trace_steps``.

After the window, with the program's state freed, the benchmark makes
the checked step's batch again from its own paths and tables
(``expected_batch``) and counts the numbers where the program's differs;
the reference runs the checked step again in f32 (TF32 off) from the
program's parameters and Adam state, on that batch (the program's
locations) and with the program's draws, and compares the loss, the
worst and the median gradient leaf and Adam's change of each leaf
(PERF.md, "Correctness"); the pairs the program counted in the window
are compared with its steps.  With ``run.control`` the reference in that
narrower type takes the program's place: a torch float type's name, its
matrix products' operands rounded to it, or "tf32", its matrix products
on the card's TF32 tensor cores.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# a program without host-side batch lengths and step counters stops here, at once
from curriculum_learning_for_vln_torch.engine.pretrain import PretrainCounters  # noqa: F401

from ..lib import costs, program_spans, vilbert_costs
from ..lib import harness as H
from ..lib import world as W
from ..reference import nets as RN
from ..reference import vilbert as RV
from ..reference import world as RW

KIND = "pretrain"  # no fault of lib/faults.py applies


class DrawSpy(TorchFunctionMode):
    """Keeps a host copy of the output of every ``torch.rand`` and
    ``torch.randint``, in order: the pretrainer's masks and dropout sites.
    It observes and changes nothing."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.rand or func is torch.randint:
            self.draws.append(out.detach().to("cpu", copy=True))
        return out


def pairs(paths: list, pre: dict, length: int) -> list:
    """Every (path, instruction) pair as an expanded item: the instruction's
    words are ids; its encoding [CLS] ids [SEP], padded to ``length``."""
    out = []
    for p in paths:
        for words in p["instructions"]:
            ids = [pre["cls_id"], *map(int, words.split()), pre["sep_id"]]
            out.append({"scan": p["scan"], "path": p["path"], "path_id": p["path_id"],
                        "instr_encoding": ids + [pre["pad_id"]] * (length - len(ids))})
    return out


class Inputs:
    """Everything the seed makes, which both sides read."""

    def __init__(self, run: H.Run):
        cfg, tr, seed = run.config, run.traffic, run.seed
        pre = cfg["pretrain"]
        self.graphs = W.make_graphs(tr["world"], H.sub_seed(seed, "world"))
        scans = W.split_scans(self.graphs, tr["world"])
        vocab = [str(i) for i in range(*pre["word_ids"])]
        paths = W.make_paths(self.graphs, scans["train"], tr["data"], vocab,
                             H.sub_seed(seed, "paths"))
        self.items = pairs(paths, pre, tr["max_text_len"])
        n = sum(len(g["node_ids"]) for g in self.graphs.values())
        self.features = H.make_features(n, cfg["widths"]["views"], cfg["v_feature_size"],
                                        H.sub_seed(seed, "features"), run.device,
                                        torch.bfloat16)
        gen = torch.Generator(device=run.device).manual_seed(H.sub_seed(seed, "targets"))
        self.node_targets = torch.softmax(
            torch.randn((n, cfg["v_target_size"]), generator=gen, device=run.device), dim=-1)
        self.param_seed = H.sub_seed(seed, "params")
        self.draw_seed = H.sub_seed(seed, "draws")
        self.batch_seed = H.sub_seed(seed, "batches")
        # not the first step: from Adam's empty state every change is lr times the
        # gradient's sign, which round-off flips where a gradient is near 0
        rng = np.random.default_rng(H.sub_seed(seed, "checked"))
        self.checked = int(rng.integers(1, tr["warmup_steps"] + 1))


class Program:
    """The port's pretrainer, stepped as ``build_clr2r`` steps it."""

    def __init__(self, run: H.Run, inp: Inputs):
        from curriculum_learning_for_vln_torch.engine.pretrain import (VLNBertPretrainer,
                                                                        pretrain_batches)
        from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig
        from curriculum_learning_for_vln_torch.world.compiler import compile_world
        from curriculum_learning_for_vln_torch.world.graph import ScanGraph

        cfg, tr = run.config, run.traffic
        pre = cfg["pretrain"]
        world = compile_world(
            {s: ScanGraph(scan_id=s, node_ids=list(g["node_ids"]), pos=g["pos"],
                          edges=g["edges"].astype(np.int32)) for s, g in inp.graphs.items()},
            max_candidates=cfg["widths"]["max_candidates"])
        self.trainer = VLNBertPretrainer(VilBertConfig.from_dict(cfg), mask_idx=pre["mask_id"],
                                         lr=pre["lr"], mask_p=tr["token_mask_p"],
                                         region_p=tr["region_mask_p"])
        self.params, self.optimizer = self.trainer.init(
            torch.Generator().manual_seed(inp.param_seed), run.device)
        self.generator = torch.Generator(device=run.device).manual_seed(inp.draw_seed)
        self.batches = pretrain_batches(
            world, inp.items, None, tr["batch"], tr["max_path_len"], cfg["v_feature_size"],
            epochs=1 << 30, seed=inp.batch_seed, mismatch_p=tr["mismatch_p"],
            device=run.device, features=inp.features, node_targets=inp.node_targets)

    def step(self):
        """One step; (its batch, its logs)."""
        batch = next(self.batches)
        return batch, self.trainer.step(self.params, self.optimizer, batch, self.generator)

    def host(self, what) -> dict:
        """Host copies of the parameters' tree (``what`` "params"), their
        gradients ("grads") or Adam's moments ("exp_avg", "exp_avg_sq";
        zeros before the first step)."""
        from curriculum_learning_for_vln_torch.utils.tree import tree_map

        state = self.optimizer.state

        def one(p):
            if what in ("params", "grads"):
                t = p if what == "params" else p.grad
            else:
                t = state[p][what] if what in state[p] else torch.zeros_like(p)
            return t.detach().to("cpu", copy=True)

        return tree_map(one, self.params)


def leaves(tree, prefix: str = "") -> list:
    """(path, tensor) of every leaf of a nested dict / list, in order."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree) for kv in leaves(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def checked_step(prog: Program, step: int) -> dict:
    """Step number ``step`` (from 0), with what the reference needs of it."""
    before = {k: prog.host(k) for k in ("params", "exp_avg", "exp_avg_sq")}
    with DrawSpy() as spy:
        batch, logs = prog.step()
    return dict(before, step=step, draws=spy.draws, loss=float(logs["loss"]),
                batch={k: v.to("cpu", copy=True) for k, v in batch.items()},
                grads=prog.host("grads"), after=prog.host("params"))


def run(run: H.Run) -> H.Outcome:
    tr = run.traffic
    phases = [("start", time.perf_counter() - run.t0)]
    inp = Inputs(run)
    phases.append(("inputs", time.perf_counter()))
    prog = Program(run, inp)
    phases.append(("program", time.perf_counter()))
    checked = None
    for i in range(tr["warmup_steps"] + 1):
        if i == inp.checked:
            checked = checked_step(prog, i)
        else:
            prog.step()
    H.sync(run.device)
    phases.append(("warm-up and checked steps", time.perf_counter()))
    setup_s = time.perf_counter() - run.t0
    H.log_phases(phases, run.t0)
    setup_peak = H.peak_bytes(run.device, reset=True)

    # the window
    counters = prog.trainer.counters

    def positions():
        return np.array([counters.text_positions, counters.pad_positions])

    pairs0, steps, stamps, start = counters.pairs, 0, [], positions()
    traced = None
    tracing = H.TracedSteps(run, tr["trace_steps"])
    t_start = time.perf_counter()
    while True:
        prog.step()
        steps += 1
        stamps.append(time.perf_counter())
        if tracing.open and steps == tr["trace_steps"]:
            traced = positions() - start
        tracing.done(steps)
        if not tracing.open and time.perf_counter() - t_start >= run.seconds:
            break
    H.sync(run.device)
    elapsed = time.perf_counter() - t_start
    pairs = counters.pairs - pairs0
    window_peak = H.peak_bytes(run.device)
    work = traced_work(run, tracing, traced) if run.trace else {}
    if work:
        H.log("device s by span, a backward's with its forward: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(work["device_by_span"].items(),
                                                            key=lambda kv: -kv[1])))
    del prog, counters
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check(run, checked, expected_batch(run, inp, checked["step"])) + [
        H.Check("pairs_done_diff", float(abs(pairs - steps * tr["batch"])),
                tr["limits"]["pairs_done_diff"])]
    H.log(f"setup {setup_s:.3f} s, window {elapsed:.3f} s ({steps} steps, {pairs} pairs), "
          f"reference {time.perf_counter() - t_ref:.3f} s; host s a step "
          f"{H.quartiles(np.diff([t_start] + stamps))}")
    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               "train_episodes_per_s": {"value": pairs / elapsed, "unit": "episodes/s"},
               "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"}}
    return H.Outcome(metrics, checks, steps, 0, max(setup_peak, window_peak), tracing.read(),
                     work)


def traced_work(run: H.Run, tracing: H.TracedSteps, positions) -> dict:
    """The traced steps' work: their matrix-product FLOPs from their shapes,
    the device time by the program's spans, and the text positions and
    padded ones among them that the pretrainer counted."""
    tr = run.traffic
    n = tr["trace_steps"]
    return {"steps": n,
            "flops": n * vilbert_costs.step_flops(run.config, tr["batch"], tr["max_text_len"],
                                                  tr["max_path_len"]),
            "peak_flops": costs.PEAK_FLOPS["bf16"],
            "device_by_span": (program_spans.device_by_span(tracing.finished)
                               if tracing.finished is not None else {}),
            "text_positions": int(positions[0]), "pad_positions": int(positions[1])}


def expected_batch(run: H.Run, inp: Inputs, step: int) -> dict:
    """Batch number ``step`` (from 0, within the first pass) as the
    benchmark makes it from its own items and tables: the rows in
    ``pretrain_batches``'s order (a numpy generator of the batch seed: a
    permutation, then for each row below ``mismatch_p`` another item's
    instruction, alignment label 0); each path's panoramas numbered as
    ``reference/world.py`` numbers them, at each the view toward the next
    one (the last keeps the one before); the features and region targets
    read at those (panorama, view) pairs from the seed's tables, zero
    features and uniform targets past a path's end.  Host tensors, all
    but the locations."""
    tr, cfg = run.traffic, run.config
    B, R, n = tr["batch"], tr["max_path_len"], len(inp.items)
    if (step + 1) * B > n:
        raise ValueError(f"step {step} is past the first pass over {n} items")
    rng = np.random.default_rng(inp.batch_seed)
    order = rng.permutation(n)
    for s in range(step + 1):
        rows = order[s * B:(s + 1) * B]
        text = rows.copy()
        for b in np.flatnonzero(rng.random(B) < tr["mismatch_p"]):
            j = int(rng.integers(n - 1))
            text[b] = j + (j >= rows[b])
    tab = RW.compile_tables(inp.graphs, cfg["widths"]["max_candidates"], "cpu")
    nodes, views, mask = (np.zeros((B, R), np.int64) for _ in range(3))
    for b, i in enumerate(rows):
        path = [tab["id"][(inp.items[i]["scan"], vp)] for vp in inp.items[i]["path"]][:R]
        for t, (g, nxt) in enumerate(zip(path, path[1:])):
            k = int(tab["n_cands"][g])
            views[b, t] = int(tab["cand_view"][g, :k][tab["cand_next"][g, :k] == nxt].item())
        views[b, len(path) - 1] = views[b, len(path) - 2]
        nodes[b, :len(path)], mask[b, :len(path)] = path, 1
    dev = inp.features.device
    at = torch.from_numpy(nodes).to(dev)
    valid = torch.from_numpy(mask).to(dev)[..., None] > 0
    K = inp.node_targets.shape[1]
    feats = torch.where(valid, inp.features[at, torch.from_numpy(views).to(dev)].float(), 0.0)
    targets = torch.where(valid, inp.node_targets[at], 1.0 / K)
    return {"tokens": torch.tensor([inp.items[j]["instr_encoding"] for j in text]),
            "feats": feats.cpu(), "region_mask": torch.from_numpy(mask).float(),
            "region_targets": targets.cpu(),
            "align_labels": torch.from_numpy((text == rows).astype(np.int64))}


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (0 where both are 0)."""
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def side(run: H.Run, checked: dict, q) -> tuple:
    """(loss, gradients, Adam's changes) of the reference over the checked
    step, its matrix products through ``q``.  A change is the parameter
    after the step, rounded to f32 as the program stores it, less the one
    before, as the program's is read: near 1 (a LayerNorm's scale) a
    change of lr = 1e-4 keeps only ~3 decimal digits."""
    from curriculum_learning_for_vln_torch.utils.tree import tree_map

    dev, pre, tr = run.device, run.config["pretrain"], run.traffic
    params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True), checked["params"])
    batch = {k: v.to(dev) for k, v in checked["batch"].items()}
    logs = RV.loss(q, params, run.config, batch, RV.Draws(checked["draws"], dev),
                   pre["mask_id"], tr["token_mask_p"], tr["region_mask_p"])
    flat = [t for _, t in leaves(params)]
    grads = torch.autograd.grad(logs["loss"], flat)
    m = [t.to(dev) for _, t in leaves(checked["exp_avg"])]
    v = [t.to(dev) for _, t in leaves(checked["exp_avg_sq"])]
    p0 = [t.detach() for t in flat]
    after = RV.adam(p0, grads, m, v, checked["step"] + 1, pre["lr"])
    return (float(logs["loss"].detach()), [g.detach() for g in grads],
            [a - b for a, b in zip(after, p0)])


def judged_control(run: H.Run, checked: dict) -> tuple:
    """``side`` of the control in ``run.control``'s precision."""
    if run.control != "tf32":
        return side(run, checked, RN.quantizer(getattr(torch, run.control)))
    # TF32 is no torch type: the card rounds each product's operands to 10 bits itself
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return side(run, checked, RN.quantizer(None))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def check(run: H.Run, checked: dict, want: dict) -> list:
    """The reference's checked step against the judged side's: the
    program's, or with ``run.control`` the reference's in that type; both
    on the batch ``want`` (``expected_batch``), which the program's has to
    equal number for number.  Leaves whose reference gradient is below
    1e-4 of the median leaf's are left out of the gradient and change
    gaps: the key projections' biases, whose gradient is 0 but for
    round-off (a softmax does not change when one number is added to
    every score of a row)."""
    dev, limits = run.device, run.traffic["limits"]
    names = [n for n, _ in leaves(checked["params"])]
    got = checked["batch"]
    batch_diff = sum(int((got[k] != v).sum()) if got[k].shape == v.shape else v.numel()
                     for k, v in want.items())
    checked = dict(checked, batch=dict(got, **want))
    loss_r, grads_r, change_r = side(run, checked, RN.quantizer(None))
    if run.control is not None:
        loss_j, grads_j, change_j = judged_control(run, checked)
    else:
        loss_j = checked["loss"]
        grads_j = [t for _, t in leaves(checked["grads"])]
        change_j = [a - b for (_, a), (_, b) in zip(leaves(checked["after"]),
                                                    leaves(checked["params"]))]
    norms = [float(g.norm()) for g in grads_r]
    still = {n for n, x in zip(names, norms) if x < 1e-4 * float(np.median(norms))}
    grad_gaps = {n: gap(a.to(dev), b) for n, a, b in zip(names, grads_j, grads_r)
                 if n not in still}
    change_gaps = {n: gap(a.to(dev), b) for n, a, b in zip(names, change_j, change_r)
                   if n not in still}
    worst_g, worst_c = max(grad_gaps, key=grad_gaps.get), max(change_gaps, key=change_gaps.get)
    median_g = float(np.median(list(grad_gaps.values())))
    median_c = float(np.median(list(change_gaps.values())))
    loss_gap = abs(loss_j - loss_r) / abs(loss_r)
    H.log(f"checked step {checked['step']}: loss {loss_j!r} reference {loss_r!r}; worst leaves: "
          f"gradient {worst_g} {grad_gaps[worst_g]!r}, change {worst_c} "
          f"{change_gaps[worst_c]!r}; median leaves: gradient {median_g!r}, change "
          f"{median_c!r}; batch numbers that differ: {batch_diff}; left out: {sorted(still)}")
    return [H.Check("loss_gap", loss_gap, limits["loss_gap"]),
            H.Check("grad_gap", grad_gaps[worst_g], limits["grad_gap"]),
            H.Check("change_gap", change_gaps[worst_c], limits["change_gap"]),
            H.Check("grad_gap_median", median_g, limits["grad_gap_median"]),
            H.Check("change_gap_median", median_c, limits["change_gap_median"]),
            H.Check("batch_diff", float(batch_diff), limits["batch_diff"])]
