"""Self-Monitor serving in a closed loop: back-to-back
``Navigator.navigate_batch`` calls of ``batch`` requests, checked against
the plain reference (``reference/monitor.py``).

Set-up makes the world, the request pool, the weights and the BatchNorm
statistics from the seed, builds the port's ``Navigator`` with the
benchmark's feature table, and makes ``warmup_calls`` calls.  The window
sends the pool's requests ``batch`` at a time, the next call as soon as
the last returned, until ``--seconds`` have passed; each call's latency
is its host-clock time until the trajectories are back.  With
``--trace`` the profiler records the window's first ``trace_calls``
calls.  The trajectories of ``checked_calls`` calls drawn from the seed
among the window's first ``sample_from`` (the window lasts until they
are made) are judged by the reference once the window has closed.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..lib import costs, port
from ..lib.launches import candidate_rows_bounds
from ..lib import harness as H
from ..lib import world as W
from ..reference import data as RD
from ..reference import monitor as RM
from ..reference import nets as RN
from ..reference import params as RP
from ..reference import world as RW

ANGLE_INC = RW.ANGLE_INC


KIND = "serve"  # which faults of lib/faults.py apply

class Inputs:
    def __init__(self, run: H.Run):
        cfgd, traffic, seed = run.config, run.traffic, run.seed
        self.widths = cfgd["widths"]
        self.vocab = W.read_vocab(H.BENCH / cfgd["vocab"])
        self.graphs = W.make_graphs(traffic["world"], H.sub_seed(seed, "world"))
        scans = W.split_scans(self.graphs, traffic["world"])
        self.requests = W.make_requests(self.graphs, scans["val_unseen"], traffic["requests"],
                                        self.vocab, H.sub_seed(seed, "requests"))
        n = sum(len(g["node_ids"]) for g in self.graphs.values())
        self.features = H.make_features(n, self.widths["views"], self.widths["feature"],
                                        H.sub_seed(seed, "features"), run.device, torch.bfloat16)
        self.params = RP.make_params(RP.monitor_layout(self.widths, len(self.vocab)),
                                     H.sub_seed(seed, "params"), run.device)
        self.bn_state = RP.make_bn_state(self.widths, H.sub_seed(seed, "bn"), run.device)
        rng = np.random.default_rng(H.sub_seed(seed, "sample"))
        self.checked = sorted(rng.choice(traffic["sample_from"], traffic["checked_calls"],
                                         replace=False).tolist())


def navigator(run: H.Run, inp: Inputs):
    from curriculum_learning_for_vln_torch.agents import build_agent
    from curriculum_learning_for_vln_torch.serve import Navigator

    cfg = port.cfg_of(run.config)
    compiled, _ = port.world(inp.graphs, inp.features[:1], cfg, "cpu")
    tok = port.tokenizer(inp.vocab, cfg)
    agent = build_agent(cfg, tok.vocab_size(), feat_dim=inp.widths["feature"])
    nav = Navigator(compiled, agent, inp.params, tok, max_batch=run.traffic["batch"],
                    precision=cfg.TPU.PRECISION, device=run.device, model_state=inp.bn_state)
    nav.tables = nav.tables._replace(features=inp.features)
    return nav


def calls(requests, batch: int):
    """The pool's requests, ``batch`` at a time, round and round."""
    i = 0
    while True:
        yield [requests[(i + k) % len(requests)] for k in range(batch)]
        i = (i + batch) % len(requests)


def run(run: H.Run) -> H.Outcome:
    traffic, B = run.traffic, run.traffic["batch"]
    phases = [("start", time.perf_counter() - run.t0)]
    if run.device.type == "cuda":
        port.build_kernels()
    phases.append(("kernels", time.perf_counter()))
    inp = Inputs(run)
    phases.append(("inputs", time.perf_counter()))
    nav = navigator(run, inp)
    phases.append(("program", time.perf_counter()))
    for chunk, _ in zip(calls(inp.requests, B), range(traffic["warmup_calls"])):
        nav.navigate_batch(chunk)
    H.sync(run.device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - run.t0
    H.log_phases(phases, run.t0)
    setup_peak = H.peak_bytes(run.device, reset=True)

    lat, kept, n = [], {}, 0
    tracing = H.TracedSteps(run, traffic["trace_calls"])
    source = calls(inp.requests, B)
    t_start = time.perf_counter()
    while True:
        chunk = next(source)
        t = time.perf_counter()
        with H.span("navigate_batch"):
            out = nav.navigate_batch(chunk)
        lat.append(time.perf_counter() - t)
        if n in inp.checked:
            kept[n] = (chunk, out)
        n += 1
        tracing.done(n)
        if (not tracing.open and n > inp.checked[-1]
                and time.perf_counter() - t_start >= run.seconds):
            break
    elapsed = time.perf_counter() - t_start
    window_peak = H.peak_bytes(run.device)
    del nav
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(run, inp, kept, getattr(torch, run.control) if run.control else None)
    H.log(f"setup {setup_s:.3f} s, window {elapsed:.3f} s ({n} calls), reference "
          f"{time.perf_counter() - t_ref:.3f} s; s a call {H.quartiles(lat)}")
    q = statistics.quantiles(lat, n=100) if len(lat) >= 2 else lat * 99
    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               "serve_requests_per_s": {"value": n * B / elapsed, "unit": "requests/s"},
               "serve_call_ms_p95": {"value": 1e3 * q[94], "unit": "ms"},
               "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"}}
    work = traced_work(run, inp, tracing.launches) if run.trace else {}
    return H.Outcome(metrics, checks, n * B, 0, max(setup_peak, window_peak), tracing.read(), work)


def moves_of(tab: dict, request: dict, trajectory) -> list:
    """The (panorama, view) of each move of a returned trajectory."""
    out = []
    for vp, heading, elevation in trajectory[1:]:
        view = (int(round(elevation / ANGLE_INC)) + 1) * 12 + int(round(heading / ANGLE_INC)) % 12
        out.append((tab["id"][(request["scan"], vp)], view))
    return out


def check(run: H.Run, inp: Inputs, kept: dict, control=None) -> list:
    """The reference along the kept calls' trajectories: the widest gap of
    a served action's logit below the best (and of the control's first
    choices, with ``control`` a narrower float type)."""
    w = inp.widths
    tab = RW.compile_tables(inp.graphs, w["max_candidates"], run.device)
    word_ids = {v: i for i, v in enumerate(inp.vocab)}
    model = RM.Monitor(tab, inp.features, RN.quantizer(None))
    ctl = RM.Monitor(tab, inp.features, RN.quantizer(control)) if control is not None else None
    gap, ctl_gap, judged, missing = 0.0, 0.0, 0, len(inp.checked) - len(kept)
    for chunk, out in kept.values():
        enc = [RD.encode(r["instruction"], word_ids, w["max_enc_len"]) for r in chunk]
        tokens = torch.from_numpy(np.stack([e[0] for e in enc])).to(run.device)
        lengths = torch.tensor([e[1] for e in enc], device=run.device)
        start = torch.tensor([tab["id"][(r["scan"], r["start_viewpoint"])] for r in chunk],
                             device=run.device)
        heading = torch.tensor([r["heading"] for r in chunk], dtype=torch.float32,
                               device=run.device)
        moves = [moves_of(tab, r, o["trajectory"]) for r, o in zip(chunk, out)]
        g, cg, j, _ = RM.judge(model, inp.params, inp.bn_state, tokens, lengths, start, heading,
                               moves, run.config["AGENT.MAX_EPISODE_LEN"], ctl)
        gap, judged = max(gap, g), judged + j
        ctl_gap = max(ctl_gap, cg or 0.0)
    limits = run.traffic["limits"]
    checks = [H.Check("action_gap", gap, limits["action_gap"]),
              H.Check("calls_missing", float(missing), 0.0)]
    if control is not None:
        checks.append(H.Check("control_gap", ctl_gap, limits["action_gap"]))
    return checks


def traced_work(run: H.Run, inp: Inputs, launches) -> dict:
    """The work of the traced calls: model FLOPs from their requests, K3's
    bounds from their token counts, K4's from the launches recorded."""
    w, B, T = inp.widths, run.traffic["batch"], run.config["AGENT.MAX_EPISODE_LEN"]
    word_ids = {v: i for i, v in enumerate(inp.vocab)}
    flops = lstm_s = 0.0
    source = calls(inp.requests, B)
    for _ in range(run.traffic["trace_calls"]):
        tok = sum(RD.encode(r["instruction"], word_ids, w["max_enc_len"])[1] for r in next(source))
        flops += costs.monitor_call_flops(w, tok, B, T, tok / B)
        lstm_s += costs.lstm_bounds(B, w["max_enc_len"], w["word_emb"], w["hidden"], tok,
                                    "bf16")["infer"]
    return {"steps": run.traffic["trace_calls"], "flops": flops,
            "peak_flops": costs.PEAK_FLOPS["bf16"],
            "bounds_s": {"lstm_scan": {"fwd": lstm_s},
                         "obs": candidate_rows_bounds(launches)},
            "launches": launches}
