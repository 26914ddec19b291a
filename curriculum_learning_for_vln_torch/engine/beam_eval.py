"""Beam-search inference with speaker rescoring, behind ``main --beam N``.

The port of ``curriculum_learning_for_vln_tpu/engine/beam_eval.py``.  The
reference exposes ``beam_search(speaker, beam_size=30)`` on every agent
(ref: tasks/R2R-judy/src/agent/base.py:452-464) but never wires it into
its CLI.  Here the flag runs the host-driven dijkstra expansion and the
speaker rescoring (agents/beam.py) over every validation split, selects
one path per instruction by combined listener + speaker log-likelihood
(the speaker-follower pragmatic rescoring rule, Fried et al. '18), and
writes both

* the reference submission format ``[{"instr_id", "trajectory":
  [(viewpoint, heading, elevation), ...]}]`` (ref: evaluator.py:12-18) to
  ``beam_<split>.json``, and
* the full scored beam (every candidate path with its listener and
  speaker scores) to ``beam_<split>_full.json``,

then scores the selected trajectories with the standard evaluator.
"""
from __future__ import annotations

import json
import logging
import os
import os.path as osp

import numpy as np
import torch

logger = logging.getLogger("main.beam_eval")


def _select_path(paths, speaker_weight: float, length_normalize: bool = False):
    """The path of highest (1 - w) * sum listener log-prob + w * sum
    speaker log-prob.  ``speaker_scores`` are per-word log-probs (the
    negated teacher-forcing losses), ``listener_scores`` per-step action
    log-probs.

    ``length_normalize`` divides the listener term by the number of
    actions.  The raw sum penalises every extra step, so dijkstra's
    first-found (max-sum) path is the listener-max selection at any beam
    width; the mean removes that short-path bias.  The speaker term stays
    a sum: every candidate scores the same instruction."""

    def score(p):
        lst = float(np.sum(p["listener_scores"]))
        if length_normalize:
            lst /= max(len(p["listener_scores"]), 1)
        spk = float(np.sum(p["speaker_scores"]))
        return (1.0 - speaker_weight) * lst + speaker_weight * spk

    return max(paths, key=score)


def run_beam_eval(cfg, agent, world, valid_env, tok, beam_size: int, seed: int = 2020,
                  device=None):
    """Beam search over every split of ``valid_env`` on ``device`` (default
    CUDA; raises without it).  Returns {split: summary}; writes the result
    files under OUTPUT.RESULT_DIR (default: <CKPT_DIR>/../results)."""
    from ..agents import init_agent
    from ..agents.beam import BeamSearch
    from ..agents.speaker import Speaker
    from ..convert import model_state_from_jax, params_from_jax
    from ..utils.logging_utils import format_score_table
    from ..utils.tree import tree_map
    from ..world.compiler import PRECISIONS, resolve_device
    from .checkpoint import load_checkpoint
    from .evaluator import Evaluation
    from .trainer import dedup_by_path

    device = resolve_device(device)
    tables = world.device_tables(cfg.TPU.PRECISION, device)
    params, model_state = init_agent(agent, torch.Generator().manual_seed(seed))

    ckpt_root = cfg.OUTPUT.CKPT_DIR or "snapshots/checkpoints"
    if cfg.OUTPUT.RESUME:
        ckpt_path = osp.join(ckpt_root, f"{cfg.OUTPUT.RESUME}.ckpt")
        logger.info("beam eval: loading agent checkpoint %s", ckpt_path)
        bundle = load_checkpoint(ckpt_path)
        params = params_from_jax(bundle["params"])
        if bundle.get("model_state"):
            model_state = model_state_from_jax(bundle["model_state"])
    else:
        logger.warning("beam eval: OUTPUT.RESUME is empty — using freshly "
                       "initialized agent weights")
    params = tree_map(lambda t: t.to(device), params)
    model_state = tree_map(lambda t: t.to(device), model_state)

    speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=tables.feat_dim,
                      episode_len=cfg.AGENT.MAX_EPISODE_LEN,
                      compute_dtype=PRECISIONS[cfg.TPU.PRECISION])
    if cfg.AIDE.SPEAKER.RESUME:
        logger.info("beam eval: loading speaker checkpoint %s", cfg.AIDE.SPEAKER.RESUME)
        spk_params, _, _ = speaker.load(cfg.AIDE.SPEAKER.RESUME, device=device)
    else:
        logger.warning("beam eval: AIDE.SPEAKER.RESUME is empty — speaker "
                       "rescoring uses freshly initialized weights")
        spk_params, _ = speaker.init(torch.Generator().manual_seed(seed + 1), device)

    results_dir = cfg.OUTPUT.RESULT_DIR or osp.join(
        osp.dirname(ckpt_root.rstrip("/")) or ".", "results")
    os.makedirs(results_dir, exist_ok=True)

    beam = BeamSearch(agent, world, tables)
    w = float(cfg.TPU.BEAM_SPEAKER_WEIGHT)
    len_norm = bool(cfg.TPU.BEAM_LEN_NORM)
    summaries = {}
    for split, henv in valid_env.items():
        out = beam.beam_search(params, model_state, henv, henv.data, speaker, spk_params,
                               beam_size)
        selected, full = [], []
        for instr_id, r in out.items():
            if r["paths"]:
                best = _select_path(r["paths"], w, len_norm)
                traj = [[v, float(h), float(e)] for v, h, e in best["trajectory"]]
            else:  # the expansion budget ran out before any <end> state
                traj = [[r["dijk_path"][0], 0.0, 0.0]]
            selected.append({"instr_id": instr_id, "trajectory": traj})
            full.append({
                "instr_id": instr_id,
                "dijk_path": r["dijk_path"],
                "paths": [{
                    "trajectory": [[v, float(h), float(e)] for v, h, e in p["trajectory"]],
                    "listener_scores": [float(s) for s in p["listener_scores"]],
                    "speaker_scores": [float(s) for s in np.asarray(p["speaker_scores"])],
                } for p in r["paths"]],
            })

        sel_path = osp.join(results_dir, f"beam_{split}.json")
        with open(sel_path, "w") as f:
            json.dump(selected, f)
        with open(osp.join(results_dir, f"beam_{split}_full.json"), "w") as f:
            json.dump(full, f)

        evaluator = Evaluation(world, dedup_by_path(henv.data))
        summary, _ = evaluator.score(selected)
        logger.info("beam(%d) %s -> %s\n%s", beam_size, split, sel_path,
                    format_score_table({split: summary}))
        print(f"beam({beam_size}) {split}: SR={summary['success_rate']:.3f} "
              f"SPL={summary['spl']:.3f} -> {sel_path}")
        summaries[split] = summary
    return summaries
