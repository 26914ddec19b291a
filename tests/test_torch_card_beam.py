"""Beam search with speaker rescoring (``main --beam``) on the card:
EnvDrop at the full width of its config (random weights from a seed; the
beam decodes in f32 on the bf16 tables, as the JAX package does), the
default ``AIDE.SPEAKER`` in bf16, one batch of 64 instructions, beam 30,
max_iters 500.

* The listener's encoder and one rescoring call through K3 against the
  plain versions.
* ``beam_rollout`` with exact launches (K3 = 2 for the listener + 4 for
  each episode with a path, nothing else), a decode step an iteration and
  a rescoring call an episode with paths.
* Every episode has a path, every score is a log-probability, every dijk
  path a connected walk.
* ``main --beam 5`` on a synthetic 6 x 48 world.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_card_world import (BATCH, CONFIG, FEAT_DIM, REPO, SEED, card, compare,  # noqa: F401
                              launch_counts, launches_of, plain_kernels, reset_launch_counts,
                              serving)

BEAM_SIZE = 30        # the default of BeamSearch.beam_rollout / beam_search
BEAM_MAX_ITERS = 500  # BeamSearch's default expansion budget


@pytest.fixture(scope="module")
def setup(serving, card):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.speaker import Speaker
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, params = serving
    dtype = PRECISIONS[cfg.TPU.PRECISION]
    T = cfg.AGENT.MAX_EPISODE_LEN
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=dtype)
    speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=FEAT_DIM, episode_len=T,
                      compute_dtype=dtype)
    spk_params, _ = speaker.init(torch.Generator().manual_seed(SEED + 1), card)
    items = expand_r2r_items(data, tok)
    env = R2RBatchEnv(world, items, BATCH, tok, seed=SEED, name="val_unseen", device=card)
    return {"agent": agent, "params": tree.tree_map(lambda t: t.to(card), params),
            "tables": world.device_tables(cfg.TPU.PRECISION, card), "speaker": speaker,
            "spk_params": spk_params, "items": items, "ep": next(env.eval_batches()),
            "m": m, "world": world}


def test_listener_encoder_agrees_with_plain_versions(setup):
    from curriculum_learning_for_vln_torch.models.encoder import encoder_apply

    ep, p = setup["ep"], setup["params"]

    def encode():
        with torch.inference_mode():
            return encoder_apply(p["encoder"], ep.instr_tokens, ep.instr_len, False,
                                 setup["m"].DROP_RATE)

    reset_launch_counts()
    enc_k = encode()
    counts = launch_counts()
    assert counts == launches_of(lstm_scan=2), f"listener encoder launches {counts}"
    with plain_kernels():
        enc_p = encode()
    err, tol = compare(enc_k, enc_p, 1e-4)
    assert err <= tol, f"listener encoder |kernel - plain| {err:.3g} > {tol:.3g}"


@pytest.fixture(scope="module")
def beam(setup):
    """``beam_rollout`` of the batch, its decode steps and rescoring calls
    counted: (search, results, launches, decode steps, rescoring args)."""
    from curriculum_learning_for_vln_torch.agents import beam as beam_mod

    search = beam_mod.BeamSearch(setup["agent"], setup["world"], setup["tables"],
                                 max_iters=BEAM_MAX_ITERS)
    rec = {"decode": 0, "rescore": []}
    make, rescore = beam_mod.make_beam_decoder, search.rescore

    def counted_decoder(a, st):
        step = make(a, st)

        def run(*args):
            rec["decode"] += 1
            return step(*args)
        return run

    def counted_rescore(*args):
        rec["rescore"].append(args)
        return rescore(*args)

    beam_mod.make_beam_decoder = counted_decoder
    search.rescore = counted_rescore
    try:
        reset_launch_counts()
        results = search.beam_rollout(setup["params"], {}, setup["ep"], setup["items"],
                                      setup["speaker"], setup["spk_params"], BEAM_SIZE)
        counts = launch_counts()
    finally:
        beam_mod.make_beam_decoder = make
    return search, results, counts, rec, rescore


def test_beam_rollout_launches_exactly(beam):
    search, results, counts, rec, _ = beam
    with_paths = sum(1 for r in results if r["paths"])
    want = launches_of(lstm_scan=2 + 4 * with_paths)  # listener 1 x 2 directions; speaker 2 x 2
    assert counts == want, f"beam launches {counts}, expected {want}"
    assert counts["lstm_scan"] > 0, "K3 launched on the beam path"
    assert rec["decode"] == search.iterations and len(rec["rescore"]) == with_paths, \
        (f"{rec['decode']} decode steps in {search.iterations} iterations, "
         f"{len(rec['rescore'])} rescoring calls for {with_paths} episodes")


def test_rescoring_call_agrees_with_plain_versions(beam):
    """The first episode's paths through K3 = 4 against plain: within 1e-3
    of the scale (f32 encoder states summed in another order, then bf16
    weights downstream)."""
    *_, rec, rescore = beam
    args = rec["rescore"][0]
    reset_launch_counts()
    pw_k = rescore(*args)
    assert launch_counts() == launches_of(lstm_scan=4), "one rescoring call: K3 = 4"
    with plain_kernels():
        pw_p = rescore(*args)
    scale = float(np.abs(pw_p).max())
    err = float(np.abs(pw_k - pw_p).max())
    assert err <= 1e-3 * max(scale, 1.0), f"rescoring |kernel - plain| {err:.3g} of {scale:.3g}"


def test_beam_paths_are_scored_walks(beam, setup):
    world = setup["world"]
    for r in beam[1]:
        assert len(r["paths"]) >= 1, f"{r['instr_id']}: a finished path"
        for path in r["paths"]:
            assert "visual_feature" not in path \
                and len(path["trajectory"]) == len(path["action"]) + 1, "a rescored path"
            assert all(x <= 1e-6 for x in path["listener_scores"]) \
                and bool(np.all(np.asarray(path["speaker_scores"]) <= 1e-6)), \
                "listener and speaker scores are log-probabilities"
        for a, b in zip(r["dijk_path"][:-1], r["dijk_path"][1:]):
            ga, gb = world.global_id(r["scan"], a), world.global_id(r["scan"], b)
            assert ga == gb or gb in world.cand_next[ga][world.cand_valid[ga]], \
                "dijk_path is a connected walk"


def test_main_beam(card, tmp_path):
    d = str(tmp_path)
    cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--beam", "5",
           "--seed", str(SEED), "--config-file", CONFIG, "TPU.SYNTHETIC_WORLD", "True",
           "TPU.SYNTHETIC_SCANS", "6", "TPU.SYNTHETIC_NODES", "48", "OUTPUT.LOG_DIR", d,
           "OUTPUT.TSBOARD_DIR", "", "OUTPUT.CKPT_DIR", os.path.join(d, "ckpt"),
           "OUTPUT.RESULT_DIR", os.path.join(d, "results")]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(d, "results", "*")))
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("beam(5)")]
    assert run.returncode == 0 and len(lines) == 2 and len(files) == 4, \
        f"main --beam 5: rc {run.returncode}, {lines}, {files}\n{run.stdout[-2000:]}\n" \
        f"{run.stderr[-4000:]}"
