"""The speaker and back-translation on the card: the default
``AIDE.SPEAKER`` (RNN_DIM 512, WEMB 256, MAX_DECODE 120) on the EnvDrop
config's serving world, bf16 with f32 masters, B = 64, T = 35, seeded
random weights.

* One teacher-forcing step through the kernels against the plain
  versions: the loss and every gradient leaf (K1 = K2 = 4: two layers,
  two directions); more steps with exact launches, finite losses, the
  leaves moved.
* Greedy and sampled decodes and ``back_translate`` with its shared noise
  mask, each with K3 = 4 exactly; the first step's logits against the
  plain versions.
* ``engine.self_train`` (2 speaker steps, 4 iterations), each call's
  launches exact: a real iteration as the training path's at T_il = T,
  ``back_translate`` K3 = 4, a back-translated iteration K1 = K2 = 4 and
  K4-K7 = 0 (its decode is the unfused one); finite losses, moved
  parameters.
* A speaker checkpoint read back with its optimizer state, and ``main
  --self-train`` on a synthetic world for one short epoch.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_card_world import (BATCH, CONFIG, FEAT_DIM, KERNELS, REPO, SEED, card,  # noqa: F401
                              finite, launch_counts, launches_of, leaf_paths, moved_leaves,
                              plain_kernels, reset_launch_counts, serving)

SPEAKER_T = 35  # envdrop_config.yaml's MAX_EPISODE_LEN: the speaker's steps, all full
STEPS = 4       # teacher-forcing steps after one warm-up
TRAIN = launches_of(lstm_scan_train=4, lstm_scan_bwd=4)  # 2 layers x 2 directions
DECODE = launches_of(lstm_scan=4)


@pytest.fixture(scope="module")
def setup(serving, card):
    from curriculum_learning_for_vln_torch.agents.speaker import Speaker
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, *_ = serving
    assert cfg.AGENT.MAX_EPISODE_LEN == SPEAKER_T, f"{CONFIG} ships T = {SPEAKER_T}"
    dtype = PRECISIONS[cfg.TPU.PRECISION]
    speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=FEAT_DIM,
                      episode_len=SPEAKER_T, compute_dtype=dtype)
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), BATCH, tok, seed=SEED, device=card)
    params, opt = speaker.init(torch.Generator().manual_seed(SEED), card)
    return speaker, dtype, world.device_tables(cfg.TPU.PRECISION, card), env, params, opt


def test_teacher_forcing_step_agrees_with_plain_versions(setup, card):
    """The loss within 1e-4 of its scale; every gradient leaf within 1e-2 of
    its largest plain element (the bf16 compute weights' gradients are
    bf16: one ulp of a leaf's largest element is up to 2^-7 of it)."""
    from curriculum_learning_for_vln_torch.agents.speaker import collect_shortest_path_features
    from curriculum_learning_for_vln_torch.utils import tree

    speaker, dtype, tables, env, params, _ = setup
    leaves = tree.tree_leaves(params)
    batch = env.next_batch()
    feats = collect_shortest_path_features(tables, batch, SPEAKER_T, dtype)

    def grads():
        gen = torch.Generator(device=card).manual_seed(SEED + 3)
        loss = speaker.teacher_forcing_loss(params, feats, batch.instr_tokens, True, gen)
        for p in leaves:
            p.grad = None
        loss.backward()
        # baseline_fc1 / fc2 are on no path of the speaker: no gradient
        return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                             for p in leaves]

    reset_launch_counts()
    loss_k, g_k = grads()
    counts = launch_counts()
    assert counts == TRAIN, f"speaker step launches {counts}, expected {TRAIN}"
    with plain_kernels():
        loss_p, g_p = grads()
    for p in leaves:
        p.grad = None
    assert abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), \
        f"speaker loss kernels {loss_k} plain {loss_p}"
    for path, gk, gp in zip(leaf_paths(params), g_k, g_p):
        sc = max(float(gp.abs().max()), 1e-6)
        e = float((gk - gp).abs().max())
        assert e <= 1e-2 * sc, f"speaker gradient leaf {'/'.join(map(str, path))}: {e:.3g}"


def test_teacher_forcing_steps_launch_exactly_and_train(setup, card):
    from curriculum_learning_for_vln_torch.utils import tree

    speaker, _, tables, env, params, opt = setup
    leaves = tree.tree_leaves(params)
    gen = torch.Generator(device=card).manual_seed(SEED + 4)
    speaker.train_steps(params, opt, tables, env, gen, 1)  # warm-up
    before = [p.detach().clone() for p in leaves]
    losses = []
    for _ in range(STEPS):
        reset_launch_counts()
        losses += speaker.train_steps(params, opt, tables, env, gen, 1)[2]
        counts = launch_counts()
        assert counts == TRAIN, f"speaker step launches {counts}, expected {TRAIN}"
    assert finite(losses), f"finite losses {losses}"
    moved = moved_leaves(before, leaves)
    assert moved >= len(leaves) - 4, f"{moved} of {len(leaves)} speaker leaves moved"


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
def test_decode_launches_k3_four_times(setup, card, sampling):
    from curriculum_learning_for_vln_torch.utils.tokenizer import EOS_IDX, PAD_IDX, UNK_IDX

    speaker, _, tables, env, params, _ = setup
    gen = torch.Generator(device=card).manual_seed(SEED + 5)
    ep = env.next_batch()
    reset_launch_counts()
    words = speaker.infer_batch(params, tables, ep, gen, sampling=sampling).cpu().numpy()
    counts = launch_counts()
    assert counts == DECODE, f"decode launches {counts}, expected {DECODE}"
    assert words.shape == (BATCH, speaker.cfg.MAX_DECODE) and not (words == UNK_IDX).any(), \
        f"decode: {words.shape} words, no <UNK>"
    for row in words:
        eos = np.flatnonzero(row == EOS_IDX)
        assert not len(eos) or (row[eos[0] + 1:] == PAD_IDX).all(), "<PAD> after <EOS>"


def test_back_translate_through_a_shared_mask(setup, card):
    from curriculum_learning_for_vln_torch.utils.tokenizer import BOS_IDX, EOS_IDX

    speaker, _, tables, env, params, _ = setup
    gen = torch.Generator(device=card).manual_seed(SEED + 6)
    ep = env.next_batch()
    reset_launch_counts()
    new_ep, noise = speaker.back_translate(params, tables, env, ep, int(ep.instr_tokens.shape[1]),
                                           gen, FEAT_DIM)
    toks, lens = new_ep.instr_tokens.cpu().numpy(), new_ep.instr_len.cpu().numpy()
    counts = launch_counts()
    assert counts == DECODE, f"back_translate launches {counts}, expected {DECODE}"
    keep = 1.0 - speaker.cfg.FEAT_DROPOUT
    assert bool(((noise == 0) | ((noise - 1.0 / keep).abs() <= 1e-6)).all()) \
        and noise.shape == (FEAT_DIM,), "the shared mask holds 0 and 1 / keep only"
    assert (toks[:, 0] == BOS_IDX).all() and (toks[np.arange(BATCH), lens - 1] == EOS_IDX).all(), \
        "back-translated instructions run <BOS> .. <EOS>"
    assert torch.equal(new_ep.start_node, ep.start_node) and bool(new_ep.valid.all()), \
        "back-translation keeps the episodes"


def test_decode_first_step_logits_agree_with_plain_versions(setup, card):
    """Within 1e-3 of their scale: f32 encoder outputs summed in another
    order, then bf16 weights downstream."""
    from curriculum_learning_for_vln_torch.agents.common import cast_compute_params
    from curriculum_learning_for_vln_torch.agents.speaker import collect_shortest_path_features
    from curriculum_learning_for_vln_torch.models.speaker_model import speaker_decoder_apply
    from curriculum_learning_for_vln_torch.utils.tokenizer import BOS_IDX

    speaker, dtype, tables, env, params, _ = setup
    ep = env.next_batch()

    def first_logits():
        with torch.no_grad():
            f = collect_shortest_path_features(tables, ep, SPEAKER_T, dtype)
            ctx, cmask = speaker._encode(params, f, False)
            h0 = torch.zeros((BATCH, speaker.cfg.RNN_DIM), device=card)
            bos = torch.full((BATCH, 1), BOS_IDX, dtype=torch.long, device=card)
            lg, _, _ = speaker_decoder_apply(cast_compute_params(params["decoder"], dtype), bos,
                                             ctx, cmask, h0, h0, False)
        return lg[:, 0].float()

    l_k = first_logits()
    with plain_kernels():
        l_p = first_logits()
    scale, err = float(l_p.abs().max()), float((l_k - l_p).abs().max())
    assert err <= 1e-3 * max(scale, 1.0), \
        f"speaker first-step logits |kernel - plain| {err:.3g} of scale {scale:.3g}"


def counted(kind, fn, record):
    """``fn`` with each call's launches appended to ``record[kind]``."""
    def run(*args, **kwargs):
        before = launch_counts()
        out = fn(*args, **kwargs)
        after = launch_counts()
        record[kind].append({k: after[k] - before[k] for k in KERNELS})
        return out

    return run


def test_self_train_launches_exactly_and_trains(setup, serving, card):
    import importlib

    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.agents.speaker import Speaker
    from curriculum_learning_for_vln_torch.utils import tree

    st = importlib.import_module("curriculum_learning_for_vln_torch.engine.self_train")
    speaker, dtype, tables, env, _, _ = setup
    _, _, _, tok, cfg, *_ = serving
    T = SPEAKER_T
    agent = EnvDropAgent(cfg.MODEL.ENVDROP, tok.encoding_length, tok.vocab_size(), FEAT_DIM, T,
                         compute_dtype=dtype, obs_masks=cfg.TPU.OBS_MASKS)
    record = {"pretrain": [], "real": [], "bt": [], "back_translate": []}
    st_speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=FEAT_DIM, episode_len=T,
                         compute_dtype=dtype)
    st_speaker.train_steps = counted("pretrain", st_speaker.train_steps, record)
    st_speaker.back_translate = counted("back_translate", st_speaker.back_translate, record)
    saved = st.one_iter, st.backtranslation_step
    st.one_iter = counted("real", st.one_iter, record)
    st.backtranslation_step = counted("bt", st.backtranslation_step, record)
    try:
        reset_launch_counts()
        st_params, _, (st_spk, _), st_losses = st.self_train(
            cfg, agent, st_speaker, env, env, tables, seed=SEED, speaker_iters=2, epochs=1,
            iters_per_epoch=4)
    finally:
        st.one_iter, st.backtranslation_step = saved
    want = {"pretrain": launches_of(lstm_scan_train=8, lstm_scan_bwd=8),  # 2 steps
            "real": launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=2 * T + 1,
                                cand_score=2 * T + 1, pano_attend_bwd=2 * T,
                                cand_score_bwd=2 * T),
            "back_translate": DECODE,
            "bt": TRAIN}
    for kind, calls in record.items():
        assert len(calls) == (1 if kind == "pretrain" else 2), f"self_train: {len(calls)} {kind}"
        for counts in calls:
            assert counts == want[kind], \
                f"self_train {kind} launches {counts}, expected {want[kind]}"
    assert finite(st_losses["real"] + st_losses["bt"]), f"finite {st_losses}"
    p0 = tree.tree_leaves(agent.init(torch.Generator().manual_seed(SEED + 1)))
    s0 = tree.tree_leaves(speaker.init(torch.Generator().manual_seed(SEED), card)[0])
    moved = sum(int(not torch.equal(a.to(card), b.detach()))
                for a, b in zip(p0, tree.tree_leaves(st_params)))
    spk_moved = sum(int(not torch.equal(a.detach(), b.detach()))
                    for a, b in zip(s0, tree.tree_leaves(st_spk)))
    assert moved == len(p0) and spk_moved >= len(s0) - 4, \
        f"self_train moved {moved}/{len(p0)} EnvDrop and {spk_moved}/{len(s0)} speaker leaves"


def test_speaker_checkpoint_reads_back_with_its_optimizer_state(setup, card, tmp_path):
    from curriculum_learning_for_vln_torch.utils import tree

    speaker, _, _, _, params, opt = setup
    path = os.path.join(tmp_path, "speaker.ckpt")
    speaker.save(path, params, opt, epoch=1)
    p2, opt2, epoch = speaker.load(path, load_optim=True, device=card)
    assert epoch == 1 and all(torch.equal(a.detach(), b.detach()) for a, b in
                              zip(tree.tree_leaves(params), tree.tree_leaves(p2))), \
        "speaker params read back"
    st1, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert st1.keys() == st2.keys() and all(
        torch.equal(st1[k][n].cpu(), st2[k][n].cpu())
        for k in st1 for n in ("step", "exp_avg", "exp_avg_sq")), \
        "the speaker's optimizer state read back"


def test_main_self_train(card, tmp_path):
    d = str(tmp_path)
    cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--self-train",
           "--seed", str(SEED), "--config-file", CONFIG, "TPU.SYNTHETIC_WORLD", "True",
           "TPU.SYNTHETIC_SCANS", "6", "TPU.SYNTHETIC_NODES", "48", "TRAIN.MAX_EPOCH", "1",
           "TRAIN.ITER_PER_EPOCH", "2", "OUTPUT.LOG_DIR", d, "OUTPUT.TSBOARD_DIR", "",
           "OUTPUT.CKPT_DIR", d]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    text = "".join(open(f).read() for f in glob.glob(os.path.join(d, "*.log")))
    assert run.returncode == 0 and "Self-training finished" in text, \
        f"main --self-train: rc {run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}"
