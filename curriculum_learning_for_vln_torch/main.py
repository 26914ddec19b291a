"""CLI entry point of the port — the flag contract of the JAX package's
``main.py`` (ref: tasks/R2R-judy/main.py:136-151), plus ``--device``:

    python -m curriculum_learning_for_vln_torch.main \\
        --config-file configs/envdrop/envdrop_cl_config.yaml --seed 2020 \\
        [TRAIN.CLMODE SELF-PACE] [KEY VALUE ...]

Config = defaults <- YAML file <- dotted-path overrides.  Runs on CUDA
unless ``--device`` names another device, and raises without a GPU.  It
trains the agent ``MODEL.NAME`` names (ENVDROP, FOLLOWER or SELF-MONITOR)
on R2R or CLR2R (real or ``TPU.SYNTHETIC_WORLD``) with the trainer
``TRAIN.CLMODE`` names for CLR2R (main.py:102-124): the classic one,
``NaiveCurriculum`` (NAIVE) or ``SelfPacedCurriculum`` (SELF-PACE), with
EnvDrop's packed RL where ``TPU.PACKED_RL`` >= 2; or, with
``--check-the-code``, runs the teacher-following sanity check on
val_unseen and exits; or, with ``--self-train`` (EnvDrop only), the
back-translation stage (main.py:78-98): a speaker of ``AIDE.SPEAKER`` in
``TPU.PRECISION``, pretrained, then EnvDrop trained on real and speaker-
generated instructions (``engine.self_train``, on CLR2R over round_5),
for TRAIN.MAX_EPOCH epochs of TRAIN.ITER_PER_EPOCH iterations.  Not
ported yet, and refused: the ``--beam`` mode, the AUTO (Exp3.S)
curriculum, the per-round train-split evaluation (``TRAIN.EVAL_TRAIN``),
the rollout early exit (``TPU.SCAN_EARLY_EXIT``), the hand-written BPTT
(``TPU.FUSED_BPTT``), frozen GloVe embeddings
(``MODEL.FOLLOWER.GLOVE_PATH``) and the other agents.
"""
from __future__ import annotations

import argparse
import random
import sys
import traceback

import numpy as np

from . import pipeline
from .agents import build_agent
from .agents.speaker import Speaker
from .engine.curriculum import NaiveCurriculum, SelfPacedCurriculum
from .engine.self_train import self_train
from .engine.trainer import ClassicTrainer, check_the_code
from .utils import logging_utils
from .utils.config import get_cfg_defaults
from .world.compiler import PRECISIONS, resolve_device

PORTED_AGENTS = ("ENVDROP", "FOLLOWER", "SELF-MONITOR")


def check_ported(args, cfg) -> None:
    """Raise on every mode and option of the JAX CLI that the port does
    not run yet, before any data is loaded."""
    if args.beam > 0:
        raise NotImplementedError("--beam is not ported yet")
    if args.self_train and cfg.MODEL.NAME != "ENVDROP":  # (main.py:84)
        raise ValueError("--self-train: back-translation is an EnvDrop stage")
    if cfg.MODEL.NAME not in PORTED_AGENTS:
        raise NotImplementedError(f"MODEL.NAME {cfg.MODEL.NAME!r} is not ported yet "
                                  f"({', '.join(PORTED_AGENTS)})")
    if cfg.MODEL.NAME == "FOLLOWER" and cfg.MODEL.FOLLOWER.GLOVE_PATH:
        raise NotImplementedError("MODEL.FOLLOWER.GLOVE_PATH (frozen GloVe embeddings) is not "
                                  "ported yet")
    pipeline.curriculum_mode(cfg)  # raises on AUTO
    for on, name in ((cfg.TRAIN.EVAL_TRAIN, "TRAIN.EVAL_TRAIN (the per-round train-split "
                                            "evaluation)"),
                     (cfg.TPU.SCAN_EARLY_EXIT, "TPU.SCAN_EARLY_EXIT (the rollout early exit)"),
                     (cfg.TPU.FUSED_BPTT, "TPU.FUSED_BPTT (the hand-written rollout BPTT)")):
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def build_trainer(cfg, train_env, logger):
    """The trainer TRAIN.CLMODE names for CLR2R (main.py:102-124)."""
    mode = pipeline.curriculum_mode(cfg)
    if mode == "NAIVE":
        logger.info("Using NaiveCurriculum trainer")
        return NaiveCurriculum()
    if mode == "SELF-PACE":
        logger.info("Using SelfPacedCurriculum trainer")
        return SelfPacedCurriculum.from_config(cfg, train_env)
    logger.info("Using Classic trainer")
    return ClassicTrainer()


def main(args, cfg) -> None:
    device = resolve_device(args.device)
    check_ported(args, cfg)
    logger = logging_utils.get_main_logger(cfg.OUTPUT.LOG_DIR, cfg.MODEL.NAME)
    if cfg.TPU.SCAN_ITERS > 1:
        logger.info("TPU.SCAN_ITERS %d is a TPU dispatch knob; it has no effect here",
                    cfg.TPU.SCAN_ITERS)
    random.seed(args.seed)
    np.random.seed(args.seed)
    pipeline.setup_vocab(cfg)
    logger.info("[1] seed %d, config %s, device %s", args.seed, args.config_file, device)

    tok = pipeline.build_tokenizer(cfg)
    logger.info("[2] tokenizer ready, vocab size %d", tok.vocab_size())
    world, train_env, valid_env, feat_dim = pipeline.build_environments(cfg, tok, seed=args.seed,
                                                                        device=device)
    logger.info("[3] world compiled (%d nodes) and environments created", world.num_nodes)

    if args.check_the_code:  # (main.py:63-65)
        logger.info("Checking the code (teacher-following agent on val_unseen)")
        check_the_code(cfg, world.device_tables(cfg.TPU.PRECISION, device), valid_env)
        return

    if args.self_train:
        # the speaker-augmented back-translation stage (main.py:78-98)
        agent = build_agent(cfg, tok.vocab_size(), feat_dim)
        speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=feat_dim,
                          episode_len=cfg.AGENT.MAX_EPISODE_LEN,
                          compute_dtype=PRECISIONS[cfg.TPU.PRECISION])
        aug_env = train_env["round_5"] if isinstance(train_env, dict) else train_env
        self_train(cfg, agent, speaker, aug_env, aug_env,
                   world.device_tables(cfg.TPU.PRECISION, device), seed=args.seed,
                   epochs=cfg.TRAIN.MAX_EPOCH, iters_per_epoch=cfg.TRAIN.ITER_PER_EPOCH)
        logger.info("[4] Self-training finished")
        return

    agent = build_agent(cfg, tok.vocab_size(), feat_dim)
    try:
        trainer = build_trainer(cfg, train_env, logger)
        trainer.train(cfg, agent, cfg.OUTPUT.TSBOARD_DIR, train_env, valid_env, seed=args.seed,
                      device=device)
    except Exception:
        s = traceback.format_exc()
        print(s)
        logger.error(s)
        sys.exit(1)
    logger.info("[4] Training finished")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="R2R navigation training, PyTorch on one GPU")
    parser.add_argument("--config-file", default="configs/envdrop/envdrop_config.yaml",
                        metavar="FILE", help="path to config file")
    parser.add_argument("--seed", default=2020, type=int, help="random seed")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda; raises without a GPU)")
    parser.add_argument("--check-the-code", action="store_true",
                        help="run the teacher-following sanity check and exit")
    parser.add_argument("--self-train", action="store_true",
                        help="speaker-augmented back-translation stage (EnvDrop)")
    parser.add_argument("--beam", default=0, type=int, metavar="N",
                        help="beam-search inference with beam size N (not ported yet)")
    parser.add_argument("opts", help="config overrides: KEY VALUE [KEY VALUE ...]",
                        default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return args, cfg


if __name__ == "__main__":
    main(*parse_args())
