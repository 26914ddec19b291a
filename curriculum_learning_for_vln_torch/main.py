"""CLI entry point of the port — the flag contract of the JAX package's
``main.py`` (ref: tasks/R2R-judy/main.py:136-151), plus ``--device``:

    python -m curriculum_learning_for_vln_torch.main \\
        --config-file configs/envdrop/envdrop_config.yaml --seed 2020 \\
        TPU.PACKED_RL 0 [KEY VALUE ...]

Config = defaults <- YAML file <- dotted-path overrides.  Runs on CUDA
unless ``--device`` names another device, and raises without a GPU.  It
trains EnvDrop with the classic trainer on R2R (real or
``TPU.SYNTHETIC_WORLD``).  Not ported yet, and refused: the
``--check-the-code``, ``--beam`` and ``--self-train`` modes, the CLR2R
curriculum trainers (``TRAIN.CLMODE``), packed RL (``TPU.PACKED_RL`` >= 2)
and the other agents.
"""
from __future__ import annotations

import argparse
import random
import sys
import traceback

import numpy as np

from . import pipeline
from .agents.envdrop import EnvDropAgent
from .engine.trainer import ClassicTrainer
from .utils import logging_utils
from .utils.config import get_cfg_defaults
from .world.compiler import PRECISIONS, resolve_device


def check_ported(args, cfg) -> None:
    """Raise on every mode and option of the JAX CLI that the port does
    not run yet, before any data is loaded."""
    for flag, name in ((args.check_the_code, "--check-the-code"), (args.beam > 0, "--beam"),
                       (args.self_train, "--self-train")):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet")
    if cfg.MODEL.NAME != "ENVDROP":
        raise NotImplementedError(f"MODEL.NAME {cfg.MODEL.NAME!r} is not ported yet (ENVDROP only)")
    if cfg.TRAIN.CLMODE:
        raise NotImplementedError(f"the {cfg.TRAIN.CLMODE} curriculum trainer is not ported yet")
    if cfg.TPU.PACKED_RL >= 2:
        raise NotImplementedError(f"TPU.PACKED_RL {cfg.TPU.PACKED_RL} (packed RL) is not ported "
                                  "yet; pass TPU.PACKED_RL 0 for the reference iteration")


def main(args, cfg) -> None:
    device = resolve_device(args.device)
    check_ported(args, cfg)
    logger = logging_utils.get_main_logger(cfg.OUTPUT.LOG_DIR, cfg.MODEL.NAME)
    random.seed(args.seed)
    np.random.seed(args.seed)
    pipeline.setup_vocab(cfg)
    logger.info("[1] seed %d, config %s, device %s", args.seed, args.config_file, device)

    tok = pipeline.build_tokenizer(cfg)
    logger.info("[2] tokenizer ready, vocab size %d", tok.vocab_size())
    world, train_env, valid_env, feat_dim = pipeline.build_environments(cfg, tok, seed=args.seed,
                                                                        device=device)
    logger.info("[3] world compiled (%d nodes) and environments created", world.num_nodes)

    agent = EnvDropAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, tok.vocab_size(), feat_dim,
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[cfg.TPU.PRECISION],
                         obs_masks=cfg.TPU.OBS_MASKS)
    try:
        ClassicTrainer().train(cfg, agent, cfg.OUTPUT.TSBOARD_DIR, train_env, valid_env,
                               seed=args.seed, device=device)
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
                        help="run the teacher-following sanity check and exit (not ported yet)")
    parser.add_argument("--self-train", action="store_true",
                        help="speaker-augmented back-translation stage (not ported yet)")
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
