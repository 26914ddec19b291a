"""CLI entry point of the port — the flag contract of the JAX package's
``main.py`` (ref: tasks/R2R-judy/main.py:136-151), plus ``--device``:

    python -m curriculum_learning_for_vln_torch.main \\
        --config-file configs/envdrop/envdrop_cl_config.yaml --seed 2020 \\
        [TRAIN.CLMODE SELF-PACE] [KEY VALUE ...]

Config = defaults <- YAML file <- dotted-path overrides.  Runs on CUDA
unless ``--device`` names another device, and raises without a GPU.  It
trains the agent ``MODEL.NAME`` names (ENVDROP, FOLLOWER or SELF-MONITOR;
the Follower with frozen GloVe embeddings from
``MODEL.FOLLOWER.GLOVE_PATH``) on ``DATA.NAME`` R2R, CLR2R, R4R (real or
``TPU.SYNTHETIC_WORLD``), RxR or Mixed (real data), with the teacher
``AGENT.TEACHER`` names (goal, or path: the gt route) and the trainer
``TRAIN.CLMODE`` names for CLR2R (main.py:102-124): the classic one,
``NaiveCurriculum`` (NAIVE), ``AutoCurriculum`` (AUTO, the Exp3.S bandit
over the rounds) or ``SelfPacedCurriculum`` (SELF-PACE), with EnvDrop's
packed RL where ``TPU.PACKED_RL`` >= 2 and the trainer allows it, the
rollouts' early exit with ``TPU.SCAN_EARLY_EXIT``, and with
``TRAIN.EVAL_TRAIN`` on real data an evaluation of each CLR2R round's
train split (main.py:127-138); or, with
``--check-the-code``, runs the teacher-following sanity check on
val_unseen and exits; or, with ``--self-train`` (EnvDrop only), the
back-translation stage (main.py:78-98): a speaker of ``AIDE.SPEAKER`` in
``TPU.PRECISION``, pretrained, then EnvDrop trained on real and speaker-
generated instructions (``engine.self_train``, on CLR2R over round_5),
for TRAIN.MAX_EPOCH epochs of TRAIN.ITER_PER_EPOCH iterations; or, with
``--beam N`` (main.py:67-76), beam-search inference with speaker
rescoring over the validation splits (``engine.beam_eval``; the agent
from OUTPUT.RESUME, the speaker from AIDE.SPEAKER.RESUME).  EnvDrop
trains through the hand-written rollout BPTT with ``TPU.FUSED_BPTT``
(ops/bptt.py), and with ``TPU.USE_PALLAS False`` every mode runs the plain
route, launching none of the kernels.  ``MODEL.NAME TEST`` is refused but with
``--check-the-code``: the model-free teacher-follower has no loss, and
the JAX package's trainer fails on it in its first iteration.

Several processes train as one on the whole batch (main.py:41-55): with
``VLN_COORDINATOR`` (host:port), ``VLN_NUM_PROCESSES`` and
``VLN_PROCESS_ID`` each process joins the process group at
``tcp://VLN_COORDINATOR`` as that rank; with ``VLN_MULTIHOST=1`` at
``env://`` (torchrun's RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  The
backend follows ``parallel.mesh.init_process_group``'s rule (NCCL when
every rank owns its GPU, gloo when ranks share one or run on the CPU),
and the trainers split each batch over the mesh of ``TPU.MESH_DATA`` /
``TPU.MESH_MODEL`` (engine/trainer.py::setup_mesh).
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
from .data import datasets as DS
from .engine.auto_curriculum import AutoCurriculum
from .engine.beam_eval import run_beam_eval
from .engine.curriculum import NaiveCurriculum, SelfPacedCurriculum
from .engine.loop import configure_runtime
from .engine.self_train import self_train
from .engine.trainer import ClassicTrainer, check_the_code
from .env.host_env import R2RBatchEnv
from .parallel import mesh as M
from .utils import logging_utils
from .utils.config import get_cfg_defaults
from .world.compiler import PRECISIONS, resolve_device

AGENTS = ("ENVDROP", "FOLLOWER", "SELF-MONITOR", "TEST")


def check_ported(args, cfg) -> None:
    """Raise, before any data is loaded, on what the JAX CLI cannot run
    either: back-translation for another agent than EnvDrop (main.py:84),
    an agent ``build_agent`` does not know (agents/__init__.py:46), and
    training or beam search with the TestAgent, which has no loss_fn (the
    JAX trainer fails in its first iteration); ``--check-the-code`` runs
    it."""
    if args.self_train and cfg.MODEL.NAME != "ENVDROP":
        raise ValueError("--self-train: back-translation is an EnvDrop stage")
    if cfg.MODEL.NAME not in AGENTS:
        raise NotImplementedError(f"MODEL.NAME {cfg.MODEL.NAME!r} ({', '.join(AGENTS)})")
    if cfg.MODEL.NAME == "TEST" and not args.check_the_code:
        raise NotImplementedError("MODEL.NAME TEST: the TestAgent follows the teacher and has "
                                  "no loss_fn to train or decode with; --check-the-code runs it")


def build_trainer(cfg, train_env, logger, seed: int = 2020):
    """The trainer TRAIN.CLMODE names for CLR2R (main.py:102-124); AUTO's
    bandit draws from ``seed``."""
    mode = pipeline.curriculum_mode(cfg)
    if mode == "NAIVE":
        logger.info("Using NaiveCurriculum trainer")
        return NaiveCurriculum()
    if mode == "AUTO":
        logger.info("Using AutoCurriculum (Exp3.S) trainer")
        return AutoCurriculum.from_config(cfg, seed=seed)
    if mode == "SELF-PACE":
        logger.info("Using SelfPacedCurriculum trainer")
        return SelfPacedCurriculum.from_config(cfg, train_env)
    if cfg.TRAIN.CLMODE and cfg.DATA.NAME == "CLR2R":
        logger.warning("TRAIN.CLMODE %r is none of %s: training the classic loop on CLR2R, as the "
                       "JAX package's main does", cfg.TRAIN.CLMODE, ", ".join(pipeline.CURRICULA))
    logger.info("Using Classic trainer")
    return ClassicTrainer()


def eval_train_envs(cfg, tok, world, seed: int, device=None) -> dict:
    """TRAIN.EVAL_TRAIN's episode sources (main.py:127-138): each CLR2R
    round's train split (from DATA.DATA_DIR for CLR2R, else
    assets/CLR2Rv3) over the world's scans, batches of 2 x BATCH_SIZE,
    seeded ``seed + 100 + k``."""
    clr_dir = cfg.DATA.DATA_DIR if cfg.DATA.NAME == "CLR2R" else "assets/CLR2Rv3"
    envs = {}
    for k in range(1, DS.CLR2R_ROUNDS + 1):
        items = DS.load_datasets([DS.clr2r_split_name(k)], "CLR2R", clr_dir)
        envs[f"round_{k}"] = R2RBatchEnv(
            world, DS.expand_r2r_items(items, tok, set(world.scan_ids)),
            cfg.TRAIN.BATCH_SIZE * 2, tok, seed + 100 + k, "train", device=device)
    return envs


def init_distributed(device_arg, logger):
    """Join the process group the ``VLN_*`` variables name (main.py:41-55);
    returns this rank's device (``--device``, default CUDA)."""
    device = M.init_from_env(device_arg)
    logger.info("[0] multi-process: rank %d of %d on %s", M.world_rank(), M.world_size(),
                device)
    return device


def main(args, cfg) -> None:
    distributed = M.launched_by_env()
    device = None if distributed else resolve_device(args.device)
    check_ported(args, cfg)
    logger = logging_utils.get_main_logger(cfg.OUTPUT.LOG_DIR, cfg.MODEL.NAME)
    if distributed:
        device = init_distributed(args.device, logger)
    try:
        run(args, cfg, device, logger)
    finally:
        if M.dist.is_initialized():
            M.dist.destroy_process_group()


def log_tpu_knobs(cfg, logger) -> None:
    """One line for each TPU/XLA knob set to what would act in the JAX
    package: each has no effect here (ROADMAP, what the port does not
    copy)."""
    tpu = cfg.TPU
    if tpu.SCAN_ITERS > 1:
        logger.info("TPU.SCAN_ITERS %d is a TPU dispatch knob; it has no effect here",
                    tpu.SCAN_ITERS)
    for key, on in (("SCAN_UNROLL", tpu.SCAN_UNROLL != 1),
                    ("COMPILATION_CACHE", bool(tpu.COMPILATION_CACHE)),
                    ("PARALLEL_WARMUP", bool(tpu.PARALLEL_WARMUP))):
        if on:
            logger.info("TPU.%s %r is a TPU/XLA knob, no effect here", key, tpu[key])


def run(args, cfg, device, logger) -> None:
    log_tpu_knobs(cfg, logger)
    # the route (TPU.USE_PALLAS) and the early exit for every mode below,
    # --self-train and --beam included; the trainers set them again
    configure_runtime(cfg)
    random.seed(args.seed)
    np.random.seed(args.seed)
    pipeline.setup_vocab(cfg)
    logger.info("[1] seed %d, config %s, device %s", args.seed, args.config_file, device)

    tok = pipeline.build_tokenizer(cfg)
    logger.info("[2] tokenizer ready, vocab size %d", tok.vocab_size())
    world, train_env, valid_env, feat_dim = pipeline.build_environments(cfg, tok, seed=args.seed,
                                                                        device=device)
    logger.info("[3] world compiled (%d nodes; shortest paths: %s solver) and environments "
                "created", world.num_nodes, world.solver)

    if args.check_the_code:  # (main.py:63-65)
        logger.info("Checking the code (teacher-following agent on val_unseen)")
        check_the_code(cfg, world.device_tables(cfg.TPU.PRECISION, device), valid_env)
        return

    if args.beam > 0:  # beam search with speaker rescoring (main.py:67-76)
        agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
        run_beam_eval(cfg, agent, world, valid_env, tok, beam_size=args.beam, seed=args.seed,
                      device=device)
        logger.info("[4] Beam-search evaluation finished")
        return

    if args.self_train:
        # the speaker-augmented back-translation stage (main.py:78-98)
        agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
        speaker = Speaker(cfg.AIDE.SPEAKER, tok.vocab_size(), feat_dim=feat_dim,
                          episode_len=cfg.AGENT.MAX_EPISODE_LEN,
                          compute_dtype=PRECISIONS[cfg.TPU.PRECISION])
        aug_env = train_env["round_5"] if isinstance(train_env, dict) else train_env
        self_train(cfg, agent, speaker, aug_env, aug_env,
                   world.device_tables(cfg.TPU.PRECISION, device), seed=args.seed,
                   epochs=cfg.TRAIN.MAX_EPOCH, iters_per_epoch=cfg.TRAIN.ITER_PER_EPOCH)
        logger.info("[4] Self-training finished")
        return

    agent = build_agent(cfg, tok.vocab_size(), feat_dim, vocab=tok.vocab)
    try:
        trainer = build_trainer(cfg, train_env, logger, seed=args.seed)
        eval_env = None
        if cfg.TRAIN.EVAL_TRAIN and not cfg.TPU.SYNTHETIC_WORLD:
            eval_env = eval_train_envs(cfg, tok, world, args.seed, device)
        trainer.train(cfg, agent, cfg.OUTPUT.TSBOARD_DIR, train_env, valid_env, seed=args.seed,
                      device=device, eval_train=eval_env is not None, eval_train_env=eval_env)
    except Exception:
        s = traceback.format_exc()
        print(s)
        logger.error(s)
        sys.exit(1)
    logger.info("[4] Training finished")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="R2R navigation training, PyTorch on GPUs")
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
                        help="beam-search inference with speaker rescoring, beam size N")
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
