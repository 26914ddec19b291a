"""End-to-end data pipeline assembly: config -> world, tokenizer, envs.

The port of ``curriculum_learning_for_vln_tpu/pipeline.py`` for
``DATA.NAME`` R2R and CLR2R (ref: tasks/R2R-judy/main.py:15-87): vocab
bootstrap, tokenizer, world compilation and the train / val_seen /
val_unseen episode sources — for CLR2R under ``TRAIN.CLMODE`` NAIVE the
five cumulative round envs ``round_1..round_5`` (each an ``R2RBatchEnv``
seeded ``seed + k``), under SELF-PACE one ``CLR2RBatchEnv`` — from two
world sources:

* real: connectivity JSONs (``DATA.CONNECTIVITY_DIR``) + the ResNet
  feature TSV (``DATA.IMG_FEAT_DIR``), with the on-disk compiled-world
  cache (``DATA.WORLD_CACHE``);
* synthetic (``TPU.SYNTHETIC_WORLD``): generated scans, episodes and
  features, so the whole stack runs with no external assets.

The same seeds give the JAX package's worlds, splits and batch orders.
The RxR, R4R and Mixed branches and the AUTO curriculum are not ported
yet and raise.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

from .data import datasets as DS
from .data import features as FT
from .env.host_env import CLR2RBatchEnv, R2RBatchEnv
from .utils.tokenizer import Tokenizer, build_vocab, read_vocab, write_vocab
from .world import compiler as WC
from .world import synthetic as SYN
from .world.graph import load_nav_graphs

logger = logging.getLogger("main.pipeline")


def r2r_dir(cfg) -> str:
    """Where the R2R JSONs lie: DATA.DATA_DIR, or for CLR2R (whose DATA_DIR
    holds the round splits) the directory above it (pipeline.py:197-204)."""
    if cfg.DATA.NAME == "CLR2R":
        return os.path.dirname(cfg.DATA.DATA_DIR.rstrip("/")) or "assets"
    return cfg.DATA.DATA_DIR


def setup_vocab(cfg) -> None:
    """Bootstrap vocab files if missing (ref: main.py:15-30)."""
    if cfg.DATA.TRAIN_VOCAB and not os.path.exists(cfg.DATA.TRAIN_VOCAB):
        data = DS.load_datasets(["train"], dataset="R2R", data_dir=r2r_dir(cfg))
        write_vocab(build_vocab(data), cfg.DATA.TRAIN_VOCAB)
    if cfg.DATA.TRAINVAL_VOCAB and not os.path.exists(cfg.DATA.TRAINVAL_VOCAB):
        data = DS.load_datasets(["train", "val_seen", "val_unseen"], dataset="R2R",
                                data_dir=r2r_dir(cfg))
        write_vocab(build_vocab(data), cfg.DATA.TRAINVAL_VOCAB)


def build_tokenizer(cfg) -> Tokenizer:
    return Tokenizer(read_vocab(cfg.DATA.TRAIN_VOCAB), cfg.DATA.MAX_ENC_LEN)


def build_synthetic_universe(cfg, seed: int = 0):
    """Synthetic world + R2R-style splits (train/val_seen/val_unseen) and
    5 CLR2R rounds over it (pipeline.py:49-100).  With
    TPU.SYNTHETIC_GROUNDED (default) the world is the learnable grounded
    variant: view features encode the room type reachable through the
    view, and instructions describe the path's room sequence."""
    graphs = SYN.make_world_graphs(cfg.TPU.SYNTHETIC_SCANS, cfg.TPU.SYNTHETIC_NODES, seed=seed)
    scans = sorted(graphs)
    n_train_scans = max(1, int(0.75 * len(scans)))
    train_scans, unseen_scans = scans[:n_train_scans], scans[n_train_scans:] or scans[:1]

    feat_dim = 128 if cfg.TPU.SYNTHETIC_NODES <= 128 else 2048
    world = WC.compile_world(graphs, max_candidates=cfg.TPU.MAX_CANDIDATES)
    if cfg.TPU.SYNTHETIC_GROUNDED:
        rooms = SYN.assign_rooms(world, seed=seed)
        SYN.attach_grounded_features(world, rooms, feature_dim=feat_dim, seed=seed)

        def make(**kw):
            return SYN.make_grounded_dataset(graphs, world, rooms, **kw)
    else:
        WC.attach_synthetic_features(world, feature_dim=feat_dim)

        def make(**kw):
            return SYN.make_r2r_dataset(graphs, **kw)

    n_train = cfg.TPU.SYNTHETIC_TRAIN_PATHS
    n_val = cfg.TPU.SYNTHETIC_VAL_PATHS
    het = float(cfg.TPU.SYNTHETIC_HETEROGENEITY) if cfg.TPU.SYNTHETIC_GROUNDED else 0.0

    def mk_train(**kw):
        return make(heterogeneity=het, **kw) if het > 0 else make(**kw)

    splits = {
        "train": mk_train(num_paths=n_train, seed=seed + 1, path_id_base=0, scans=train_scans),
        "val_seen": make(num_paths=n_val, seed=seed + 2, path_id_base=10_000, scans=train_scans),
        "val_unseen": make(num_paths=n_val, seed=seed + 3, path_id_base=20_000,
                           scans=unseen_scans),
    }
    # curriculum rounds: partition train by path length (difficulty proxy)
    train_sorted = sorted(splits["train"], key=lambda it: it["distance"])
    rounds_raw: Dict[str, List[dict]] = {}
    per = max(1, len(train_sorted) // 5)
    for k in range(1, 6):
        lo = (k - 1) * per
        hi = k * per if k < 5 else len(train_sorted)
        rounds_raw[f"round_{k}"] = train_sorted[lo:hi]
    return world, splits, rounds_raw, feat_dim


def build_real_world(cfg, scans) -> Tuple[WC.CompiledWorld, int]:
    cache = cfg.DATA.WORLD_CACHE
    feats = FT.read_feature_tsv(cfg.DATA.IMG_FEAT_DIR)
    feat_dim = next(iter(feats.values())).shape[-1]
    allowed = FT.featurized_scans(feats)
    scans = [s for s in scans if s in allowed]
    if cache and os.path.exists(os.path.join(cache, "world.npz")):
        world = WC.CompiledWorld.load(os.path.join(cache, "world.npz"))
    else:
        graphs = load_nav_graphs(scans, cfg.DATA.CONNECTIVITY_DIR)
        world = WC.compile_world(graphs, max_candidates=cfg.TPU.MAX_CANDIDATES)
        if cache:
            world.save(os.path.join(cache, "world.npz"))
    WC.attach_features(world, FT.feature_fn_from_dict(feats), feature_dim=feat_dim)
    return world, feat_dim


def curriculum_mode(cfg) -> str:
    """TRAIN.CLMODE where it applies (DATA.NAME CLR2R), else "" (classic);
    raises on a mode the port does not run."""
    mode = cfg.TRAIN.CLMODE if cfg.DATA.NAME == "CLR2R" else ""
    if mode == "AUTO":
        raise NotImplementedError("the AUTO (Exp3.S) curriculum trainer is not ported yet")
    if mode not in ("", "NAIVE", "SELF-PACE"):
        raise ValueError(f"unknown TRAIN.CLMODE {mode!r}")
    return mode


def build_environments(cfg, tok: Tokenizer, seed: int = 2020, device=None):
    """World + train/valid envs per cfg (ref: main.py:55-87).  Returns
    (world, train_env, valid_env, feat_dim) where train_env is an
    R2RBatchEnv, a dict of cumulative round envs (NAIVE) or a
    CLR2RBatchEnv (SELF-PACE); the envs' batches live on ``device``
    (default CUDA)."""
    if cfg.DATA.NAME not in ("R2R", "CLR2R"):
        raise NotImplementedError(f"DATA.NAME {cfg.DATA.NAME!r} is not ported yet "
                                  "(R2R and CLR2R only)")
    mode = curriculum_mode(cfg)
    bs = cfg.TRAIN.BATCH_SIZE
    tm = cfg.AGENT.TEACHER

    def env(world, items, s, name):
        return R2RBatchEnv(world, items, bs, tok, s, name, teacher_mode=tm, device=device)

    if cfg.TPU.SYNTHETIC_WORLD:
        world, splits, rounds_raw, feat_dim = build_synthetic_universe(cfg, seed=seed)

        def expand(items):
            return DS.expand_r2r_items(items, tok, None)

        train_items = splits["train"]
        val_seen_items, val_unseen_items = splits["val_seen"], splits["val_unseen"]

        def round_items(k):  # the raw items of round k
            return rounds_raw[f"round_{k}"]
    else:
        train_items = DS.load_datasets(["train"], "R2R", r2r_dir(cfg))
        base_dir = "assets" if cfg.DATA.NAME == "CLR2R" else cfg.DATA.DATA_DIR
        val_seen_items = DS.load_datasets(["val_seen"], "R2R", base_dir)
        val_unseen_items = DS.load_datasets(["val_unseen"], "R2R", base_dir)
        all_scans = sorted({it["scan"] for it in train_items + val_seen_items + val_unseen_items})
        world, feat_dim = build_real_world(cfg, all_scans)
        allowed = set(world.scan_ids)

        def expand(items):
            return DS.expand_r2r_items(items, tok, allowed)

        def round_items(k):
            return DS.load_datasets([DS.clr2r_split_name(k)], "CLR2R", cfg.DATA.DATA_DIR)

    valid_env = {
        "val_seen": env(world, expand(val_seen_items), seed + 11, "val_seen"),
        "val_unseen": env(world, expand(val_unseen_items), seed + 12, "val_unseen"),
    }
    if mode == "NAIVE":
        # cumulative rounds: round_k holds rounds 1..k (ref: main.py:66-69)
        train_env, acc = {}, []
        for k in range(1, DS.CLR2R_ROUNDS + 1):
            acc = acc + round_items(k)
            train_env[f"round_{k}"] = env(world, expand(acc), seed + k, "train")
    elif mode == "SELF-PACE":
        rounds = {f"round_{k}": expand(round_items(k)) for k in range(1, DS.CLR2R_ROUNDS + 1)}
        train_env = CLR2RBatchEnv(world, rounds, bs, cfg.TRAIN.SELF_PACE.CRATE, tok, seed,
                                  teacher_mode=tm, device=device)
    else:
        train_env = env(world, expand(train_items), seed, "train")
    return world, train_env, valid_env, feat_dim
