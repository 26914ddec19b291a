"""Classic (non-curriculum) training engine.

The port of ``curriculum_learning_for_vln_tpu/engine/trainer.py``'s
``ClassicTrainer`` (ref: tasks/R2R-judy/src/engine/trainer.py): the
per-epoch iteration loop over ``engine.loop.one_iter``, the eval cadence
on val_seen/val_unseen with argmax feedback, best-SR checkpoints per split
with superseded-file cleanup, a rotating "latest" checkpoint, scalar
logging, and ``OUTPUT.RESUME``.  Checkpoints hold the optimizer and
generator state too.  One device, eager: no mesh, no ``SCAN_ITERS``, no
packed-RL branch and no compile warm-up.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time
from typing import Optional

import torch

from ..convert import params_from_jax
from ..utils.logging_utils import ScalarWriter, clean_dir, prettyprint
from ..utils.tree import tree_map
from ..world.compiler import resolve_device
from .checkpoint import load_checkpoint, restore_training_state, save_checkpoint
from .evaluator import Evaluation
from .loop import build_eval_rollout, make_optimizer, one_iter, run_eval

logger = logging.getLogger("main.train")

METRIC_KEYS = ("lengths", "steps", "nav_error", "oracle_error", "success_rate", "oracle_rate",
               "spl", "ndtw", "sdtw")


def dedup_by_path(items):
    seen, out = set(), []
    for it in items:
        if it["path_id"] not in seen:
            seen.add(it["path_id"])
            out.append(it)
    return out


def il_bucket_fn(cfg, agent):
    """Episode-length bucketing for teacher-forced rollouts
    (trainer.py:86-105): a callable env -> IL rollout length (None = full).
    A teacher-forced episode needs the batch's max hops + 1 steps (the
    STOP step); the length is the smallest bucket of ``TPU.IL_BUCKETS``
    that holds them, else the full horizon."""
    buckets = tuple(cfg.TPU.IL_BUCKETS or ())
    applies = cfg.AGENT.FEEDBACK == "teacher" or agent.name == "ENVDROP"
    if not buckets or not applies:
        return lambda env: None
    full = agent.episode_len

    def bucket(env) -> Optional[int]:
        need = env.cur_batch_max_hops + 1
        for b in sorted(buckets):
            if need <= b < full:
                return b
        return None

    return bucket


class ClassicTrainer:
    """The classic trainer (ref: engine/__init__.py:6-17)."""

    def train(self, cfg, agent, tsboard_dir, train_env, valid_env, seed: int = 2020,
              device=None):
        """Train for TRAIN.MAX_EPOCH epochs on ``device`` (default CUDA).
        Returns (params, best_val)."""
        device = resolve_device(device)
        tables = train_env.world.device_tables(cfg.TPU.PRECISION, device)
        train_cfg = cfg.TRAIN

        time_str = time.strftime("%Y-%m%d-%H:%M", time.localtime())
        writer = ScalarWriter(osp.join(tsboard_dir, time_str) if tsboard_dir else None)

        # the same parameters for a seed on any device
        params = agent.init(torch.Generator().manual_seed(seed))
        generator = torch.Generator(device=device).manual_seed(seed + 1)
        start_epoch = train_cfg.START_EPOCH
        ckpt_root = cfg.OUTPUT.CKPT_DIR or "snapshots/checkpoints"
        bundle = None
        if cfg.OUTPUT.RESUME:
            ckpt_path = osp.join(ckpt_root, f"{cfg.OUTPUT.RESUME}.ckpt")
            logger.info("Resuming %s from %s", cfg.MODEL.NAME, ckpt_path)
            bundle = load_checkpoint(ckpt_path)
            params = params_from_jax(bundle["params"])
        params = tree_map(lambda t: t.to(device).requires_grad_(t.is_floating_point()), params)
        optimizer = make_optimizer(train_cfg.OPTIM, train_cfg.LR, params)
        if bundle is not None:
            start_epoch = restore_training_state(bundle, optimizer, generator) + 1

        eval_rollout = build_eval_rollout(agent)
        il_bucket = il_bucket_fn(cfg, agent)
        valid_evaluator = {key: Evaluation(env.world, dedup_by_path(env.data))
                           for key, env in valid_env.items()}
        best_val = {key: {"success_rate": 0.0} for key in valid_env}
        output_ckpt_dir = osp.join(ckpt_root, time_str)
        os.makedirs(output_ckpt_dir, exist_ok=True)
        logger.info("Checkpoints at %s", output_ckpt_dir)

        def save(path, ep):
            save_checkpoint(path, params, optimizer, generator, ep, cfg_yaml=cfg.dump())

        start_time = last_time = time.time()
        iters = train_cfg.ITER_PER_EPOCH
        for ep in range(start_epoch, train_cfg.MAX_EPOCH + 1):
            # logs stay on the device until the epoch ends: one sync per epoch
            log_entries = []
            for _ in range(iters):
                batch = train_env.next_batch()
                log_entries.append(one_iter(agent, optimizer, cfg.AGENT.FEEDBACK, tables, params,
                                            batch, generator, il_len=il_bucket(train_env)))
            host = {k: torch.stack([e[k] for e in log_entries]).cpu()
                    for k in ("loss", "entropy", "critic_loss", "total_actions")}
            epoch_losses = [float(x) for x in host["loss"]]
            epoch_loss = sum(epoch_losses)
            avg_iter = epoch_loss / len(epoch_losses)
            writer.add_scalar("train/ml_epoch", epoch_loss, ep)
            writer.add_scalar("train/ml_iter_avg", avg_iter, ep)
            writer.add_scalar("train/ml_iter_max", max(epoch_losses), ep)
            writer.add_scalar("train/ml_iter_min", min(epoch_losses), ep)
            total = max(float(host["total_actions"].sum()), 1.0)
            writer.add_scalar("train/critic_loss", float(host["critic_loss"].sum()) / total, ep)
            writer.add_scalar("train/policy_entropy", float(host["entropy"].sum()) / total, ep)
            writer.add_scalar("train/total_actions", total, ep)

            cost = (time.time() - last_time) / 60
            remain = ((time.time() - start_time) / (60 * (ep + 1 - start_epoch))
                      * (train_cfg.MAX_EPOCH - ep))
            msg = (f"Epoch [{ep}/{train_cfg.MAX_EPOCH}], {cost:.2f}min/ep, remaining "
                   f"{remain:.2f}min, loss {epoch_loss:.4f} (avg {avg_iter:.4f})")
            print(msg)
            logger.info(msg)

            if ep % train_cfg.EVAL_INTERVAL == 0:
                summary = {}
                for key, env in valid_env.items():
                    results = run_eval(agent, params, tables, env, eval_rollout)
                    scores, _ = valid_evaluator[key].score(results)
                    summary[key] = scores
                    for mk in METRIC_KEYS:
                        writer.add_scalar(f"{key}/{mk}", scores[mk], ep)
                    if scores["success_rate"] > best_val[key]["success_rate"]:
                        best_val[key] = dict(scores)
                        clean_dir(output_ckpt_dir, clean_key=f"best_{key}")
                        path = osp.join(output_ckpt_dir,
                                        f"best_{key}_SR:{scores['success_rate']:.4f}.ckpt")
                        save(path, ep)
                        logger.info("Saved best %s SR=%.4f -> %s", key, scores["success_rate"],
                                    path)
                prettyprint(summary)

            clean_dir(output_ckpt_dir, clean_key="latest_ep")
            save(osp.join(output_ckpt_dir, f"latest_ep{ep}.ckpt"), ep)
            save(osp.join(ckpt_root, "latest.ckpt"), ep)  # stable "latest" for OUTPUT.RESUME
            last_time = time.time()

        writer.close()
        return params, best_val
