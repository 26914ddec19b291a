"""Classic (non-curriculum) training engine.

The port of ``curriculum_learning_for_vln_tpu/engine/trainer.py``'s
``ClassicTrainer`` (ref: tasks/R2R-judy/src/engine/trainer.py): the
per-epoch iteration loop over ``engine.loop.one_iter``, the eval cadence
on val_seen/val_unseen with argmax feedback, best-SR checkpoints per split
with superseded-file cleanup, a rotating "latest" checkpoint, scalar
logging, and ``OUTPUT.RESUME``.  Checkpoints hold the optimizer and
generator state too, and the curriculum state of a curriculum trainer.
With ``TPU.PACKED_RL`` >= 2 (the shipped EnvDrop configs set 3) each
iteration draws that many batches: IL on the first, the packed A2C
rollout over all of them (trainer.py:204-216, 279-298).

The Follower and the Self-Monitor train by ``engine.loop.agent_one_iter``
(no clip), their model state (the Self-Monitor's BN statistics) carried
through the epochs, the evaluations and the checkpoints.
``check_the_code`` is the teacher-following sanity check (trainer.py:
108-118).

The curriculum trainers (engine/curriculum.py) are this trainer with its
hooks overridden: ``select_env`` / ``iter_env`` choose the episode source,
``batch_weights`` / ``record_losses`` / ``end_epoch`` carry SPCL's
per-item weights, loss record and update, ``curriculum_state`` /
``load_curriculum_state`` its checkpoint entry.  One device, eager: no
mesh, no ``SCAN_ITERS`` and no compile warm-up.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..agents import TestAgent, init_agent
from ..convert import model_state_from_jax, params_from_jax
from ..utils.logging_utils import ScalarWriter, clean_dir, prettyprint
from ..utils.tree import tree_map
from ..world.compiler import resolve_device
from .checkpoint import load_checkpoint, restore_training_state, save_checkpoint
from .evaluator import Evaluation
from .loop import (agent_one_iter, build_eval_rollout, check_pool_valid, concat_batches,
                   make_optimizer, one_iter, packed_one_iter, run_eval)

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


def check_the_code(cfg, tables, valid_env) -> dict:
    """The sanity check (ref: trainer.py:27-39): the model-free
    teacher-follower (agents/test_agent.py) through val_unseen, scored;
    an SR near 1 shows the env, the teacher and the metrics agree."""
    agent = TestAgent(episode_len=cfg.AGENT.MAX_EPISODE_LEN)
    henv = valid_env["val_unseen"]
    results = run_eval(agent, {}, tables, henv)
    summary, _ = Evaluation(henv.world, dedup_by_path(henv.data)).score(results)
    prettyprint({"val_unseen": summary})
    return summary


def packed_factor(cfg, agent, trainer) -> int:
    """TPU.PACKED_RL where it applies (ENVDROP, sample feedback, a trainer
    that supports it), else 0 (trainer.py:204-214)."""
    packed = cfg.TPU.PACKED_RL
    if packed >= 2 and (agent.name != "ENVDROP" or cfg.AGENT.FEEDBACK != "sample"
                        or not trainer.supports_packed_rl()):
        logger.info("TPU.PACKED_RL=%d ignored (needs ENVDROP + sample feedback)", packed)
        return 0
    return packed if packed >= 2 else 0


class ClassicTrainer:
    """The classic trainer (ref: engine/__init__.py:6-17)."""

    # -- curriculum hooks (trainer.py:125-153) -----------------------------
    def select_env(self, train_env, ep: int):
        """Which episode source to use this epoch."""
        return train_env

    def iter_env(self, epoch_env, train_env):
        """Which episode source to use this iteration; the epoch's."""
        return epoch_env

    def supports_packed_rl(self) -> bool:
        """Whether TPU.PACKED_RL may replace this trainer's iteration."""
        return True

    def curriculum_state(self):
        """Curriculum state to embed in checkpoints (None = stateless)."""
        return None

    def load_curriculum_state(self, state) -> None:
        pass

    def batch_weights(self, idx: np.ndarray) -> Optional[torch.Tensor]:
        """Per-sample loss weights of the dataset items ``idx`` (None:
        the unweighted objective)."""
        return None

    def record_losses(self, idx: np.ndarray, loss_per_sample: torch.Tensor) -> None:
        """The latest per-item losses of an iteration's IL batch."""

    def end_epoch(self, ep: int, writer: ScalarWriter) -> None:
        """After the epoch's evaluation, before its latest checkpoint."""

    def train(self, cfg, agent, tsboard_dir, train_env, valid_env, seed: int = 2020,
              device=None):
        """Train for TRAIN.MAX_EPOCH epochs on ``device`` (default CUDA).
        Returns (params, best_val)."""
        device = resolve_device(device)
        first_env = self.select_env(train_env, cfg.TRAIN.START_EPOCH)
        tables = first_env.world.device_tables(cfg.TPU.PRECISION, device)
        train_cfg = cfg.TRAIN

        time_str = time.strftime("%Y-%m%d-%H:%M", time.localtime())
        writer = ScalarWriter(osp.join(tsboard_dir, time_str) if tsboard_dir else None)

        # the same parameters for a seed on any device
        params, model_state = init_agent(agent, torch.Generator().manual_seed(seed))
        generator = torch.Generator(device=device).manual_seed(seed + 1)
        start_epoch = train_cfg.START_EPOCH
        ckpt_root = cfg.OUTPUT.CKPT_DIR or "snapshots/checkpoints"
        bundle = None
        if cfg.OUTPUT.RESUME:
            ckpt_path = osp.join(ckpt_root, f"{cfg.OUTPUT.RESUME}.ckpt")
            logger.info("Resuming %s from %s", cfg.MODEL.NAME, ckpt_path)
            bundle = load_checkpoint(ckpt_path)
            params = params_from_jax(bundle["params"])
            if bundle.get("model_state"):
                model_state = model_state_from_jax(bundle["model_state"])
            if bundle.get("curriculum") is not None:
                self.load_curriculum_state(bundle["curriculum"])
        params = tree_map(lambda t: t.to(device).requires_grad_(t.is_floating_point()), params)
        model_state = tree_map(lambda t: t.to(device), model_state)
        envdrop = agent.name == "ENVDROP"
        optimizer = make_optimizer(train_cfg.OPTIM, train_cfg.LR, params)
        if bundle is not None:
            start_epoch = restore_training_state(bundle, optimizer, generator) + 1

        eval_rollout = build_eval_rollout(agent)
        il_bucket = il_bucket_fn(cfg, agent)
        packed = packed_factor(cfg, agent, self)
        pool_checked = False  # the packed pool's contract, checked once per run
        valid_evaluator = {key: Evaluation(env.world, dedup_by_path(env.data))
                           for key, env in valid_env.items()}
        best_val = {key: {"success_rate": 0.0} for key in valid_env}
        output_ckpt_dir = osp.join(ckpt_root, time_str)
        os.makedirs(output_ckpt_dir, exist_ok=True)
        logger.info("Checkpoints at %s", output_ckpt_dir)

        def save(path, ep):
            save_checkpoint(path, params, optimizer, generator, ep, cfg_yaml=cfg.dump(),
                            curriculum=self.curriculum_state(), model_state=model_state)

        start_time = last_time = time.time()
        iters = train_cfg.ITER_PER_EPOCH
        log_keys = (("loss", "entropy", "critic_loss", "total_actions") if envdrop
                    else ("loss", "progress_loss") if agent.name == "SELF-MONITOR" else ("loss",))
        if packed:
            log_keys += ("episodes_done", "episodes_started")
        for ep in range(start_epoch, train_cfg.MAX_EPOCH + 1):
            epoch_env = self.select_env(train_env, ep)
            # logs stay on the device until the epoch ends: one sync per epoch
            log_entries = []
            for _ in range(iters):
                env_i = self.iter_env(epoch_env, train_env)
                batch = env_i.next_batch()
                idx = env_i.cur_batch_index
                il_len = il_bucket(env_i)
                if packed:
                    # IL on the first batch, the packed A2C rollout over all
                    raws, pool_idx = [batch], [idx]
                    for _ in range(packed - 1):
                        raws.append(env_i.next_batch())
                        pool_idx.append(env_i.cur_batch_index)
                    pool = concat_batches(raws)
                    if not pool_checked:
                        check_pool_valid(pool)
                        pool_checked = True
                    logs = packed_one_iter(agent, optimizer, tables, params, batch, pool,
                                           generator, self.batch_weights(idx),
                                           self.batch_weights(np.concatenate(pool_idx)), il_len)
                elif envdrop:
                    logs = one_iter(agent, optimizer, cfg.AGENT.FEEDBACK, tables, params, batch,
                                    generator, weights=self.batch_weights(idx), il_len=il_len)
                else:
                    logs, model_state = agent_one_iter(
                        agent, optimizer, cfg.AGENT.FEEDBACK, tables, params, model_state, batch,
                        generator, weights=self.batch_weights(idx), il_len=il_len,
                        lamb=train_cfg.PROGMONITOR_WEIGHT)
                self.record_losses(idx, logs["loss_per_sample"])
                log_entries.append(logs)
            host = {k: torch.stack([e[k] for e in log_entries]).cpu() for k in log_keys}
            epoch_losses = [float(x) for x in host["loss"]]
            epoch_loss = sum(epoch_losses)
            avg_iter = epoch_loss / len(epoch_losses)
            writer.add_scalar("train/ml_epoch", epoch_loss, ep)
            writer.add_scalar("train/ml_iter_avg", avg_iter, ep)
            writer.add_scalar("train/ml_iter_max", max(epoch_losses), ep)
            writer.add_scalar("train/ml_iter_min", min(epoch_losses), ep)
            if "progress_loss" in host:
                writer.add_scalar("train/progress_loss", float(host["progress_loss"].sum()), ep)
            if envdrop:
                total = max(float(host["total_actions"].sum()), 1.0)
                writer.add_scalar("train/critic_loss", float(host["critic_loss"].sum()) / total,
                                  ep)
                writer.add_scalar("train/policy_entropy", float(host["entropy"].sum()) / total,
                                  ep)
                writer.add_scalar("train/total_actions", total, ep)

            cost = (time.time() - last_time) / 60
            remain = ((time.time() - start_time) / (60 * (ep + 1 - start_epoch))
                      * (train_cfg.MAX_EPOCH - ep))
            msg = (f"Epoch [{ep}/{train_cfg.MAX_EPOCH}], {cost:.2f}min/ep, remaining "
                   f"{remain:.2f}min, loss {epoch_loss:.4f} (avg {avg_iter:.4f})")
            if packed:
                done, started = (int(host[k].sum()) for k in ("episodes_done", "episodes_started"))
                writer.add_scalar("train/episodes_done", done, ep)
                writer.add_scalar("train/episodes_started", started, ep)
                msg += f", packed RL: {done} episodes done of {started} started"
            print(msg)
            logger.info(msg)

            if ep % train_cfg.EVAL_INTERVAL == 0:
                summary = {}
                for key, env in valid_env.items():
                    results = run_eval(agent, params, tables, env, eval_rollout, model_state)
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

            self.end_epoch(ep, writer)
            clean_dir(output_ckpt_dir, clean_key="latest_ep")
            save(osp.join(output_ckpt_dir, f"latest_ep{ep}.ckpt"), ep)
            save(osp.join(ckpt_root, "latest.ckpt"), ep)  # stable "latest" for OUTPUT.RESUME
            last_time = time.time()

        writer.close()
        return params, best_val
