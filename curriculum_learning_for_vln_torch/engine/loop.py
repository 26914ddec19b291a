"""The training iteration, the optimizers and the evaluation runner.

The port of ``curriculum_learning_for_vln_tpu/engine/loop.py``.  One
EnvDrop iteration is the reference's dual rollout — teacher-forced IL
then sampled A2C on the same minibatch, one optimizer step over the
summed loss (ref: tasks/R2R-judy/src/engine/trainer.py:411-427; JAX
loop.py:97-173) — run eagerly: two rollouts through autograd, one
backward, a clip of the encoder's and the decoder's gradients at 40, one
optimizer step.  The Follower's and the Self-Monitor's iteration
(``agent_one_iter``, loop.py:147-163) is one rollout in AGENT.FEEDBACK
and ``agent.loss_fn``, with no clip, and it returns the updated model
state (the Self-Monitor's BN statistics).  SPCL weighting enters as a
per-sample weight vector (``weights``), so one iteration serves the
classic and the curriculum trainers.  The packed iteration
(``TPU.PACKED_RL``, loop.py:277-342) runs EnvDrop's IL arm on one batch
and the A2C arm over a pool of ``factor`` batches (agents/packed.py);
weighted, its objective is dot(w_il, ml_vec) + dot(w_pool,
rl_loss_per_episode).

``ClippedAdam`` is the speaker's optimizer (a global-norm clip at 40 in
optax's form, then Adam) and, unclipped, the ViLBERT pretrainer's.
Parameters are nested dicts of leaf tensors (``utils/tree.py``).  The
scanned (``SCAN_ITERS``) iteration is a TPU dispatch device and is not
ported.  ``configure_runtime`` sets the rollout's early exit and the
route (TPU.USE_PALLAS: the kernels or none of them) from the config, as
the trainers' first step (loop.py:26-72).  ``write_results`` writes an
evaluation's trajectories as the reference's results JSON (loop.py:
466-481), which ``Evaluation.score`` reads back.

Data parallelism: given a ``mesh`` of more than one rank, an iteration
runs this rank's rows of the global batch as its part of the global
program (``parallel.mesh.sharded_step``: global draws, global
denominators, SPCL weights cut to the rank's rows), and ``_update``
sums the gradients over the ranks before the clip and the step
(``all_reduce_grads``), then sums the logged scalars and gathers the
per-sample record, so that every rank logs, clips and steps as one
process on the whole batch does (JAX's SPMD step, mesh.py:79-101).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Optional

import torch

from ..agents.common import (FEEDBACK_ARGMAX, FEEDBACK_IDS, FEEDBACK_SAMPLE, FEEDBACK_TEACHER,
                             assemble_trajectories, set_early_exit)
from ..env.env import EpisodeBatch
from ..ops import set_kernels
from ..parallel import mesh as M
from ..utils.profiling import span
from ..utils.tree import tree_leaves
from ..world.compiler import WorldTables


logger = logging.getLogger("main.loop")


def configure_runtime(cfg) -> None:
    """The runtime knobs of cfg.TPU the port reads, each set whatever its
    value, so that a second run in one process does not keep an earlier
    run's (loop.py:56-59): ``SCAN_EARLY_EXIT``, and ``USE_PALLAS``, which
    sets the LSTM and the observation backends to the kernels ("cuda") or
    to none of them ("plain": the autograd step loop and the agents'
    unfused decode).  The JAX package sets its backends only when the knob
    is True (loop.py:60-71) and leaves them otherwise; the port sets them
    in both directions.  Off, ``OBS_MASKS`` is not read, as in JAX."""
    set_early_exit(bool(cfg.TPU.SCAN_EARLY_EXIT))
    use_kernels = bool(cfg.TPU.USE_PALLAS)
    set_kernels(use_kernels)
    if not use_kernels:
        logger.info("TPU.USE_PALLAS False: the plain route, K1-K8 not launched (the encoders' "
                    "autograd step loop, the agents' unfused decode); TPU.OBS_MASKS %r is "
                    "ignored", cfg.TPU.OBS_MASKS)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` as the JAX package builds it
    (loop.py:78): nu = decay nu + (1 - decay) g^2 from nu = 0, then
    p -= lr g / sqrt(nu + eps) — eps INSIDE the square root (optax's
    eps_in_sqrt=True), where ``torch.optim.RMSprop`` adds it outside.  A
    parameter without a gradient counts as a zero gradient, as in optax."""

    def __init__(self, params, lr: float, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1.0 - group["decay"])
                p.sub_(group["lr"] * g * torch.rsqrt(nu + group["eps"]))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on ``grads`` in place: left as
    they are while their global L2 norm is below ``max_norm``, else each
    becomes t / norm * max_norm, with no epsilon (``torch.nn.utils.
    clip_grad_norm_`` adds 1e-6, and ``clip_submodule_grads`` clips a
    submodule at a time).  Returns the norm; no host synchronisation."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


class ClippedAdam(torch.optim.Adam):
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``,
    the speaker's optimizer (speaker.py:122-125): one global-norm clip over
    every leaf's gradient, then Adam with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8 outside the root); with ``max_norm=None`` no clip, which
    is ``optax.adam(lr)`` alone (the ViLBERT pretrainer's, pretrain.py:
    126).  A parameter without a gradient counts as a zero gradient, as in
    optax."""

    def __init__(self, params, lr: float, max_norm: Optional[float] = 40.0):
        super().__init__(params, lr, betas=(0.9, 0.999), eps=1e-8)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        leaves = [p for group in self.param_groups for p in group["params"]]
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in leaves], self.max_norm)
        return super().step(closure)


def make_optimizer(name: str, lr: float, params: dict) -> torch.optim.Optimizer:
    """adam / rms / sgd with torch-default hyperparameters over the leaves
    of ``params`` (ref: trainer.py:17-21; JAX loop.py:74-81).  Adam's eps
    sits outside the root in both optax and torch."""
    leaves = tree_leaves(params)
    if name == "rms":
        return RMSprop(leaves, lr, decay=0.99, eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(leaves, lr)
    return torch.optim.Adam(leaves, lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_submodule_grads(params: dict, keys, max_norm: float) -> Dict[str, torch.Tensor]:
    """Per-submodule global-norm clipping of the ``.grad`` of each leaf, the
    reference's clip_grad_norm(encoder) / clip_grad_norm(decoder) at 40
    (ref: trainer.py:425-426; the critic is NOT clipped), with the norm +
    1e-6 of loop.py:84-94.  Returns each submodule's norm before the clip."""
    norms = {}
    for key in keys:
        grads = [p.grad for p in tree_leaves(params[key]) if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        norms[key] = norm
    return norms


def iteration_loss(agent, feedback: str, tables: WorldTables, params: dict, ep,
                   generator: Optional[torch.Generator], weights: Optional[torch.Tensor] = None,
                   il_len: Optional[int] = None):
    """The objective of one EnvDrop iteration (loop.py:104-146): the
    teacher-forced IL rollout, truncated to ``il_len`` (the batch's bucketed
    episode length, trainer.py:86-105), then with sample feedback the
    sampled A2C rollout at the full horizon, on the same minibatch.
    Returns (total loss, logs)."""
    if agent.name != "ENVDROP":
        raise ValueError(f"iteration_loss is EnvDrop's; the {agent.name} iteration is "
                         "agent_iteration_loss")
    il, _ = agent.rollout(params, tables, ep, FEEDBACK_TEACHER, train=True, train_ml=True,
                          train_rl=False, episode_len=il_len, generator=generator)
    rl = None
    if FEEDBACK_IDS[feedback] == FEEDBACK_SAMPLE:
        rl, _ = agent.rollout(params, tables, ep, FEEDBACK_SAMPLE, train=True, train_ml=False,
                              train_rl=True, generator=generator)
    with span("rollout.loss"):
        ml_vec = il.ml_loss_per_sample
        rl_vec = rl.rl_loss_per_sample if rl is not None else torch.zeros_like(ml_vec)
        if weights is None:
            total = il.ml_loss + (rl.rl_loss if rl is not None else 0.0)
        else:
            total = torch.dot(weights, ml_vec + rl_vec)  # (ref: curriculum.py:294-296)
        zero = total.new_zeros(())
        logs = {
            "loss": total,
            "ml_loss": il.ml_loss,
            "rl_loss": rl.rl_loss if rl is not None else zero,
            # SPCL per-item record: ml vector * B (ref: curriculum.py:313)
            "loss_per_sample": ml_vec * M.global_rows(ml_vec.shape[0]),
            "entropy": rl.entropy_sum if rl is not None else il.entropy_sum,
            "critic_loss": rl.critic_loss_sum if rl is not None else zero,
            "total_actions": rl.total_actions if rl is not None else il.total_actions,
        }
    return total, logs


def packed_iteration_loss(agent, tables: WorldTables, params: dict, ep: EpisodeBatch,
                          pool: EpisodeBatch, generator: Optional[torch.Generator],
                          w_il: Optional[torch.Tensor] = None,
                          w_pool: Optional[torch.Tensor] = None, il_len: Optional[int] = None):
    """The objective of one packed iteration (loop.py:300-331): the
    teacher-forced IL rollout on ``ep`` as in ``iteration_loss``, and the
    packed A2C rollout over ``pool`` (every episode valid, ``ep`` its
    first B) with B slots.  With SPCL weights for the IL batch ``w_il``
    [B] and for the pool ``w_pool`` [N] the total is dot(w_il, ml_vec) +
    dot(w_pool, rl_loss_per_episode); all-ones weights give the unweighted
    total.  Returns (total loss, logs)."""
    if agent.name != "ENVDROP":
        raise NotImplementedError("packed RL is implemented for ENVDROP")
    B = ep.instr_tokens.shape[0]
    il, _ = agent.rollout(params, tables, ep, FEEDBACK_TEACHER, train=True, train_ml=True,
                          train_rl=False, episode_len=il_len, generator=generator)
    rl, _ = agent.rollout_packed(params, tables, pool, batch_size=B, generator=generator)
    with span("rollout.loss"):
        ml_vec = il.ml_loss_per_sample
        if w_il is None:
            total = il.ml_loss + rl.rl_loss
        else:
            total = torch.dot(w_il, ml_vec) + torch.dot(w_pool, rl.rl_loss_per_episode)
        logs = {
            "loss": total,
            "ml_loss": il.ml_loss,
            "rl_loss": rl.rl_loss,
            # SPCL per-item record for the IL batch (ref: curriculum.py:313)
            "loss_per_sample": ml_vec * M.global_rows(ml_vec.shape[0]),
            "entropy": rl.entropy_sum,
            "critic_loss": rl.critic_loss_sum,
            "total_actions": rl.total_actions,
            "episodes_done": rl.episodes_done,
            "episodes_started": rl.episodes_started,
        }
    return total, logs


# an iteration's logs, by how the ranks' values make the global one: scalars
# that are sums of the ranks' parts, scalars every rank holds whole (the
# packed rollout's episode counts), and per-row vectors (gathered in rank order)
SUMMED_LOGS = ("loss", "ml_loss", "rl_loss", "entropy", "critic_loss", "total_actions",
               "progress_loss")
GLOBAL_LOGS = ("episodes_done", "episodes_started")
ROW_LOGS = ("loss_per_sample",)


def reduce_logs(logs: dict, mesh: Optional[M.Mesh]) -> dict:
    """The global logs of a data-parallel iteration: the summed scalars
    summed over the ranks (one all-reduce), ``loss_per_sample`` gathered
    in rank order; as they are without a process group.  A key of none of
    the three kinds raises, with or without a process group."""
    unknown = set(logs).difference(SUMMED_LOGS, GLOBAL_LOGS, ROW_LOGS)
    if unknown:
        raise KeyError(f"reduce_logs: the logs {sorted(unknown)} are of no known kind "
                       "(engine/loop.py: SUMMED_LOGS, GLOBAL_LOGS or ROW_LOGS)")
    if mesh is None or not mesh.distributed:
        return logs
    with M.sharded_step(mesh):
        keys = [k for k in SUMMED_LOGS if k in logs]
        sums = M.global_sum(torch.stack([logs[k].float() for k in keys]))
        out = dict(logs, **{k: v.to(logs[k].dtype) for k, v in zip(keys, sums.unbind())})
        if "loss_per_sample" in logs:
            out["loss_per_sample"] = M.gather_rows(logs["loss_per_sample"])
    return out


def _update(optimizer: torch.optim.Optimizer, params: dict, total: torch.Tensor,
            logs: dict, clip: bool = True, mesh: Optional[M.Mesh] = None) -> dict:
    """Gradients of ``total`` (summed over the ranks of ``mesh``), with
    ``clip`` the clip at 40 of the encoder's and the decoder's (EnvDrop's
    alone, loop.py:146), one optimizer step on ``params`` (in place); the
    detached global logs."""
    with span("update.backward"):
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        M.all_reduce_grads(params, mesh)
    if clip:
        with span("update.clip"):
            clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
    with span("update.optim"):
        optimizer.step()
    return reduce_logs({k: v.detach() for k, v in logs.items()}, mesh)


def agent_iteration_loss(agent, feedback: str, tables: WorldTables, params: dict,
                         model_state: dict, ep: EpisodeBatch,
                         generator: Optional[torch.Generator],
                         weights: Optional[torch.Tensor] = None, il_len: Optional[int] = None,
                         lamb: float = 0.5):
    """The objective of one Follower or Self-Monitor iteration (loop.py:
    147-163): one rollout in ``feedback`` at train=True, truncated to
    ``il_len`` only when teacher-forced, ``agent.loss_fn`` (SPCL-weighted
    with ``weights``), ``lamb`` = TRAIN.PROGMONITOR_WEIGHT for the
    Self-Monitor.  Returns (total, logs, new model state); the logs' per-
    sample record is ``ml_loss_per_sample`` unscaled (EnvDrop's is scaled
    by B)."""
    fb = FEEDBACK_IDS[feedback]
    kwargs = {"lamb": lamb} if agent.name == "SELF-MONITOR" else {}
    losses, _, model_state = agent.rollout(
        params, tables, ep, fb, train=True, generator=generator, model_state=model_state,
        episode_len=il_len if fb == FEEDBACK_TEACHER else None, **kwargs)
    with span("rollout.loss"):
        total = agent.loss_fn(losses, weights)
    logs = {"loss": total, "ml_loss": losses.ml_loss,
            "loss_per_sample": losses.ml_loss_per_sample}
    if agent.name == "SELF-MONITOR":
        logs["progress_loss"] = losses.progress_loss
    return total, logs, model_state


def agent_one_iter(agent, optimizer: torch.optim.Optimizer, feedback: str, tables: WorldTables,
                   params: dict, model_state: dict, ep: EpisodeBatch,
                   generator: Optional[torch.Generator], weights: Optional[torch.Tensor] = None,
                   il_len: Optional[int] = None, lamb: float = 0.5,
                   mesh: Optional[M.Mesh] = None):
    """One Follower or Self-Monitor iteration: ``agent_iteration_loss`` and
    one unclipped update of ``params``; with a ``mesh``, ``ep`` is this
    rank's rows and ``weights`` the global batch's.  Returns (the detached
    logs, the new model state)."""
    with span("iter"):
        with M.sharded_step(mesh):
            total, logs, model_state = agent_iteration_loss(
                agent, feedback, tables, params, model_state, ep, generator,
                M.local_rows(weights), il_len, lamb)
        return _update(optimizer, params, total, logs, clip=False, mesh=mesh), model_state


def one_iter(agent, optimizer: torch.optim.Optimizer, feedback: str, tables: WorldTables,
             params: dict, ep, generator: Optional[torch.Generator],
             weights: Optional[torch.Tensor] = None, il_len: Optional[int] = None,
             mesh: Optional[M.Mesh] = None) -> dict:
    """One training iteration: ``iteration_loss`` and one update of
    ``params``; with a ``mesh``, ``ep`` is this rank's rows and ``weights``
    the global batch's.  Returns the detached logs."""
    with span("iter"):
        with M.sharded_step(mesh):
            total, logs = iteration_loss(agent, feedback, tables, params, ep, generator,
                                         M.local_rows(weights), il_len)
        return _update(optimizer, params, total, logs, mesh=mesh)


def packed_one_iter(agent, optimizer: torch.optim.Optimizer, tables: WorldTables, params: dict,
                    ep: EpisodeBatch, pool: EpisodeBatch, generator: Optional[torch.Generator],
                    w_il: Optional[torch.Tensor] = None, w_pool: Optional[torch.Tensor] = None,
                    il_len: Optional[int] = None, mesh: Optional[M.Mesh] = None) -> dict:
    """One packed iteration: ``packed_iteration_loss`` and one update of
    ``params``; with a ``mesh``, ``ep`` and ``w_il`` are this rank's rows
    of the global IL batch and its weights, ``pool`` and ``w_pool`` the
    global pool's.  Returns the detached logs, ``episodes_done`` and
    ``episodes_started`` among them."""
    with span("iter"):
        with M.sharded_step(mesh):
            total, logs = packed_iteration_loss(agent, tables, params, ep, pool, generator,
                                                M.local_rows(w_il), w_pool, il_len)
        return _update(optimizer, params, total, logs, mesh=mesh)


def concat_batches(batches) -> EpisodeBatch:
    """Concatenate EpisodeBatches along the batch axis: the episode pool of
    a packed rollout."""
    return EpisodeBatch(*(torch.cat(fields, dim=0) for fields in zip(*batches)))


def check_pool_valid(pool: EpisodeBatch) -> None:
    """Raise unless every episode of a packed pool is valid: the packed
    rollout refills ended slots assuming each pool entry is a real episode,
    and a padding entry would be refilled born-ended, wasting a slot-step
    and inflating episodes_started (loop.py:260-274).  One device fetch:
    call it once per run, never per iteration."""
    if not bool(pool.valid.all()):
        raise ValueError("packed RL pool contains invalid (padding) episodes; "
                         "TPU.PACKED_RL requires a full-valid wraparound train iterator")


def build_eval_rollout(agent) -> Callable:
    """Argmax eval rollout without autograd (the encoder runs K3):
    (tables, params, ep, generator, model_state) -> RolloutResult."""

    @torch.no_grad()
    def roll(tables, params, ep, generator=None, model_state=None):
        return agent.rollout(params, tables, ep, FEEDBACK_ARGMAX, train=False,
                             generator=generator, model_state=model_state)[1]

    return roll


def write_results(results, results_dir: str, split: str = "train") -> str:
    """Write ``results`` ({"instr_id", "trajectory": [(viewpoint, heading,
    elevation), ...]} each) as ``<results_dir>/<split>.json``, the JSON the
    JAX package writes byte for byte (ref: base.py:32-37; the submission
    format of evaluator.py:12-18).  Returns the path."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"{split}.json")
    serializable = [
        {"instr_id": r["instr_id"],
         "trajectory": [[v, float(h), float(e)] for v, h, e in r["trajectory"]]}
        for r in results
    ]
    with open(path, "w") as f:
        json.dump(serializable, f)
    return path


def run_eval(agent, params: dict, tables: WorldTables, henv,
             eval_rollout: Optional[Callable] = None, model_state: Optional[dict] = None) -> list:
    """Full-split evaluation with exact coverage (replaces the reference's
    loop-until-instr_id-repeats, base.py:63-82)."""
    if eval_rollout is None:
        eval_rollout = build_eval_rollout(agent)
    results = []
    for ep in henv.eval_batches():
        result = eval_rollout(tables, params, ep, model_state=model_state)
        results += assemble_trajectories(henv.world, ep, result, henv.data)
    return results
