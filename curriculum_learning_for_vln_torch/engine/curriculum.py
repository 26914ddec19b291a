"""Curriculum training engines: naive rounds and self-paced (SPCL).

The port of ``curriculum_learning_for_vln_tpu/engine/curriculum.py``
(ref: tasks/R2R-judy/src/engine/curriculum.py), both as the classic
trainer with its hooks overridden (engine/trainer.py):

* ``NaiveCurriculum`` (:45-54): round k = 1 + (epoch - 1) // switch_epoch,
  capped at round 5; each round's episode source holds the cumulative
  rounds 1..k (built by pipeline.build_environments).
* ``SelfPacedCurriculum`` (:105-350): SPCL (Jiang et al., AAAI'15) —
  training on per-sample weighted losses, and every ``INTERVAL`` epochs
  from ``BURN_IN`` on the closed-form update of the weights (pace
  function, then the projection onto the curriculum region {w : a.w <=
  c}) and of the model age lambda.  Weights, the per-item loss record and
  the solver live on the device; the record is the IL batch's ml vector *
  B of each iteration (packed iterations record their IL batch too).  The
  curriculum state is checkpointed (weights, lambda, per-item losses) in
  the JAX package's form, so an SPCL run of either package resumes in the
  port.

One device: the JAX package's mesh and ``SCAN_ITERS`` are not ported.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..world.compiler import resolve_device
from .trainer import ClassicTrainer

logger = logging.getLogger("main.curriculum")

PACE_FUNCS = ("linear", "log", "binary")


class NaiveCurriculum(ClassicTrainer):
    def __init__(self, switch_epoch: int = 20):
        self.switch_epoch = switch_epoch

    def select_env(self, train_env, ep: int):
        """(ref: curriculum.py:176-179)"""
        idx = 1 + (ep - 1) // self.switch_epoch
        key = f"round_{idx}" if idx <= 4 else "round_5"
        logger.info("NAIVE curriculum: epoch %d trains on %s (%d episodes)", ep, key,
                    train_env[key].size())
        return train_env[key]


# ---------------------------------------------------------------------------
# SPCL solver (pure tensor functions)
# ---------------------------------------------------------------------------

def spcl_update_weight(weight: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                       lamb: torch.Tensor, loss: torch.Tensor,
                       pace_func: str = "linear") -> torch.Tensor:
    """One SPCL weight update (ref: curriculum.py:428-448): the pace
    function of the latest per-item losses [N] at model age ``lamb``, then
    the projection onto {w : a.w <= c} of difficulties ``a`` [N]."""
    zeta = 1.0 - lamb
    hard = loss >= lamb
    if pace_func == "log":
        easy_w = torch.log(loss + zeta) / torch.log(zeta)
    elif pace_func == "linear":
        easy_w = 1.0 - loss / lamb
    elif pace_func == "binary":
        easy_w = torch.ones_like(loss)
    else:
        raise NotImplementedError(pace_func)
    w = torch.where(hard, 0.01, easy_w).clamp_min(0.01)
    aw = torch.dot(a, w)
    w_proj = w + a * (c - aw) / torch.dot(a, a)
    w_proj = torch.where(w_proj <= 0.0, 0.001, w_proj)
    return torch.where(aw > c, w_proj, w)


def spcl_update_lambda(lamb: torch.Tensor, stepsize: float, loss_max: torch.Tensor
                       ) -> torch.Tensor:
    """lambda += mu, or mu / 2 once lambda reaches the largest loss (ref:
    curriculum.py:406-407)."""
    return torch.where(lamb < loss_max, lamb + stepsize, lamb + stepsize / 2.0)


class SelfPacedCurriculum(ClassicTrainer):
    """SPCL trainer over a CLR2RBatchEnv."""

    def __init__(self, train_env, pace_func: str = "linear", init_lamb: float = 0.1,
                 init_weight_ctrl: float = 0.5, miu: float = 0.1, interval: int = 5,
                 strategy: str = "epoch", burn_in: int = 10, device=None):
        if strategy != "epoch":
            raise NotImplementedError("only the reference's epoch strategy is implemented")
        if pace_func not in PACE_FUNCS:
            raise NotImplementedError(pace_func)
        self.device = resolve_device(device if device is not None else train_env.device)
        self.pace_func = pace_func
        self.dim = len(train_env)
        self.a = torch.from_numpy(train_env.a).to(self.device)
        self.c = torch.tensor(train_env.c, dtype=torch.float32, device=self.device)
        self.lamb = torch.tensor(float(init_lamb), dtype=torch.float32, device=self.device)
        # init weights: WCTRL, except rounds <= 2 start at 1.0 (ref: :214-220)
        w = np.full(self.dim, init_weight_ctrl, dtype=np.float32)
        w[train_env.a <= 2] = 1.0
        self.weight = torch.from_numpy(w).to(self.device)
        self.loss_for_item = torch.zeros(self.dim, device=self.device)
        self.stepsize = miu
        self.burn_in = burn_in
        self.update_interval = interval

    @classmethod
    def from_config(cls, cfg, train_env, device=None) -> "SelfPacedCurriculum":
        sp = cfg.TRAIN.SELF_PACE
        return cls(train_env, pace_func=sp.FUNC, init_lamb=sp.LAMB, init_weight_ctrl=sp.WCTRL,
                   miu=sp.MIU, interval=sp.INTERVAL, strategy=sp.STRATEGY,
                   burn_in=sp.BURN_IN, device=device)

    def train(self, cfg, agent, tsboard_dir, train_env, valid_env, seed: int = 2020,
              device=None):
        # a run starts from an empty loss record (or the checkpoint's)
        self.loss_for_item = torch.zeros(self.dim, device=self.device)
        return super().train(cfg, agent, tsboard_dir, train_env, valid_env, seed=seed,
                             device=device)

    # -- hooks ------------------------------------------------------------
    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(self.device)

    def batch_weights(self, idx: np.ndarray) -> Optional[torch.Tensor]:
        return self.weight[self._rows(idx)]

    def record_losses(self, idx: np.ndarray, loss_per_sample: torch.Tensor) -> None:
        """Scatter the latest per-item losses (ref: curriculum.py:310-314)."""
        self.loss_for_item[self._rows(idx)] = loss_per_sample.detach().float()

    def curriculum_state(self) -> dict:
        return {"weight": self.weight.cpu().numpy(), "lamb": self.lamb.cpu().numpy(),
                "loss_for_item": self.loss_for_item.cpu().numpy()}

    def load_curriculum_state(self, state: dict) -> None:
        def dev(x):
            return torch.from_numpy(np.array(x, dtype=np.float32)).to(self.device)

        self.weight, self.lamb = dev(state["weight"]), dev(state["lamb"])
        self.loss_for_item = dev(state["loss_for_item"])

    def end_epoch(self, ep: int, writer) -> None:
        """The SPCL parameter update (ref: curriculum.py:403-415)."""
        if ep < self.burn_in or ep % self.update_interval:
            return
        self.lamb = spcl_update_lambda(self.lamb, self.stepsize, self.loss_for_item.max())
        self.weight = spcl_update_weight(self.weight, self.a, self.c, self.lamb,
                                         self.loss_for_item, pace_func=self.pace_func)
        loss_np, w_np = self.loss_for_item.cpu().numpy(), self.weight.cpu().numpy()
        q = np.percentile(loss_np, [0, 25, 50, 75, 100])
        logger.info("SPCL lambda=%s loss quantiles=%s", float(self.lamb), q.tolist())
        writer.add_histogram("sample_weight", w_np, ep)
        writer.add_histogram("sample_loss", loss_np, ep)
        a_np = self.a.cpu().numpy()
        for k in range(1, 6):
            wk = w_np[a_np == k]
            if wk.size:
                logger.info("Round[%d] weight avg %.3f min %.3f max %.3f", k, wk.mean(),
                            wk.min(), wk.max())
