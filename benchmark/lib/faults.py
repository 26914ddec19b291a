"""Faults planted in the program under test, to show that the checks catch
them: each a context manager that patches the port in this process.

Training (EnvDrop SPCL):

* ``unchanged``: the optimizer step leaves the parameters as they are;
* ``half_batch``: half of the IL batch and of the pool left out of the
  loss, the other half weighted double (the mean over the rest);
* ``token``: the sampled action of every eighth slot replaced, where it is
  made, by the first candidate.

Serving (argmax rollouts):

* ``token``: every eighth request's action replaced by the first
  candidate where it is chosen;
* ``unchanged``: the environment step returns the state it was given.

One process has one card, so no exchange between cards exists to leave
out.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

TRAIN = ("unchanged", "half_batch", "token")
SERVE = ("token", "unchanged")


@contextmanager
def patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def every_eighth(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) % 8 == 0


@contextmanager
def planted(kind: str, fault: str):
    """Plant ``fault`` of a ``kind`` ("train" or "serve") cell."""
    from curriculum_learning_for_vln_torch.agents import common
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.env import env

    if kind == "train" and fault == "unchanged":
        with patched(loop.RMSprop, "step", lambda self, closure=None: None):
            yield
    elif kind == "train" and fault == "half_batch":
        inner = loop.packed_iteration_loss

        def half(agent, tables, params, ep, pool, generator, w_il=None, w_pool=None, il_len=None):
            def keep(w):
                return torch.where(torch.arange(w.shape[0], device=w.device) < w.shape[0] // 2,
                                   2.0 * w, torch.zeros_like(w))

            return inner(agent, tables, params, ep, pool, generator, keep(w_il), keep(w_pool),
                         il_len)

        with patched(loop, "packed_iteration_loss", half):
            yield
    elif kind == "train" and fault == "token":
        inner = common.gumbel_noise

        def noise(shape, generator, device):
            g = inner(shape, generator, device)
            bonus = torch.zeros_like(g)
            bonus[every_eighth(shape[0], device), 0] = 1e4
            return g + bonus

        with patched(common, "gumbel_noise", noise):
            yield
    elif kind == "serve" and fault == "token":
        inner = common.select_action

        def select(feedback, masked, teacher, generator=None):
            action, logp, ent = inner(feedback, masked, teacher, generator)
            action = torch.where(every_eighth(action.shape[0], action.device), 0, action)
            return action, logp, ent

        with patched(common, "select_action", select):
            yield
    elif kind == "serve" and fault == "unchanged":
        with patched(env, "step", lambda world, state, action: state):
            yield
    else:
        raise ValueError(f"no fault {fault!r} for a {kind} cell")
