"""The random draws of a rollout step, recorded so that a skipped step can
make them again.

Every dropout mask, env-dropout seed and Gumbel sample of a rollout comes
from one torch generator, in step order.  The rollout's early exit
(``TPU.SCAN_EARLY_EXIT``, agents/common.py) replaces the steps after
every episode has ended with a frozen record and runs no model there; so
that the rollouts after it (the A2C rollout after the IL one, in one
iteration) read the same draws with the flag on as with it off, a skipped
step makes the draws the last live step made, of the same shapes from the
same generator, and drops them: the generator ends where the fixed-length
loop leaves it.  The draws of a step do not depend on the data, only on
the shapes.

``rand`` and ``randint`` are ``torch.rand`` and ``torch.randint``, noted
in the open ``recording`` if there is one; ``replay`` makes a recorded
step's draws again.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch

_log: Optional[List[tuple]] = None  # the draws of the step being recorded


def rand(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) f32 of ``shape``."""
    if _log is not None:
        _log.append((tuple(shape), generator, device, None))
    return torch.rand(shape, generator=generator, device=device)


def randint(low: int, high: int, shape, generator: Optional[torch.Generator], device,
            dtype=torch.int64) -> torch.Tensor:
    """Integers of ``dtype`` in [low, high) of ``shape``."""
    if _log is not None:
        _log.append((tuple(shape), generator, device, (low, high, dtype)))
    return torch.randint(low, high, shape, dtype=dtype, generator=generator, device=device)


@contextmanager
def recording():
    """Record the draws made inside; yields their list."""
    global _log
    saved, _log = _log, []
    try:
        yield _log
    finally:
        _log = saved


def replay(log: List[tuple]) -> None:
    """Make the draws of ``log`` again, in order, and drop them."""
    for shape, generator, device, ints in log:
        if ints is None:
            torch.rand(shape, generator=generator, device=device)
        else:
            low, high, dtype = ints
            torch.randint(low, high, shape, dtype=dtype, generator=generator, device=device)
