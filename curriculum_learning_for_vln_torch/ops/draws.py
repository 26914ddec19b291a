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

In a data-parallel step (``parallel.mesh.sharded_step``) a rank holds
rows r * B / N ... of the global batch along ``batch_dim`` (None: a
draw with no batch axis, which every rank takes whole).  It draws the
global batch's noise from the one generator every rank holds, and keeps
its rows: rank r's draws are rows r * B / N ... of one process's, and
every generator ends where one process's does.  A draw site names its
batch axis: inside such a step a draw without ``batch_dim`` raises,
since a batch on another axis would silently draw the wrong noise.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch

from ..parallel import mesh as M

_log: Optional[List[tuple]] = None  # the draws of the step being recorded
UNSET = object()  # the batch_dim of a draw site that named no batch axis


def _global(shape, batch_dim):
    """The global shape of a draw whose rank holds ``shape``, and the
    rank's (dim, start, length) of it (None: the whole draw)."""
    mesh = M.step_mesh()
    if mesh is None or mesh.data == 1:
        return tuple(shape), None
    if batch_dim is UNSET:
        raise ValueError(f"a draw of shape {tuple(shape)} inside a data-parallel step names no "
                         "batch axis: pass batch_dim (None for a draw every rank takes whole)")
    if batch_dim is None:
        return tuple(shape), None
    shape = list(shape)
    n = shape[batch_dim]
    shape[batch_dim] = n * mesh.data
    return tuple(shape), (batch_dim, mesh.data_index * n, n)


def rand(shape, generator: Optional[torch.Generator], device, batch_dim=UNSET) -> torch.Tensor:
    """U[0, 1) f32 of ``shape``."""
    shape, rows = _global(shape, batch_dim)
    if _log is not None:
        _log.append((shape, generator, device, None))
    out = torch.rand(shape, generator=generator, device=device)
    return out if rows is None else out.narrow(*rows)


def randint(low: int, high: int, shape, generator: Optional[torch.Generator], device,
            dtype=torch.int64, batch_dim=UNSET) -> torch.Tensor:
    """Integers of ``dtype`` in [low, high) of ``shape``."""
    shape, rows = _global(shape, batch_dim)
    if _log is not None:
        _log.append((shape, generator, device, (low, high, dtype)))
    out = torch.randint(low, high, shape, dtype=dtype, generator=generator, device=device)
    return out if rows is None else out.narrow(*rows)


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
