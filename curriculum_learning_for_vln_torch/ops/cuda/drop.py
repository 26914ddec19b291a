"""Env-dropout mask modes of the observation kernels (K4-K7).

A ``DropSpec`` says how a kernel drops the image rows it reads:

* ``"none"`` — not at all (train=False, or a zero rate);
* ``"ext"``  — by a keep-mask the caller passes, bool [B, rows, D];
* ``"prng"`` — by the Philox4x32-10 draw of a per-sample int64 seed [B]
  (ops/philox.py), which the kernel makes itself and the backward makes
  again: no mask ever lies in device memory;
* ``"prng_shared"`` — as prng, but the rows of each group of 8
  consecutive rows share one mask, the draw of the group's first seed
  (``philox.group_seeds``; the JAX package's ``pallas_prng_shared``).

A kept element becomes ``round_to_table_dtype(x / keep)``, a dropped one
0, before the f32 accumulation (pano_fused.py:54-59, cand_score.py:52-57).
There ``x / keep`` divides a row of the table dtype by a Python float, so
JAX rounds keep to the table dtype first: a bf16 row is divided by
bf16(0.7) = 0.69921875, not by f32(0.7).  ``divisor`` is that value, and
the kernels and the plain versions divide by it; the keep test of the
prng modes uses the probability itself.  ``dropped`` is the drop in plain
torch, for the kernels' plain versions; ``c_args`` is what the CUDA entry
points take.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import philox
from .build import acc_dtype

MODE_CODES = {"none": 0, "ext": 1, "prng": 2, "prng_shared": 3}


class DropSpec(NamedTuple):
    mode: str = "none"
    mask: Optional[torch.Tensor] = None    # bool [B, rows, D] (ext)
    seeds: Optional[torch.Tensor] = None   # int64 [B] (prng, prng_shared)
    keep: float = 1.0


NO_DROP = DropSpec()


def draw_keep_mask(shape, keep: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """A fresh ext keep-mask of ``shape``: each element kept with
    probability ``keep``, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def keep_mask(drop: DropSpec, shape) -> Optional[torch.Tensor]:
    """The keep-mask [B, *shape] of ``drop`` (None in mode "none")."""
    if drop.mode == "none":
        return None
    if drop.mode == "ext":
        return drop.mask
    if drop.mode == "prng":
        return philox.keep_mask(drop.seeds, shape, drop.keep)
    if drop.mode == "prng_shared":
        return philox.keep_mask(philox.group_seeds(drop.seeds), shape, drop.keep)
    raise ValueError(f"unknown mask mode {drop.mode!r}")


def divisor(keep: float, dtype: torch.dtype) -> float:
    """The keep probability rounded to the table dtype: what a kept element
    is divided by (bf16(0.7) = 0.69921875 for a bf16 table)."""
    return float(torch.tensor(keep, dtype=dtype))


def dropped(rows: torch.Tensor, drop: DropSpec) -> torch.Tensor:
    """rows [B, n, D] in the table dtype, dropped per ``drop``, in f32 (f64
    for an f64 table)."""
    acc = acc_dtype(rows)
    mask = keep_mask(drop, rows.shape[1:])
    if mask is None:
        return rows.to(acc)
    # x / keep by a tensor divisor: an IEEE division, as the kernels make
    keep = torch.tensor(divisor(drop.keep, rows.dtype), dtype=acc, device=rows.device)
    return torch.where(mask, (rows.to(acc) / keep).to(rows.dtype).to(acc), 0.0)


def c_args(drop: DropSpec, B: int, rows: int, D: int, device, name: str, dtype: torch.dtype):
    """(mode, mask pointer, seeds pointer, keep divisor in ``dtype``, the
    table dtype, and threshold) for a CUDA entry point, after checking the
    mask or the seeds."""
    if drop.mode not in MODE_CODES:
        raise ValueError(f"{name}: unknown mask mode {drop.mode!r}")
    mask_ptr = seeds_ptr = None
    if drop.mode == "ext":
        m = drop.mask
        if (m is None or m.dtype != torch.bool or tuple(m.shape) != (B, rows, D)
                or m.device != device or not m.is_contiguous()):
            raise ValueError(f"{name}: the ext mask must be a contiguous bool [{B}, {rows}, {D}] "
                             f"tensor on {device}")
        mask_ptr = m.data_ptr()
    elif drop.mode in ("prng", "prng_shared"):
        s = drop.seeds
        if (s is None or s.dtype != torch.int64 or tuple(s.shape) != (B,) or s.device != device
                or not s.is_contiguous()):
            raise ValueError(f"{name}: prng seeds must be a contiguous int64 [{B}] tensor on "
                             f"{device}")
        seeds_ptr = s.data_ptr()
    if drop.mode != "none" and not 0.0 < drop.keep <= 1.0:
        raise ValueError(f"{name}: keep probability {drop.keep} outside (0, 1]")
    return (MODE_CODES[drop.mode], mask_ptr, seeds_ptr, divisor(drop.keep, dtype),
            philox.keep_threshold(drop.keep))
