"""Philox4x32-10 in plain torch: the env-dropout masks of the prng mode.

The observation kernels (K4-K7, ``csrc/common.cuh``) draw their keep-masks
from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11; the Random123 constants) keyed by a per-sample 64-bit
seed: element e of a sample's [rows, D] block takes word e % 4 of the
block at counter (e / 4, 0, 0, 0), and is kept iff that word is below
``keep_threshold(keep)``; in the prng_shared mode a group of 8 rows
takes the draw of its first row's seed (``group_seeds``).  This module
computes the same bits on int64 tensors (each holding a uint32), on the
CPU or the card, so a kernel's plain version draws the kernel's mask and
the CPU can run the prng modes.

The JAX package draws these masks from the TPU's hardware RNG
(pano_fused.py:62-70), which is reproducible nowhere else: the port's
realization differs, its distribution does not.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
SHARED_GROUP = 8  # rows per shared mask in the prng_shared mode (common.cuh)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the uint32 values in ``b``, in 16-bit limbs so that no int64
    product overflows."""
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & _MASK16) + (p10 & _MASK16)
    lo = ((mid & _MASK16) << 16) | (p00 & _MASK16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (four int64 tensors of uint32 values)
    under ``key`` (two of them); the tensors broadcast.  Returns the four
    output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(keep: float) -> int:
    """The keep test is bits < threshold (pano_fused.py:69)."""
    return min(int(keep * 4294967296.0), 4294967295)


def random_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """uint32 words (in int64) [B, n]: element e of sample b's block, under
    the key of seeds[b] (int64, its low and high words)."""
    k0 = (seeds & _MASK32)[:, None]
    k1 = ((seeds >> 32) & _MASK32)[:, None]
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=seeds.device)[None, :]
    zero = torch.zeros_like(blocks)
    words = philox4x32_10((blocks, zero, zero, zero), (k0, k1))
    words = torch.broadcast_tensors(*words)
    return torch.stack(words, dim=-1).reshape(seeds.shape[0], -1)[:, :n]


def keep_mask(seeds: torch.Tensor, shape, keep: float) -> torch.Tensor:
    """The boolean keep-mask [B, *shape] the kernels draw for per-sample
    ``seeds`` [B] at keep probability ``keep``."""
    n = 1
    for s in shape:
        n *= s
    bits = random_bits(seeds, n)
    return (bits < keep_threshold(keep)).reshape(seeds.shape[0], *shape)


def group_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """The seed of each row's group in the prng_shared mode: rows b with the
    same b // SHARED_GROUP take the seed of the group's first row, so the
    group shares one mask (the JAX kernels' G = 8 sample groups,
    pano_fused.py:128-134; a short last group is allowed)."""
    rows = torch.arange(seeds.shape[0], device=seeds.device)
    return seeds[rows - rows % SHARED_GROUP]


def draw_seeds(batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """Per-sample 64-bit seeds [batch] (int64) from ``generator``."""
    return torch.randint(-2 ** 63, 2 ** 63 - 1, (batch,), dtype=torch.int64,
                         generator=generator, device=device)
