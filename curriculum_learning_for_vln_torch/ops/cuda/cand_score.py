"""K6 and K7: candidate scoring for the EnvDrop decoder tail, forward and
backward; CUDA kernels and plain twins.

K6 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/cand_score.py::
cand_score_fwd_pallas``, K7 its ``cand_score_bwd_pallas``, each in the
mask modes "none", "ext", "prng" and "prng_shared" (``drop.py``).
Kernel: ``csrc/cand_score.cu`` — the forward takes one block per
(candidate, group of 8 samples) and one warp per sample, every load of a
row in flight before its first FMA (``cand_score_plan`` gives the grid);
the backward one block per (slice of 128 image columns, group of 8
samples), one warp per sample and four image columns a lane (a few lanes
also take four angle columns), all 16 candidate rows of a lane in flight
before its first FMA (``cand_score_bwd_plan``).  The CPU
tests check both plans.  Both are bound by the device-memory bytes of the
candidate rows (the source says what the design does about that).

``cand_score`` and ``cand_score_bwd`` dispatch by device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel; there is no
fallback between them.  ``launches`` counts K6 launches, ``bwd_launches``
K7 launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build
from .drop import NO_DROP, DropSpec, c_args, dropped

launches = 0
bwd_launches = 0

_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_uint32,
                  ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + _DROP_ARGTYPES
_FWD_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]

GROUP = 8            # samples a K6 block scores: one warp each (the prng_shared group)
FWD_THREADS = 32 * GROUP
PASS = 2048          # row elements a K6 warp has in flight at once


class ScorePlan(NamedTuple):
    """K6's launch: grid (MC, groups); block (j, g) warp w scores sample
    GROUP * g + w's candidate j where that sample exists; ``smem`` bytes of
    static shared memory (the prng_shared keep flags of one pass)."""
    grid: Tuple[int, int]
    threads: int
    smem: int


def cand_score_plan(B: int, MC: int) -> ScorePlan:
    return ScorePlan((MC, -(-B // GROUP)), FWD_THREADS, PASS)


BWD_COLS = 128       # image columns a K7 block covers: 4 a lane
BWD_ROWS = 16        # candidate rows a K7 lane has in flight at once


class ScoreBwdPlan(NamedTuple):
    """K7's launch: grid (slices, groups); block (s, g) warp w sums sample
    GROUP * g + w's rows; lane l owns image columns s * cols + 4l .. + 3
    and, for l < ``ang_quads``, angle columns 4 (s * ang_quads + l) .. + 3,
    where that sample and those columns exist (``load_bytes`` a row and
    column set); ``smem`` bytes of shared memory: every lane's 16 rows of
    image and angle columns and of ext flags, staged by cp.async, and the
    prng_shared keep flags of 16 rows of the slice."""
    grid: Tuple[int, int]
    cols: int
    ang_quads: int
    threads: int
    load_bytes: int
    smem: int


def cand_score_bwd_plan(B: int, MC: int, D: int, A: int, dtype: torch.dtype) -> ScoreBwdPlan:
    slices = -(-D // BWD_COLS)
    ang_quads = -(-(A // 4) // slices)
    load = 4 * torch.empty((), dtype=dtype).element_size()
    smem = BWD_ROWS * (GROUP * (32 + ang_quads) * load + FWD_THREADS * 4 + 32 * 4)
    return ScoreBwdPlan((slices, -(-B // GROUP)), BWD_COLS, ang_quads, FWD_THREADS, load, smem)


def _rows(cand_img, cand_angle, drop):
    """[dropped image rows ; angle rows rounded to the table dtype] in f32."""
    img = dropped(cand_img, drop)
    return torch.cat([img, cand_angle.to(cand_img.dtype).to(img.dtype)], dim=-1)


def cand_score_plain(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                     cand_valid: torch.Tensor, q: torch.Tensor,
                     drop: DropSpec = NO_DROP) -> torch.Tensor:
    """cand_img [B, MC, D] (table dtype), cand_angle [B, MC, A] (rounded to
    the table dtype, as cand_score.py:124 does), cand_valid [B, MC] bool,
    q [B, D+A] f32.  Returns logits [B, MC+1] f32: valid candidates score
    [drop(img) ; angle] . q, invalid ones and the STOP slot MC score 0."""
    rows = _rows(cand_img, cand_angle, drop)
    s = torch.einsum("bkf,bf->bk", rows, q.to(rows.dtype))
    s = torch.where(cand_valid, s, 0.0)
    return torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=1)


def cand_score_bwd_plain(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                         cand_valid: torch.Tensor, d_logits: torch.Tensor,
                         drop: DropSpec = NO_DROP) -> torch.Tensor:
    """The cotangent d_q [B, D+A] f32 of ``cand_score_plain``'s q:
    sum_j valid_j d_logits[:, j] [drop(img_j) ; angle_j]."""
    MC = cand_img.shape[1]
    rows = _rows(cand_img, cand_angle, drop)
    w = torch.where(cand_valid, d_logits[:, :MC].to(rows.dtype), 0.0)
    return torch.einsum("bk,bkf->bf", w, rows)


def _check(name, cand_img, ang, cand_valid, vec, vec_name, vec_shape):
    B, MC, D = cand_img.shape
    A = ang.shape[-1]
    if cand_img.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: candidate rows must be float32 or bfloat16, "
                        f"got {cand_img.dtype}")
    if (D * cand_img.element_size()) % 16:
        raise ValueError(f"{name}: candidate rows must be a multiple of 16 bytes (D={D})")
    for arg, t, shape, dt in (("cand_angle", ang, (B, MC, A), cand_img.dtype),
                              ("cand_valid", cand_valid, (B, MC), torch.bool),
                              (vec_name, vec, vec_shape, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    ins = (cand_img, ang, cand_valid, vec)
    if any(t.device != cand_img.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: all inputs must be contiguous and on one CUDA device")
    return B, MC, D, A


def cand_score_cuda(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                    cand_valid: torch.Tensor, q: torch.Tensor,
                    drop: DropSpec = NO_DROP) -> torch.Tensor:
    """``cand_score_plain`` as one launch of K6."""
    global launches
    B, MC, D = cand_img.shape
    ang = cand_angle.to(cand_img.dtype)
    B, MC, D, A = _check("cand_score", cand_img, ang, cand_valid, q, "q",
                         (B, D + ang.shape[-1]))
    if (D + A) % 4:
        raise ValueError(f"cand_score: q rows must be a multiple of 16 bytes (D + A = {D + A})")
    dargs = c_args(drop, B, MC, D, cand_img.device, "cand_score", cand_img.dtype)
    if any(t.data_ptr() % 16 for t in (cand_img, q, drop.mask) if t is not None):
        raise ValueError("cand_score: the candidate rows, q and the ext mask must be 16-byte "
                         "aligned")
    plan = cand_score_plan(B, MC)
    logits = torch.empty((B, MC + 1), dtype=torch.float32, device=cand_img.device)
    fn = build.kernel_function("cand_score", "cand_score", _FWD_ARGTYPES)
    err = fn(cand_img.data_ptr(), ang.data_ptr(), cand_valid.data_ptr(), q.data_ptr(),
             logits.data_ptr(), B, MC, D, A, build.DTYPE_CODES[cand_img.dtype], *dargs,
             plan.grid[1], build.stream_handle(cand_img))
    build.check_launch(err, "cand_score")
    launches += 1
    return logits


def cand_score_bwd_cuda(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                        cand_valid: torch.Tensor, d_logits: torch.Tensor,
                        drop: DropSpec = NO_DROP) -> torch.Tensor:
    """``cand_score_bwd_plain`` as one launch of K7."""
    global bwd_launches
    B, MC, D = cand_img.shape
    ang = cand_angle.to(cand_img.dtype)
    B, MC, D, A = _check("cand_score_bwd", cand_img, ang, cand_valid, d_logits, "d_logits",
                         (B, MC + 1))
    if A % 4 or cand_score_bwd_plan(B, MC, D, A, cand_img.dtype).ang_quads > 32:
        raise ValueError(f"cand_score_bwd: the angle rows must be a multiple of 4 wide and at "
                         f"most 32 quads a slice of {BWD_COLS} image columns (A = {A})")
    dargs = c_args(drop, B, MC, D, cand_img.device, "cand_score_bwd", cand_img.dtype)
    if drop.mask is not None and drop.mask.data_ptr() % 16:
        raise ValueError("cand_score_bwd: the ext mask must be 16-byte aligned")
    d_q = torch.empty((B, D + A), dtype=torch.float32, device=cand_img.device)
    fn = build.kernel_function("cand_score", "cand_score_bwd", _ARGTYPES)
    err = fn(cand_img.data_ptr(), ang.data_ptr(), cand_valid.data_ptr(), d_logits.data_ptr(),
             d_q.data_ptr(), B, MC, D, A, build.DTYPE_CODES[cand_img.dtype], *dargs,
             build.stream_handle(cand_img))
    build.check_launch(err, "cand_score_bwd")
    bwd_launches += 1
    return d_q


def cand_score(cand_img: torch.Tensor, cand_angle: torch.Tensor, cand_valid: torch.Tensor,
               q: torch.Tensor, drop: DropSpec = NO_DROP) -> torch.Tensor:
    if cand_img.device.type == "cuda":
        return cand_score_cuda(cand_img, cand_angle, cand_valid, q, drop)
    if cand_img.device.type == "cpu":
        return cand_score_plain(cand_img, cand_angle, cand_valid, q, drop)
    raise ValueError(f"cand_score: no implementation for device {cand_img.device}")


def cand_score_bwd(cand_img: torch.Tensor, cand_angle: torch.Tensor, cand_valid: torch.Tensor,
                   d_logits: torch.Tensor, drop: DropSpec = NO_DROP) -> torch.Tensor:
    if cand_img.device.type == "cuda":
        return cand_score_bwd_cuda(cand_img, cand_angle, cand_valid, d_logits, drop)
    if cand_img.device.type == "cpu":
        return cand_score_bwd_plain(cand_img, cand_angle, cand_valid, d_logits, drop)
    raise ValueError(f"cand_score_bwd: no implementation for device {cand_img.device}")
