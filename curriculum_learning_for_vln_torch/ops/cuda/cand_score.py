"""K6: candidate scoring for the EnvDrop decoder tail, CUDA kernel and
plain twin.

Replaces ``curriculum_learning_for_vln_tpu/ops/pallas/cand_score.py::
cand_score_fwd_pallas`` in its mask mode "none" (no env-dropout: the
serving path, train=False).  Kernel: ``csrc/cand_score.cu`` — one block
per sample, one warp per candidate; it is bound by the device-memory
bytes of the candidate rows (the source says what the design does about
that).  The ext and in-kernel-RNG mask modes are not ported yet.

``cand_score`` dispatches by device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; there is no fallback between them.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def cand_score_plain(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                     cand_valid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """cand_img [B, MC, D] (table dtype), cand_angle [B, MC, A] (rounded to
    the table dtype, as cand_score.py:124 does), cand_valid [B, MC] bool,
    q [B, D+A] f32.  Returns logits [B, MC+1] f32: valid candidates score
    [img ; angle] . q, invalid ones and the STOP slot MC score 0."""
    D = cand_img.shape[-1]
    ang = cand_angle.to(cand_img.dtype).float()
    q = q.float()
    s = (torch.einsum("bkd,bd->bk", cand_img.float(), q[:, :D])
         + torch.einsum("bka,ba->bk", ang, q[:, D:]))
    s = torch.where(cand_valid, s, 0.0)
    return torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=1)


def cand_score_cuda(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                    cand_valid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``cand_score_plain`` as one launch of the CUDA kernel."""
    global launches
    B, MC, D = cand_img.shape
    A = cand_angle.shape[-1]
    dtype = cand_img.dtype
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"cand_score: candidate rows must be float32 or bfloat16, got {dtype}")
    if (D * cand_img.element_size()) % 16:
        raise ValueError(f"cand_score: candidate rows must be a multiple of 16 bytes (D={D})")
    ang = cand_angle.to(dtype)
    for name, t, shape, dt in (("cand_angle", ang, (B, MC, A), dtype),
                               ("cand_valid", cand_valid, (B, MC), torch.bool),
                               ("q", q, (B, D + A), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"cand_score: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    ins = (cand_img, ang, cand_valid, q)
    if any(t.device != cand_img.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError("cand_score: all inputs must be contiguous and on one CUDA device")
    logits = torch.empty((B, MC + 1), dtype=torch.float32, device=cand_img.device)
    fn = build.kernel_function("cand_score", _ARGTYPES)
    err = fn(cand_img.data_ptr(), ang.data_ptr(), cand_valid.data_ptr(), q.data_ptr(),
             logits.data_ptr(), B, MC, D, A, build.DTYPE_CODES[dtype],
             build.stream_handle(cand_img))
    build.check_launch(err, "cand_score")
    launches += 1
    return logits


def cand_score(cand_img: torch.Tensor, cand_angle: torch.Tensor,
               cand_valid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if cand_img.device.type == "cuda":
        return cand_score_cuda(cand_img, cand_angle, cand_valid, q)
    if cand_img.device.type == "cpu":
        return cand_score_plain(cand_img, cand_angle, cand_valid, q)
    raise ValueError(f"cand_score: no implementation for device {cand_img.device}")
