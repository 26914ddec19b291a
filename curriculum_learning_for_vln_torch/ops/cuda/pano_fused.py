"""K4: panorama gather + visual attention + candidate rows, CUDA kernel
and plain twin.

Replaces ``curriculum_learning_for_vln_tpu/ops/pallas/pano_fused.py::
pano_attend_fwd_pallas`` in its mask mode "none" (no env-dropout: the
serving path, train=False).  Kernel: ``csrc/pano_fused.cu`` — one block
per sample scores the 36 views, takes the softmax on chip, forms the
weighted sum and copies the candidate rows out of the feature table; it is
bound by the device-memory bytes of the feature rows (the source says
what the design does about that).  The ext and in-kernel-RNG mask modes
are not ported yet.

``pano_attend`` dispatches by device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; there is no fallback between them.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pano_attend_plain(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                      features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features [N, V, D] (table dtype), loc_embed [36, V, A] f32, nodes and
    views [B], cand_view [B, MC], tv [B, D+A] f32.  Returns (vis [B, D+A]
    f32, alpha [B, V] f32, cand_img [B, MC, D] table dtype), where vis is
    the softmax-over-views weighted sum of [features[node] ; loc_embed[view]]
    scored against tv, and cand_img[b, j] = features[node, cand_view[j]]."""
    feats = features[nodes]                                       # [B, V, D]
    pano = torch.cat([feats.float(), loc_embed[views].float()], dim=-1)
    scores = torch.einsum("bvf,bf->bv", pano, tv.float())
    alpha = torch.softmax(scores, dim=-1)
    vis = torch.einsum("bv,bvf->bf", alpha, pano)
    D = features.shape[-1]
    cand = feats.gather(1, cand_view[:, :, None].expand(-1, -1, D))
    return vis, alpha, cand


def pano_attend_cuda(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                     features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pano_attend_plain`` as one launch of the CUDA kernel."""
    global launches
    B = nodes.shape[0]
    N, V, D = features.shape
    A = loc_embed.shape[-1]
    MC = cand_view.shape[1]
    dtype = features.dtype
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"pano_attend: feature table must be float32 or bfloat16, got {dtype}")
    if (D * features.element_size()) % 16:
        raise ValueError(f"pano_attend: feature rows must be a multiple of 16 bytes (D={D})")
    for name, t, shape, dt in (("views", views, (B,), torch.int64),
                               ("nodes", nodes, (B,), torch.int64),
                               ("cand_view", cand_view, (B, MC), torch.int64),
                               ("loc_embed", loc_embed, (loc_embed.shape[0], V, A), torch.float32),
                               ("tv", tv, (B, D + A), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"pano_attend: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    ins = (nodes, views, cand_view, features, loc_embed, tv)
    if any(t.device != features.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError("pano_attend: all inputs must be contiguous and on one CUDA device")
    vis = torch.empty((B, D + A), dtype=torch.float32, device=features.device)
    alpha = torch.empty((B, V), dtype=torch.float32, device=features.device)
    cand = torch.empty((B, MC, D), dtype=dtype, device=features.device)
    fn = build.kernel_function("pano_fused", _ARGTYPES)
    err = fn(nodes.data_ptr(), views.data_ptr(), cand_view.data_ptr(), features.data_ptr(),
             loc_embed.data_ptr(), tv.data_ptr(), vis.data_ptr(), alpha.data_ptr(),
             cand.data_ptr(), B, V, D, A, MC, build.DTYPE_CODES[dtype],
             build.stream_handle(features))
    build.check_launch(err, "pano_attend")
    launches += 1
    return vis, alpha, cand


def pano_attend(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if features.device.type == "cuda":
        return pano_attend_cuda(nodes, views, cand_view, features, loc_embed, tv)
    if features.device.type == "cpu":
        return pano_attend_plain(nodes, views, cand_view, features, loc_embed, tv)
    raise ValueError(f"pano_attend: no implementation for device {features.device}")
