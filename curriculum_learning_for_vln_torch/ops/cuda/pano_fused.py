"""K4 and K5: panorama gather + env-dropout + visual attention + candidate
rows, forward and backward; CUDA kernels and plain twins.

K4 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/pano_fused.py::
pano_attend_fwd_pallas``, K5 its ``pano_attend_bwd_pallas``, each in the
mask modes "none", "ext", "prng" and "prng_shared" (``drop.py``).
Kernel: ``csrc/pano_fused.cu`` — one block per sample scores the 36
views, takes the softmax (forward) or its VJP (backward) on chip and
forms the weighted sum; the forward also copies the candidate rows out of
the feature table.  Both are bound by
the device-memory bytes of the feature rows (the source says what the
design does about that).

``pano_attend`` and ``pano_attend_bwd`` dispatch by device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel; there is no
fallback between them.  ``launches`` counts K4 launches, ``bwd_launches``
K5 launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .drop import NO_DROP, DropSpec, c_args, dropped

launches = 0
bwd_launches = 0

_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_uint32,
                  ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + _DROP_ARGTYPES
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + _DROP_ARGTYPES


def _pano(nodes, views, features, loc_embed, drop):
    """[dropped rows ; loc rows] [B, V, D+A] f32 and the raw rows [B, V, D]."""
    feats = features[nodes]
    img = dropped(feats, drop)
    pano = torch.cat([img, loc_embed[views].to(img.dtype)], dim=-1)
    return pano, feats


def pano_attend_plain(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                      features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor,
                      drop: DropSpec = NO_DROP
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features [N, V, D] (table dtype), loc_embed [36, V, A] f32, nodes and
    views [B], cand_view [B, MC], tv [B, D+A] f32.  Returns (vis [B, D+A]
    f32, alpha [B, V] f32, cand_img [B, MC, D] table dtype), where vis is
    the softmax-over-views weighted sum of [drop(features[node]) ;
    loc_embed[view]] scored against tv, and cand_img[b, j] =
    features[node, cand_view[j]] (not dropped)."""
    pano, feats = _pano(nodes, views, features, loc_embed, drop)
    scores = torch.einsum("bvf,bf->bv", pano, tv.to(pano.dtype))
    alpha = torch.softmax(scores, dim=-1)
    vis = torch.einsum("bv,bvf->bf", alpha, pano)
    D = features.shape[-1]
    cand = feats.gather(1, cand_view[:, :, None].expand(-1, -1, D))
    return vis, alpha, cand


def pano_attend_bwd_plain(nodes: torch.Tensor, views: torch.Tensor, features: torch.Tensor,
                          loc_embed: torch.Tensor, alpha: torch.Tensor, d_vis: torch.Tensor,
                          drop: DropSpec = NO_DROP) -> torch.Tensor:
    """The cotangent d_tv [B, D+A] f32 of ``pano_attend_plain``'s tv from
    the forward's alpha [B, V] and d_vis [B, D+A]: d_a = rows . d_vis,
    d_s = a (d_a - sum a d_a), d_tv = d_s^T rows."""
    pano, _ = _pano(nodes, views, features, loc_embed, drop)
    d_a = torch.einsum("bvf,bf->bv", pano, d_vis.to(pano.dtype))
    d_s = alpha * (d_a - (alpha * d_a).sum(dim=1, keepdim=True))
    return torch.einsum("bv,bvf->bf", d_s, pano)


def _check(name, nodes, views, features, loc_embed, others):
    B = nodes.shape[0]
    N, V, D = features.shape
    A = loc_embed.shape[-1]
    if features.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: feature table must be float32 or bfloat16, "
                        f"got {features.dtype}")
    if (D * features.element_size()) % 16:
        raise ValueError(f"{name}: feature rows must be a multiple of 16 bytes (D={D})")
    for arg, t, shape, dt in (("views", views, (B,), torch.int64),
                              ("nodes", nodes, (B,), torch.int64),
                              ("loc_embed", loc_embed, (loc_embed.shape[0], V, A), torch.float32),
                              *others):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    ins = (nodes, views, features, loc_embed, *(o[1] for o in others))
    if any(t.device != features.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: all inputs must be contiguous and on one CUDA device")
    return B, V, D, A


def pano_attend_cuda(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                     features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor,
                     drop: DropSpec = NO_DROP
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pano_attend_plain`` as one launch of K4."""
    global launches
    B, MC = cand_view.shape
    D, A = features.shape[-1], loc_embed.shape[-1]
    B, V, D, A = _check("pano_attend", nodes, views, features, loc_embed,
                        (("cand_view", cand_view, (B, MC), torch.int64),
                         ("tv", tv, (B, D + A), torch.float32)))
    dargs = c_args(drop, B, V, D, features.device, "pano_attend")
    vis = torch.empty((B, D + A), dtype=torch.float32, device=features.device)
    alpha = torch.empty((B, V), dtype=torch.float32, device=features.device)
    cand = torch.empty((B, MC, D), dtype=features.dtype, device=features.device)
    fn = build.kernel_function("pano_fused", "pano_attend", _ARGTYPES)
    err = fn(nodes.data_ptr(), views.data_ptr(), cand_view.data_ptr(), features.data_ptr(),
             loc_embed.data_ptr(), tv.data_ptr(), vis.data_ptr(), alpha.data_ptr(),
             cand.data_ptr(), B, V, D, A, MC, build.DTYPE_CODES[features.dtype], *dargs,
             build.stream_handle(features))
    build.check_launch(err, "pano_attend")
    launches += 1
    return vis, alpha, cand


def pano_attend_bwd_cuda(nodes: torch.Tensor, views: torch.Tensor, features: torch.Tensor,
                         loc_embed: torch.Tensor, alpha: torch.Tensor, d_vis: torch.Tensor,
                         drop: DropSpec = NO_DROP) -> torch.Tensor:
    """``pano_attend_bwd_plain`` as one launch of K5."""
    global bwd_launches
    B, (V, D), A = nodes.shape[0], features.shape[1:], loc_embed.shape[-1]
    _check("pano_attend_bwd", nodes, views, features, loc_embed,
           (("alpha", alpha, (B, V), torch.float32),
            ("d_vis", d_vis, (B, D + A), torch.float32)))
    dargs = c_args(drop, B, V, D, features.device, "pano_attend_bwd")
    d_tv = torch.empty((B, D + A), dtype=torch.float32, device=features.device)
    fn = build.kernel_function("pano_fused", "pano_attend_bwd", _BWD_ARGTYPES)
    err = fn(nodes.data_ptr(), views.data_ptr(), features.data_ptr(), loc_embed.data_ptr(),
             alpha.data_ptr(), d_vis.data_ptr(), d_tv.data_ptr(), B, V, D, A,
             build.DTYPE_CODES[features.dtype], *dargs, build.stream_handle(features))
    build.check_launch(err, "pano_attend_bwd")
    bwd_launches += 1
    return d_tv


def pano_attend(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor,
                drop: DropSpec = NO_DROP) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if features.device.type == "cuda":
        return pano_attend_cuda(nodes, views, cand_view, features, loc_embed, tv, drop)
    if features.device.type == "cpu":
        return pano_attend_plain(nodes, views, cand_view, features, loc_embed, tv, drop)
    raise ValueError(f"pano_attend: no implementation for device {features.device}")


def pano_attend_bwd(nodes: torch.Tensor, views: torch.Tensor, features: torch.Tensor,
                    loc_embed: torch.Tensor, alpha: torch.Tensor, d_vis: torch.Tensor,
                    drop: DropSpec = NO_DROP) -> torch.Tensor:
    if features.device.type == "cuda":
        return pano_attend_bwd_cuda(nodes, views, features, loc_embed, alpha, d_vis, drop)
    if features.device.type == "cpu":
        return pano_attend_bwd_plain(nodes, views, features, loc_embed, alpha, d_vis, drop)
    raise ValueError(f"pano_attend_bwd: no implementation for device {features.device}")
