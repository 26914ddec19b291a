"""K4 and K5: panorama gather + env-dropout + visual attention + candidate
rows, forward and backward; CUDA kernels and plain twins.

K4 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/pano_fused.py::
pano_attend_fwd_pallas``, K5 its ``pano_attend_bwd_pallas``, each in the
mask modes "none", "ext", "prng" and "prng_shared" (``drop.py``).
Kernel: ``csrc/pano_fused.cu`` — the grid is (slice of D, group of G
samples), a cluster of S blocks along D per group (``pano_plan``).  A
block stages its rows' slice in shared memory once (one TMA box a sample,
every load in flight before any arithmetic), writes the candidate rows'
slice (K4), drops each element once in place, forms its partial scores,
sends them to every rank of the cluster through distributed shared
memory, sums the S ranks' partials in rank order, takes the softmax
(forward) or its VJP (backward) and forms its slice of the weighted
sum.  Both are bound by the device-memory bytes of the feature
rows (the source says what the design does about that).
``pano_attend_emulated`` and ``pano_attend_bwd_emulated`` are the
kernels' arithmetic, block by block, in plain torch, for the CPU tests.

``pano_attend`` and ``pano_attend_bwd`` dispatch by device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel; there is no
fallback between them.  ``launches`` counts K4 launches, ``bwd_launches``
K5 launches.
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
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + _DROP_ARGTYPES
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + _DROP_ARGTYPES


THREADS = 288        # 9 warps: 8 threads a (sample, view) row at G = 1, 4 at G = 2
MIN_BLOCKS = 3       # blocks an SM holds by their registers (the kernel's launch bounds)
MAX_SPLIT = 8        # the largest portable cluster
SMEM_LIMIT = 232448  # shared memory a block can use on the H100
SM_SMEM = 233472     # shared memory of an SM
BLOCK_RESERVE = 1024  # the runtime's shared memory of each block
SMS = 132


class PanoPlan(NamedTuple):
    """K4's or K5's launch: grid (S, groups) in clusters of S blocks along
    x; block (rank, y) owns samples y G .. y G + G - 1 (those < B), image
    columns [rank cols, (rank + 1) cols) and angle columns [4 rank aq,
    4 (rank + 1) aq) of [0, A); ``smem`` bytes of dynamic shared memory;
    ``waves`` of clusters the grid is expected to take."""
    grid: Tuple[int, int]
    cluster: int
    samples: int
    cols: int
    ang_quads: int
    threads: int
    smem: int
    waves: int


def _align128(x: int) -> int:
    return (x + 127) // 128 * 128


def pano_smem(S: int, G: int, V: int, cols: int, aq: int, MC: int, elem: int) -> int:
    """A block's shared-memory bytes (csrc/pano_fused.cu ``layout``), each
    region 128-byte aligned, per sample where it says so: rows [G, V, cols]
    in the table dtype; ext or prng flags [G, V, cols] bytes; angle rows
    [G, V, 4 aq] f32; the query slice [G, cols + 4 aq] f32; every rank's
    partial scores [S, G, V] f32; the weights and alpha, each [G, V] f32;
    K4's candidate views [G, MC] int32; and 128 bytes to align the base."""
    return (G * (_align128(V * cols * elem) + _align128(V * cols) + _align128(V * aq * 16))
            + _align128(G * (cols + 4 * aq) * 4) + _align128(S * G * V * 4)
            + 2 * _align128(G * V * 4) + _align128(G * MC * 4) + 128)


def clusters_at_once(S: int, smem: int) -> int:
    """The clusters of S blocks of ``smem`` bytes the card is taken to hold
    at once: an SM holds min(MIN_BLOCKS, what its shared memory holds)
    blocks, and the card 90% of the clusters those would make
    (cudaOccupancyMaxActiveClusters read 91-94% on the H100)."""
    per_sm = min(MIN_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVE))
    return max(1, SMS * per_sm // S * 9 // 10)


def pano_plan(B: int, V: int, D: int, A: int, dtype: torch.dtype, MC: int = 0) -> PanoPlan:
    """The launch of K4 (MC candidates) or K5 (MC = 0).  S: the largest of 8,
    4, 2, 1 that divides the row's 16-byte chunks.  G: of 8, 4, 2, 1 (those
    whose shared memory fits), the one whose grid takes the fewest waves of
    clusters (``clusters_at_once``), and of those the smallest.  Raises
    where no G fits."""
    elem = torch.empty((), dtype=dtype).element_size()
    n = 16 // elem
    if B < 1 or D < n or D % n or A % 4:
        raise ValueError(f"pano_plan: no plan for B={B}, D={D}, A={A} in {dtype}")
    chunks = D // n
    S = MAX_SPLIT
    while chunks % S:
        S //= 2
    cols, aq = chunks // S * n, -(-(A // 4) // S)
    best = None
    for G in (1, 2, 4, 8):  # a block's samples never straddle a prng_shared group of 8
        smem = pano_smem(S, G, V, cols, aq, MC, elem)
        if smem > SMEM_LIMIT:
            break
        groups = -(-B // G)
        waves = -(-groups // clusters_at_once(S, smem))
        if best is None or waves < best.waves:
            best = PanoPlan((S, groups), S, G, cols, aq, THREADS, smem, waves)
    if best is None:
        raise ValueError(f"pano_plan: a {V} x {cols} slice of {dtype} rows does not fit in "
                         f"shared memory (D={D})")
    return best


def plan_query(B: int, V: int, D: int, A: int, dtype: torch.dtype, MC: int = 0):
    """(S, G, groups, cols, aq, smem, clusters the card holds at once) of the
    plan the C entry points compute for themselves, read from the built
    library (a card is needed for the last)."""
    fn = build.kernel_function("pano_fused", "pano_plan_query",
                               [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 7)()
    build.check_launch(fn(B, V, D, A, MC, build.DTYPE_CODES[dtype], out), "pano_plan_query")
    return tuple(out)


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


def _blocks(plan: PanoPlan, B: int, D: int, A: int):
    """Each block of ``plan`` as (rank, samples, image columns, angle
    columns as absolute positions in [0, D + A))."""
    S, groups = plan.grid
    G, cols, aq = plan.samples, plan.cols, plan.ang_quads
    for y in range(groups):
        bs = torch.arange(y * G, min(B, (y + 1) * G))
        for rank in range(S):
            a0 = 4 * rank * aq
            yield (rank, bs, torch.arange(rank * cols, (rank + 1) * cols),
                   torch.arange(D + a0, D + min(A, a0 + 4 * aq)))


def _emulated(nodes, views, features, loc_embed, vec, drop, MC, weights):
    """The kernels' arithmetic, block by block: each element dropped once;
    per block, its partial scores over its columns; per group, the S
    ranks' partials summed in rank order and turned into weights by
    ``weights`` (scores of the group's samples -> weights); per block, its
    slice of the weighted sum.  Outputs nobody writes stay NaN."""
    B = nodes.shape[0]
    _, V, D = features.shape
    A = loc_embed.shape[-1]
    plan = pano_plan(B, V, D, A, features.dtype, MC)
    pano, _ = _pano(nodes, views, features, loc_embed, drop)  # [dropped rows ; loc rows]
    out = torch.full((B, D + A), float("nan"), dtype=pano.dtype)
    w_all = torch.full((B, V), float("nan"), dtype=pano.dtype)
    blocks = list(_blocks(plan, B, D, A))
    S = plan.cluster
    for i in range(0, len(blocks), S):
        cluster = blocks[i:i + S]
        bs = cluster[0][1]
        score = torch.zeros((len(bs), V), dtype=pano.dtype)
        for _, _, cols, acols in cluster:  # rank order
            cs = torch.cat([cols, acols])
            score = score + torch.einsum("gvc,gc->gv", pano[bs][:, :, cs],
                                         vec[bs][:, cs].to(pano.dtype))
        w = weights(score, bs)
        w_all[bs] = w
        for _, _, cols, acols in cluster:
            cs = torch.cat([cols, acols])
            out[bs[:, None], cs[None, :]] = torch.einsum("gv,gvc->gc", w, pano[bs][:, :, cs])
    return out, w_all


def pano_attend_emulated(nodes: torch.Tensor, views: torch.Tensor, cand_view: torch.Tensor,
                         features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor,
                         drop: DropSpec = NO_DROP
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pano_attend_plain`` computed as K4 computes it under ``pano_plan``:
    the candidate rows copied slice by slice from the raw rows, the scores
    summed over the ranks in order, the softmax per group and each slice's
    weighted sum."""
    B, MC = cand_view.shape
    D = features.shape[-1]
    plan = pano_plan(B, features.shape[1], D, loc_embed.shape[-1], features.dtype, MC)
    raw = features[nodes]
    cand = torch.full((B, MC, D), float("nan"), dtype=features.dtype)
    for _, bs, cols, _ in _blocks(plan, B, D, loc_embed.shape[-1]):
        cand[bs[:, None, None], torch.arange(MC)[None, :, None], cols[None, None, :]] = \
            raw[bs[:, None, None], cand_view[bs][:, :, None], cols[None, None, :]]
    vis, alpha = _emulated(nodes, views, features, loc_embed, tv, drop, MC,
                           lambda s, bs: torch.softmax(s, dim=-1))
    return vis, alpha, cand


def pano_attend_bwd_emulated(nodes: torch.Tensor, views: torch.Tensor, features: torch.Tensor,
                             loc_embed: torch.Tensor, alpha: torch.Tensor, d_vis: torch.Tensor,
                             drop: DropSpec = NO_DROP) -> torch.Tensor:
    """``pano_attend_bwd_plain`` computed as K5 computes it under
    ``pano_plan``: d_a summed over the ranks in order, the softmax VJP with
    the saved alpha per group, each slice's weighted sum."""
    def vjp(d_a, bs):
        a = alpha[bs].to(d_a.dtype)
        return a * (d_a - (a * d_a).sum(dim=1, keepdim=True))

    d_tv, _ = _emulated(nodes, views, features, loc_embed, d_vis, drop, 0, vjp)
    return d_tv


def _check(name, nodes, views, features, loc_embed, others, drop):
    B = nodes.shape[0]
    N, V, D = features.shape
    A = loc_embed.shape[-1]
    if features.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: feature table must be float32 or bfloat16, "
                        f"got {features.dtype}")
    if (D * features.element_size()) % 16:
        raise ValueError(f"{name}: feature rows must be a multiple of 16 bytes (D={D})")
    if A % 4:
        raise ValueError(f"{name}: angle rows must be a multiple of 16 bytes (A={A})")
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
    # the kernels copy rows, the query and the ext mask 16 (the mask 8 or 4)
    # bytes at a time
    copied = (features, loc_embed, others[-1][1], *((drop.mask,) if drop.mode == "ext" and drop.mask is not None else ()))
    if any(t.data_ptr() % 16 for t in copied):
        raise ValueError(f"{name}: the feature table, loc_embed, the query or cotangent and the "
                         f"ext mask must be 16-byte aligned")
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
                         ("tv", tv, (B, D + A), torch.float32)), drop)
    dargs = c_args(drop, B, V, D, features.device, "pano_attend", features.dtype)
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
            ("d_vis", d_vis, (B, D + A), torch.float32)), drop)
    dargs = c_args(drop, B, V, D, features.device, "pano_attend_bwd", features.dtype)
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
