"""The ('data', 'model') process layout over ``torch.distributed``.

The port of ``curriculum_learning_for_vln_tpu/parallel/mesh.py``.  One
process is one rank; rank = d * model + m (the JAX package's devices
reshaped to (data, model)).  Episode batches are split over 'data' (rank
d keeps rows d * B / data ...), parameters are the same on every rank,
and 'model' is the ViLBERT scorer's tensor-parallel axis
(parallel/vilbert_sharding.py).

Under JAX's SPMD a sharded step *is* the one-device program over the
global batch.  Here each rank runs its rows, and the global program is
rebuilt by hand, one place for each part, while ``sharded_step(mesh)``
is open:

* random draws: ``ops/draws.py`` draws the global batch's noise from the
  one generator every rank holds, and keeps the rank's rows;
* losses that divide by a batch quantity divide by its global value
  (``global_rows``, ``global_sum``); each rank's loss is then its part of
  the global loss, and ``all_reduce_grads`` SUMS the gradients;
* batch statistics (the Self-Monitor's BatchNorm) reduce through
  ``differentiable_sum``; the packed rollout's refill reads every rank's
  flags through ``gather_rows``; the early exit waits for every rank's
  episodes (``all_true``).

The backend rule (``init_process_group``): NCCL when every rank owns its
own GPU (``cuda:local_rank``), gloo when ranks share one device or run on
the CPU.  NCCL refuses two ranks on one GPU; gloo reduces CUDA tensors
through the host.  A host's ranks are LOCAL_RANK / LOCAL_WORLD_SIZE
(``local_layout``), which a start whose ranks do not each own a card of
one host must set.  A backend that fails to start raises; nothing falls
back to another backend.  ``init_from_env`` joins the group the VLN_*
variables name, for ``main`` and ``build_clr2r``.
"""
from __future__ import annotations

import datetime
import logging
import os
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves
from ..world.compiler import resolve_device

logger = logging.getLogger("main.parallel")

_STEP: Optional["Mesh"] = None  # the mesh of the sharded step being run


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL when every rank of a host (``local_world_size`` of them) owns its
    own GPU, else gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_layout(world_size: int, rank: int, device_type: str):
    """(local_rank, local_world_size): this rank's place among its host's
    ranks.  torchrun sets LOCAL_RANK and LOCAL_WORLD_SIZE, and so must a
    start by the VLN_* variables whose ranks do not each own a card of one
    host: without them, CPU ranks and a CUDA world no larger than this
    host's cards are taken to be this host's ranks, one a card; a larger
    CUDA world raises (several hosts, or ranks sharing a card)."""
    local = [os.environ.get(k) for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")]
    if all(v is not None for v in local):
        return int(local[0]), int(local[1])
    if any(v is not None for v in local):
        raise ValueError("set both LOCAL_RANK and LOCAL_WORLD_SIZE, or neither")
    if device_type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} CUDA ranks and {torch.cuda.device_count()} cards on this "
                         "host: set LOCAL_RANK and LOCAL_WORLD_SIZE (this rank's place among "
                         "this host's ranks) to choose the backend and the card")
    return rank, world_size


def init_process_group(init_method: str, world_size: Optional[int] = None,
                       rank: Optional[int] = None, device=None,
                       timeout_s: float = 1800.0) -> torch.device:
    """Start the process group by the backend rule and return this rank's
    device: ``cuda:local_rank`` (a shared card: local_rank modulo the
    cards) for CUDA, else the CPU.  ``init_method`` "env://" reads RANK,
    WORLD_SIZE and MASTER_ADDR / MASTER_PORT (torchrun) and leaves
    ``world_size`` and ``rank`` to them; the host's ranks come from
    ``local_layout``."""
    if init_method == "env://":
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    device = resolve_device(device)  # raises without CUDA unless the CPU is asked for
    local_rank, local_world = local_layout(world_size, rank, device.type)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend_for(device, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    why = ("every rank owns its GPU" if backend == "nccl" else
           "ranks share a GPU" if device.type == "cuda" else "ranks on the CPU")
    logger.info("torch.distributed: backend %s (%s), rank %d of %d on %s", backend, why, rank,
                world_size, device)
    return device


def launched_by_env() -> bool:
    """Whether the VLN_* variables start this process as a rank (main.py:41-55)."""
    return bool(os.environ.get("VLN_COORDINATOR")) or os.environ.get("VLN_MULTIHOST") == "1"


def init_from_env(device=None) -> torch.device:
    """Join the process group the VLN_* variables name: at
    ``tcp://VLN_COORDINATOR`` as rank VLN_PROCESS_ID of VLN_NUM_PROCESSES,
    or with VLN_MULTIHOST=1 at ``env://`` (torchrun's variables); returns
    this rank's device."""
    if os.environ.get("VLN_COORDINATOR"):
        return init_process_group(f"tcp://{os.environ['VLN_COORDINATOR']}",
                                  int(os.environ["VLN_NUM_PROCESSES"]),
                                  int(os.environ["VLN_PROCESS_ID"]), device)
    return init_process_group("env://", device=device)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 writes logs and checkpoints (trainer.py:172)."""
    return world_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class Mesh:
    """This rank's place in the (data, model) layout and its groups; with
    no process group, the 1 x 1 mesh of one process."""

    def __init__(self, data: int, model: int):
        self.data, self.model = data, model
        self.distributed = dist.is_initialized()
        rank = world_rank()
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = self.model_group = None
        if data * model != world_size():
            raise ValueError(f"a mesh of data={data} x model={model} must use every one of the "
                             f"{world_size()} ranks: one process is one rank, and a rank "
                             "outside the mesh would have no rows (TRAIN.BATCH_SIZE and "
                             "TPU.MESH_DATA / MESH_MODEL must fit the world)")
        if not self.distributed:
            return
        # every rank makes every group, in the same order (new_group's rule)
        for m in range(model):
            g = (dist.group.WORLD if model == 1
                 else dist.new_group([d * model + m for d in range(data)]))
            if m == self.model_index:
                self.data_group = g
        for d in range(data):
            g = (dist.group.WORLD if data == 1
                 else dist.new_group([d * model + m for m in range(model)]))
            if d == self.data_index:
                self.model_group = g

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model})"


def mesh_shape(n_ranks: int, data: int, model: int, batch_size: int):
    """(data, model) by the JAX package's rule (mesh.py:31-48): data = 0
    means every rank the model axis does not use; the data axis shrinks
    until it divides ``batch_size``."""
    model = max(1, int(model))
    avail = max(1, n_ranks // model)
    data = int(data) if int(data) > 0 else avail
    data = min(data, avail)
    while batch_size % data:
        data -= 1
    return data, model


def make_mesh(data: int = 0, model: int = 1) -> Mesh:
    """A (data, model) mesh over the process group; data = 0 means all
    ranks not used by the model axis."""
    if data <= 0:
        if world_size() % model:
            raise ValueError(f"{world_size()} ranks do not split into model = {model}")
        data = world_size() // model
    return Mesh(data, model)


def mesh_from_config(cfg, batch_size: int) -> Mesh:
    """The production mesh from TPU.MESH_DATA / TPU.MESH_MODEL."""
    return make_mesh(*mesh_shape(world_size(), cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL,
                                 batch_size))


def pad_batch_to_devices(n: int, mesh: Mesh) -> int:
    """The smallest batch size >= n the data axis divides."""
    d = mesh.data
    return ((n + d - 1) // d) * d


# ---------------------------------------------------------------------------
# Rows of a batch
# ---------------------------------------------------------------------------

def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} does not split over data = {mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every leaf of a leading-batch tree."""
    return _map(lambda t: t[batch_rows(mesh, t.shape[0])], tree)


def _broadcast_(t: torch.Tensor, src: int = 0) -> None:
    """Rank ``src``'s values into ``t`` in place; a CPU tensor under NCCL
    goes through the rank's GPU."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        buf = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(buf, src)
        t.copy_(buf.cpu())
    else:
        dist.broadcast(t, src)


@torch.no_grad()
def replicate(tree):
    """Rank 0's values in every tensor leaf of ``tree``, in place (the
    parameters, the model state); returns ``tree``."""
    if dist.is_initialized():
        _map(_broadcast_, tree)
    return tree


@torch.no_grad()
def replicate_optimizer(optimizer: torch.optim.Optimizer) -> None:
    """Rank 0's optimizer state on every rank, in place."""
    if not dist.is_initialized():
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            for _, v in sorted(optimizer.state.get(p, {}).items()):
                if isinstance(v, torch.Tensor):
                    _broadcast_(v)


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

@contextmanager
def sharded_step(mesh: Optional[Mesh]):
    """Run the enclosed rollouts and losses as this rank's rows of the
    global program (the draws, the denominators, the statistics); a mesh
    without a process group, or None, changes nothing."""
    global _STEP
    saved = _STEP
    _STEP = mesh if mesh is not None and mesh.distributed else None
    try:
        yield
    finally:
        _STEP = saved


@contextmanager
def replicated_rows():
    """Suspend the sharded step: the enclosed work runs on rows every rank
    holds whole (the packed rollout's episode pool)."""
    global _STEP
    saved, _STEP = _STEP, None
    try:
        yield
    finally:
        _STEP = saved


def step_mesh() -> Optional[Mesh]:
    """The mesh of the open sharded step, or None."""
    return _STEP


def global_rows(n: int) -> int:
    """The global batch of a sharded step whose ranks hold ``n`` rows each."""
    return n * _STEP.data if _STEP is not None else n


def local_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows of a global-batch tensor (SPCL's weights)."""
    if t is None or _STEP is None:
        return t
    return t[batch_rows(_STEP, t.shape[0])]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data axis, carrying no gradient: a
    denominator or a count."""
    if _STEP is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_STEP.data_group)
    return out


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward is the all-reduce of the gradient:
    every rank's loss is a part of the global one."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def differentiable_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data axis; its gradient is the sum of the
    ranks' gradients (every rank's loss is a part of the global one)."""
    if _STEP is None:
        return t
    return _SumOverRanks.apply(t, _STEP.data_group)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order (no gradient): an all-reduce
    of the rows placed in zeros, which gloo runs on CUDA tensors too."""
    if _STEP is None:
        return t
    n = t.shape[0]
    kind = t.dtype
    work = t.detach().to(torch.int32 if kind == torch.bool else kind)
    out = work.new_zeros((n * _STEP.data,) + tuple(t.shape[1:]))
    out[batch_rows(_STEP, n * _STEP.data)] = work
    dist.all_reduce(out, group=_STEP.data_group)
    return out.to(kind)


def all_true(t: torch.Tensor) -> bool:
    """Whether ``t`` is all true on every rank (one host read)."""
    if _STEP is None:
        return bool(t.all())
    return int(global_sum(torch.logical_not(t).sum())) == 0


@torch.no_grad()
def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """The counterpart of ``jit_sharded_train_step`` (mesh.py:79-101): the
    gradient of every leaf of ``params`` summed over the data axis, in
    place, one flat buffer a dtype.  Every trainer's update comes through
    here, so every rank then steps on the global gradient."""
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in tree_leaves(params)
             if isinstance(p, torch.Tensor) and p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.data_group)
        off = 0
        for g in group:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()
