"""Resource manager over a process group, and the port's collectives
(counterpart of hugectr_tpu/core/mesh.py: `ResourceManager` :38,
`init_distributed` :166).

The JAX package builds one device mesh in one process and XLA inserts the
collectives. The port runs one process per device (a rank): each rank
joins one `torch.distributed` process group (`init_distributed`; NCCL for
CUDA, gloo for the CPU), and `ResourceManager` holds the rank's device and
the group's size, which is the data-parallel size of the JAX mesh
(`data_parallel_size`, mesh.py:122). With no group the manager is one
device, as before.

Every collective of the port is here: `all_gather` and `reduce_scatter`
(tiled on dim 0, as `jax.lax.all_gather(tiled=True)` and
`jax.lax.psum_scatter(tiled=True)`), `all_reduce` (sum, `jax.lax.psum`) and
`broadcast` (rank 0's tensor on every rank; the JAX package needs none, as
XLA's replicated computations give equal bits). At world size 1 they are identities and need no group. gloo is a host
backend: a CUDA tensor under gloo goes through an explicit host copy here
(W ranks sharing one card); NCCL never stages, and a CPU tensor under NCCL
raises. No collective changes backend. `COLLECTIVE_CALLS` counts each
collective's calls and `COLLECTIVE_BYTES` adds up the bytes of the whole
buffer it covers on this rank (the all-gathered output, the
reduce-scattered input, the all-reduced or broadcast tensor); a ring moves (W - 1) / W
of that into and out of each rank (twice for all_reduce).

Not ported: the hierarchical ("dcn", "ici") mesh (`num_slices` > 1,
mesh.py:82; ROADMAP Queue 1 item 1g) and column-wise sharding
(`ev_parallelism`).
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]

# torch 2.13 renamed the tiled collectives (`*_into_tensor`/`*_tensor` are
# deprecated aliases of `*_single`); the name is chosen once, here
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
COLLECTIVE_BYTES: collections.Counter = collections.Counter()
COLLECTIVE_CALLS: collections.Counter = collections.Counter()
COLLECTIVE_NAMES = {"all_gather": _ALL_GATHER.__name__, "reduce_scatter": _REDUCE_SCATTER.__name__,
                    "all_reduce": "all_reduce", "broadcast": "broadcast"}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. A CUDA device without CUDA raises; the CPU is
    only taken when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        # fp32 math stays fp32: the reference runs fp32 GEMMs and the port is
        # compared with it in fp32 (TF32 keeps only ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None and group_size() > 1:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_distributed(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
) -> None:
    """Join this process to the group of ranks (mesh.py:166). Arguments not
    given come from torchrun's environment (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, and `MASTER_ADDR`/`MASTER_PORT` through the default
    `env://`). The backend is NCCL where CUDA is available and gloo on the
    CPU; gloo with CUDA runs ranks that share cards (their collectives are
    staged through the host). With CUDA the rank's card is
    `torch.cuda.set_device(LOCAL_RANK)` (under gloo, modulo the cards)."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        torch.cuda.set_device(local_rank if backend == "nccl" else local_rank % n)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(minutes=10),
    )


def group_size() -> int:
    """Ranks in the initialised group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def group_rank() -> int:
    return dist.get_rank() if group_size() > 1 else 0


def backend() -> Optional[str]:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def _count(name: str, nbytes: int) -> None:
    COLLECTIVE_BYTES[name] += nbytes
    COLLECTIVE_CALLS[name] += 1


def _staged(op, t: torch.Tensor) -> torch.Tensor:
    """op(t) on the group's backend. gloo is a host backend: a CUDA tensor
    travels through a host copy and comes back to its device. NCCL takes
    device tensors only."""
    b = backend()
    if b == "gloo" and t.is_cuda:
        return op(t.cpu()).to(t.device)
    if b == "nccl" and not t.is_cuda:
        raise RuntimeError("the NCCL group takes CUDA tensors; this one is on the CPU")
    return op(t)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """[n, ...] on every rank -> [W * n, ...], rank r's rows at [r * n,
    (r + 1) * n) (`jax.lax.all_gather(..., tiled=True)`)."""
    w = group_size()
    if w == 1:
        return t

    def op(x):
        out = x.new_empty((w * x.shape[0], *x.shape[1:]))
        _ALL_GATHER(out, x.contiguous())
        return out

    _count("all_gather", w * t.numel() * t.element_size())
    return _staged(op, t)


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """[W * n, ...] on every rank -> the sum over ranks of rows [r * n,
    (r + 1) * n) on rank r (`jax.lax.psum_scatter(..., tiled=True)`)."""
    w = group_size()
    if w == 1:
        return t
    if t.shape[0] % w:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not split over {w} ranks")

    def op(x):
        out = x.new_empty((x.shape[0] // w, *x.shape[1:]))
        _REDUCE_SCATTER(out, x.contiguous(), op=dist.ReduceOp.SUM)
        return out

    _count("reduce_scatter", t.numel() * t.element_size())
    return _staged(op, t)


def _in_place(name: str, op, t: torch.Tensor) -> torch.Tensor:
    """op(x) in place on a contiguous `t`, or on its host copy under gloo,
    copied back; returns `t`."""
    if group_size() == 1:
        return t
    _count(name, t.numel() * t.element_size())
    out = _staged(op, t)
    if out is not t:
        t.copy_(out)
    return t


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, in place in `t` (contiguous), returned
    (`jax.lax.psum`)."""
    def op(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    return _in_place("all_reduce", op, t)


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` (contiguous) on every rank, in place, returned."""
    def op(x):
        dist.broadcast(x, src=0)
        return x

    return _in_place("broadcast", op, t)


class ResourceManager:
    """The rank's device and the group's size (mesh.py:38 `ResourceManager`,
    :50 `create`). `num_devices` and `data_parallel_size` are the world
    size; `local_world_size` the ranks on this host (torchrun's
    `LOCAL_WORLD_SIZE`)."""

    def __init__(self, device: torch.device, rank: int = 0, world_size: int = 1,
                 local_world_size: Optional[int] = None):
        self.device = device
        self.rank = rank
        self.world_size = world_size
        self.local_world_size = local_world_size or world_size

    @classmethod
    def create(
        cls, num_devices: int = 0, device: DeviceLike = None, num_slices: int = 1
    ) -> "ResourceManager":
        """Over the initialised group (`init_distributed`), or one device
        without one; `num_devices` other than 0 must be the group's size."""
        if num_slices > 1:
            raise NotImplementedError(
                "a hierarchical mesh (num_slices > 1) is not ported yet (ROADMAP Queue 1 item 1g)"
            )
        w = group_size()
        if num_devices not in (0, w):
            raise ValueError(
                f"num_devices={num_devices}, but the process group has {w} rank(s): one device per "
                "rank; start the ranks with init_distributed() (torchrun, or tools/hybrid.py)"
            )
        local = int(os.environ.get("LOCAL_WORLD_SIZE", w))
        return cls(resolve_device(device), group_rank(), w, min(local, w))

    @property
    def num_devices(self) -> int:
        return self.world_size

    @property
    def data_parallel_size(self) -> int:
        return self.world_size

    def is_master_process(self) -> bool:
        return self.rank == 0

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the rank's device, seeded alike on every rank."""
        return torch.Generator(device=self.device).manual_seed(int(seed))
