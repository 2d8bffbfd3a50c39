"""Resource manager over a process group, its meshes, and the port's
collectives (counterpart of hugectr_tpu/core/mesh.py: `ResourceManager`
:38, `create` :50-93, the mesh facts :96-143, `init_distributed` :166).

The JAX package builds one device mesh in one process and XLA inserts the
collectives. The port runs one process per device (a rank): each rank
joins one `torch.distributed` process group (`init_distributed`; NCCL for
CUDA, gloo for the CPU), and `ResourceManager` holds the rank's device and
its place in one of the JAX package's three meshes over the W ranks, rank r
where JAX's reshape of the devices puts device r:

* flat, ("data",): rank r at data index r;
* ("data", "ev") with `ev_parallelism` e: rank r at (r // e, r % e); the
  batch and the model-parallel rows are split over "data" only (W / e
  blocks), each block replicated over the e ranks of "ev";
* ("dcn", "ici") with `num_slices` d, slice size I = W / d: rank r at
  (r // I, r % I); the batch is split over both axes (data index r).

The rank's sub-groups (`Group`): its data group (the ranks of its ev index:
every rank on the flat and hierarchical meshes), its ev group (the e
replicas of its batch block), its ICI group (the I ranks of its slice) and
its DCN group (the d ranks at its position in their slices). Every rank
creates every sub-group of its mesh, in one order, in `create`.

Every collective of the port is here: `all_gather` and `reduce_scatter`
(tiled on dim 0, as `jax.lax.all_gather(tiled=True)` and
`jax.lax.psum_scatter(tiled=True)`), `all_to_all` (even splits of dim 0,
`jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`),
`all_reduce` (sum, `jax.lax.psum`; `all_reduce_autograd` is the same sum
under autograd) and `broadcast` (one rank's tensor on every rank of a
group; the JAX package needs none, as XLA's replicated computations give
equal bits). Each takes the `Group` it runs over; without one it runs over
the data group of the last `ResourceManager` made (`data_group()`: the
data axes, as the JAX package's collectives name `rm.data_axes`). Over one
rank they are identities. `hier_reduce_scatter` and `hier_all_gather` are
the two-level exchange of a hierarchical mesh (ICI first, then DCN;
collection.py:391-423) and its transpose.

A bfloat16 (or float16) `reduce_scatter` or `all_reduce` gives the float32
sum of every rank's part, rounded once to the tensor's type, the same on
every rank whatever the placement, as JAX's `psum_scatter` and `psum` do:
an `all_to_all` of the 16-bit blocks, a float32 sum of the W blocks in rank
order and one rounding on each rank, and for `all_reduce` an `all_gather`
of the rounded blocks (16-bit on the wire, the bytes of a ring). A backend's
own 16-bit reduction rounds after every add, in an order of its own.

Every collective takes float32, bfloat16 and integer tensors alike,
through NCCL and through gloo. gloo is a host backend: a CUDA tensor under
gloo goes through an explicit host copy here (W ranks sharing one card);
NCCL never stages, and a CPU tensor under NCCL raises. Under NCCL every
collective is one fixed-shape device op, so a step's collectives capture
into its CUDA graph (`Model._replay`); `gather_ints` is the uncounted
all-gather the ranks agree by outside a step. `COLLECTIVE_CALLS`
counts each collective's calls and `COLLECTIVE_BYTES` adds up the bytes of
the whole buffer it covers on this rank (the all-gathered output, the
reduce-scattered input, the all-to-all's input, the all-reduced or
broadcast tensor) at its element size (2 bytes for bfloat16); a ring moves
(W - 1) / W of that into and out of each rank (twice for all_reduce). A
collective over a sub-group of a mesh level is counted under its level:
`reduce_scatter_ici`, `all_gather_dcn`, `broadcast_ev`.
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple, Union

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
                    "all_to_all": "all_to_all_single", "all_reduce": "all_reduce", "broadcast": "broadcast"}
# the dtypes whose sums over ranks are taken in float32 and rounded once
_ROUND_ONCE = (torch.bfloat16, torch.float16)


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
    `torch.cuda.set_device(LOCAL_RANK)` (under gloo, modulo the cards).
    An NCCL group is bound to that card (`device_id`): its communicator,
    and each sub-group's made from it by `create`, exists from the start,
    never first made inside a captured step."""
    global _DATA_GROUP
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    bound = {}
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        torch.cuda.set_device(local_rank if backend == "nccl" else local_rank % n)
        if backend == "nccl":
            bound["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(minutes=10), **bound,
    )
    _PROCESS_GROUPS.clear()  # sub-groups of an earlier group are gone
    _DATA_GROUP = None


def group_size() -> int:
    """Ranks in the initialised group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def group_rank() -> int:
    return dist.get_rank() if group_size() > 1 else 0


def backend() -> Optional[str]:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


class Group:
    """Ranks of the process group that a collective runs over, in the order
    of their blocks, and this rank's position among them; `level` names the
    mesh level in the counters ("" for the data axes)."""

    def __init__(self, ranks: Sequence[int], level: str = ""):
        self.ranks = tuple(ranks)
        self.level = level
        self.size = len(self.ranks)
        self.index = self.ranks.index(group_rank()) if group_rank() in self.ranks else -1
        self.pg = _process_group(self.ranks)

    def name(self, op: str) -> str:
        return f"{op}_{self.level}" if self.level else op


# process groups of sub-groups by their ranks; every rank creates every one
# in the same order (`torch.distributed.new_group` asks it of every rank)
_PROCESS_GROUPS: Dict[Tuple[int, ...], object] = {}
_DATA_GROUP: Optional[Group] = None


def _process_group(ranks: Tuple[int, ...]):
    """The process group of `ranks`: None (the default group) for all of
    them; a sub-group is made once."""
    if len(ranks) == group_size():
        return None
    if ranks not in _PROCESS_GROUPS:
        _PROCESS_GROUPS[ranks] = dist.new_group(list(ranks))
    return _PROCESS_GROUPS[ranks]


def data_group() -> Group:
    """The data axes of the last `ResourceManager` made (every rank without
    one)."""
    return _DATA_GROUP if _DATA_GROUP is not None else Group(range(group_size()))


def _group(group: Optional[Group]) -> Group:
    return data_group() if group is None else group


def data_size() -> int:
    """The ranks of the data axes: the batch blocks."""
    return data_group().size


def data_rank() -> int:
    """This rank's batch block."""
    return max(data_group().index, 0)


def gather_ints(value: int) -> list:
    """`value` of every rank of the process group, in rank order, by one
    all-gather that the counters leave out (on the rank's card under NCCL):
    what the ranks agree on outside a step, such as a capture's shapes."""
    if group_size() == 1:
        return [int(value)]
    dev = torch.device("cuda", torch.cuda.current_device()) if backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = t.new_empty(group_size())
    _ALL_GATHER(out, t)
    return out.cpu().tolist()


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


def _gather(t: torch.Tensor, g: Group) -> torch.Tensor:
    def op(x):
        out = x.new_empty((g.size * x.shape[0], *x.shape[1:]))
        _ALL_GATHER(out, x.contiguous(), group=g.pg)
        return out

    return _staged(op, t)


def _exchange(t: torch.Tensor, g: Group) -> torch.Tensor:
    def op(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=g.pg)
        return out

    return _staged(op, t)


def _sum_blocks_once(t: torch.Tensor, g: Group) -> torch.Tensor:
    """[size * n, ...] 16-bit on every rank -> the float32 sum over the
    group's ranks of rows [i * n, (i + 1) * n) on rank i, in rank order,
    rounded once to the tensor's type."""
    recv = _exchange(t, g).reshape(g.size, -1, *t.shape[1:])
    acc = recv[0].float()
    for s in range(1, g.size):
        acc += recv[s].float()
    return acc.to(t.dtype)


def all_gather(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """[n, ...] on every rank -> [size * n, ...], the group's i-th rank's
    rows at [i * n, (i + 1) * n) (`jax.lax.all_gather(..., tiled=True)`)."""
    g = _group(group)
    if g.size == 1:
        return t
    _count(g.name("all_gather"), g.size * t.numel() * t.element_size())
    return _gather(t, g)


def reduce_scatter(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """[size * n, ...] on every rank -> the sum over the group of rows [i *
    n, (i + 1) * n) on its i-th rank (`jax.lax.psum_scatter(...,
    tiled=True)`); 16-bit sums in float32, rounded once."""
    g = _group(group)
    if g.size == 1:
        return t
    if t.shape[0] % g.size:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not split over {g.size} ranks")
    _count(g.name("reduce_scatter"), t.numel() * t.element_size())
    if t.dtype in _ROUND_ONCE:
        return _sum_blocks_once(t, g)

    def op(x):
        out = x.new_empty((x.shape[0] // g.size, *x.shape[1:]))
        _REDUCE_SCATTER(out, x.contiguous(), op=dist.ReduceOp.SUM, group=g.pg)
        return out

    return _staged(op, t)


def all_to_all(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """[size * n, ...] on every rank -> [size * n, ...] whose rows [s * n,
    (s + 1) * n) are the group's s-th rank's rows [i * n, (i + 1) * n) on
    its i-th rank (`jax.lax.all_to_all(..., split_axis=0, concat_axis=0,
    tiled=True)`)."""
    g = _group(group)
    if g.size == 1:
        return t
    if t.shape[0] % g.size:
        raise ValueError(f"all_to_all: {t.shape[0]} rows do not split over {g.size} ranks")
    _count(g.name("all_to_all"), t.numel() * t.element_size())
    return _exchange(t, g)


def _in_place(name: str, op, t: torch.Tensor, g: Group) -> torch.Tensor:
    """op(x) in place on a contiguous `t`, or on its host copy under gloo,
    copied back; returns `t`."""
    if g.size == 1:
        return t
    _count(g.name(name), t.numel() * t.element_size())
    out = _staged(op, t)
    if out is not t:
        t.copy_(out)
    return t


def all_reduce(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The sum over the group, in place in `t` (contiguous), returned
    (`jax.lax.psum`); 16-bit sums in float32, rounded once: the flat tensor
    padded to a multiple of the group's size, reduce-scattered so, and the
    rounded blocks all-gathered."""
    g = _group(group)
    if g.size > 1 and t.dtype in _ROUND_ONCE:
        _count(g.name("all_reduce"), t.numel() * t.element_size())
        flat = t.reshape(-1)
        n = flat.numel()
        pad = flat.new_zeros((-n) % g.size)
        summed = _gather(_sum_blocks_once(torch.cat([flat, pad]), g), g)
        t.copy_(summed[:n].view_as(t))
        return t

    def op(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g.pg)
        return x

    return _in_place("all_reduce", op, t, g)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data axes of a tensor each rank computed; its
    gradient on each rank is the sum of the gradients (every rank's loss
    reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone())


def all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    """`all_reduce` as a new tensor that autograd differentiates (the
    batch statistics of PReLU_Dice over the data axes); `t` itself over one
    rank."""
    return t if data_size() == 1 else _AllReduceSum.apply(t)


def broadcast(t: torch.Tensor, src: int = 0, group: Optional[Group] = None) -> torch.Tensor:
    """Rank `src`'s `t` (contiguous) on every rank of `group`, in place,
    returned. `src` is a rank of the whole process group."""
    g = _group(group)

    def op(x):
        dist.broadcast(x, src=src, group=g.pg)
        return x

    return _in_place("broadcast", op, t, g)


def hier_reduce_scatter(t: torch.Tensor, rm: "ResourceManager") -> torch.Tensor:
    """The two-level reduce-scatter of [B, ...] partials over a
    hierarchical mesh (collection.py:391-423): the blocks reordered slice
    index last, (d, I, ...) -> (I, d, ...), reduce-scattered over the ICI
    group, then over the DCN group, which carries 1 / I of the volume.
    Rank (s, i) ends with block s * I + i, as the flat reduce-scatter
    leaves it; in 16 bits each level rounds once."""
    d, i = rm.num_slices, rm.slice_size
    rows = t.shape[0] // (d * i)
    u = t.reshape(d, i, rows, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
    return reduce_scatter(reduce_scatter(u, rm.ici_group), rm.dcn_group)


def hier_all_gather(t: torch.Tensor, rm: "ResourceManager") -> torch.Tensor:
    """The transpose of `hier_reduce_scatter`: [b, ...] on every rank ->
    [d * I * b, ...] in rank order, by an all-gather over the DCN group,
    then over the ICI group, and the inverse of the reordering."""
    d, i = rm.num_slices, rm.slice_size
    u = all_gather(all_gather(t, rm.dcn_group), rm.ici_group)
    return u.reshape(i, d, t.shape[0], *t.shape[1:]).transpose(0, 1).reshape(d * i * t.shape[0], *t.shape[1:])


class ResourceManager:
    """The rank's device and its place in the mesh (mesh.py:38
    `ResourceManager`, :50 `create`, :96-143 the mesh facts).
    `num_devices` is the world size W, `data_parallel_size` the batch
    blocks (W / e on the ("data", "ev") mesh), `local_world_size` the ranks
    on this host (torchrun's `LOCAL_WORLD_SIZE`). The sub-groups are made
    by `create` (none without a process group: a manager made by its
    constructor makes no collective)."""

    def __init__(self, device: torch.device, rank: int = 0, world_size: int = 1,
                 local_world_size: Optional[int] = None, ev_parallelism: int = 1, num_slices: int = 1):
        if ev_parallelism > 1 and num_slices > 1:
            raise ValueError("ev_parallelism and num_slices are exclusive")
        for what, f in (("ev_parallelism", ev_parallelism), ("num_slices", num_slices)):
            if f > 1 and world_size % f:
                raise ValueError(f"num_devices={world_size} not divisible by {what}={f}")
        self.device = device
        self.rank = rank
        self.world_size = world_size
        self.local_world_size = local_world_size or world_size
        self.ev_parallelism = ev_parallelism
        self._num_slices = num_slices
        self.data_group: Optional[Group] = None
        self.ev_group: Optional[Group] = None
        self.ici_group: Optional[Group] = None
        self.dcn_group: Optional[Group] = None

    @classmethod
    def create(
        cls, num_devices: int = 0, device: DeviceLike = None, num_slices: int = 1, ev_parallelism: int = 1,
    ) -> "ResourceManager":
        """Over the initialised group (`init_distributed`), or one device
        without one; `num_devices` other than 0 must be the group's size.
        Makes the mesh's sub-groups and sets the data axes as the
        collectives' default."""
        global _DATA_GROUP
        w = group_size()
        if num_devices not in (0, w):
            raise ValueError(
                f"num_devices={num_devices}, but the process group has {w} rank(s): one device per "
                "rank; start the ranks with init_distributed() (torchrun, or tools/hybrid.py)"
            )
        local = int(os.environ.get("LOCAL_WORLD_SIZE", w))
        rm = cls(resolve_device(device), group_rank(), w, min(local, w), ev_parallelism, num_slices)
        r = rm.rank
        if rm.ev_parallel_size > 1:
            e, n = rm.ev_parallel_size, rm.data_parallel_size
            data = [Group(range(j, w, e)) for j in range(e)]
            evs = [Group(range(b * e, (b + 1) * e), "ev") for b in range(n)]
            rm.data_group, rm.ev_group = data[r % e], evs[r // e]
        else:
            rm.data_group = Group(range(w))
        if rm.is_hierarchical:
            d, i = rm.num_slices, rm.slice_size
            icis = [Group(range(s * i, (s + 1) * i), "ici") for s in range(d)]
            dcns = [Group(range(j, w, i), "dcn") for j in range(i)]
            rm.ici_group, rm.dcn_group = icis[r // i], dcns[r % i]
        _DATA_GROUP = rm.data_group
        return rm

    # ---- mesh facts (mesh.py:96-143)
    @property
    def num_devices(self) -> int:
        return self.world_size

    @property
    def is_hierarchical(self) -> bool:
        return self._num_slices > 1

    @property
    def data_axes(self):
        """The mesh axes of the batch: "data", or ("dcn", "ici")."""
        return ("dcn", "ici") if self.is_hierarchical else "data"

    @property
    def num_slices(self) -> int:
        return self._num_slices

    @property
    def slice_size(self) -> int:
        return self.world_size // self._num_slices if self.is_hierarchical else self.data_parallel_size

    @property
    def data_parallel_size(self) -> int:
        return self.world_size // self.ev_parallelism

    @property
    def ev_parallel_size(self) -> int:
        return self.ev_parallelism

    @property
    def data_index(self) -> int:
        """This rank's batch block (and model-parallel shard position)."""
        return self.rank // self.ev_parallelism

    @property
    def ev_index(self) -> int:
        return self.rank % self.ev_parallelism

    def replica_group(self, f: int) -> Tuple[int, Optional[Group]]:
        """(the lowest rank, the group) of the ranks that hold the same
        storage as this rank under f shards: the ranks whose data index
        equals this rank's modulo f, over every ev index ((W / e) / f x e
        of them; a partial placement's replicas and the ev replicas).
        (0, None) when one rank holds it. The first call for an f makes
        the groups of all f shards on every rank, in order, so every rank
        calls this with the same f's in the same order."""
        n, e = self.data_parallel_size, self.ev_parallelism
        if n % f:
            raise ValueError(f"{f} shards do not divide {n} ranks")
        if n // f * e == 1:
            return self.rank, None
        groups = [Group([r for r in range(self.world_size) if (r // e) % f == c]) for c in range(f)]
        mine = groups[self.data_index % f]
        return mine.ranks[0], mine

    def is_master_process(self) -> bool:
        return self.rank == 0

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the rank's device, seeded alike on every rank."""
        return torch.Generator(device=self.device).manual_seed(int(seed))
