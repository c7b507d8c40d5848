"""Process groups, the (data, model) mesh and the state layouts
(unite_tpu/parallel/mesh.py).

The reference trains under ``torchrun`` with DDP over NCCL
(utils.py:510-551 init_distributed_mode); unite_tpu carries that as a mesh
of devices with layout annotations. Here each process drives one card:

* ``init_distributed`` sets up the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``), the backend from --dist_backend (NCCL on the card,
  gloo on the CPU when left at its default) and the init method from
  --dist_url; rank r takes ``cuda:LOCAL_RANK``. A run that torchrun did not
  launch and that asks for no layout keeps no process group (one process,
  the single-card path); one that asks for --zero1 or --fsdp gets a
  one-process group. A failed rendezvous or backend raises.
* The mesh is (data, model): rank = data_index * tp + model_index, so the
  model axis is minor and a tensor-parallel group is ``tp`` consecutive
  ranks, which never straddle a host since --tp must divide the local world
  size (unite_tpu/train/common.py:57-60).
* ``state_layout`` is the one-stop switch of unite_tpu's ``state_layout``,
  with its precedence (--fsdp with --tp downgrades to ZeRO-1 moments):
  DDP; ZeRO-1 moments on JAX's rule (each moment split over the data axis
  along its first divisible dim, ``zero1_dim``; the updated slices
  broadcast after each step); FSDP2 ``fully_shard`` per block, then the
  root, over params, EMA and moments; Megatron tensor parallelism over the
  model axis (``tensor_parallel_``: column-parallel ``attn.qkv`` and
  ``mlp.fc1``, row-parallel ``attn.proj`` and ``mlp.fc2``; everything else
  replicated), under DDP over the data axis.

Every layout keeps a rule for each parameter and moment: how this rank's
piece lies in the full tensor. Checkpoints gather full tensors through the
rules (a collective) and load by slicing them, so a checkpoint written under
any layout at any world size loads into any other.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


@dataclass
class Mesh:
    """This process's place in the run. ``backend`` None: no process group
    (one process, no collectives)."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1
    tp: int = 1
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    data_group: object = None   # None: the default (world) group
    model_group: object = None  # None when tp == 1

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


_MESH = Mesh()
_GROUPS: Dict[int, tuple] = {}  # tp -> (data group, model group)


def current() -> Mesh:
    return _MESH


def _backend(args, dev: torch.device) -> str:
    """--dist_backend; its schema default ("ici", the JAX package's) and an
    empty value mean NCCL on the card, gloo on the CPU."""
    name = getattr(args, "dist_backend", None)
    if not name or name == "ici":
        return "nccl" if dev.type == "cuda" else "gloo"
    return name


def _groups(tp: int, world: int):
    """(data group, model group) of this rank for ``tp`` ways; every rank
    creates every group, in the same order."""
    if tp == 1:
        return None, None
    if tp not in _GROUPS:
        mine_d = mine_m = None
        rank = dist.get_rank()
        for m in range(tp):
            g = dist.new_group(list(range(m, world, tp)))
            if rank % tp == m:
                mine_d = g
        for d in range(world // tp):
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if rank // tp == d:
                mine_m = g
        _GROUPS[tp] = (mine_d, mine_m)
    return _GROUPS[tp]


def init_distributed(args, device=None) -> Mesh:
    """Set up (or reuse) the process group and the mesh for ``args``; returns
    the mesh, whose ``device`` is the one this rank trains on (CUDA unless
    ``device`` says otherwise)."""
    global _MESH
    tp = int(getattr(args, "tp", 1) or 1)
    launched = "WORLD_SIZE" in os.environ
    if launched and "RANK" not in os.environ:
        if int(os.environ["WORLD_SIZE"]) > 1:
            raise RuntimeError(
                f"WORLD_SIZE {os.environ['WORLD_SIZE']} without RANK in the "
                "environment: launch the entry with torchrun")
        launched = False
    if launched:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        args.world_size = world  # the reference's init_distributed_mode
    else:
        world, rank, local_rank = 1, 0, 0
        local_world = 1
        if int(getattr(args, "world_size", 1) or 1) > 1:
            raise RuntimeError(
                f"--world_size {args.world_size} without RANK and WORLD_SIZE "
                "in the environment: launch the entry with torchrun")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if tp > 1 and (world % tp or local_world % tp):
        raise ValueError(f"--tp {tp} must divide the local world size "
                         f"({local_world}) and the world size ({world})")
    asks = tp > 1 or getattr(args, "zero1", False) or getattr(
        args, "fsdp", False)
    if not launched and not asks:
        _MESH = Mesh(device=dev)
        return _MESH
    backend = _backend(args, dev)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} rank "
                f"{dist.get_rank()} exists; this run is world {world} rank "
                f"{rank}")
        backend = dist.get_backend()
    elif launched:
        dist.init_process_group(
            backend, init_method=getattr(args, "dist_url", None) or "env://",
            world_size=world, rank=rank,
            **({"device_id": dev} if backend == "nccl" else {}))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    data_group, model_group = _groups(tp, world)
    _MESH = Mesh(world=world, rank=rank, local_rank=local_rank,
                 local_world=local_world, tp=tp, backend=backend, device=dev,
                 data_group=data_group, model_group=model_group)
    return _MESH


def shutdown() -> None:
    """Destroy the process group (the end of a launched entry)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    _MESH = Mesh(device=_MESH.device)


def process_count() -> int:
    return _MESH.world


def process_index() -> int:
    return _MESH.rank


def is_main_process() -> bool:
    return _MESH.rank == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous shard of the global batch."""
    per = global_batch // _MESH.world
    start = per * _MESH.rank
    return slice(start, start + per)


def barrier() -> None:
    if _MESH.distributed:
        dist.barrier()


def gather_objects(obj, group=None) -> list:
    """``obj`` of every member of ``group`` (the data group by default), in
    rank order; ``[obj]`` without a process group."""
    if not _MESH.distributed:
        return [obj]
    group = group if group is not None else _MESH.data_group
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_sum(values: Sequence[float]) -> List[float]:
    """Float64 sums of ``values`` over every rank."""
    if not _MESH.distributed:
        return [float(v) for v in values]
    dev = _MESH.device if _MESH.backend == "nccl" else torch.device("cpu")
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return t.cpu().tolist()


# ------------------------------------------------------------------ rules


def _world_group(group):
    return group if group is not None else dist.group.WORLD


def sum_over_groups(tensors: Sequence[torch.Tensor],
                    groups: Sequence[object]) -> List[torch.Tensor]:
    """Each tensor summed elementwise over the ranks of its group (None:
    the world): one ``all_reduce`` a group, of its tensors flattened into
    one fp32 buffer. Returns new tensors in the inputs' shapes and
    dtypes."""
    by_group: Dict[int, tuple] = {}
    for i, g in enumerate(groups):
        by_group.setdefault(id(g), (g, []))[1].append(i)
    out = list(tensors)
    for group, idx in by_group.values():
        flat = torch.cat([tensors[i].reshape(-1).float() for i in idx])
        dist.all_reduce(flat, group=group)
        o = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[o:o + t.numel()].view(t.shape).to(t.dtype)
            o += t.numel()
    return out


def gather_pieces(local: torch.Tensor, shapes, group) -> List[torch.Tensor]:
    """Every member's piece of a tensor, in member order, each sent by one
    broadcast (gloo on CUDA tensors has broadcasts but no reduce-scatter,
    and the pieces may differ in size)."""
    group = _world_group(group)
    me = dist.get_rank(group)
    out = []
    for i, shape in enumerate(shapes):
        buf = (local.contiguous() if i == me else
               torch.empty(shape, dtype=local.dtype, device=local.device))
        if buf.numel():
            dist.broadcast(buf, src=dist.get_global_rank(group, i),
                           group=group)
        out.append(buf)
    return out


class Replicated:
    """The whole tensor on every rank."""

    def local(self, full):
        return full

    def full(self, local):
        return local.clone()


class Split:
    """Consecutive pieces of ``sizes`` along ``dim``, piece i on member i of
    ``group``; this rank holds piece ``index``."""

    def __init__(self, dim: int, sizes: Sequence[int], group, index: int):
        self.dim, self.sizes = dim, list(sizes)
        self.group, self.index = group, index
        self.start = sum(self.sizes[:index])

    def local(self, full):
        return full.narrow(self.dim, self.start, self.sizes[self.index])

    def positions(self, n: int):
        """(positions along ``dim`` of this piece's ``n`` entries in the
        whole tensor, the whole tensor's length along ``dim``)."""
        return (torch.arange(self.start, self.start + n), sum(self.sizes))

    def full(self, local):
        shapes = []
        for n in self.sizes:
            s = list(local.shape)
            s[self.dim] = n
            shapes.append(s)
        return torch.cat(gather_pieces(local, shapes, self.group), self.dim)


class HeadSplit:
    """A packed qkv weight [3*H*D, C] split by heads: member i holds
    [3, H/ways, D, C] of the [3, H, D, C] view, as [3*(H/ways)*D, C], the
    packed layout the attention kernels take; the checkpoint keeps the
    unsharded [3C, C]."""

    dim = 0

    def __init__(self, ways: int, group, index: int):
        self.ways, self.group, self.index = ways, group, index

    def local(self, full):
        return full.reshape(3, self.ways, -1)[:, self.index].reshape(
            -1, *full.shape[1:])

    def positions(self, n: int):
        """(positions of this piece's ``n`` rows in the whole tensor, its
        number of rows): a block of rows in each of q, k and v."""
        full = n * self.ways
        return (torch.arange(full).reshape(3, self.ways, -1)[:, self.index]
                .reshape(-1), full)

    def full(self, local):
        pieces = gather_pieces(local, [local.shape] * self.ways, self.group)
        return torch.cat([p.reshape(3, 1, -1) for p in pieces], 1).reshape(
            -1, *local.shape[1:])


def even_sizes(n: int, ways: int) -> List[int]:
    return [n // ways] * ways


def fsdp_sizes(n: int, ways: int) -> List[int]:
    """FSDP2's dim-0 pieces: ceil(n / ways) each, the last ones shorter or
    empty (torch.chunk, padded with empties)."""
    per = -(-n // ways)
    return [max(0, min(per, n - i * per)) for i in range(ways)]


def zero1_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The ZeRO-1 moment rule (unite_tpu mesh.py:199-215): the first dim
    whose size is a multiple of ``n`` (and at least ``n``), or None to
    replicate."""
    for dim, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return dim
    return None


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (FSDP's parameters and gradients), without
    importing ``torch.distributed.tensor`` (a second) when nothing has."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local_tensor(t):
    """This rank's piece of ``t``: a DTensor's local shard, else ``t``."""
    return t.to_local() if is_dtensor(t) else t


# -------------------------------------------------------- tensor parallel


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, sum of the gradient over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelAxis:
    """A module's share of the model axis: ``ways`` ranks in ``group``, this
    one at ``index``."""

    def __init__(self, group, ways: int, index: int):
        self.group, self.ways, self.index = group, ways, index

    def copy_in(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce_out(self, x):
        return _ReduceFromModel.apply(x, self.group)

    def part(self, t, dim: int = 0):
        n = t.shape[dim] // self.ways
        return t.narrow(dim, self.index * n, n)


def _shard_param(module: nn.Module, attr: str, rule, group) -> None:
    old = getattr(module, attr)
    p = nn.Parameter(rule.local(old.detach()).clone(),
                     requires_grad=old.requires_grad)
    p.tp_group = group  # the group its gradient norm is summed over
    setattr(module, attr, p)


def tensor_parallel_(model: nn.Module, mesh: Mesh) -> Dict[str, object]:
    """Shard ``model``'s blocks over the model axis in place, Megatron's
    column/row split (unite_tpu ``_TP_COLUMN`` / ``_TP_ROW``): ``attn.qkv``
    by heads and ``mlp.fc1`` by output rows (column-parallel), ``attn.proj``
    and ``mlp.fc2`` by input columns (row-parallel, one sum over the model
    group each); biases and everything else stay replicated. An attention
    whose heads, or an MLP whose hidden width, do not divide by --tp stays
    whole. Returns the rules of the sharded parameters by name."""
    from unite_torch.models.layers import Attention, Mlp

    tp, group, idx = mesh.tp, mesh.model_group, mesh.tp_rank
    axis = ModelAxis(group, tp, idx)
    rules: Dict[str, object] = {}

    def shard(prefix, module, attr, rule):
        _shard_param(module, attr, rule, group)
        rules[f"{prefix}{attr}"] = rule

    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Attention) and mod.num_heads % tp == 0:
            shard(f"{pre}qkv.", mod.qkv, "weight", HeadSplit(tp, group, idx))
            width = mod.proj.weight.shape[1]
            shard(f"{pre}proj.", mod.proj, "weight",
                  Split(1, even_sizes(width, tp), group, idx))
            mod.tp = axis
            mod.proj.tp, mod.proj.tp_mode = axis, "row"
        elif isinstance(mod, Mlp) and mod.fc1.weight.shape[0] % tp == 0:
            hidden = mod.fc1.weight.shape[0]
            shard(f"{pre}fc1.", mod.fc1, "weight",
                  Split(0, even_sizes(hidden, tp), group, idx))
            shard(f"{pre}fc2.", mod.fc2, "weight",
                  Split(1, even_sizes(hidden, tp), group, idx))
            mod.fc1.tp, mod.fc1.tp_mode = axis, "col"
            mod.fc2.tp, mod.fc2.tp_mode = axis, "row"
    return rules


# ----------------------------------------------------------------- layouts


class Layout:
    """How a model's training state lies over the ranks: the module a step
    calls (``net``: the model, or its DDP wrapper), and the rule of each
    parameter (``param_rules``) and of the optimizer's piece of it, which
    every state tensor shaped like the parameter follows (``moment_rules``;
    ZeRO-1's moments keep ``zero1`` slices (dim, start, size) of replicated
    parameters). The default is one process: the model
    itself, every rule ``Replicated``."""

    def __init__(self, model: nn.Module, net: Optional[nn.Module] = None,
                 name: str = "single", mesh: Optional[Mesh] = None,
                 param_rules: Optional[Dict] = None,
                 zero1: Optional[Dict] = None):
        self.model, self.net = model, net if net is not None else model
        self.name = name
        self.mesh = mesh if mesh is not None else Mesh()
        self.param_rules = dict(param_rules or {})
        self.zero1 = dict(zero1 or {})  # name -> (dim, start, size)
        by_name = dict(model.named_parameters())
        self._zero1_of = {by_name[n]: z for n, z in self.zero1.items()}
        self.moment_rules = dict(self.param_rules)
        for n, (dim, _, size) in self.zero1.items():
            full = by_name[n].shape[dim]
            self.moment_rules[n] = Split(dim, even_sizes(full, full // size),
                                         self.mesh.data_group,
                                         self.mesh.dp_rank)
        self._splits = {}
        for n, rule in self.moment_rules.items():
            if isinstance(rule, (Split, HeadSplit)):
                p = by_name[n]
                pos, full = rule.positions(self.part(p, p).shape[rule.dim])
                self._splits[p] = (rule.dim, pos, full, rule.group)

    @property
    def distributed(self) -> bool:
        return self.mesh.distributed

    def part(self, p, t):
        """The piece of ``t`` (``p`` itself, its gradient, or a tensor of its
        shape) whose update this rank computes."""
        t = local_tensor(t)
        z = self._zero1_of.get(p)
        return t.narrow(*z) if z is not None else t

    def split_of(self, p):
        """How the piece of ``p`` that this rank's optimizer holds lies in
        the whole tensor: (dim, positions along it, the whole length, the
        group of ranks that hold the pieces), or None for the whole tensor.
        A statistic over a whole tensor is summed over that group."""
        return self._splits.get(p)

    def attach(self, optimizer):
        """Point ``optimizer`` at this rank's pieces (ZeRO-1 slices, FSDP
        shards, tensor-parallel shards) and, under ZeRO-1, the broadcast of
        the updated slices."""
        if self.distributed:
            optimizer.part = self.part
            optimizer.split = self.split_of
            optimizer.sync = self.sync_zero1 if self.zero1 else None
        return optimizer

    def sync_zero1(self, params) -> None:
        """Broadcast the ZeRO-1 slices each member updated into every other
        member's parameters: one packed buffer a member and dtype."""
        group = _world_group(self.mesh.data_group)
        leaves = [(p, self._zero1_of[p]) for p in params
                  if p in self._zero1_of]
        if not leaves:
            return
        me = dist.get_rank(group)
        with torch.no_grad():
            for i in range(dist.get_world_size(group)):
                by_dtype: Dict[torch.dtype, list] = {}
                for p, (dim, _, size) in leaves:
                    by_dtype.setdefault(p.dtype, []).append(
                        p.narrow(dim, i * size, size))
                for dtype, views in by_dtype.items():
                    if i == me:
                        buf = torch.cat([v.reshape(-1) for v in views])
                    else:
                        buf = torch.empty(sum(v.numel() for v in views),
                                          dtype=dtype, device=views[0].device)
                    dist.broadcast(buf, src=dist.get_global_rank(group, i),
                                   group=group)
                    if i != me:
                        o = 0
                        for v in views:
                            v.copy_(buf[o:o + v.numel()].view(v.shape))
                            o += v.numel()

    def named_parameters(self) -> List[tuple]:
        """The model's parameters as the optimizer holds them. An FSDP root
        keeps its unsharded parameters registered after a forward without a
        backward (an evaluation); they are resharded first."""
        if self.name == "fsdp":
            from torch.distributed.fsdp import FSDPModule

            for m in self.model.modules():
                if isinstance(m, FSDPModule):
                    m.reshard()
        return list(self.model.named_parameters())

    # ----- full tensors (collective when distributed) and their pieces

    def full_param(self, name: str, local):
        return self.param_rules.get(name, Replicated()).full(local)

    def local_param(self, name: str, full):
        return self.param_rules.get(name, Replicated()).local(full)

    def full_moment(self, name: str, local):
        return self.moment_rules.get(name, Replicated()).full(local)

    def local_moment(self, name: str, full):
        return self.moment_rules.get(name, Replicated()).local(full)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every tensor whole (copies)."""
        self.named_parameters()  # an FSDP root's shards registered
        return {k: self.full_param(k, local_tensor(v).detach())
                for k, v in self.model.state_dict().items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a whole state dict (any layout's checkpoint) into this
        rank's pieces."""
        if not self.distributed:
            self.model.load_state_dict(state)
            return
        self.named_parameters()  # an FSDP root's shards registered
        own = self.model.state_dict()
        missing, extra = set(own) - set(state), set(state) - set(own)
        if missing or extra:
            raise RuntimeError(f"state dict keys differ: missing "
                               f"{sorted(missing)}, unexpected "
                               f"{sorted(extra)}")
        with torch.no_grad():
            for k, v in own.items():
                mine = local_tensor(v)
                mine.copy_(self.local_param(k, state[k].to(mine.device)))


def _blocks(model: nn.Module) -> List[nn.Module]:
    from unite_torch.models.layers import Block

    return [m for m in model.modules() if isinstance(m, Block)]


def _ddp(model: nn.Module, mesh: Mesh):
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=([mesh.device.index] if mesh.device.type == "cuda"
                           else None),
        process_group=mesh.data_group, broadcast_buffers=False,
        # blocks above the last tap (stage 1) and the CLIP decoders
        # (stage 3) take no part in some steps
        find_unused_parameters=True)


def plan_layout(model: nn.Module, mesh: Mesh, tp: int = 1,
                zero1: bool = False, fsdp: bool = False):
    """(name, param rules, ZeRO-1 slices) of a layout, with ``model``
    sharded in place where the layout shards it (tensor parallelism, FSDP);
    unite_tpu's precedence: --fsdp with --tp downgrades to ZeRO-1 moments."""
    rules: Dict[str, object] = {}
    if tp > 1:
        if fsdp:
            print("[mesh] --fsdp with --tp: params/EMA stay sharded by the "
                  "TP rules only; full-state data-axis sharding downgrades "
                  "to ZeRO-1 moment sharding (expect TP-level, not "
                  "world-level, per-chip state memory)", flush=True)
        zero1 = zero1 or fsdp
        rules = tensor_parallel_(model, mesh)
        name = "tp+zero1" if zero1 else "tp"
    elif fsdp:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        dmesh = init_device_mesh(mesh.device.type, (mesh.world,),
                                 mesh_dim_names=("data",))
        for block in _blocks(model):
            fully_shard(block, mesh=dmesh)
        fully_shard(model, mesh=dmesh)
        rules = {n: Split(0, fsdp_sizes(p.shape[0], mesh.dp),
                          mesh.data_group, mesh.dp_rank)
                 for n, p in model.named_parameters()}
        name, zero1 = "fsdp", False
    else:
        name = "zero1" if zero1 else "ddp"
    z1 = {}
    if zero1:
        for n, p in model.named_parameters():
            dim = None if n in rules else zero1_dim(p.shape, mesh.dp)
            if dim is not None:
                size = p.shape[dim] // mesh.dp
                z1[n] = (dim, mesh.dp_rank * size, size)
    return name, rules, z1


def state_layout(model: nn.Module, tp: int = 1, zero1: bool = False,
                 fsdp: bool = False) -> Layout:
    """The entries' one-stop layout (unite_tpu ``state_layout``): one
    process (no process group), DDP, DDP with ZeRO-1 moments, FSDP, or
    tensor parallelism under DDP (with ZeRO-1 moments when asked, or when
    --fsdp is asked with it). Shards ``model`` in place where the layout
    does; build the optimizer after this, from ``model``'s parameters."""
    mesh = current()
    if not mesh.distributed:
        return Layout(model)
    if tp != mesh.tp:
        raise ValueError(f"--tp {tp} but the mesh was set up for {mesh.tp}")
    name, rules, z1 = plan_layout(model, mesh, tp, zero1, fsdp)
    net = model if name == "fsdp" else _ddp(model, mesh)
    return Layout(model, net, name, mesh, rules, z1)
