"""The process mesh and its sharding rules over torch.distributed.

Port of `stgcma_tpu/runtime/mesh.py`. A 2-D mesh of processes ('data',
'model'), one card a process (or one CPU process under gloo):

- 'data': each rank runs its rows of the global batch (`shard_batch`); the
  server all-gathers the outputs over 'data', the Trainer all-reduces the
  masters' gradients (`MultiTaskServer`, `train/loop.py::Trainer`);
- 'model': Megatron's column / row split of the tower's big linears
  (`param_spec`), as storage. The tower's hand-written kernels take whole
  operands, as a Pallas custom call does under XLA's partitioner, so each
  rank stores 1/model of every split leaf (`shard_params`), and the leaf is
  all-gathered over the 'model' group each time a module reads it; the
  gathered copy lives as long as that read (a `torch.nn.utils.parametrize`
  parametrization does both). Compute stays replicated over 'model'.

Train-time draws and batch statistics follow the global batch: inside
`data_parallel(mesh)` (the Trainer's step) a draw for the rows a rank holds
is made for the whole global batch from the shared generator and sliced to
those rows (`draw_rows`, `draw_items`), the waveform mixup sees the global
batch (`gather_rows`), and a train-mode BatchNorm sums its statistics over
'data' (`sum_rows`, differentiable), so a mesh step computes the step of one
process on the whole batch.

`init_distributed` brings the processes up from explicit arguments or the
environment: NCCL where CUDA is available, gloo on the CPU, and never the
one in place of the other.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, local_device_ids=None) -> bool:
    """Bring up torch.distributed before any collective. Sources, the first
    that is set wins for each field:
      1. the arguments;
      2. STGCMA_COORDINATOR ("host:port"), STGCMA_NUM_PROCESSES and
         STGCMA_PROCESS_ID;
      3. STGCMA_DISTRIBUTED=1: `env://`, torchrun's MASTER_ADDR,
         MASTER_PORT, WORLD_SIZE and RANK.
    Returns False with none of them (one process, no group), True once the
    group is up; a second call is a no-op that returns True. The backend is
    NCCL where CUDA is available, gloo otherwise; this process's card is
    local_device_ids[0], else LOCAL_RANK, else the rank modulo the cards."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("STGCMA_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _int_env(
        "STGCMA_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("STGCMA_PROCESS_ID")
    if coordinator is None and os.environ.get("STGCMA_DISTRIBUTED") != "1":
        return False
    if coordinator is not None and (num_processes is None or process_id is None):
        raise ValueError("a coordinator needs num_processes and process_id "
                         "(STGCMA_NUM_PROCESSES, STGCMA_PROCESS_ID)")
    cuda = torch.cuda.is_available()
    if cuda:
        if local_device_ids is not None:
            dev = int(list(local_device_ids)[0])
        elif "LOCAL_RANK" in os.environ:
            dev = int(os.environ["LOCAL_RANK"])
        else:
            rank = process_id if coordinator is not None else int(os.environ.get("RANK", 0))
            dev = rank % torch.cuda.device_count()
        torch.cuda.set_device(dev)
    backend = "nccl" if cuda else "gloo"
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def make_mesh(data: int = -1, model: int = 1, devices=None):
    """A ('data', 'model') DeviceMesh over the ranks `devices` (all of the
    group's, in order, by default); data=-1 takes every rank the model
    extent leaves. Needs `init_distributed` first."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    ranks = np.asarray(devices if devices is not None else range(dist.get_world_size()))
    n = ranks.size
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return DeviceMesh("cuda" if torch.cuda.is_available() else "cpu",
                      torch.as_tensor(ranks.reshape(data, model)),
                      mesh_dim_names=("data", "model"))


def extent(mesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


# ---------------------------------------------------------------------------
# parameter sharding rules (Megatron layout for the transformer cores)
# ---------------------------------------------------------------------------

_COL_SPLIT = ("qkv", "fc1", "c_fc", "in_proj", "D_fc1")     # out-dim over 'model'
_ROW_SPLIT = ("proj", "fc2", "c_proj", "out_proj", "D_fc2")  # in-dim over 'model'


def param_spec(name: str, leaf) -> Optional[int]:
    """The dim of a leaf (dotted name) split over 'model', or None where it
    is replicated: JAX's rules on the port's names and layout. A linear's
    `weight` / `weight_q` (out, in) is JAX's `kernel` / `kernel_q` (in,
    out), so JAX's column split P(None, 'model') of the out dim is dim 0
    here and its row split P('model', None) dim 1. Leaves of other than two
    dims are replicated."""
    if getattr(leaf, "ndim", 0) != 2:
        return None
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] not in ("weight", "weight_q"):
        return None
    if parts[-2] in _COL_SPLIT:
        return 0
    if parts[-2] in _ROW_SPLIT:
        return 1
    return None


class _Gathered(nn.Module):
    """The parametrization of a split leaf: this rank stores its shard; a
    read all-gathers the shards over the 'model' group along `dim`."""

    def __init__(self, dim: int, group, world: int):
        super().__init__()
        self.dim, self.group, self.world = dim, group, world

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(shard) for _ in range(self.world)]
        dist.all_gather(parts, shard.contiguous(), group=self.group)
        return torch.cat(parts, dim=self.dim)

    def __deepcopy__(self, memo):       # a copy shares the process group
        return _Gathered(self.dim, self.group, self.world)


def _leaves(model: nn.Module):
    """(module name, module, leaf name, tensor) of every parameter and
    buffer."""
    for mod_name, mod in model.named_modules():
        for slots in (mod._parameters, mod._buffers):
            for leaf, t in list(slots.items()):
                if t is not None:
                    yield mod_name, mod, leaf, t


def _full_name(mod_name: str, leaf: str) -> str:
    return f"{mod_name}.{leaf}" if mod_name else leaf


def replicate(model: nn.Module, mesh) -> nn.Module:
    """In place: every parameter and buffer takes the values of the mesh's
    first rank, so all ranks hold one copy."""
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) != dist.get_world_size():
        raise ValueError("the mesh must cover every rank of the process group")
    with torch.no_grad():
        for _, _, _, t in _leaves(model):
            dist.broadcast(t.data, src=ranks[0])
    return model


def shard_params(model: nn.Module, mesh, names: Optional[Iterable[str]] = None) -> nn.Module:
    """In place: every leaf (or those `names` gives) that `param_spec`
    splits, where its dim divides by the 'model' extent, kept as this rank's
    1/model shard behind a gathering parametrization (`mod.<leaf>` still
    reads the whole leaf; `mod.parametrizations.<leaf>.original` is the
    shard). `replicate` first, so that the shards come from one copy."""
    keep = None if names is None else set(names)
    m = extent(mesh, "model")
    group = mesh.get_group("model")
    idx = dist.get_rank(group)
    for mod_name, mod, leaf, t in list(_leaves(model)):
        name = _full_name(mod_name, leaf)
        dim = param_spec(name, t)
        if (keep is not None and name not in keep) or dim is None or t.shape[dim] % m:
            continue
        shard = t.detach().chunk(m, dim)[idx].clone()
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(shard, requires_grad=t.requires_grad)
        else:
            mod._buffers[leaf] = shard
        parametrize.register_parametrization(mod, leaf, _Gathered(dim, group, m), unsafe=True)
    return model


_ORIGINAL = re.compile(r"(.*)parametrizations\.([^.]+)\.original$")


def gathered_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict under its unsharded names, each split leaf
    gathered (a collective: every rank of the 'model' group calls it)."""
    out = {}
    for k, v in model.state_dict().items():
        hit = _ORIGINAL.match(k)
        if hit:
            prefix, leaf = hit.groups()
            mod = model.get_submodule(prefix.rstrip(".")) if prefix else model
            out[prefix + leaf] = getattr(mod, leaf).detach()
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the batch over 'data'
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows over 'data': block `index` of `count` equal blocks."""
    index: int
    count: int
    group: object

    def rows(self, n_local: int) -> slice:
        return slice(self.index * n_local, (self.index + 1) * n_local)


def batch_sharding(mesh) -> RowShard:
    group = mesh.get_group("data")
    return RowShard(dist.get_rank(group), extent(mesh, "data"), group)


def shard_batch(batch, mesh):
    """This rank's block of the leading (batch) axis of every array or
    tensor of `batch`; the leading dim must divide by the 'data' extent."""
    s = batch_sharding(mesh)

    def cut(x):
        n = x.shape[0]
        if n % s.count:
            raise ValueError(f"leading dim {n} does not divide the mesh's data extent "
                             f"{s.count}")
        return x[s.rows(n // s.count)]

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(cut(v) for v in batch)


_SHARD: contextvars.ContextVar = contextvars.ContextVar("stgcma_row_shard", default=None)


@contextlib.contextmanager
def data_parallel(mesh):
    """Inside the block, this process holds its rows of a global batch: the
    helpers below draw and reduce over the whole of it."""
    token = _SHARD.set(batch_sharding(mesh))
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[RowShard]:
    return _SHARD.get()


def draw_rows(draw: Callable, shape) -> torch.Tensor:
    """draw(shape) for the rows this process holds: drawn for the global
    batch (leading dim times the 'data' extent) and sliced to this rank's
    block, so the generator moves as in one process."""
    s = _SHARD.get()
    if s is None:
        return draw(tuple(shape))
    n = shape[0]
    return draw((n * s.count,) + tuple(shape[1:]))[s.rows(n)]


def draw_items(draw_one: Callable, n: int) -> List:
    """[draw_one() for each of this rank's n rows], drawn for every row of
    the global batch in order and sliced."""
    s = _SHARD.get()
    if s is None:
        return [draw_one() for _ in range(n)]
    return [draw_one() for _ in range(n * s.count)][s.rows(n)]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of x's rows (not differentiable)."""
    s = _SHARD.get()
    if s is None:
        return x
    parts = [torch.empty_like(x) for _ in range(s.count)]
    dist.all_gather(parts, x.contiguous(), group=s.group)
    return torch.cat(parts)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global batch's rows."""
    s = _SHARD.get()
    return x if s is None else x[s.rows(x.shape[0] // s.count)]


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """x summed over the 'data' group, differentiably (the backward sums
    the gradients over the group): a per-rank partial sum of the batch
    becomes the global batch's."""
    s = _SHARD.get()
    return x if s is None else _SumOverGroup.apply(x, s.group)


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient:
    each rank's loss depends on every rank's partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None




def mean_over_data(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """In place: each tensor replaced by its mean over the 'data' group (one
    all-reduce of their concatenation, so every rank ends with the same
    bits). Returns the tensors."""
    group, n = mesh.get_group("data"), extent(mesh, "data")
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    ofs = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[ofs:ofs + t.numel()].view(t.shape))
            ofs += t.numel()
    return tensors
