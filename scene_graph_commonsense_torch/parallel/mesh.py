"""The ('data', 'model') mesh over torch.distributed (torch port of
scene_graph_commonsense_tpu/parallel/mesh.py).

The JAX package lays one program over a ('data', 'model') device mesh and
reduces gradients with `pmean` inside shard_map.  Here each process is one
rank of an initialised process group (NCCL on the card, gloo on the CPU).
Rank r sits at data index r // model and model index r % model, the order
of the JAX package's reshape(data, model):

  * axis 'data'  - batch sharding: a rank takes the rows of its data index
    of every global batch; the flagship train step averages the gradients
    with one all-reduce over the data group, the ranks that share its model
    index (train.engine.make_train_step), or, as its global-batch step and
    the plug-and-play step (train.pnp_engine.make_pnp_train_step) do, sums
    the gradients of its share of the global batch's losses (global_losses),
    and the eval steps and the detector concatenate the data group's
    outputs;
  * axis 'model' - tensor parallelism over the model group, the ranks that
    share its data index: the relation head's fc1 and fc2_h are split over
    it (parallel/tp.py) and everything else is replicated; the paths
    without TP layers repeat the data shard's work on every rank of the
    model group, as the JAX package's shard_map over 'data' does.

One difference from the JAX package: a JAX mesh may leave spare devices out
of its data axis, but a launched process cannot sit idle, so the mesh must
fill the world.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from scene_graph_commonsense_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: the axis sizes, the global rank, the
    device its weights live on, the data group (the ranks that share its
    model index; None: the default group, right where model == 1) and the
    model group (the ranks that share its data index; None where
    model == 1)."""
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        """The axis sizes by name, as jax.sharding.Mesh.shape reads."""
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis: its shard of a batch."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's index on the model axis: its shard of fc1 and
        fc2_h."""
        return self.rank % self.model


def world_size() -> int:
    """The size of the initialised default group, else 1."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of this rank: cuda without an index means the card of the
    rank's local index (torchrun's LOCAL_RANK) among the visible ones."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(data: int = -1, model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The ('data', 'model') mesh over the initialised process group;
    data=-1 uses every process.  `device` (default cuda) is where this
    rank's weights live.  With model > 1 every rank builds every data and
    model group (dist.new_group, called in the same order on each rank)
    and keeps its own two."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call init_multihost (or launch with torchrun)")
    n = dist.get_world_size()
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if data * model < n:
        raise ValueError(
            f"mesh {data}x{model} leaves {n - data * model} of {n} "
            f"processes without a shard: a launched process cannot sit out "
            f"the data axis, so launch {data * model} processes")
    rank = dist.get_rank()
    data_group = model_group = None
    if model > 1:
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if i == rank // model:
                model_group = g
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == rank % model:
                data_group = g
    return Mesh(data, model, rank, _rank_device(device, rank), data_group,
                model_group)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: DeviceLike = None,
                   backend: Optional[str] = None) -> int:
    """Initialises the default process group and returns this process's
    rank.  The rendezvous is `coordinator_address` (an init method URL,
    tcp://host:port or file://path; a bare host:port means tcp) with
    `num_processes` and `process_id`, or else torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  A no-op returning the
    rank when a group is already up, and returning 0 for a single process
    with neither set.  The backend follows the device (default cuda): NCCL
    on cuda, gloo on the CPU; `backend` overrides it (gloo's CUDA path puts
    several ranks on one card, which NCCL refuses)."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes is None \
            and "WORLD_SIZE" not in os.environ:
        return 0
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = coordinator_address or "env://"
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", -1))
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_device(dev, max(rank, 0)))
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=num_processes if num_processes is not None else -1,
        rank=rank)
    return dist.get_rank()


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of a global batch: the contiguous block
    [i * b, (i + 1) * b) of every array, tensor or list, i the data index,
    b = rows / data, which is what the JAX package's P('data') sharding
    places on the devices of the i-th data index.  Other entries pass through.  Raises when the data axis
    does not divide an entry's rows."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, tuple)) or (
                isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0):
            rows = len(v)
            if rows % mesh.data:
                raise ValueError(
                    f"batch entry {k!r} has {rows} rows, which the data "
                    f"axis of {mesh.data} does not divide")
            b = rows // mesh.data
            i = mesh.data_index
            v = v[i * b:(i + 1) * b]
        out[k] = v
    return out


@torch.no_grad()
def replicate_tree(mesh: Mesh, tree: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Broadcasts every tensor of `tree` in place, so that every rank
    starts bit-identical; returns the tree.  A tensor is rank 0's, over
    every rank; a TP shard (a tensor with a `tp_dim`, parallel/tp.py) is
    that of the rank at data index 0 with its model index, over its data
    group."""
    for t in tree.values():
        if getattr(t, "tp_dim", None) is not None and mesh.model > 1:
            dist.broadcast(t.detach(), src=mesh.model_index,
                           group=mesh.data_group)
        else:
            dist.broadcast(t.detach(), src=0)
    return tree


def all_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the data group, in place: one all-reduce."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return t


def all_mean_(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the data group, in place: one all-reduce (sum), then
    the division by the axis size, as jax.lax.pmean over 'data'
    computes it."""
    return all_sum_(mesh, flat).div_(mesh.data)


def global_total(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The data group's sum of `t`, detached (a copy; `t` is left as it is): the
    global count, or sum, of a quantity of which each rank holds its rows'
    share."""
    return all_sum_(mesh, t.detach().clone())


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's `obj` (anything picklable) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_rows(mesh: Mesh, tree: Dict[str, Optional[torch.Tensor]]
                    ) -> Dict[str, Optional[torch.Tensor]]:
    """The data group's tensors of `tree` concatenated along the first
    axis in data-index order, each in its own dtype (the JAX package's
    out_specs=P('data')); None entries pass through."""
    out = {}
    for k, t in tree.items():
        if t is not None:
            parts = [torch.empty_like(t) for _ in range(mesh.data)]
            dist.all_gather(parts, t.contiguous(),
                            group=mesh.data_group)
            t = torch.cat(parts)
        out[k] = t
    return out


def exclusive_prefix(mesh: Mesh, counts: torch.Tensor) -> List[int]:
    """From one all-gather of `counts` (a 1-D integer tensor, this rank's
    count of each of a few things) over the data group: per entry, the sum
    of the counts of the ranks before this one in data-index order (its
    offset in the global enumeration), on the host."""
    parts = [torch.empty_like(counts) for _ in range(mesh.data)]
    dist.all_gather(parts, counts.contiguous(), group=mesh.data_group)
    return torch.stack(parts[:mesh.data_index] + [torch.zeros_like(counts)]) \
        .sum(0).tolist()


class _GatherRows(torch.autograd.Function):
    """all_gather_rows of one tensor with a gradient: the forward
    concatenates the data group's blocks in data-index order; the backward
    is the reduce-scatter of the gathered rows' gradient, every rank's
    gradient of this rank's block summed (one all-reduce of the whole
    gradient, then this rank's block: a collective that gloo runs on CUDA
    tensors too, and the rows are few)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(t) for _ in range(mesh.data)]
        dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = all_sum_(mesh, grad.contiguous().clone())
        return grad.chunk(mesh.data)[mesh.data_index], None


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The data group's blocks of `t` (equal shapes) concatenated along the
    first axis in data-index order, differentiable: this rank's block sits
    at rows [data_index * len(t), (data_index + 1) * len(t))."""
    return _GatherRows.apply(t, mesh)


class GlobalTotals:
    """A step's `total` (train/losses.py) over a mesh: the data group's
    sums of every denominator of its losses in one all-reduce.  A first
    pass over the losses (without gradients) records each denominator and
    returns it as it is; reduce() sums them all, flattened into one buffer
    in their widest dtype; the second pass reads the sums in the same
    order, each in its shape and dtype."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.seen: List[torch.Tensor] = []
        self.sums: Optional[List[torch.Tensor]] = None
        self.read = 0

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.sums is None:
            self.seen.append(t.detach())
            return t
        self.read += 1
        return self.sums[self.read - 1].to(t.dtype)

    def reduce(self) -> None:
        dtype = self.seen[0].dtype
        for t in self.seen[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        flat = all_sum_(self.mesh, torch.cat(
            [t.reshape(-1).to(dtype) for t in self.seen]))
        self.sums = [s.view_as(t) for s, t in zip(
            flat.split([t.numel() for t in self.seen]), self.seen)]


def global_losses(mesh: Mesh, losses: Callable[[GlobalTotals], Any]) -> Any:
    """`losses(total)` with every denominator the data group's sum, so that
    what it returns is this rank's share of the global batch's losses
    (shares that sum to them): computed once without gradients to collect
    the denominators, which travel in one all-reduce, then again, with
    gradients, over their sums."""
    totals = GlobalTotals(mesh)
    with torch.no_grad():
        losses(totals)
    totals.reduce()
    return losses(totals)
