"""Data-parallel mesh over torch.distributed (torch port of
scene_graph_commonsense_tpu/parallel/mesh.py).

The JAX package lays one program over a ('data', 'model') device mesh and
reduces gradients with `pmean` inside shard_map.  Here each process is one
rank of an initialised process group (NCCL on the card, gloo on the CPU),
holds one replica of the weights and takes its rows of every global batch:

  * axis 'data'  - batch sharding; the flagship train step averages the
    gradients with one all-reduce over the group (train.engine.
    make_train_step), the plug-and-play step sums the gradients of its
    global losses (train.pnp_engine.make_pnp_train_step), and the eval
    steps and the detector concatenate every rank's outputs;
  * axis 'model' - tensor parallelism (the JAX package's parallel/tp.py),
    not yet ported: make_mesh refuses model > 1.

One difference from the JAX package: a JAX mesh may leave spare devices out
of its data axis, but a launched process cannot sit idle, so the data axis
must fill the world.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from scene_graph_commonsense_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel group: the axis sizes, the
    rank (its index on the data axis), the device its replica lives on and
    the process group (None: the default group)."""
    data: int
    model: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        """The axis sizes by name, as jax.sharding.Mesh.shape reads."""
        return {"data": self.data, "model": self.model}


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
    rank's replica runs."""
    if model > 1:
        raise NotImplementedError(
            "tensor parallelism (parallel/tp.py) is not yet ported; the "
            "mesh's model axis must be 1")
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
    return Mesh(data, model, rank, _rank_device(device, rank))


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
    [rank * b, (rank + 1) * b) of every array, tensor or list, b = rows /
    data, which is what the JAX package's P('data') sharding places on the
    rank-th device.  Other entries pass through.  Raises when the data axis
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
            v = v[mesh.rank * b:(mesh.rank + 1) * b]
        out[k] = v
    return out


@torch.no_grad()
def replicate_tree(mesh: Mesh, tree: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Broadcasts every tensor of `tree` from rank 0, in place, so that
    every rank starts bit-identical; returns the tree."""
    for t in tree.values():
        dist.broadcast(t.detach(), src=0, group=mesh.group)
    return tree


def all_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the group, in place: one all-reduce."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_mean_(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the group, in place: one all-reduce (sum), then the
    division by the axis size, as jax.lax.pmean computes it."""
    return all_sum_(mesh, flat).div_(mesh.data)


def global_total(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The group's sum of `t`, detached (a copy; `t` is left as it is): the
    global count, or sum, of a quantity of which each rank holds its rows'
    share."""
    return all_sum_(mesh, t.detach().clone())


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's `obj` (anything picklable) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def all_gather_rows(mesh: Mesh, tree: Dict[str, Optional[torch.Tensor]]
                    ) -> Dict[str, Optional[torch.Tensor]]:
    """Every rank's tensors of `tree` concatenated along the first axis in
    rank order, each in its own dtype (the JAX package's out_specs=
    P('data')); None entries pass through."""
    out = {}
    for k, t in tree.items():
        if t is not None:
            parts = [torch.empty_like(t) for _ in range(mesh.data)]
            dist.all_gather(parts, t.contiguous(), group=mesh.group)
            t = torch.cat(parts)
        out[k] = t
    return out
