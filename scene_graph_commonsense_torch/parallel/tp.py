"""Tensor parallelism for the relation head's wide layers (torch port of
scene_graph_commonsense_tpu/parallel/tp.py).

The relation head is ~290M parameters, dominated by fc1 (65536 x 4096 at
VG widths).  The JAX package shards fc1 and fc2_h over the mesh's 'model'
axis with Megatron layouts and lets GSPMD insert the collectives; here the
collectives are written out, over the mesh's model group
(parallel/mesh.py):

  fc1:    column-parallel (output rows of the (out, in) weight and the bias
          split): each rank computes its 4096/model hidden columns from
          the replicated input, whose gradient is all-reduced in the
          backward (copy_to_model);
  fc2_h:  row-parallel (input columns of the weight split): each rank's
          partial product is all-reduced in the forward (reduce_from_model)
          and the replicated bias is added once, after the reduce;
  everything else replicated, fc2_h's bias included.

Torch's nn.Linear.weight is (out, in), the transpose of flax's kernel, so
the split dims are the transposes of the JAX package's PartitionSpecs.
`shard_module` splits a RelationClassifier's parameters in place and marks
the module, whose forward then runs the collectives
(models/relation_head.py); `shard_params` and `gather_params` map a state
dict to this rank's shards and back.

Two recipes for a (data, model) mesh, as in the JAX package:
  * make_train_step(mesh=) shards the model in place (build the TrainState
    after it) and steps on each rank's rows of the global batch with the
    losses of those rows, the gradients averaged over 'data': the JAX
    package's shard_map step, which its fit and CLI run;
  * make_train_step(mesh=, global_batch=True) computes the losses of the
    whole global batch, each rank its share, the gradients summed over
    'data': the JAX package's parallel/tp.py recipe, shard_params and the
    mesh-less step on a P('data') batch (the GSPMD step), equal to the
    unsharded step on the global batch.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

# state-dict name suffix (module, leaf) -> the PartitionSpec of the torch
# layout: the axis name at the split dim, None elsewhere
_TP_RULES = {
    ("fc1", "weight"): ("model", None),
    ("fc1", "bias"): ("model",),
    ("fc2_h", "weight"): (None, "model"),
}


def partition_spec_for_path(name: str) -> Tuple[Optional[str], ...]:
    """The spec of a state-dict name (a dotted path): () is replicated."""
    parts = name.split(".")
    for (mod, leaf), spec in _TP_RULES.items():
        if mod in parts and parts[-1] == leaf:
            return spec
    return ()


def shard_dim(name: str) -> Optional[int]:
    """The dim of `name` split over the model axis, None if replicated."""
    spec = partition_spec_for_path(name)
    return spec.index("model") if "model" in spec else None


def param_shardings(tree: Mapping[str, torch.Tensor]
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The spec of every entry of a state dict under TP."""
    return {k: partition_spec_for_path(k) for k in tree}


def _block(t: torch.Tensor, dim: int, model: int, index: int
           ) -> torch.Tensor:
    size = t.shape[dim]
    if size % model:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"the model axis of {model}")
    w = size // model
    return t.narrow(dim, index * w, w)


def shard_params(tree: Mapping[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's view of a full state dict: the contiguous block of the
    mesh's model index along each split dim (what the JAX package's
    NamedSharding places on that device), a copy; replicated entries pass
    through."""
    out = {}
    for k, t in tree.items():
        dim = shard_dim(k)
        if dim is not None and mesh.model > 1:
            t = _block(t, dim, mesh.model, mesh.model_index).contiguous() \
                .clone()
        out[k] = t
    return out


def gather_params(tree: Mapping[str, torch.Tensor], mesh
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of shard_params: every split entry all-gathered over
    the model group and concatenated along its dim (a collective: every
    rank of the model group calls it); replicated entries pass through
    (detached)."""
    out = {}
    for k, t in tree.items():
        t = t.detach()
        dim = shard_dim(k)
        if dim is not None and mesh.model > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            t = torch.cat(parts, dim)
        out[k] = t
    return out


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Splits the model's fc1 and fc2_h parameters in place (each keeps its
    Parameter object and gains a `tp_dim` attribute) and sets the module's
    `tp_mesh`, so that its forward runs the collectives over the mesh's
    model group.  Idempotent on its own mesh; a no-op where model == 1.
    Returns the model."""
    current = getattr(model, "tp_mesh", None)
    if mesh is None or mesh.model <= 1 or current is mesh:
        return model
    if current is not None:
        raise ValueError("the model is already sharded over another mesh")
    for k, p in model.named_parameters():
        dim = shard_dim(k)
        if dim is not None:
            p.data = _block(p.data, dim, mesh.model, mesh.model_index) \
                .contiguous().clone()
            p.tp_dim = dim
    model.tp_mesh = mesh
    return model


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's unsharded state dict (gather_params over its model
    group where it is sharded: a collective), detached."""
    sd = model.state_dict()
    mesh = getattr(model, "tp_mesh", None)
    return sd if mesh is None else gather_params(sd, mesh)


def load_full_state_dict(model: torch.nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> None:
    """Loads an unsharded state dict into the model, sharded or not."""
    mesh = getattr(model, "tp_mesh", None)
    model.load_state_dict(state_dict if mesh is None
                          else shard_params(state_dict, mesh))


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient all-reduced over the model group
    (the input of a column-parallel layer: each rank's shard contributes
    its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The all-reduce over the model group forward (the partial products
    of a row-parallel layer); the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def is_shard(t: torch.Tensor) -> bool:
    """Whether `t` is a parameter that shard_module split."""
    return getattr(t, "tp_dim", None) is not None


def global_sum_squares(mesh, params: Mapping[str, torch.Tensor],
                       squares: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The sum of every parameter's squared gradient norm (`squares`, 0-dim
    per name) over the unsharded model: the shards' sum all-reduced over
    the model group, the replicated ones counted once."""
    rep = [v for k, v in squares.items() if not is_shard(params[k])]
    part = torch.stack([v for k, v in squares.items()
                        if is_shard(params[k])]).sum()
    dist.all_reduce(part, group=mesh.model_group)
    return torch.stack(rep).sum() + part


def mean_replicated_grads_(mesh, params: Mapping[str, torch.Tensor],
                           grads: Dict[str, torch.Tensor]) -> None:
    """Averages, in place, the gradients of the replicated parameters over
    the model group, in one all-reduce of their sum in their widest dtype.
    Every rank of the group computes them from the same replicated
    activations, so the mean is their value (to the bit for a model axis of
    2, to its rounding above); it keeps the replicas bit-identical where a
    kernel's atomics make two ranks' gradients differ in the last bit."""
    names = [k for k in grads if not is_shard(params[k])]
    if mesh.model <= 1 or not names:
        return
    dtype = grads[names[0]].dtype
    for k in names[1:]:
        dtype = torch.promote_types(dtype, grads[k].dtype)
    flat = torch.cat([grads[k].reshape(-1).to(dtype) for k in names])
    dist.all_reduce(flat, group=mesh.model_group)
    flat.div_(mesh.model)
    off = 0
    for k in names:
        g = grads[k]
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
