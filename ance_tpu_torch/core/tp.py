"""Tensor (model-axis) parallelism for the encoder, on ``torch.distributed``.

Counterpart of ``ance_tpu/core/tp.py``. The JAX package annotates parameter
shardings over a 2-D ``(data, model)`` mesh and lets XLA's partitioner
insert the collectives; PyTorch has no partitioner, so here each rank holds
its slice of the parameters and the encoder layers run Megatron's forward
over the model axis themselves (``models/transformer.py``).

Layout (Megatron-LM §3), by the port's state-dict names:

  * column-parallel: ``attention.self.{query,key,value}`` and
    ``intermediate.dense``, split on ``nn.Linear``'s output rows (dim 0),
    their biases alike: each rank computes its heads and its slice of the
    MLP's width, with no communication;
  * row-parallel: ``attention.output.dense`` and ``output.dense``, split on
    the input columns (dim 1): each rank's product is a partial sum, summed
    over the model axis before the (replicated) bias is added once;
  * everything else replicated: embeddings, LayerNorms, ``embeddingHead``,
    ``norm``, the DPR towers' heads.

The autograd rule is Megatron's pair of operators: *f*
(:func:`copy_to_model`, identity forward, all-reduce backward) in front of
each column-parallel block, and *g* (:func:`reduce_from_model`, all-reduce
forward, identity backward) after each row-parallel product. A reduction
whose backward reduces again (``torch.distributed.nn.functional.
all_reduce``) would multiply every replicated parameter's gradient by tp.

``num_heads`` and ``intermediate_size`` must divide by tp, and the
attention must be ``xla`` or ``xla_bf16`` (:func:`validate_tp`), as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from ance_tpu_torch.core.mesh import DataMesh, rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_COLUMN = (".attention.self.query.", ".attention.self.key.",
           ".attention.self.value.", ".intermediate.dense.")
_ROW = (".attention.output.dense.", ".output.dense.")


def make_mesh_2d(model: int, data: Optional[int] = None, *, device
                 ) -> tuple[DataMesh, DataMesh]:
    """This rank's place in a ``(data, model)`` grid of the job's ranks:
    rank r sits at data ``r // model``, model ``r % model``, so neighbouring
    ranks share a model group (the JAX mesh's layout). Returns (the data
    axis, the model axis), each a :class:`DataMesh` over its own process
    group, on this rank's card of ``device``. Collective: every rank calls
    it, and makes every group in one order."""
    if not dist.is_initialized():
        raise ValueError("make_mesh_2d needs the job's process group "
                         "(core.mesh.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    data = data or world // model
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} devices")
    if data * model < world:
        raise ValueError(f"mesh {data}x{model} leaves ranks of the {world} "
                         "without a place")
    groups = {}
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        groups[DATA_AXIS, m] = dist.new_group(ranks)
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        groups[MODEL_AXIS, d] = dist.new_group(ranks)
    common = dict(device=rank_device(device, rank),
                  backend=dist.get_backend(), global_rank=rank)
    return (DataMesh(rank=rank // model, world=data,
                     group=groups[DATA_AXIS, rank % model], **common),
            DataMesh(rank=rank % model, world=model,
                     group=groups[MODEL_AXIS, rank // model], **common))


def param_spec(name: str, model_axis: str = MODEL_AXIS) -> tuple:
    """The sharding of one parameter, by its state-dict name: the axis each
    dimension is split over (``jax.sharding.PartitionSpec``'s form, for a
    torch layout: a Linear weight is [out, in], the flax kernel's
    transpose)."""
    if name.endswith(".weight"):
        if any(m in name for m in _COLUMN):
            return (model_axis, None)
        if any(m in name for m in _ROW):
            return (None, model_axis)
    if name.endswith(".bias") and any(m in name for m in _COLUMN):
        return (model_axis,)
    return ()


def encoder_param_shardings(model: nn.Module,
                            model_axis: str = MODEL_AXIS) -> dict:
    """{name: :func:`param_spec`} for every parameter of ``model``."""
    return {n: param_spec(n, model_axis) for n, _ in model.named_parameters()}


def validate_tp(config, axis: Union[DataMesh, int]) -> None:
    """Fail loudly on geometry the layout cannot split (the JAX
    package's messages)."""
    tp = axis if isinstance(axis, int) else axis.world
    if tp <= 1:
        return
    if config.num_heads % tp:
        raise ValueError(f"num_heads {config.num_heads} not divisible by "
                         f"tp {tp}")
    if config.intermediate_size % tp:
        raise ValueError(f"intermediate_size {config.intermediate_size} "
                         f"not divisible by tp {tp}")
    impl = getattr(config, "attention_impl", "xla")
    if impl not in ("xla", "xla_bf16"):
        # 'auto' picks a hand-written attention kernel on the card (the
        # Pallas kernels' port), which this layout does not split
        raise ValueError(
            f"attention_impl={impl!r} may select a fused attention kernel "
            "(the port of the Pallas kernels), which the model-parallel "
            "forward does not split; tensor parallelism requires an "
            "explicit 'xla' or 'xla_bf16'")


def shard_params_tp(model: nn.Module, axis: DataMesh) -> nn.Module:
    """Cut this rank's slice of every model-parallel parameter of
    ``model`` from its full value (a checkpoint's, or the JAX package's
    carried across by ``models/weights.py``), in place, and make its
    encoder layers run the model-parallel forward over ``axis``. Returns
    ``model``; at tp 1 it stays as it is."""
    if axis.world == 1:
        return model
    for name, p in list(model.named_parameters()):
        spec = param_spec(name)
        if MODEL_AXIS not in spec:
            continue
        dim = spec.index(MODEL_AXIS)
        if p.shape[dim] % axis.world:
            raise ValueError(f"{name}: {p.shape[dim]} does not split over "
                             f"tp {axis.world}")
        per = p.shape[dim] // axis.world
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        setattr(owner, leaf, nn.Parameter(
            p.detach().narrow(dim, axis.rank * per, per).clone(),
            requires_grad=p.requires_grad))
        if leaf == "weight" and isinstance(owner, nn.Linear):
            owner.out_features, owner.in_features = owner.weight.shape
    for module in model.modules():
        if hasattr(module, "tp_axis"):
            module.tp_axis = axis
    return model


def _summed(x: torch.Tensor, axis: DataMesh) -> torch.Tensor:
    """The sum of every model rank's ``x``, in fp32, in a new tensor."""
    out = x.to(torch.float32, copy=True).contiguous()
    return axis.all_reduce_(out)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the input of a column-parallel block, replicated on
    the model ranks. Each rank's columns give only a part of the input's
    gradient, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.axis).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum of the row-parallel partial products, in
    fp32. The sum's gradient is each term's, already replicated, so the
    backward passes it on."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.dtype = x.dtype
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, axis: DataMesh) -> torch.Tensor:
    """*f* over the model axis ``axis``."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: DataMesh) -> torch.Tensor:
    """*g* over the model axis ``axis``: fp32, whatever ``x``'s dtype."""
    return _ReduceFromModel.apply(x, axis)
