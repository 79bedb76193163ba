"""Tensor parallelism: a training state's wide output channels split over a
grid's model axis (port of the JAX package's ``parallel/sharding_rules.py``).

The rule is shape-based, so it applies alike to the parameters, their EMA
copies and the optimizer's moments, which mirror the parameters' shapes:

- a leaf of rank ≥ 2 whose output channels (dim 0 of the port's conv and
  linear weights, OIHW / OIDHW / (out, in); the last dim of the Flax layout
  JAX's rule reads) number at least ``min_channels`` and divide by the
  model axis is split along them, one slice per model-axis device of the
  grid row;
- every other leaf (biases, BN vectors and statistics, GeM's p, narrow
  kernels) is not split: it stays whole on the row's first device.

The data axis is the port's existing one: one process per grid row under
``torch.distributed`` (``parallel/multihost.py``), each process taking row
``process_index()`` of the grid, with the BN statistics' all-reduce and
``train/steps.py::average_gradients`` (the model-axis devices of a process
see the same rows, so the world all-reduce gives the global statistics).

Design: the persistent state is split, the compute is not.
``shard_state`` replaces each split parameter of the model and of its EMA
by its slices, registered on the module as ``<name>_shards.<k>``; a forward
pre-hook on the model gathers them onto the row's first device with a
differentiable concatenation (so the model runs through its ``forward``,
not a split method such as ``forward_2d``), whose backward returns each slice's gradient to the slice's
device, so that the optimizer (rebuilt over the slices, its moments split
alike) and the EMA update each slice where it lives. A step over a sharded
state is the replicated step's arithmetic, and each model-axis device holds
its share of the split leaves' parameters, EMA and moments. (Column-parallel
compute, each device also computing its slice of the output channels, is
not ported.) ``gathered`` gives a sharded model's state_dict, or its
gradients, in the unsharded layout.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ball_action_spotting_torch.parallel.mesh import MODEL_AXIS, DeviceMesh
from ball_action_spotting_torch.parallel.multihost import process_index
from ball_action_spotting_torch.train.state import TrainState

SHARDS = "_shards"


def leaf_spec(shape, n_model: int, min_channels: int = 256) -> Optional[int]:
    """The dim of a leaf of ``shape`` (the port's layout) to split over a
    model axis of ``n_model``, or None to keep it whole."""
    if n_model <= 1 or len(shape) < 2:
        return None
    out = shape[0]
    return 0 if out >= min_channels and out % n_model == 0 else None


def state_shardings(model: nn.Module, mesh: DeviceMesh, min_channels: int = 256) -> dict:
    """{parameter name: the dim to split, or None} for ``model``."""
    n_model = mesh.shape[MODEL_AXIS]
    return {name: leaf_spec(tuple(p.shape), n_model, min_channels)
            for name, p in model.named_parameters()}


def _shard_module(model: nn.Module, specs: dict, devices: list) -> dict:
    """Replace each split parameter of ``model`` by its slices, gathered
    for the model's forward by hooks on the model itself (a module may read
    a child's weight, as the encoder's SE block does); returns {the old
    parameter: (its slices, the split dim)}."""
    replaced, split = {}, []
    for full_name, dim in specs.items():
        if dim is None:
            continue
        module_name, _, name = full_name.rpartition(".")
        module = model.get_submodule(module_name)
        param = module._parameters.pop(name)
        pieces = param.detach().chunk(len(devices), dim)
        shards = nn.ParameterList([
            nn.Parameter(piece.to(dev).clone(), requires_grad=param.requires_grad)
            for piece, dev in zip(pieces, devices)])
        module.register_module(name + SHARDS, shards)
        replaced[param] = (list(shards), dim)
        split.append((module, name, shards, dim))

    def gather(_, args):
        for module, name, shards, dim in split:
            module.__dict__[name] = torch.cat([s.to(devices[0]) for s in shards], dim)

    def drop(_, args, output):
        for module, name, _, _ in split:
            module.__dict__.pop(name, None)  # the graph keeps what backward needs

    model.register_forward_pre_hook(gather)
    model.register_forward_hook(drop)
    return replaced


def shard_state(state: TrainState, mesh: DeviceMesh, min_channels: int = 256,
                row: Optional[int] = None) -> TrainState:
    """Split ``state`` over the model-axis devices of grid row ``row``
    (this process's, ``process_index()``, by default) by ``leaf_spec``: the
    model and EMA in place, and a new optimizer of the same kind and
    settings over the slices, its state split alike. Whole leaves and the
    compute go to the row's first device. Returns ``state``."""
    devices = mesh.model_devices(process_index() if row is None else row)
    specs = state_shardings(state.model, mesh, min_channels)
    old = state.optimizer
    opt_state = {p: old.state[p] for group in old.param_groups for p in group["params"]
                 if p in old.state}
    state.model.to(devices[0])
    state.ema.to(devices[0])
    replaced = _shard_module(state.model, specs, devices)
    _shard_module(state.ema, specs, devices)

    groups = []
    for group in old.param_groups:
        params = []
        for p in group["params"]:
            params.extend(replaced[p][0] if p in replaced else [p])
        groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": params})
    new = type(old)(groups)  # every group carries all of its settings
    for p, st in opt_state.items():
        if p in replaced:
            shards, dim = replaced[p]
            for k, shard in enumerate(shards):
                # moments split like the parameter; a step count copied (the
                # optimizer increments it in place, once per slice)
                new.state[shard] = {
                    key: (v.chunk(len(shards), dim)[k].to(shard.device).clone()
                          if torch.is_tensor(v) and v.shape == p.shape
                          else v.clone() if torch.is_tensor(v) else v)
                    for key, v in st.items()}
        else:
            new.state[p] = {key: v.to(devices[0]) if torch.is_tensor(v) and v.dim() else v
                            for key, v in st.items()}
    state.optimizer = new
    return state


def gathered(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A sharded model's {name: tensor} mapping (its state_dict, its
    parameters' gradients) in the unsharded layout: each split leaf's slices
    concatenated under the leaf's own name, on the first slice's device."""
    out: dict[str, torch.Tensor] = {}
    pending: dict[str, list] = {}
    for key, tensor in tensors.items():
        prefix, _, index = key.rpartition(".")
        if prefix.endswith(SHARDS) and index.isdigit():
            pending.setdefault(prefix[: -len(SHARDS)], []).append(tensor)
        else:
            out[key] = tensor
    for name, shards in pending.items():  # leaf_spec splits dim 0 only
        out[name] = torch.cat([s.to(shards[0].device) for s in shards])
    return out
