"""Weight bridge between JAX/Flax variable trees and the port model's
state_dict, both ways.

The inverse of the JAX package's ``models/torch_import.py`` layout rules,
onto the port's own module names (which are the Flax names):

  conv2d  HWIO  → OIHW    (depthwise (K, K, 1, C) → (C, 1, K, K), same rule)
  conv3d  DHWIO → OIDHW
  dense   (in, out) → (out, in)
  BN      params scale/bias → weight/bias; batch_stats mean/var →
          running_mean/running_var; a folded tree's lone ``bias`` stays

Input trees hold numpy arrays (``train/checkpoint.py`` reads them from a
JAX ``.ckpt``; tests pass ``jax.tree.map(np.asarray, variables)``).
``state_dict_to_flax_tree`` is the way back, for the checkpoints the port
writes: the JAX package's ``load_checkpoint`` reads them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "p"): "p",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _tensor(leaf: str, value) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if leaf == "kernel":
        arr = arr.transpose(_KERNEL_PERM[arr.ndim])
    return torch.from_numpy(np.ascontiguousarray(arr))


def flax_tree_to_state_dict(variables_np: Mapping) -> dict[str, torch.Tensor]:
    """{"params"[, "batch_stats"]} numpy tree of any ported Flax module →
    the state_dict of its port counterpart (names mapped, not checked)."""
    state: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple[str, ...], collection: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                # the Flax BatchNorm submodule's scope has no port counterpart
                walk(value, prefix if key == "BatchNorm_0" else prefix + (key,),
                     collection)
            else:
                name = _LEAF_NAMES[collection, key]
                state[".".join(prefix + (name,))] = _tensor(key, value)

    for collection in ("params", "batch_stats"):
        walk(variables_np.get(collection, {}), (), collection)
    return state


def jax_variables_to_state_dict(variables_np: Mapping, nn_kwargs: Mapping) -> dict:
    """{"params", "batch_stats"} (or folded {"params"}) numpy tree → the
    state_dict of ``build_model("multidim_stacker", **nn_kwargs)`` (with
    ``bn_folded`` set when the tree has no ``batch_stats``). The result is
    checked by a strict ``load_state_dict`` into that model."""
    from ball_action_spotting_torch.models import build_model

    state = flax_tree_to_state_dict(variables_np)
    folded = "batch_stats" not in variables_np
    model = build_model("multidim_stacker", bn_folded=folded, **dict(nn_kwargs))
    model.load_state_dict(state, strict=True)
    return state


_INVERSE_PERM = {ndim: tuple(int(i) for i in np.argsort(perm))
                 for ndim, perm in _KERNEL_PERM.items()}
_BN_LEAVES = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def state_dict_to_flax_tree(state: Mapping[str, torch.Tensor], model) -> dict:
    """A port model's state_dict (or any subset of it, such as the
    parameters' gradients) → the {"params"[, "batch_stats"]} numpy float32
    tree of the Flax module. ``model`` tells which modules are BN: an
    unfolded BN's leaves go under its ``BatchNorm_0`` scope."""
    from ball_action_spotting_torch.models.effnetv2 import BatchNormAct

    bn = {name: m.folded for name, m in model.named_modules() if isinstance(m, BatchNormAct)}
    tree: dict = {}
    for name, tensor in state.items():
        prefix, _, leaf = name.rpartition(".")
        path = prefix.split(".") if prefix else []
        arr = tensor.detach().cpu().float().numpy()
        if prefix in bn and not bn[prefix]:
            collection, key = _BN_LEAVES[leaf]
            path.append("BatchNorm_0")
        elif leaf == "weight":
            collection, key = "params", "kernel"
            arr = arr.transpose(_INVERSE_PERM[arr.ndim])
        else:  # conv/dense and folded-BN biases, GeM's p
            collection, key = "params", leaf
        node = tree.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr)
    return tree
