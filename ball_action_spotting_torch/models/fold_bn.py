"""Fold inference BatchNorm into the preceding conv weights (port of the JAX
package's ``models/fold_bn.py``, on the port's own state_dict).

Every BN in this model family directly follows a bias-free conv, so

    weight' = weight · s (per output channel),   bias = beta − mean · s,
    s = gamma / sqrt(var + eps)

and the folded model (``bn_folded=True``) runs conv → add-bias → act.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

# BN module name → preceding conv sibling, in priority order (the first name
# present in the same scope wins)
_BN_TO_CONV: dict[str, tuple[str, ...]] = {
    "bn1": ("conv_stem", "conv", "conv_exp", "conv_pw"),
    "bn2": ("conv_dw", "conv_pwl"),
    "bn3": ("conv_pwl",),
    "conv2d_projection_bn": ("conv2d_projection_conv",),
    "conv3d_projection_bn": ("conv3d_projection_conv",),
}


def default_eps_rule(path: tuple[str, ...]) -> float:
    """The model family's BN epsilons, read from the port modules' own
    defaults: the projection norms (``PROJECTION_BN_EPS``), the 3D blocks
    (``InvertedResidual3d.bn_eps``) and the TF-ported encoder
    (``EfficientNetV2Features.bn_eps``). Unknown BN scopes raise."""
    from ball_action_spotting_torch.models.blocks3d import InvertedResidual3d
    from ball_action_spotting_torch.models.effnetv2 import EfficientNetV2Features
    from ball_action_spotting_torch.models.multidim_stacker import PROJECTION_BN_EPS

    if path[-1] in ("conv2d_projection_bn", "conv3d_projection_bn"):
        return float(PROJECTION_BN_EPS)
    if any(p.startswith("conv3d_encoder") for p in path):
        return float(InvertedResidual3d.bn_eps)
    if "conv2d_encoder" in path:
        return float(EfficientNetV2Features.bn_eps)
    raise ValueError(f"fold_bn: no epsilon known for BN scope {'.'.join(path)}")


def fold_bn_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    eps_rule: Callable[[tuple[str, ...]], float] = default_eps_rule,
) -> dict[str, torch.Tensor]:
    """Unfolded ``MultiDimStacker`` state_dict → the state_dict of the
    ``bn_folded=True`` model. Raises if a BN has no recognized conv
    sibling."""
    out = dict(state_dict)
    for key in list(state_dict):
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        path = tuple(bn.split("."))
        scope = ".".join(path[:-1])
        prefix = scope + "." if scope else ""
        conv = next((prefix + c for c in _BN_TO_CONV.get(path[-1], ())
                     if prefix + c + ".weight" in state_dict), None)
        if conv is None:
            raise ValueError(f"No conv sibling for BN scope {bn}")
        gamma = state_dict[bn + ".weight"].float()
        beta = state_dict[bn + ".bias"].float()
        mean = state_dict[bn + ".running_mean"].float()
        var = state_dict[bn + ".running_var"].float()
        scale = gamma / torch.sqrt(var + eps_rule(path))
        weight = state_dict[conv + ".weight"].float()
        if weight.shape[0] != scale.shape[0]:
            raise ValueError(f"{conv}: out={weight.shape[0]} vs {bn}: C={scale.shape[0]}")
        out[conv + ".weight"] = weight * scale.view((-1,) + (1,) * (weight.dim() - 1))
        for leaf in ("weight", "running_mean", "running_var"):
            del out[f"{bn}.{leaf}"]
        out[bn + ".bias"] = beta - mean * scale
    return out
