"""Reference PyTorch state dicts → Flax-layout numpy trees (copy of the JAX
package's ``models/torch_import.py``).

Two import paths:

1. ``convert_timm_effnetv2``: a timm ``tf_efficientnetv2_*`` features-only
   state dict (the reference's ImageNet-pretrained 2D encoder) → the
   (params, batch_stats) trees of ``EfficientNetV2Features``.
2. ``convert_multidim_stacker``: a full reference ``MultiDimStacker`` state
   dict (the ``nn_state_dict`` of an argus ``.pth`` checkpoint) →
   {"params", "batch_stats"}.

The trees are exactly those the JAX converter emits, so ``.pth`` and
``.ckpt`` weights reach the port's state through one path,
``convert.py::jax_variables_to_state_dict`` (``flax_tree_to_state_dict``
for an encoder subtree). Layout rules:

  conv2d  OIHW  → HWIO   (depthwise (C,1,K,K) → (K,K,1,C), same transpose)
  conv3d  OIDHW → DHWIO
  linear  (out,in) → (in,out)
  BN      weight/bias → params scale/bias; running stats → batch_stats

Tensors may be torch tensors or numpy arrays; the conversion is numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ball_action_spotting_torch.models.effnetv2 import resolve_arch, stem_kernel_to_s2d


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16; widening is exact
            t = t.float()
        t = t.numpy()
    return np.asarray(t)


def _conv2d(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def _conv3d(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 4, 1, 0)


def _linear(w) -> np.ndarray:
    return _np(w).transpose(1, 0)


def _bn(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    """Returns (params, batch_stats) subtrees for one BatchNormAct module."""
    params = {"BatchNorm_0": {"scale": _np(sd[f"{prefix}.weight"]),
                              "bias": _np(sd[f"{prefix}.bias"])}}
    stats = {"BatchNorm_0": {"mean": _np(sd[f"{prefix}.running_mean"]),
                             "var": _np(sd[f"{prefix}.running_var"])}}
    return params, stats


def convert_timm_effnetv2(state_dict: Mapping, model_name: str, prefix: str = "",
                          stem_space_to_depth: bool = False) -> tuple[dict, dict]:
    """timm EfficientNetV2 state dict → (params, batch_stats) trees of
    ``EfficientNetV2Features``. ``prefix`` strips a leading module path
    (``"conv2d_encoder."`` inside a full reference checkpoint);
    ``stem_space_to_depth`` applies the exact stem-kernel transform of the
    space-to-depth stem. Blocks the state dict lacks (a checkpoint cut past
    the feature tap) are left out; keys past the tap (``conv_head``,
    ``classifier``) and ``num_batches_tracked`` are never read."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    _, stages = resolve_arch(model_name)

    params: dict = {}
    stats: dict = {}

    def put(name: str, p: dict, s: dict):
        params[name] = p
        if s:
            stats[name] = s

    stem = _conv2d(sd["conv_stem.weight"])
    if stem_space_to_depth:
        stem = stem_kernel_to_s2d(stem)
    params["conv_stem"] = {"kernel": stem}
    bn_p, bn_s = _bn(sd, "bn1")
    put("bn1", bn_p, bn_s)

    for stage_idx, stage in enumerate(stages):
        for rep in range(stage.repeats):
            t = f"blocks.{stage_idx}.{rep}"
            if f"{t}.conv.weight" not in sd and f"{t}.conv_pw.weight" not in sd \
                    and f"{t}.conv_exp.weight" not in sd:
                continue  # checkpoint truncated past the feature tap
            name = f"blocks_{stage_idx}_{rep}"
            block_p: dict = {}
            block_s: dict = {}

            def bn_into(flax_name: str, torch_name: str):
                p, s = _bn(sd, f"{t}.{torch_name}")
                block_p[flax_name] = p
                block_s[flax_name] = s

            if stage.kind == "cn":
                block_p["conv"] = {"kernel": _conv2d(sd[f"{t}.conv.weight"])}
                bn_into("bn1", "bn1")
            elif stage.kind == "er":
                block_p["conv_exp"] = {"kernel": _conv2d(sd[f"{t}.conv_exp.weight"])}
                bn_into("bn1", "bn1")
                block_p["conv_pwl"] = {"kernel": _conv2d(sd[f"{t}.conv_pwl.weight"])}
                bn_into("bn2", "bn2")
            else:  # ir
                block_p["conv_pw"] = {"kernel": _conv2d(sd[f"{t}.conv_pw.weight"])}
                bn_into("bn1", "bn1")
                block_p["conv_dw"] = {"kernel": _conv2d(sd[f"{t}.conv_dw.weight"])}
                bn_into("bn2", "bn2")
                if f"{t}.se.conv_reduce.weight" in sd:
                    block_p["se"] = {
                        "conv_reduce": {
                            "kernel": _conv2d(sd[f"{t}.se.conv_reduce.weight"]),
                            "bias": _np(sd[f"{t}.se.conv_reduce.bias"]),
                        },
                        "conv_expand": {
                            "kernel": _conv2d(sd[f"{t}.se.conv_expand.weight"]),
                            "bias": _np(sd[f"{t}.se.conv_expand.bias"]),
                        },
                    }
                block_p["conv_pwl"] = {"kernel": _conv2d(sd[f"{t}.conv_pwl.weight"])}
                bn_into("bn3", "bn3")

            put(name, block_p, block_s)

    return params, stats


def _bn3d(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    """The reference's ``BatchNormAct3d`` nests its norm as ``.bn3d``."""
    return _bn(sd, f"{prefix}.bn3d")


def convert_multidim_stacker(state_dict: Mapping, model_name: str, num_3d_blocks: int,
                             stem_space_to_depth: bool = False) -> dict:
    """Full reference ``MultiDimStacker`` state dict → {"params",
    "batch_stats"}. A ``torch.compile`` checkpoint's ``_orig_mod.`` prefix
    is stripped."""
    sd = dict(state_dict)
    if any(k.startswith("_orig_mod.") for k in sd):
        sd = {k.removeprefix("_orig_mod."): v for k, v in sd.items()}

    enc_p, enc_s = convert_timm_effnetv2(sd, model_name, prefix="conv2d_encoder.",
                                         stem_space_to_depth=stem_space_to_depth)
    params: dict = {"conv2d_encoder": enc_p}
    stats: dict = {"conv2d_encoder": enc_s}

    params["conv2d_projection_conv"] = {"kernel": _conv2d(sd["conv2d_projection.0.weight"])}
    p, s = _bn(sd, "conv2d_projection.1")
    params["conv2d_projection_bn"], stats["conv2d_projection_bn"] = p, s

    for i in range(num_3d_blocks):
        t = f"conv3d_encoder.{i}"
        block_p: dict = {
            "conv_pw": {"kernel": _conv3d(sd[f"{t}.conv_pw.weight"])},
            "conv_dw": {"kernel": _conv3d(sd[f"{t}.conv_dw.weight"])},
            "conv_pwl": {"kernel": _conv3d(sd[f"{t}.conv_pwl.weight"])},
            "se": {
                "conv_reduce": {
                    "kernel": _conv3d(sd[f"{t}.se.conv_reduce.weight"]),
                    "bias": _np(sd[f"{t}.se.conv_reduce.bias"]),
                },
                "conv_expand": {
                    "kernel": _conv3d(sd[f"{t}.se.conv_expand.weight"]),
                    "bias": _np(sd[f"{t}.se.conv_expand.bias"]),
                },
            },
        }
        block_s: dict = {}
        for bn_name in ("bn1", "bn2", "bn3"):
            p, s = _bn3d(sd, f"{t}.{bn_name}")
            block_p[bn_name] = p
            block_s[bn_name] = s
        params[f"conv3d_encoder_{i}"] = block_p
        stats[f"conv3d_encoder_{i}"] = block_s

    params["conv3d_projection_conv"] = {"kernel": _conv2d(sd["conv3d_projection.0.weight"])}
    p, s = _bn(sd, "conv3d_projection.1")
    params["conv3d_projection_bn"], stats["conv3d_projection_bn"] = p, s

    params["global_pool"] = {"p": _np(sd["global_pool.p"])}
    params["classifier"] = {"kernel": _linear(sd["classifier.weight"]),
                            "bias": _np(sd["classifier.bias"])}
    return {"params": params, "batch_stats": stats}


def load_reference_checkpoint(path: Path | str, use_ema: bool = True) -> tuple[dict, dict]:
    """A reference argus ``.pth`` checkpoint → (Flax-layout variables, its
    ``params`` dict as saved): the EMA weights (``nn_state_dict``) or, with
    ``use_ema=False``, the raw ones (``no_ema_nn_state_dict``). The params'
    ``device`` and ``amp`` are ignored. Only ``multidim_stacker`` checkpoints
    are accepted.

    The file is unpickled (``torch.load(weights_only=False)``, as the
    argus ``params`` dict needs), which can run code: load only files you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model_params = ckpt["params"]
    nn_name, nn_kwargs = model_params["nn_module"]
    if nn_name != "multidim_stacker":
        raise ValueError(f"Unsupported reference nn_module: {nn_name}")
    sd = ckpt["nn_state_dict" if use_ema else "no_ema_nn_state_dict"]
    variables = convert_multidim_stacker(sd, nn_kwargs["model_name"], nn_kwargs["num_3d_blocks"])
    return variables, model_params
