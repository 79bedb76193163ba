"""Model zoo: ``build_model`` instantiates a model family by name from a
checkpoint's ``nn_module`` kwargs: ``multidim_stacker``, ``multichan_stacker``
and the plain 2D classifier (``timm``, ``classifier2d``), as the JAX
package's registry does."""

import math
from typing import Any

import torch

from ball_action_spotting_torch.models.blocks3d import (
    GeneralizedMeanPooling,
    InvertedResidual3d,
    SqueezeExcite3d,
)
from ball_action_spotting_torch.models.effnetv2 import (
    EFFNETV2_ARCHS,
    EfficientNetV2Features,
)
from ball_action_spotting_torch.models.classifier2d import Classifier2d
from ball_action_spotting_torch.models.multichan_stacker import MultiChanStacker
from ball_action_spotting_torch.models.multidim_stacker import MultiDimStacker

MODEL_REGISTRY: dict[str, Any] = {
    "multidim_stacker": MultiDimStacker,
    "multichan_stacker": MultiChanStacker,
    # the plain 2D encoder + head, the reference registry's generic "timm"
    "timm": Classifier2d,
    "classifier2d": Classifier2d,
}

# kwargs that configure weight initialization, not module structure
# (``pretrained`` is honoured by ``Trainer.init_state``)
_IGNORED_KWARGS = {"pretrained"}


def build_model(name: str, **kwargs):
    kwargs = {k: v for k, v in kwargs.items() if k not in _IGNORED_KWARGS}
    # accept timm-style encoder names from reference configs
    if "model_name" in kwargs:
        kwargs["model_name"] = kwargs["model_name"].replace("tf_", "").split(".")[0]
    return MODEL_REGISTRY[name](**kwargs)


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded random weights in place, for runs without a checkpoint:
    LeCun-normal conv and dense kernels (the Flax default's scale), GeM
    p = 3, and BN statistics, scales and all biases drawn around their
    trained-model ranges so that folding and activations see non-trivial
    values."""

    def randn(shape, scale):
        return torch.randn(shape, generator=generator) * scale

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    with torch.no_grad():
        for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and tensor.dim() > 1:
                tensor.copy_(randn(tensor.shape, 1.0 / math.sqrt(tensor[0].numel())))
            elif leaf in ("weight", "running_var"):  # BN scale and variance
                tensor.copy_(uniform(tensor.shape, 0.5, 1.5))
            elif leaf == "p":
                tensor.fill_(3.0)
            else:  # biases and running means
                tensor.copy_(randn(tensor.shape, 0.1))
    return model


def init_train_weights(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded initial weights for training from scratch, in place, with the
    Flax initializers the JAX package's ``model.init`` uses: conv and dense
    kernels LeCun-normal (a normal truncated at ±2σ, σ = 1/√fan_in
    / 0.8796), BN scale 1 and bias 0, running mean 0 and variance 1, all
    other biases 0, GeM p = 3."""
    with torch.no_grad():
        for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and tensor.dim() > 1:
                std = 1.0 / math.sqrt(tensor[0].numel()) / 0.87962566103423978
                torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                            generator=generator)
            elif leaf in ("weight", "running_var"):  # BN scale and variance
                tensor.fill_(1.0)
            elif leaf == "p":
                tensor.fill_(3.0)
            else:  # biases and running means
                tensor.zero_()
    return model


__all__ = [
    "Classifier2d",
    "EFFNETV2_ARCHS",
    "EfficientNetV2Features",
    "GeneralizedMeanPooling",
    "InvertedResidual3d",
    "MODEL_REGISTRY",
    "MultiChanStacker",
    "MultiDimStacker",
    "SqueezeExcite3d",
    "build_model",
    "init_train_weights",
    "init_weights",
]
