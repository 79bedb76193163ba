"""Inputs made from the seed: the frame pool and the weights handed to
both the program and the reference, and the program's description of a
configuration (a checkpoint's ``params``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .reference.model import ENCODER_EPS, HEAD_EPS, calibrate_bn, seeded_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one purpose of a run (``stream``)."""
    return np.random.default_rng([seed, *stream])


def frame_pool(seed: int, count: int, height: int, width: int, device) -> np.ndarray:
    """(count, height, width) uint8 grayscale frames, as a decoder hands
    them over: a smooth random field plus fine noise, made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand((count, 1, -(-height // 16), -(-width // 16)), generator=g, device=device)
    x = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)[:, 0]
    x = x * 200.0 + torch.rand((count, height, width), generator=g, device=device) * 55.0
    return x.to(torch.uint8).cpu().numpy()


def pad_frames(frames: np.ndarray, image_size) -> np.ndarray:
    """(N, h, w) → (N, H, W) uint8, zeros around, the extra row of an odd
    margin at the bottom (right)."""
    n, h, w = frames.shape
    tw, th = image_size
    out = np.zeros((n, th, tw), np.uint8)
    top, left = (th - h) // 2, (tw - w) // 2
    out[:, top:top + h, left:left + w] = frames
    return out


def model_weights(model: dict, seed: int, device, pool: np.ndarray) -> dict:
    """Seeded weights on ``device`` with every BN's statistics set from
    one clip of the pool (the reference's forward, float32), in the form
    the configuration's dtype serves them (``served``)."""
    kw = model["nn_module_kwargs"]
    w = seeded_weights(kw, seed, device)
    step, t = model["frame_stack_step"], kw["num_frames"]
    clip = pad_frames(pool[np.arange(t) * step % len(pool)], model["image_size"])
    calibrate_bn(w, kw, torch.from_numpy(clip).to(device)[None].float() / 255.0)
    return served(w, DTYPES[model["dtype"]])


# the conv a BN follows, by the BN's name (the first of these the scope has)
BN_CONV = {"bn1": ("conv_stem", "conv", "conv_exp", "conv_pw"), "bn2": ("conv_dw", "conv_pwl"),
           "bn3": ("conv_pwl",), "conv2d_projection_bn": ("conv2d_projection_conv",),
           "conv3d_projection_bn": ("conv3d_projection_conv",)}


def served(w: dict, dtype: torch.dtype) -> dict:
    """``w`` as a checkpoint in ``dtype`` serves it: each BN folded into
    the conv before it, every value rounded to ``dtype``, and each BN left
    as the identity (scale 1, mean 0, variance 1 − eps, the folded shift
    as its bias). A program that folds BN or casts its weights to
    ``dtype`` then changes no value, so the program and the float32
    reference run the same weights and differ only in how they compute.
    (Rounded apart, each side's weights would carry its own rounding, a
    fixed error per seed that swamps the computation's.)"""
    out = dict(w)
    for key in w:
        if not key.endswith(".running_mean"):
            continue
        bn = key.removesuffix(".running_mean")
        scope, name = bn.rsplit(".", 1) if "." in bn else ("", bn)
        prefix = scope + "." if scope else ""
        conv = next(prefix + c for c in BN_CONV[name] if prefix + c + ".weight" in w)
        eps = ENCODER_EPS if bn.startswith("conv2d_encoder.") else HEAD_EPS
        scale = w[bn + ".weight"] / torch.sqrt(w[bn + ".running_var"] + eps)
        weight = w[conv + ".weight"]
        out[conv + ".weight"] = weight * scale.view((-1,) + (1,) * (weight.dim() - 1))
        out[bn + ".bias"] = w[bn + ".bias"] - w[bn + ".running_mean"] * scale
        var = torch.tensor(1.0 - eps)
        while float(var + eps) != 1.0:  # the float32 variance whose var + eps is 1 exactly
            var = torch.nextafter(var, torch.tensor(1.0 if float(var + eps) < 1 else 0.0))
        out[bn + ".weight"] = torch.ones_like(scale)
        out[bn + ".running_mean"] = torch.zeros_like(scale)
        out[bn + ".running_var"] = torch.full_like(scale, float(var))
    return {k: v if k.endswith(".running_var") else v.to(dtype).float() for k, v in out.items()}


def program_params(model: dict) -> dict:
    """The ``params`` dict of a checkpoint of this configuration."""
    return {
        "nn_module": (model["nn_module"], dict(model["nn_module_kwargs"])),
        "frame_stack_size": model["frame_stack_size"],
        "frame_stack_step": model["frame_stack_step"],
        "frames_processor": ("pad_normalize", {"size": tuple(model["image_size"])}),
    }
