"""ImageNet-pretrained encoder initialization (port of the JAX package's
``models/pretrained.py``).

The reference's training recipe starts the 2D encoder from timm
``tf_efficientnetv2_b0.in1k`` ImageNet weights (configs pass
``"pretrained": True``). A local weight file is converted with
``convert_timm_effnetv2`` and written into the model's state, weights and
BN running statistics both.

File discovery: ``$BAS_TPU_PRETRAINED_DIR`` (default ``<workdir>/data/
pretrained``, the directory the JAX package reads) is searched for
``<name>.{safetensors,npz,pth,bin}``, ``<name>`` the full timm name
(``tf_efficientnetv2_b0.in1k``) and the bare arch name
(``efficientnetv2_b0``). Weights that are asked for and absent raise
``PretrainedWeightsError``: training from a random init instead is never
done quietly.

``.safetensors`` files are read by this module's own reader (no
``safetensors`` package): an 8-byte little-endian header length, a JSON
header of dtype, shape and byte offsets, then the raw bytes.
"""

from __future__ import annotations

import json
import math
import os
import struct
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ball_action_spotting_torch import paths
from ball_action_spotting_torch.convert import flax_tree_to_state_dict
from ball_action_spotting_torch.models.torch_import import convert_timm_effnetv2

SUFFIXES = (".safetensors", ".npz", ".pth", ".bin")
# safetensors dtype names → numpy (little-endian); BF16 is read through torch
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


class PretrainedWeightsError(RuntimeError):
    pass


def pretrained_dir() -> Path:
    return Path(os.environ.get("BAS_TPU_PRETRAINED_DIR", paths.data_dir() / "pretrained"))


def candidate_names(model_name: str) -> list[str]:
    """Full timm name plus the bare arch key (``tf_`` stripped, tag dropped)."""
    bare = model_name.replace("tf_", "").split(".")[0]
    names = [model_name]
    if bare != model_name:
        names.append(bare)
    return names


def find_pretrained_file(model_name: str) -> Optional[Path]:
    root = pretrained_dir()
    for name in candidate_names(model_name):
        for suffix in SUFFIXES:
            path = root / f"{name}{suffix}"
            if path.exists():
                return path
    return None


def read_safetensors(path: Path | str) -> dict[str, np.ndarray]:
    """name → array of a ``.safetensors`` file (BF16 widened to float32,
    exactly). A malformed header raises ``ValueError``."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", data[:8])
    if n > len(data) - 8:
        raise ValueError(f"{path}: safetensors header length {n} past the end of the file")
    try:
        header = json.loads(data[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise ValueError(f"{path}: malformed safetensors header: {err}") from err
    if not isinstance(header, dict):
        raise ValueError(f"{path}: malformed safetensors header: not a JSON object")
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype, shape, (begin, end) = info["dtype"], list(info["shape"]), info["data_offsets"]
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"{path}: malformed safetensors entry {name!r}: {info!r}") from err
        if dtype == "BF16":
            itemsize = 2
        elif dtype in _SAFETENSORS_DTYPES:
            itemsize = np.dtype(_SAFETENSORS_DTYPES[dtype]).itemsize
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype!r}")
        if not (0 <= begin <= end <= len(body)) or end - begin != math.prod(shape) * itemsize:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} do not hold "
                             f"{dtype} {shape} within the {len(body)}-byte body")
        raw = body[begin:end]
        if dtype == "BF16":
            arr = (torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).float().numpy()
                   if end > begin else np.zeros(0, np.float32))
        else:
            arr = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[dtype]).astype(
                np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("="))
        out[name] = arr.reshape(shape)
    return out


def load_state_dict(path: Path | str) -> dict[str, np.ndarray]:
    """Flat name → array state dict from ``.safetensors``, ``.npz`` or a
    torch pickle (``.pth``/``.bin``, a ``{"state_dict": ...}`` wrapper
    unwrapped). The pickle is loaded with ``weights_only=False``, which can
    run code: use it on files you trust."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.float() if v.dtype == torch.bfloat16 else v
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def _merge_strict(target: Mapping[str, torch.Tensor],
                  source: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every entry of ``target`` replaced by the same-named entry of
    ``source``, in the target's dtype; extra ``source`` entries (encoder
    blocks past the feature tap) are ignored. A missing entry or a shape
    mismatch raises: a partial ImageNet init is a silent correctness bug."""
    out = {}
    for key, tval in target.items():
        if key not in source:
            raise PretrainedWeightsError(f"pretrained weights missing parameter {key!r}")
        sval = source[key]
        if tuple(sval.shape) != tuple(tval.shape):
            raise PretrainedWeightsError(
                f"pretrained weight {key!r} shape {tuple(sval.shape)} != model shape "
                f"{tuple(tval.shape)}")
        out[key] = sval.to(tval.dtype)
    return out


def apply_pretrained_encoder(
    state_dict: Mapping[str, torch.Tensor],
    model_name: str,
    encoder_name: str = "conv2d_encoder",
    stem_space_to_depth: bool = False,
    weights_path: Optional[Path] = None,
) -> dict[str, torch.Tensor]:
    """``state_dict`` (a port model's) with every entry under
    ``encoder_name`` replaced by the converted ImageNet weights: the
    parameters and the BN running statistics, both part of what
    "pretrained" means."""
    path = weights_path or find_pretrained_file(model_name)
    if path is None:
        raise PretrainedWeightsError(
            f"pretrained=True but no ImageNet weights for {model_name!r} found in "
            f"{pretrained_dir()} (tried "
            f"{[n + s for n in candidate_names(model_name) for s in SUFFIXES]}). "
            "Place a timm weight file there (the JAX package's "
            "`scripts/download_pretrained.py` fetches one on a networked host) or set "
            "BAS_TPU_PRETRAINED_DIR.")
    enc_params, enc_stats = convert_timm_effnetv2(
        load_state_dict(path), model_name, stem_space_to_depth=stem_space_to_depth)
    source = flax_tree_to_state_dict({"params": {encoder_name: enc_params},
                                      "batch_stats": {encoder_name: enc_stats}})
    prefix = encoder_name + "."
    target = {k: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not target:
        raise PretrainedWeightsError(
            f"model has no {encoder_name!r} subtree; cannot apply pretrained encoder weights")
    return {**state_dict, **_merge_strict(target, source)}
