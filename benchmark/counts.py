"""The yardstick: operations and bytes that the algorithm needs, from the
shapes alone, and the card's published peaks.

FLOPs are counted once on the plain reference (``reference/model.py``)
with ``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device,
so a count costs no device time and does not depend on how the program
does the work. A kernel's bytes are each input read once and each output
written once.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.model import Reference, model_shapes, num_stacks

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def _meta_weights(kwargs: dict) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in model_shapes(kwargs).items()}


def _count(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


@functools.lru_cache(maxsize=None)
def _predict_frame_flops(kwargs_json: str, height: int, width: int, views: int) -> int:
    kwargs = json.loads(kwargs_json)
    w = _meta_weights(kwargs)
    ref = Reference(w, kwargs)
    m, s = kwargs["stack_size"], num_stacks(kwargs)
    enc = _count(lambda: ref.encoder(torch.empty(views, m, height, width, device="meta")))
    h, wd = -(-height // 32), -(-width // 32)
    feats = torch.empty(views, s, h, wd, kwargs["num_3d_features"], device="meta")
    return enc + _count(lambda: ref.head(feats))


def predict_frame_flops(kwargs: dict, height: int, width: int, views: int) -> int:
    """FLOPs of one predicted frame in a video: one new stack encoded and
    one window through the 3D head, for each of ``views`` (2 with hflip
    TTA)."""
    return _predict_frame_flops(json.dumps(kwargs, sort_keys=True), height, width, views)


def dwconv3d_bytes(n: int, t: int, h: int, w: int, c: int, dtype: str) -> int:
    """The depthwise 3×3×3 conv: x read once, out written once, the
    float32 taps read once."""
    return 2 * n * t * h * w * c * ITEMSIZE[dtype] + 27 * c * 4


def bound_s(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOP_S)
