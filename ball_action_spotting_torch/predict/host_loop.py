"""The host side of the chunked engines (part of the port of the JAX
package's ``predict/streaming.py``): frame padding, the chunk loop and the
sequential frame iterator. It imports no model code, so that a sealed
artifact (``predict/export.py``) runs with it alone."""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.utils import profiling


def pad_offsets(image_size, height, width) -> tuple[int, int]:
    """Top/left offsets for a symmetric pad to the (W, H) config size."""
    wp, hp = image_size[0] - width, image_size[1] - height
    return hp // 2, wp // 2


def pad_frame(frame: np.ndarray, image_size) -> np.ndarray:
    """Symmetric zero-pad one (H, W) frame to the (W, H) config size."""
    h, w = frame.shape
    tw, th = image_size
    if (w, h) == (tw, th):
        return frame
    top, left = pad_offsets(image_size, h, w)
    out = np.zeros((th, tw), dtype=frame.dtype)
    out[top : top + h, left : left + w] = frame
    return out


def run_chunk_loop(
    chunk_call: Callable,
    *,
    indexes_generator: StackIndexesGenerator,
    chunk_size: int,
    overlap: int,
    image_size: tuple[int, int],
    num_classes: int | tuple[int, ...],
    frames: Iterator[tuple[int, np.ndarray]],
    frame_count: int,
    put_new: Callable,
    put_carry: Callable,
) -> tuple[list[int], np.ndarray]:
    """Host side of the chunked engine: frame intake, symmetric padding,
    carry bootstrap, chunk dispatch.

    ``chunk_call(new_frames, carry) -> (preds, new_carry)`` is the device
    program; ``put_new``/``put_carry`` stage host uint8 arrays onto the
    device. Frames [0, first_needed) are decoded and dropped; past the end
    of the video the last padded frame repeats. ``num_classes`` is the
    shape of one prediction row (a (folds, classes) tuple for the fused
    ensemble), used for a video shorter than one window.

    Traced (``utils/profiling.py``): the call is one request,
    ``predict.segment``, around ``predict.pad`` (each intake and pad),
    ``predict.bootstrap`` (``put_carry``), ``predict.upload`` (each
    ``put_new``), ``predict.dispatch`` (each ``chunk_call``) and
    ``predict.readback`` (the predictions to the host); counters
    ``frames_in``, ``frames_skipped``, ``frames_repeated``,
    ``bytes_uploaded``, ``chunks``, ``windows_computed`` and
    ``predictions_kept``."""
    gen, n = indexes_generator, chunk_size
    with profiling.span("predict.segment", request=True):
        min_predict = gen.clip_index(0, frame_count, 1)
        max_predict = gen.clip_index(frame_count, frame_count, 1)
        if max_predict < min_predict:  # video shorter than one window
            return [], np.zeros((0, *np.atleast_1d(num_classes)), np.float32)
        predict_indexes = list(range(min_predict, max_predict + 1))
        tw, th = image_size

        frames_iter = iter(frames)
        last_frame = np.zeros((th, tw), dtype=np.uint8)

        def take_frames(size: int) -> np.ndarray:
            """Next ``size`` padded frames; repeats the last frame past EOF."""
            nonlocal last_frame
            with profiling.span("predict.pad"):
                out = np.empty((size, th, tw), dtype=np.uint8)
                taken = 0
                for i in range(size):
                    try:
                        _, frame = next(frames_iter)
                        last_frame = pad_frame(np.asarray(frame), image_size)
                        taken += 1
                    except StopIteration:
                        pass
                    out[i] = last_frame
                profiling.count("frames_in", taken)
                profiling.count("frames_repeated", size - taken)
            return out

        skip = predict_indexes[0] - gen.behind
        take_frames(skip)
        profiling.count("frames_skipped", skip)
        first = take_frames(overlap)
        with profiling.span("predict.bootstrap"):
            carry = put_carry(first)
        profiling.count("bytes_uploaded", first.nbytes)

        predictions: list[torch.Tensor] = []
        total = len(predict_indexes)
        for _ in range(0, total, n):
            new = take_frames(n)
            with profiling.span("predict.upload"):
                staged = put_new(new)
            profiling.count("bytes_uploaded", new.nbytes)
            with profiling.span("predict.dispatch"):
                preds, carry = chunk_call(staged, carry)
            predictions.append(preds)
            profiling.count("chunks", 1)
            profiling.count("windows_computed", n)

        with profiling.span("predict.readback"):
            raw = torch.cat(predictions, dim=0).cpu().numpy()
        profiling.count("predictions_kept", total)
        return predict_indexes, raw[:total]


def iter_source_frames(source) -> Iterator[tuple[int, np.ndarray]]:
    """(index, frame) sequential-decode iterator over a FrameSource."""
    for idx in range(source.num_frames):
        yield idx, source.fetch_frame()
