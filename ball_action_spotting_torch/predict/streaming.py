"""Full-video inference engines (port of the JAX package's
``predict/streaming.py``: ``load_inference_variables``, ``pad_frame``,
``StreamingPredictor``, ``get_raw_predictions``, ``ChunkedVideoPredictor``,
``run_chunk_loop`` and ``iter_source_frames``).

Two engines over the same split forward:

- ``StreamingPredictor``, the per-frame streaming engine: a frame dict and a
  stack-feature cache, so that in the steady state one new stack goes
  through the 2D encoder per frame (``PredictorBase.fwd2d``) and one window
  through the 3D head (``PredictorBase.fwd3d_head``). Suited to live use;
  the serving engines of ``predict/multistream.py`` batch the same two
  programs across streams.
- ``ChunkedVideoPredictor``, the offline engine. Per chunk of N prediction
  indexes it runs the whole pipeline on the device: uint8 frames →
  channels-last stack assembly → u8 → compute dtype, then /255 (+ hflip
  TTA) → ``forward_2d_nhwc`` over the stacks → window slices →
  ``forward_3d_head`` → float32 sigmoid. The host uploads each frame once
  per chunk as one uint8 array; a carry rides along on the device between
  chunks: by default (``carry_features=True``) the overlap stacks' encoded
  features plus a short uint8 frame tail, seeded once by a bootstrap
  program from the first ``overlap`` frames; with ``carry_features=False``
  the ``overlap`` raw frames, whose stacks are then encoded again. Both give
  the same predictions.

The two engines keep the JAX package's orders of operations, which differ:
the streaming programs normalize in float32 and pool the concatenated
stack map; the chunked program normalizes in the compute dtype and pools
per stack.

Not ported yet: the multi-device ``mesh``/``spatial`` options, the
space-to-depth stem and int8 convs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from ball_action_spotting_torch.convert import jax_variables_to_state_dict
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.device import resolve_device
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.fold_bn import fold_bn_state_dict
from ball_action_spotting_torch.train.checkpoint import resolve_pretrain_variables


def _batched(seq, size):
    for i in range(0, len(seq), size):
        yield tuple(seq[i : i + size])


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


def load_inference_variables(checkpoint_path: Path | str, use_ema: bool = True,
                             fold_bn: bool = True) -> tuple[dict, dict]:
    """Checkpoint → (port state_dict, params dict): EMA selection, then the
    BN fold. The single loading path of every predictor."""
    variables, params = resolve_pretrain_variables(Path(checkpoint_path), use_ema)
    state = jax_variables_to_state_dict(variables, params["nn_module"][1])
    if fold_bn:
        state = fold_bn_state_dict(state)
    return state, params


class PredictorBase:
    """Model, weights and geometry shared by the engines.

    Weights come from ``checkpoint_path`` (a JAX ``.ckpt``) or, for callers
    that build them in memory, ``weights=(state_dict, params)`` with an
    unfolded port state_dict. ``device`` defaults to ``"cuda"`` and must
    exist; ``dtype`` is the compute dtype (bfloat16 by default, as on the
    TPU). ``dw3d_use_kernel`` routes the 3D blocks' depthwise conv through
    the hand-written kernel; by default it does so on a CUDA device, and
    ``False`` keeps the grouped ``conv3d`` there."""

    def __init__(
        self,
        checkpoint_path: Path | str | None = None,
        tta: bool = False,
        use_ema: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        fold_bn: bool = True,
        dw3d_use_kernel: bool | None = None,
        device: str | torch.device = "cuda",
        weights: tuple[dict, dict] | None = None,
    ):
        self.device = resolve_device(device)
        if dw3d_use_kernel is None:
            dw3d_use_kernel = self.device.type == "cuda"
        if (checkpoint_path is None) == (weights is None):
            raise ValueError("pass exactly one of checkpoint_path and weights")
        if weights is None:
            state, params = load_inference_variables(
                checkpoint_path, use_ema=use_ema, fold_bn=fold_bn)
        else:
            state, params = weights
            if fold_bn:
                state = fold_bn_state_dict(state)
        self.params = params
        nn_name, nn_kwargs = params["nn_module"]
        if nn_name != "multidim_stacker":
            raise ValueError(f"Unsupported nn_module {nn_name!r}")
        self.model = build_model(nn_name, dtype=dtype, bn_folded=fold_bn,
                                 dw3d_use_kernel=dw3d_use_kernel, **nn_kwargs)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.tta = tta
        self.num_tta = 2 if tta else 1
        self.frame_stack_size = params["frame_stack_size"]
        self.frame_stack_step = params["frame_stack_step"]
        self.indexes_generator = StackIndexesGenerator(
            self.frame_stack_size, self.frame_stack_step)
        self.model_stack_size = self.model.stack_size
        self.num_stacks = self.model.num_stacks
        self.image_size = tuple(params["frames_processor"][1]["size"])  # (W, H)

    def pad_frame(self, frame: np.ndarray) -> np.ndarray:
        return pad_frame(frame, self.image_size)

    def fwd2d(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(B, stack, H, W) padded u8 stacks → (B, tta, h, w, C) features:
        float32, /255, hflip TTA stacked tta-major, then ``forward_2d``."""
        x = frames_u8.float() / 255.0
        if self.tta:
            x = torch.cat([x, x.flip(-1)], dim=0)
        feats = self.model.forward_2d(x)[:, 0]  # (tta·B, h, w, C)
        feats = feats.reshape((self.num_tta, frames_u8.shape[0]) + feats.shape[1:])
        return feats.transpose(0, 1)

    def fwd3d_head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, num_stacks, h, w, C) features → (B, classes) float32
        sigmoids: ``forward_3d``, then ``forward_head`` (GeM over the
        concatenated stack map)."""
        logits = self.model.forward_head(self.model.forward_3d(feats))
        return torch.sigmoid(logits.float())

    def upload(self, frames_u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(frames_u8).to(self.device)


class StreamingPredictor(PredictorBase):
    """Per-frame streaming predictor with a frame dict and a stack-feature
    cache (the reference's ``MultiDimStackerPredictor``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._frame_index2frame: dict[int, np.ndarray] = {}
        self._stack_indexes2features: dict[tuple[int, ...], torch.Tensor] = {}
        self._predict_offset = self.indexes_generator.make_stack_indexes(0)[-1]

    def reset_buffers(self) -> None:
        self._frame_index2frame = {}
        self._stack_indexes2features = {}

    def _clear_old(self, minimum_index: int) -> None:
        for idx in [i for i in self._frame_index2frame if i < minimum_index]:
            del self._frame_index2frame[idx]
        stale = [k for k in self._stack_indexes2features if any(i < minimum_index for i in k)]
        for key in stale:
            del self._stack_indexes2features[key]

    def predict(self, frame: np.ndarray, index: int) -> tuple[torch.Tensor | None, int]:
        """Feed one decoded grayscale frame; returns (prediction, predict
        index). The prediction is None until the lagging window is full,
        else a (num_classes,) tensor on the device, not synchronised, so
        that decoding overlaps the device's work."""
        self._frame_index2frame[index] = self.pad_frame(np.asarray(frame))
        predict_index = index - self._predict_offset
        predict_indexes = self.indexes_generator.make_stack_indexes(predict_index)
        self._clear_old(predict_indexes[0])
        if not set(predict_indexes) <= set(self._frame_index2frame):
            return None, predict_index

        stacks_indexes = list(_batched(predict_indexes, self.model_stack_size))
        missing = [s for s in stacks_indexes if s not in self._stack_indexes2features]
        with torch.inference_mode():
            if missing:
                # one encoder call for every uncached stack (a stream's start
                # needs them all; the steady state needs one)
                frames = np.stack([np.stack([self._frame_index2frame[i] for i in stack])
                                   for stack in missing])
                feats = self.fwd2d(self.upload(frames))
                for j, stack in enumerate(missing):
                    self._stack_indexes2features[stack] = feats[j]  # (tta, h, w, C)
            feats = torch.stack([self._stack_indexes2features[s] for s in stacks_indexes],
                                dim=1)  # (tta, S, h, w, C)
            prediction = self.fwd3d_head(feats).mean(dim=0)
        return prediction, predict_index


class ChunkedVideoPredictor(PredictorBase):
    """Batched offline engine (see module docstring)."""

    def __init__(self, *args, chunk_size: int = 128, carry_features: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.chunk_size = chunk_size
        self.carry_features = carry_features
        m, step = self.model_stack_size, self.frame_stack_step
        self.stack_span = m * step
        # frames carried between chunks: stacks spanning the chunk boundary
        # plus the intra-stack reach
        self.overlap = (self.num_stacks - 1) * self.stack_span + (m - 1) * step
        self._frame_tail = (m - 1) * step  # frames only the new stacks need
        self._feat_tail = (self.num_stacks - 1) * self.stack_span  # carried stacks

    # --- device programs -------------------------------------------------

    def _stacks(self, frames: torch.Tensor, count: int) -> torch.Tensor:
        """(F, H, W) u8 → the first ``count`` stacks, (count, H, W, m) u8,
        stack axis last: stack f's j-th frame is frames[f + j·step]."""
        step = self.frame_stack_step
        return torch.stack(
            [frames[j * step : j * step + count] for j in range(self.model_stack_size)],
            dim=-1)

    def normalize_stacks(self, stacks: torch.Tensor) -> torch.Tensor:
        """(batch, H, W, m) u8 → (tta·batch, H, W, m) in the compute dtype:
        cast first, then /255; hflip TTA flips W and stacks tta-major."""
        if self.tta:
            stacks = torch.cat([stacks, stacks.flip(2)], dim=0)
        return stacks.to(self.model.dtype) / 255.0

    def encode_2d(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized (tta·batch, H, W, m) stacks → (tta, batch, h, w, C)."""
        feats = self.model.forward_2d_nhwc(x)
        return feats.reshape((self.num_tta, -1) + feats.shape[1:])

    def head_from_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """(tta, N + (S-1)·span, h, w, C) stack features → (N, classes)
        sigmoid predictions; window p's k-th stack is feats[p + k·span]."""
        n, span = self.chunk_size, self.stack_span
        windows = torch.stack(
            [feats[:, k * span : k * span + n] for k in range(self.num_stacks)], dim=2)
        flat = windows.reshape((self.num_tta * n,) + windows.shape[2:])  # tta-major
        logits = self.model.forward_3d_head(flat)
        preds = torch.sigmoid(logits.float())
        return preds.reshape(self.num_tta, n, -1).mean(dim=0)

    def chunk_frames(self, new_frames: torch.Tensor, carry: torch.Tensor):
        """Frame carry: (N, H, W) u8 + (overlap, H, W) u8 → (preds, carry)."""
        frames = torch.cat([carry, new_frames], dim=0)
        n_stacks = self.chunk_size + self._feat_tail
        x = self.normalize_stacks(self._stacks(frames, n_stacks))
        return self.head_from_feats(self.encode_2d(x)), frames[-self.overlap:]

    def chunk_features(self, new_frames: torch.Tensor, carry):
        """Feature carry: (N, H, W) u8 + (frame tail, feature tail) →
        (preds, carry); encodes only the N new stacks."""
        tail_u8, feat_carry = carry
        frames = torch.cat([tail_u8, new_frames], dim=0)
        x = self.normalize_stacks(self._stacks(frames, self.chunk_size))
        feats = torch.cat([feat_carry, self.encode_2d(x)], dim=1)
        preds = self.head_from_feats(feats)
        return preds, (frames[-self._frame_tail:], feats[:, -self._feat_tail:])

    def bootstrap(self, first_frames: torch.Tensor):
        """First ``overlap`` frames → the initial feature carry (frame tail,
        the features of stacks 0..feat_tail-1)."""
        x = self.normalize_stacks(self._stacks(first_frames, self._feat_tail))
        return first_frames[-self._frame_tail:], self.encode_2d(x)

    # --- host loop -------------------------------------------------------

    def init_carry(self, first_frames_u8: np.ndarray):
        """Device carry from the first ``overlap`` (padded, uint8) frames."""
        frames = self.upload(first_frames_u8)
        return self.bootstrap(frames) if self.carry_features else frames

    def predict_video(
        self,
        frames: Iterator[tuple[int, np.ndarray]],
        frame_count: int,
    ) -> tuple[list[int], np.ndarray]:
        """frames: iterator of (frame_index, grayscale uint8 frame) in order.
        Returns (frame_indexes, raw sigmoid predictions) over the contiguous
        range the streaming loop covers."""
        chunk = self.chunk_features if self.carry_features else self.chunk_frames
        with torch.inference_mode():
            return run_chunk_loop(
                chunk,
                indexes_generator=self.indexes_generator,
                chunk_size=self.chunk_size,
                overlap=self.overlap,
                image_size=self.image_size,
                num_classes=self.model.num_classes,
                frames=frames,
                frame_count=frame_count,
                put_new=self.upload,
                put_carry=self.init_carry,
            )


def run_chunk_loop(
    chunk_call: Callable,
    *,
    indexes_generator: StackIndexesGenerator,
    chunk_size: int,
    overlap: int,
    image_size: tuple[int, int],
    num_classes: int,
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
    of the video the last padded frame repeats."""
    gen = indexes_generator
    min_predict = gen.clip_index(0, frame_count, 1)
    max_predict = gen.clip_index(frame_count, frame_count, 1)
    if max_predict < min_predict:  # video shorter than one window
        return [], np.zeros((0, num_classes), np.float32)
    predict_indexes = list(range(min_predict, max_predict + 1))
    n = chunk_size
    tw, th = image_size

    frames_iter = iter(frames)
    last_frame = np.zeros((th, tw), dtype=np.uint8)

    def take_frames(count: int) -> np.ndarray:
        """Next ``count`` padded frames; repeats the last frame past EOF."""
        nonlocal last_frame
        out = np.empty((count, th, tw), dtype=np.uint8)
        for i in range(count):
            try:
                _, frame = next(frames_iter)
                last_frame = pad_frame(np.asarray(frame), image_size)
            except StopIteration:
                pass
            out[i] = last_frame
        return out

    take_frames(predict_indexes[0] - gen.behind)
    carry = put_carry(take_frames(overlap))

    predictions: list[torch.Tensor] = []
    total = len(predict_indexes)
    for _ in range(0, total, n):
        preds, carry = chunk_call(put_new(take_frames(n)), carry)
        predictions.append(preds)

    raw = torch.cat(predictions, dim=0).cpu().numpy()
    return predict_indexes, raw[:total]


def iter_source_frames(source) -> Iterator[tuple[int, np.ndarray]]:
    """(index, frame) sequential-decode iterator over a FrameSource."""
    for idx in range(source.num_frames):
        yield idx, source.fetch_frame()


def get_raw_predictions(predictor: StreamingPredictor, source,
                        frame_count: int | None = None) -> tuple[list[int], np.ndarray]:
    """The streaming engine's whole-video loop: (frame_indexes, raw sigmoid
    predictions) over the same range as ``ChunkedVideoPredictor``. The rows
    are stacked on the device and copied to the host once."""
    frame_count = frame_count or source.num_frames
    gen = predictor.indexes_generator
    min_index = gen.clip_index(0, frame_count, 1)
    max_index = gen.clip_index(frame_count, frame_count, 1)
    if max_index < min_index:  # video shorter than one window
        return [], np.zeros((0, predictor.model.num_classes), np.float32)
    predictor.reset_buffers()
    frame_index2prediction: dict[int, torch.Tensor] = {}
    frame_index = -1
    while True:
        frame = source.fetch_frame()
        frame_index += 1
        prediction, predict_index = predictor.predict(frame, frame_index)
        if prediction is not None and predict_index >= min_index:
            frame_index2prediction[predict_index] = prediction
        if predict_index >= max_index:
            break
    predictor.reset_buffers()
    frame_indexes = sorted(frame_index2prediction)
    with torch.inference_mode():
        raw = torch.stack([frame_index2prediction[i] for i in frame_indexes]).cpu().numpy()
    return frame_indexes, raw
