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

``ChunkedVideoPredictor(mesh=...)`` spreads each chunk over the data axis
of a device grid (``parallel/mesh.py``). Every engine reads a ``.ckpt`` or
a reference argus ``.pth`` and takes ``s2d_stem`` (the space-to-depth stem,
exact). Not ported yet: the ``spatial`` option and int8 convs.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from ball_action_spotting_torch.convert import jax_variables_to_state_dict
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.device import resolve_device
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.effnetv2 import stem_weight_to_s2d
from ball_action_spotting_torch.models.fold_bn import fold_bn_state_dict
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.parallel.multihost import process_slice
from ball_action_spotting_torch.predict.host_loop import (  # noqa: F401  (re-exported)
    iter_source_frames,
    pad_frame,
    run_chunk_loop,
)
from ball_action_spotting_torch.train.checkpoint import resolve_pretrain_variables


def _batched(seq, size):
    for i in range(0, len(seq), size):
        yield tuple(seq[i : i + size])


def load_inference_variables(checkpoint_path: Path | str, use_ema: bool = True,
                             fold_bn: bool = True, s2d_stem: bool = False) -> tuple[dict, dict]:
    """Checkpoint (``.ckpt`` or reference ``.pth``) → (port state_dict,
    params dict): EMA selection, the BN fold, then the optional s2d stem
    rewrite. The single loading path of every predictor."""
    variables, params = resolve_pretrain_variables(Path(checkpoint_path), use_ema)
    state = jax_variables_to_state_dict(variables, params["nn_module"][1])
    return inference_state(state, fold_bn, s2d_stem), params


def inference_state(state: dict, fold_bn: bool, s2d_stem: bool) -> dict:
    """An unfolded port state_dict → the inference engines' weights: BN
    folded into the convs (``models/fold_bn.py``), then, with ``s2d_stem``,
    the k3 s2 stem rewritten as the space-to-depth stem's k2 s1 conv on 4·C
    channels (exact, ``effnetv2.py::stem_kernel_to_s2d``)."""
    if fold_bn:
        state = fold_bn_state_dict(state)
    if s2d_stem:
        key = "conv2d_encoder.conv_stem.weight"
        state = {**state, key: stem_weight_to_s2d(state[key])}
    return state


class PredictorBase:
    """Model, weights and geometry shared by the engines.

    Weights come from ``checkpoint_path`` (a JAX ``.ckpt``) or, for callers
    that build them in memory, ``weights=(state_dict, params)`` with an
    unfolded port state_dict. ``device`` defaults to ``"cuda"`` and must
    exist; ``dtype`` is the compute dtype (bfloat16 by default, as on the
    TPU). ``dw3d_use_kernel`` routes the 3D blocks' depthwise conv through
    the hand-written kernel; by default it does so on a CUDA device, and
    ``False`` keeps the grouped ``conv3d`` there. ``s2d_stem`` runs the
    encoder's stem as the space-to-depth stem, on the same weights."""

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
        s2d_stem: bool = False,
    ):
        self.device = resolve_device(device)
        if dw3d_use_kernel is None:
            dw3d_use_kernel = self.device.type == "cuda"
        self._load_options = dict(use_ema=use_ema, dtype=dtype, fold_bn=fold_bn,
                                  dw3d_use_kernel=dw3d_use_kernel, s2d_stem=s2d_stem)
        self.model, params = self.load_model(checkpoint_path, weights)
        self.params = params
        self.tta = tta
        self.num_tta = 2 if tta else 1
        self.frame_stack_size = params["frame_stack_size"]
        self.frame_stack_step = params["frame_stack_step"]
        self.indexes_generator = StackIndexesGenerator(
            self.frame_stack_size, self.frame_stack_step)
        self.model_stack_size = self.model.stack_size
        self.num_stacks = self.model.num_stacks
        self.image_size = tuple(params["frames_processor"][1]["size"])  # (W, H)

    def load_model(self, checkpoint_path: Path | str | None = None,
                   weights: tuple[dict, dict] | None = None):
        """(model on this engine's device in eval mode, params dict) from a
        checkpoint or from ``weights``, with this engine's EMA choice,
        compute dtype, BN fold, stem and depthwise route."""
        opts = self._load_options
        if (checkpoint_path is None) == (weights is None):
            raise ValueError("pass exactly one of checkpoint_path and weights")
        if weights is None:
            state, params = load_inference_variables(
                checkpoint_path, use_ema=opts["use_ema"], fold_bn=opts["fold_bn"],
                s2d_stem=opts["s2d_stem"])
        else:
            state, params = weights
            state = inference_state(state, opts["fold_bn"], opts["s2d_stem"])
        nn_name, nn_kwargs = params["nn_module"]
        if nn_name != "multidim_stacker":
            raise ValueError(f"Unsupported nn_module {nn_name!r}")
        model = build_model(nn_name, dtype=opts["dtype"], bn_folded=opts["fold_bn"],
                            dw3d_use_kernel=opts["dw3d_use_kernel"],
                            **{**nn_kwargs, "stem_space_to_depth": opts["s2d_stem"]})
        model.load_state_dict(state, strict=True)
        return model.to(self.device).eval(), params

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
    """Batched offline engine (see module docstring).

    A chunk is split into shares, one per device of the data axis of
    ``mesh`` (``parallel/mesh.py::make_mesh``); without ``mesh`` the grid is
    this engine's device alone and its one share is the whole chunk. Every
    share's device encodes its part of the chunk's new stacks and predicts
    its part of the windows, from the stack features it needs, copied from
    the devices that encoded them (the counterpart of GSPMD's halo exchange
    in the JAX package); the predictions are gathered in order on the first
    device, and equal one device's. The model is copied to each distinct
    device; each device's work is launched on its own current stream.

    The chunk programs take the shares as an argument (``shares=None`` is
    this engine's own: ``[(device, model)]`` per data device), so that the
    fused ensemble (``predict/fused.py``) runs the same single-fold programs
    over its folds' models. ``spatial=True``, spatial partitioning, is not
    ported yet and raises."""

    def __init__(self, *args, chunk_size: int = 128, carry_features: bool = True,
                 mesh=None, spatial: bool = False, **kwargs):
        if spatial:
            raise NotImplementedError(
                "spatial=True (frame height over the mesh's model axis) is not ported yet; "
                "it is queued for the next slice of the port")
        if mesh is not None:
            kwargs["device"] = mesh.data_devices()[0]
        super().__init__(*args, **kwargs)
        self.chunk_size = chunk_size
        self.carry_features = carry_features
        self.mesh = mesh or make_mesh(1, 1, [self.device])
        m, step = self.model_stack_size, self.frame_stack_step
        self.stack_span = m * step
        # frames carried between chunks: stacks spanning the chunk boundary
        # plus the intra-stack reach
        self.overlap = (self.num_stacks - 1) * self.stack_span + (m - 1) * step
        self._frame_tail = (m - 1) * step  # frames only the new stacks need
        self._feat_tail = (self.num_stacks - 1) * self.stack_span  # carried stacks
        self.shares = self.place(self.model, self.mesh.data_devices())

    @staticmethod
    def place(model, devices) -> list:
        """[(device, ``model`` on it)] for each of ``devices``: one copy of
        the model per distinct device."""
        copies = {}
        for dev in devices:
            if dev not in copies:
                copies[dev] = model if next(model.parameters()).device == dev \
                    else copy.deepcopy(model).to(dev)
        return [(dev, copies[dev]) for dev in devices]

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

    def encode_2d(self, x: torch.Tensor, model=None) -> torch.Tensor:
        """Normalized (tta·batch, H, W, m) stacks → (tta, batch, h, w, C)."""
        feats = (model or self.model).forward_2d_nhwc(x)
        return feats.reshape((self.num_tta, -1) + feats.shape[1:])

    def head_from_feats(self, feats: torch.Tensor, model=None) -> torch.Tensor:
        """(tta, n + (S-1)·span, h, w, C) stack features → (n, classes)
        sigmoid predictions; window p's k-th stack is feats[p + k·span]."""
        span = self.stack_span
        n = feats.shape[1] - self._feat_tail
        windows = torch.stack(
            [feats[:, k * span : k * span + n] for k in range(self.num_stacks)], dim=2)
        flat = windows.reshape((self.num_tta * n,) + windows.shape[2:])  # tta-major
        logits = (model or self.model).forward_3d_head(flat)
        preds = torch.sigmoid(logits.float())
        return preds.reshape(self.num_tta, n, -1).mean(dim=0)

    @staticmethod
    def _split(count: int, shares: list) -> list:
        """[(device, model, slice)]: the non-empty parts of ``count`` items,
        one per share, in order."""
        out = []
        for d, (dev, model) in enumerate(shares):
            part = process_slice(count, d, len(shares))
            if part.stop > part.start:
                out.append((dev, model, part))
        return out

    def _encode_shares(self, frames: torch.Tensor, count: int, first: int, shares: list):
        """Stacks [0, count) of ``frames`` encoded in shares, one per
        (device, model) of ``shares`` → [(chunk stack index of the share's
        first, features on its device)]; stack j of ``frames`` is the
        chunk's stack ``first + j``."""
        reach = (self.model_stack_size - 1) * self.frame_stack_step
        work = self._split(count, shares)
        # every copy before any compute: a copy between devices runs on its
        # source device's stream, behind the work already queued there
        subs = [frames[part.start:part.stop + reach].to(dev) for dev, _, part in work]
        return [(first + part.start,
                 self.encode_2d(self.normalize_stacks(self._stacks(sub, part.stop - part.start)),
                                model))
                for (_, model, part), sub in zip(work, subs)]

    @staticmethod
    def _gather_feats(parts, lo: int, hi: int, device) -> torch.Tensor:
        """The features of the chunk's stacks [lo, hi) from ``parts``, on
        ``device``."""
        pieces = []
        for start, feats in parts:
            a, b = max(lo, start), min(hi, start + feats.shape[1])
            if a < b:
                pieces.append(feats[:, a - start:b - start].to(device))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)

    def _heads(self, parts, shares: list) -> torch.Tensor:
        """Each share's part of the chunk's N windows → (N, classes) on the
        first share's device, in order. Every share's features are copied
        before any head is queued."""
        inputs = [(model, self._gather_feats(parts, part.start, part.stop + self._feat_tail, dev))
                  for dev, model, part in self._split(self.chunk_size, shares)]
        preds = [self.head_from_feats(feats, model).to(shares[0][0]) for model, feats in inputs]
        return preds[0] if len(preds) == 1 else torch.cat(preds, dim=0)

    def chunk_frames(self, new_frames: torch.Tensor, carry: torch.Tensor, shares=None):
        """Frame carry: (N, H, W) u8 + (overlap, H, W) u8 → (preds, carry);
        encodes the stacks of the chunk's N + (S-1)·span windows."""
        shares = shares or self.shares
        frames = torch.cat([carry, new_frames], dim=0)
        parts = self._encode_shares(frames, self.chunk_size + self._feat_tail, 0, shares)
        return self._heads(parts, shares), frames[-self.overlap:]

    def chunk_features(self, new_frames: torch.Tensor, carry, shares=None):
        """Feature carry: (N, H, W) u8 + (frame tail, feature tail) →
        (preds, carry); encodes only the N new stacks. The next chunk's
        carried features come from the last shares; they move to the first
        share's device, whose share starts with them."""
        shares = shares or self.shares
        tail_u8, feat_carry = carry
        frames = torch.cat([tail_u8, new_frames], dim=0)
        n, tail = self.chunk_size, self._feat_tail
        parts = [(0, feat_carry)] + self._encode_shares(frames, n, tail, shares)
        new_feats = self._gather_feats(parts, n, n + tail, shares[0][0])
        return self._heads(parts, shares), (frames[-self._frame_tail:], new_feats)

    def bootstrap(self, first_frames: torch.Tensor, model=None):
        """First ``overlap`` frames → the initial feature carry (frame tail,
        the features of stacks 0..feat_tail-1)."""
        x = self.normalize_stacks(self._stacks(first_frames, self._feat_tail))
        return first_frames[-self._frame_tail:], self.encode_2d(x, model)

    # --- host loop -------------------------------------------------------

    def init_carry(self, first_frames_u8: np.ndarray):
        """Device carry from the first ``overlap`` (padded, uint8) frames."""
        frames = self.upload(first_frames_u8)
        return self.bootstrap(frames) if self.carry_features else frames

    def chunk_call(self) -> Callable:
        """The chunk program ``predict_video`` runs: feature or frame carry."""
        return self.chunk_features if self.carry_features else self.chunk_frames

    def predict_video(
        self,
        frames: Iterator[tuple[int, np.ndarray]],
        frame_count: int,
    ) -> tuple[list[int], np.ndarray]:
        """frames: iterator of (frame_index, grayscale uint8 frame) in order.
        Returns (frame_indexes, raw sigmoid predictions) over the contiguous
        range the streaming loop covers."""
        with torch.inference_mode():
            return run_chunk_loop(
                self.chunk_call(),
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
