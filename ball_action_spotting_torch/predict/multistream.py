"""Multi-stream serving engines: many live videos per card (port of the JAX
package's ``predict/multistream.py``).

``MultiStreamPredictor`` runs K concurrent streams with the per-stream
semantics of ``StreamingPredictor`` (frame dict, stack-feature cache,
optional hflip TTA) but batches the device work of a tick across streams:

- every stream's newly needed stacks → one ``fwd2d`` call;
- every stream with a complete window → one ``fwd3d_head`` call.

Batch sizes vary from tick to tick, so each call pads up to a bucket:
powers of two up to 8, one step at 12, 16, then multiples of
``bucket_granularity`` (default 8). Padding rows repeat the last row and
are discarded. Nothing compiles here, but the first call at a batch shape
picks cuDNN's algorithms and grows the allocator, so a bounded set of
shapes is still what ``warmup`` pays for before serving.

``MultiStreamPredictor(mesh=...)`` spreads each tick over the data axis of
a device grid (``parallel/mesh.py``): the weights are copied to every
data-axis device, and each call's bucket, floored at the axis size and
rounded up to a multiple of it, is split into equal shares, one per
device, each launched on its device's current stream; a window's stack
features are copied to the device that predicts it, and the predictions are
gathered on the first device. With ``conv_int8`` the shares of one encoder
call take one activation scale, that of the whole padded bucket, as the
JAX package's sharded program does (``PredictorBase.run_shares``).

``DeviceStateMultiStreamPredictor`` keeps each stream's state on one
device instead, in two preallocated rings updated in place, so that a
tick is one ``_tick`` call (see its docstring).

``device_tick_ms`` and ``device_state_tick_ms`` time one steady-state tick
of each engine by differencing: the tick runs L0 and L1 times and the
result is the time difference over L1 − L0 (CUDA events on the card,
``perf_counter`` on the CPU).

Every entry point that runs the model enters ``torch.inference_mode``
itself: the mode is thread-local, and the HTTP server
(``predict/server.py``) calls the engines from its batcher thread.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ball_action_spotting_torch.predict.streaming import PredictorBase, _batched


def _loop_seconds(devices: Sequence[torch.device], fn: Callable, length: int) -> float:
    """Seconds for ``length`` calls of ``fn``: CUDA events around them on
    each card's stream (the longest span of the cards), the host clock on
    the CPU."""
    if devices[0].type == "cuda":
        devices = list(dict.fromkeys(devices))
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in devices]
        for dev, (start, _) in zip(devices, events):
            start.record(torch.cuda.current_stream(dev))
        for _ in range(length):
            fn()
        for dev, (_, end) in zip(devices, events):
            end.record(torch.cuda.current_stream(dev))
        for _, end in events:
            end.synchronize()
        return max(start.elapsed_time(end) for start, end in events) / 1e3
    t0 = time.perf_counter()
    for _ in range(length):
        fn()
    return time.perf_counter() - t0


def _differenced_ms(devices: Sequence[torch.device], tick: Callable,
                    scan_lengths: tuple[int, int], reps: int) -> tuple[float, dict]:
    """(ms per tick, best seconds by length): ``tick`` run L0 and L1 times,
    best of ``reps`` after one warm-up run per length."""
    times = {}
    with torch.inference_mode():
        for length in scan_lengths:
            _loop_seconds(devices, tick, length)
            times[length] = min(_loop_seconds(devices, tick, length) for _ in range(reps))
    l0, l1 = scan_lengths
    return (times[l1] - times[l0]) / (l1 - l0) * 1e3, times


def device_tick_ms(predictor: "MultiStreamPredictor", bucket: int,
                   scan_lengths: tuple[int, int] = (1, 9), reps: int = 3) -> tuple[float, dict]:
    """Steady-state tick latency of the host-state engine at a padded batch
    of ``bucket`` streams: in the steady state (staggered admission) every
    stream brings one new stack and one ready window per tick, so a tick is
    one ``fwd2d`` and one ``_fwd3d_rows`` at ``bucket`` rows (over a grid,
    each device's share of them). The window rows are the new features
    repeated, in place of the host's row gather.

    Returns ``(ms_per_tick, best_seconds_by_length)``."""
    pw, ph = predictor.image_size
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (bucket, predictor.model_stack_size, ph, pw), dtype=np.uint8)
    shares = [(model, torch.from_numpy(x[part]).to(dev))
              for dev, model, part in predictor._share_slices(bucket)]

    def tick():
        feats = predictor.run_shares([lambda model=model, xs=xs: predictor.fwd2d(xs, model)
                                      for model, xs in shares])  # (share, tta, h, w, C) each
        for (model, xs), f in zip(shares, feats):
            predictor._fwd3d_rows(torch.cat([f] * predictor.num_stacks), len(xs), model)

    return _differenced_ms([dev for dev, _ in predictor.shares], tick, scan_lengths, reps)


def device_state_tick_ms(predictor: "DeviceStateMultiStreamPredictor", bucket: int,
                         frames_per_slot: int = 1, scan_lengths: tuple[int, int] = (1, 9),
                         reps: int = 3) -> tuple[float, dict]:
    """Steady-state tick latency of the device-state engine: its mask-free
    tick (every slot active) at ``bucket`` slots × ``frames_per_slot``
    frames, on copies of the rings (the live streams' state stays as it
    is), the write phase advancing by ``frames_per_slot`` per tick as
    ``predict_batch`` advances it.

    Returns ``(ms_per_tick, best_seconds_by_length)``."""
    predictor._ensure_capacity(bucket)
    rng = np.random.default_rng(0)
    new = predictor.upload(rng.integers(
        0, 255, (bucket, frames_per_slot, predictor._ph, predictor._pw), dtype=np.uint8))
    active = torch.ones((bucket,), dtype=torch.bool, device=predictor.device)
    with torch.inference_mode():
        frames_ring = predictor._frames_ring.clone()
        feats_ring = predictor._feats_ring.clone()
    span = max(1, predictor._span)
    counter = itertools.count()

    def tick():
        phase = next(counter) * frames_per_slot % span
        predictor._tick(bucket, frames_per_slot, False, frames_ring, feats_ring, active, new,
                        phase)

    return _differenced_ms([predictor.device], tick, scan_lengths, reps)


def _bucket(n: int) -> int:
    """Next power of two ≥ n."""
    b = 1
    while b < n:
        b *= 2
    return b


class _StreamState:
    __slots__ = ("frames", "features")

    def __init__(self):
        self.frames: dict[int, np.ndarray] = {}
        self.features: dict[tuple[int, ...], torch.Tensor] = {}


class MultiStreamPredictor(PredictorBase):
    """Per-tick batched inference over many independent frame streams.

    Streams are keyed by caller-chosen ids. Feed with
    ``predict_batch([(stream_id, frame, frame_index), ...])`` → list of
    ``(stream_id, prediction | None, predict_index)`` in input order; a
    prediction is a (classes,) tensor on the device, not synchronised.
    Results match a dedicated ``StreamingPredictor`` per stream (same
    weights, same math; only the batching differs). ``mesh`` spreads each
    tick over the grid's data axis (module docstring); the engine's
    ``device`` is then the axis's first."""

    _min_bucket = 1  # the data axis's size: every padded batch is a multiple

    def __init__(self, *args, mesh=None, bucket_granularity: int = 8, **kwargs):
        if mesh is not None:
            kwargs["device"] = mesh.data_devices()[0]
        super().__init__(*args, **kwargs)
        devices = mesh.data_devices() if mesh is not None else [self.device]
        self.shares = self.place(self.model, devices)  # [(device, model)]
        self._min_bucket = len(devices)
        self._streams: dict = {}
        self._predict_offset = self.indexes_generator.make_stack_indexes(0)[-1]
        # above 16 rows, pad to multiples of this instead of the next power
        # of two (K = 33..63 streams would all pay bucket-64 compute); 0
        # keeps pure powers of two
        self.bucket_granularity = bucket_granularity
        # (program, rows) shapes run so far, ("tick", bucket, frames,
        # masked) on the device-state engine; ``warmup`` runs every shape
        # serving up to its stream count can reach
        self._shapes: set[tuple] = set()

    def _bucket_shape(self, n: int) -> int:
        """Padded batch size for ``n`` rows: the next power of two up to 8,
        one intermediate step (multiples of ``granularity / 2``, i.e. 12)
        between 8 and 16, then multiples of ``bucket_granularity``; floored
        at the grid's data-axis size and rounded up to a multiple of it, so
        that it splits into equal shares (a 6-device axis takes n = 7 to 12,
        not 8)."""
        b = _bucket(n)
        g = self.bucket_granularity
        if g and b > 16:
            b = -(-n // g) * g
        elif g and b == 16:
            half = max(4, g // 2)
            b = -(-n // half) * half
        b = max(b, self._min_bucket)
        return -(-b // self._min_bucket) * self._min_bucket

    def _share_slices(self, n: int) -> list:
        """[(device, model, rows)]: ``n`` padded rows in equal shares, one
        per data-axis device."""
        per = n // len(self.shares)
        return [(dev, model, slice(d * per, (d + 1) * per))
                for d, (dev, model) in enumerate(self.shares)]

    def _encode_stacks(self, batch: np.ndarray) -> list:
        """(nb, stack, H, W) padded u8 stacks → nb (tta, h, w, C) feature
        rows, each on the device of its share."""
        shares = self._share_slices(len(batch))
        feats = self.run_shares([
            lambda dev=dev, model=model, part=part: self.fwd2d(
                torch.from_numpy(batch[part]).to(dev), model)
            for dev, model, part in shares])
        rows = []
        for (_, _, part), f in zip(shares, feats):
            rows.extend(self._split_rows(f, part.stop - part.start))
        return rows

    def _predict_windows(self, rows: list, mb: int) -> torch.Tensor:
        """``mb`` windows' feature rows (``num_stacks`` each, in window
        order, on any devices) → (mb, classes) on the first device."""
        s = self.num_stacks
        preds = []
        for dev, model, part in self._share_slices(mb):
            share = rows[part.start * s:part.stop * s]
            stacked = torch.stack([r.to(dev, non_blocking=True) for r in share])
            preds.append(self._fwd3d_rows(stacked, part.stop - part.start, model))
        return torch.cat([p.to(self.device, non_blocking=True) for p in preds])

    def _split_rows(self, array: torch.Tensor, n: int) -> tuple:
        """The first ``n`` rows of ``array`` as views."""
        self._shapes.add(("split", n))
        return array[:n].unbind(0)

    def _fwd3d_rows(self, stacked: torch.Tensor, mb: int, model=None) -> torch.Tensor:
        """3D + head over window rows stacked as (mb·S, tta, h, w, C) →
        TTA-averaged (mb, classes)."""
        self._shapes.add(("fwd3d_rows", mb))
        s, t = self.num_stacks, self.num_tta
        w = stacked.reshape((mb, s, t) + stacked.shape[2:]).transpose(1, 2)  # (mb, tta, S, ...)
        preds = self.fwd3d_head(w.reshape((mb * t,) + w.shape[2:]), model)
        return preds.reshape(mb, t, -1).mean(dim=1)

    def warmup(self, max_streams: int, frames_per_tick: int = 1,
               include_rampup: bool = False) -> list[int]:
        """Run every tick shape reachable while serving up to ``max_streams``
        streams (``frames_per_tick`` frames each per ``predict_batch``), on
        zero inputs on the device: the whole bucket ladder below the
        steady-state shape, since a staggered ramp-up passes through it.
        ``include_rampup=True`` also covers simultaneous admission, whose
        first complete window encodes up to ``num_stacks`` stacks per stream
        in one tick. Returns the sorted buckets run."""
        rows = max(1, max_streams) * max(1, frames_per_tick)
        reach = self.num_stacks * rows if include_rampup else rows
        targets = sorted({self._bucket_shape(n) for n in range(1, reach + 1)})
        pw, ph = self.image_size
        with torch.inference_mode():
            for b in targets:
                rows = self._encode_stacks(np.zeros((b, self.model_stack_size, ph, pw),
                                                    np.uint8))
                preds = self._predict_windows(rows * self.num_stacks, b)
                self._split_rows(preds, b)[0].cpu()  # wait for the device
        return targets

    def reset_stream(self, stream_id) -> None:
        self._streams[stream_id] = _StreamState()

    def close_stream(self, stream_id) -> None:
        self._streams.pop(stream_id, None)

    def _state(self, stream_id) -> _StreamState:
        state = self._streams.get(stream_id)
        if state is None:
            state = _StreamState()
            self._streams[stream_id] = state
        return state

    def predict_batch(self, items: Sequence[tuple]) -> list[tuple[object, Optional[torch.Tensor], int]]:
        with torch.inference_mode():
            return self._predict_batch(items)

    def _predict_batch(self, items: Sequence[tuple]) -> list:
        gen = self.indexes_generator
        # 1) ingest frames, resolve each item's lagging window. The window's
        # frames are snapshotted into the plan: a later item of the same
        # stream in this batch moves the eviction horizon past them.
        plans = []  # (stream_id, state, predict_index, stacks or None, window frames)
        for stream_id, frame, index in items:
            state = self._state(stream_id)
            state.frames[index] = self.pad_frame(np.asarray(frame))
            predict_index = index - self._predict_offset
            window = gen.make_stack_indexes(predict_index)
            low = window[0]
            for i in [i for i in state.frames if i < low]:
                del state.frames[i]
            for k in [k for k in state.features if any(i < low for i in k)]:
                del state.features[k]
            if set(window) <= set(state.frames):
                stacks = list(_batched(window, self.model_stack_size))
                window_frames = {i: state.frames[i] for i in window}
            else:
                stacks = window_frames = None
            plans.append((stream_id, state, predict_index, stacks, window_frames))

        # 2) one 2D call for every missing stack across all streams
        missing = []
        seen = set()
        for _, state, _, stacks, window_frames in plans:
            for stack in stacks or ():
                key = (id(state), stack)
                if stack not in state.features and key not in seen:
                    seen.add(key)
                    missing.append((state, stack, window_frames))
        if missing:
            batch = np.stack([np.stack([frames[i] for i in stack])
                              for _, stack, frames in missing])
            n = len(missing)
            nb = self._bucket_shape(n)
            if nb != n:  # pad with repeats to the bucket
                batch = np.concatenate([batch, np.repeat(batch[-1:], nb - n, axis=0)])
            rows = self._encode_stacks(batch)
            for j, (state, stack, _) in enumerate(missing):
                state.features[stack] = rows[j]  # (tta, h, w, C)

        # 3) one 3D + head call for every complete window
        ready = [p for p in plans if p[3]]
        results: dict[int, torch.Tensor] = {}
        if ready:
            rows_list = [state.features[s] for _, state, _, stacks, _ in ready for s in stacks]
            m = len(ready)
            mb = self._bucket_shape(m)
            if mb != m:
                rows_list.extend(rows_list[-self.num_stacks:] * (mb - m))
            preds = self._predict_windows(rows_list, mb)  # (mb, classes)
            pred_rows = self._split_rows(preds, mb)
            for j, plan in enumerate(ready):
                results[id(plan)] = pred_rows[j]

        return [(plan[0], results.get(id(plan)), plan[2]) for plan in plans]


class DeviceStateMultiStreamPredictor(MultiStreamPredictor):
    """Multi-stream serving with each stream's state on the device: a tick
    is one ``_tick`` call.

    - A frame ring ``(cap, fr, H, W)`` u8 and a phase-keyed feature store
      ``(cap, span, S-1, tta, h, w, C)`` in the compute dtype are
      preallocated on the device, one row per stream slot, and updated in
      place. ``fr = (stack-1)·step + 1`` frames are what the newest stack
      needs. The window of predict index p reads the newest stacks of the
      ticks ``span·k`` ago, k = 0..S-1, so a stored row is only read at ages
      that are multiples of ``span``: the store splits into ``span``
      sub-rings of S-1 rows keyed by write phase (tick index mod span), and
      a tick reads and shifts only its phase's sub-ring. A slot that skipped
      a dispatch falls out of phase with the global counter; before its next
      tick the host rolls its (span, S-1) plane (``_realign_fn``).
    - Slots are compact (live streams hold rows 0..K-1; ``close_stream``
      moves the last row into the hole), so a tick reads the ring prefix
      ``[:bucket]`` by slicing, with no gather. An ``(active,)`` mask keeps
      the rows of streams that fed no frame this tick unchanged, to the
      byte; when every row is active the mask-free variant skips the select.

    Per-slot semantics in the steady state (one new stack and one ready
    window per frame) are those of ``StreamingPredictor``. Each stream must
    feed consecutive frame indexes (a gap raises). Predictions surface once
    the stream has fed a full window (``behind + ahead + 1`` frames), when
    the host-state engine's first prediction appears."""

    def __init__(self, *args, slot_capacity: int = 8, **kwargs):
        if kwargs.get("mesh") is not None:
            raise ValueError(
                "DeviceStateMultiStreamPredictor is single-chip (capacity is a per-chip "
                "number); use MultiStreamPredictor(mesh=...) to spread host-state ticks "
                "over a mesh")
        super().__init__(*args, **kwargs)
        self._pw, self._ph = self.image_size
        m, step = self.model_stack_size, self.frame_stack_step
        self._span = m * step
        self._fr = (m - 1) * step + 1
        self._feat_hw_c: tuple[int, int, int] | None = None
        self._cap = 0
        self._frames_ring: torch.Tensor | None = None
        self._feats_ring: torch.Tensor | None = None
        # host bookkeeping: compact slot ids and per-stream progress only
        self._slot_of: dict = {}
        self._stream_at: list = []  # slot → stream id
        self._fed: dict = {}
        self._next_index: dict = {}
        # the global write phase (mod span) and each slot's last write phase
        self._phase = 0
        self._wp: dict[int, int] = {}
        self._window_span = self.indexes_generator.behind + self.indexes_generator.ahead + 1
        self._ensure_capacity(max(1, slot_capacity))

    # -- device state ------------------------------------------------------

    def _feat_shape(self) -> tuple[int, int, int]:
        """(h, w, C) of one stack's features, from one encoder forward of a
        zero stack on the device."""
        if self._feat_hw_c is None:
            x = torch.zeros((1, self._ph, self._pw, self.model_stack_size),
                            dtype=self.model.dtype, device=self.device)
            with torch.inference_mode():
                self._feat_hw_c = tuple(self.model.forward_2d_nhwc(x).shape[1:])
        return self._feat_hw_c

    def _ensure_capacity(self, n_slots: int) -> None:
        """Grow the rings to hold ``n_slots`` streams (bucketed): a new
        allocation with the live rows copied over."""
        cap = self._bucket_shape(n_slots)
        if cap <= self._cap:
            return
        fh, fw, fc = self._feat_shape()
        with torch.inference_mode():
            frames = torch.zeros((cap, self._fr, self._ph, self._pw), dtype=torch.uint8,
                                 device=self.device)
            feats = torch.zeros((cap, self._span, self.num_stacks - 1, self.num_tta, fh, fw, fc),
                                dtype=self.model.dtype, device=self.device)
            if self._frames_ring is not None:
                frames[: self._cap].copy_(self._frames_ring)
                feats[: self._cap].copy_(self._feats_ring)
        self._frames_ring, self._feats_ring = frames, feats
        self._cap = cap

    def _tick(self, bucket: int, f: int, masked: bool, frames_ring: torch.Tensor,
              feats_ring: torch.Tensor, active: torch.Tensor, new_frames: torch.Tensor,
              phase: int) -> torch.Tensor:
        """The tick for ``bucket`` slot rows × ``f`` consecutive frames per
        row → (bucket·f, classes) predictions, the rings updated in place.
        ``masked=False`` is the steady-state variant (every row active).
        ``active``: (bucket,) bool; ``new_frames``: (bucket, f, H, W) u8;
        ``phase``: the global write phase of local frame 0 (frame j lands at
        phase + j, distinct sub-rings as f ≤ span). Every slab is read into a
        new tensor before any write-back."""
        if f > self._span and self.num_stacks > 1:
            raise ValueError(
                f"device-state tick supports at most span={self._span} "
                f"frames per dispatch (got {f}); predict_batch splits "
                "bigger uniform backlogs into span-sized layers")
        self._shapes.add(("tick", bucket, f, masked))
        m, step, span, fr = self.model_stack_size, self.frame_stack_step, self._span, self._fr
        s, t = self.num_stacks, self.num_tta
        fr_rows = frames_ring[:bucket]
        ext = torch.cat([fr_rows, new_frames], dim=1)  # (bucket, fr + f, H, W)
        # the newest stack of local frame j ends at ext index fr + j; its
        # k-th frame sits (m-1-k)·step earlier
        stacks = torch.stack([ext[:, fr - (m - 1 - k) * step: fr - (m - 1 - k) * step + f]
                              for k in range(m)], dim=-1)  # (bucket, f, H, W, m)
        x = stacks.reshape((bucket * f,) + stacks.shape[2:])
        if self.tta:
            x = torch.cat([x, x.flip(2)], dim=0)
        feats = self.model.forward_2d_nhwc(x.to(self.model.dtype) / 255.0)
        # (t·bucket·f, h, w, C) → (bucket, f, t, h, w, C)
        new_feats = feats.reshape((t, bucket, f) + feats.shape[1:]).movedim(0, 2)
        wins, updates = [], []
        for j in range(f):
            nf = new_feats[:, j]  # (bucket, t, h, w, C)
            if s > 1:
                ph_j = (phase + j) % span
                slab = feats_ring[:bucket, ph_j]  # (bucket, S-1, t, h, w, C), oldest first
                window = torch.cat([slab, nf[:, None]], dim=1)  # (bucket, S, t, ...)
                advanced = window[:, 1:]
                if masked:
                    advanced = torch.where(active[:, None, None, None, None, None],
                                           advanced, slab)
                updates.append((ph_j, advanced))
                wins.append(window.transpose(1, 2))
            else:
                wins.append(nf[:, :, None])
        wins = torch.stack(wins, dim=1)  # (bucket, f, t, S, h, w, C)
        logits = self.model.forward_3d_head(wins.reshape((bucket * f * t,) + wins.shape[3:]))
        preds = torch.sigmoid(logits.float()).reshape(bucket, f, t, -1).mean(dim=2)
        advanced_frames = ext[:, f: f + fr]
        if masked:
            advanced_frames = torch.where(active[:, None, None, None], advanced_frames, fr_rows)
        frames_ring[:bucket].copy_(advanced_frames)
        for ph_j, advanced in updates:
            feats_ring[:bucket, ph_j].copy_(advanced)
        return preds.reshape(bucket * f, -1)

    # -- stream lifecycle ----------------------------------------------------

    def _slot(self, stream_id) -> int:
        slot = self._slot_of.get(stream_id)
        if slot is None:
            slot = len(self._stream_at)  # compact: append at the end
            if slot >= self._cap:
                self._ensure_capacity(self._cap * 2)
            self._slot_of[stream_id] = slot
            self._stream_at.append(stream_id)
            self._fed[stream_id] = 0
            self._next_index[stream_id] = None
        return slot

    def reset_stream(self, stream_id) -> None:
        if stream_id in self._slot_of:
            self._fed[stream_id] = 0
            self._next_index[stream_id] = None

    def _realign_fn(self, slot: int, d: int) -> None:
        """Roll one slot's (span, S-1) plane by ``d`` phases: a slot that
        skipped ``d`` global ticks has every stored row keyed ``d`` phases
        early."""
        with torch.inference_mode():
            plane = self._feats_ring[slot]
            plane.copy_(torch.roll(plane, d, dims=0))

    def _move_fn(self, src: int, dst: int) -> None:
        """Copy slot row ``src`` into row ``dst`` (two distinct rows)."""
        with torch.inference_mode():
            self._frames_ring[dst].copy_(self._frames_ring[src])
            self._feats_ring[dst].copy_(self._feats_ring[src])

    def close_stream(self, stream_id) -> None:
        slot = self._slot_of.pop(stream_id, None)
        if slot is None:
            return
        self._fed.pop(stream_id, None)
        self._next_index.pop(stream_id, None)
        last = len(self._stream_at) - 1
        if slot != last:
            # keep slots compact: move the last row into the hole
            mover = self._stream_at[last]
            self._move_fn(last, slot)
            self._stream_at[slot] = mover
            self._slot_of[mover] = slot
            if last in self._wp:
                self._wp[slot] = self._wp[last]
        self._wp.pop(last, None)
        self._stream_at.pop()

    # -- serving -------------------------------------------------------------

    def warmup(self, max_streams: int, frames_per_tick: int = 1) -> list[int]:
        """Run the reachable tick ladder, both variants, at 1 and
        ``frames_per_tick`` frames per slot (ramp-up ticks run the same
        shapes, so there is no ``include_rampup``). The masked ticks run
        with every row inactive, so the live rings keep their bytes; the
        mask-free ones run on copies of the rings."""
        self._ensure_capacity(max_streams)
        warmed = sorted({self._bucket_shape(n) for n in range(1, max(1, max_streams) + 1)})
        fs = sorted({1, max(1, frames_per_tick)})
        with torch.inference_mode():
            for b in warmed:
                inactive = torch.zeros((b,), dtype=torch.bool, device=self.device)
                for f in fs:
                    new = torch.zeros((b, f, self._ph, self._pw), dtype=torch.uint8,
                                      device=self.device)
                    self._tick(b, f, True, self._frames_ring, self._feats_ring, inactive,
                               new, self._phase).cpu()
                    self._tick(b, f, False, self._frames_ring.clone(),
                               self._feats_ring.clone(), ~inactive, new, self._phase).cpu()
        if self.num_stacks > 1 and self._span > 1:
            self._realign_fn(0, 0)  # the ragged-traffic roll; d = 0 is the identity
        return warmed

    def _predict_batch(self, items: Sequence[tuple]) -> list:
        # group consecutive frames per stream, keeping the input order
        per_stream: dict = {}
        order: list = []
        for stream_id, frame, index in items:
            lst = per_stream.get(stream_id)
            if lst is None:
                per_stream[stream_id] = lst = []
                order.append(stream_id)
            expected = self._next_index.get(stream_id)
            if lst:
                if index != lst[-1][1] + 1:
                    raise ValueError(
                        f"device-state stream {stream_id!r} frames must be "
                        f"consecutive (got {index} after {lst[-1][1]})")
            elif self._fed.get(stream_id, 0) and expected is not None and index != expected:
                raise ValueError(
                    f"device-state stream {stream_id!r} frames must be "
                    f"consecutive (got {index}, expected {expected})")
            lst.append((self.pad_frame(np.asarray(frame)), index))

        results: dict = {}
        counts = {len(v) for v in per_stream.values()}
        if len(counts) == 1:
            # uniform (the steady state): one tick at (bucket, F); backlogs
            # deeper than span split into span-sized layers, since a tick's
            # frames must land on distinct phases
            f = next(iter(counts))
            step = self._span if self.num_stacks > 1 else f
            layers = [(min(step, f - off), [(sid, per_stream[sid][off:off + step]) for sid in order])
                      for off in range(0, f, step)]
        else:
            # ragged backlogs: one F=1 layer per depth
            layers = [(1, [(sid, [per_stream[sid][d]]) for sid in order
                           if len(per_stream[sid]) > d])
                      for d in range(max(counts))]
        for f, layer in layers:
            self._dispatch(layer, f, results)
        return [(stream_id, results.get((stream_id, index)), index - self._predict_offset)
                for stream_id, _, index in items]

    def _dispatch(self, layer: list, f: int, results: dict) -> None:
        slots = [self._slot(sid) for sid, _ in layer]  # may grow the rings
        # the tick reads the compact slot prefix, so the bucket covers every
        # live stream, not just this layer's
        b = self._bucket_shape(len(self._stream_at))
        active = np.zeros((b,), bool)
        # padding slots (no stream owns them) may advance: a stream's first
        # prediction depends only on its own last ring writes, which is also
        # what makes a slot safe to reuse after close_stream
        active[len(self._stream_at):] = True
        new = np.zeros((b, f, self._ph, self._pw), np.uint8)
        for (sid, frames), slot in zip(layer, slots):
            active[slot] = True
            for k, (frame, _) in enumerate(frames):
                new[slot, k] = frame
        span, phi = self._span, self._phase
        if self.num_stacks > 1 and span > 1:
            # realign slots whose last write is not one global tick behind
            # (they skipped dispatches); the steady state never does
            for (sid, _), slot in zip(layer, slots):
                if self._fed.get(sid, 0):
                    d = (phi - 1 - self._wp.get(slot, phi - 1)) % span
                    if d:
                        self._realign_fn(slot, d)
        preds = self._tick(b, f, not bool(active.all()), self._frames_ring, self._feats_ring,
                           torch.from_numpy(active).to(self.device), self.upload(new), phi)
        for slot in slots:
            self._wp[slot] = (phi + f - 1) % span
        self._phase = (phi + f) % span
        pred_rows = self._split_rows(preds, b * f)
        for (sid, frames), slot in zip(layer, slots):
            fed = self._fed[sid]
            for k, (_, index) in enumerate(frames):
                fed += 1
                if fed >= self._window_span:
                    results[(sid, index)] = pred_rows[slot * f + k]
            self._fed[sid] = fed
            self._next_index[sid] = frames[-1][1] + 1
