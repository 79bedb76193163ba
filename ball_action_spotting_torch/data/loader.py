"""Host-side batched clip loading with prefetch to the device (port of the
JAX package's ``data/loader.py``).

Decode runs in a thread pool (OpenCV/FFmpeg and numpy release the GIL) and
workers assemble WHOLE batches in place into pooled, reused uint8 buffers,
writing each frame once at its padded position. Batches complete in
whichever order workers finish unless ``ordered=True``.

Buffer lifetime: yielded arrays are read-only views of a rotating
per-worker pool and stay valid for at least ``POOL_DEPTH - queue capacity``
further iterations: consume them (``prefetch_to_device`` copies them out at
once) before iterating on, or pass ``copy_out=True``. Setting
``BAS_TPU_LOADER_POISON=1`` fills every reused slot with 0xAB at acquire, so
a stale view reads visibly wrong pixels in tests.

``prefetch_to_device`` copies each batch out of its pool slot into pinned
host memory and starts a non-blocking copy to the card on a side stream;
the consumer's stream waits on that copy's event, so the host assembles
and uploads later batches while the card computes.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ball_action_spotting_torch.data.dataset import ClipDataset

POOL_DEPTH = 4
RESULT_QUEUE_BATCHES = 2


def _poison_enabled() -> bool:
    return os.environ.get("BAS_TPU_LOADER_POISON", "0") == "1"


class _BufferPool:
    """Rotating (frames, targets) batch buffers, zeroed on first use."""

    def __init__(self, batch_size: int, clip_len: int, height: int, width: int,
                 num_classes: int):
        self.frames = [
            np.zeros((batch_size, clip_len, height, width), np.uint8)
            for _ in range(POOL_DEPTH)
        ]
        self.targets = [
            np.zeros((batch_size, num_classes), np.float32)
            for _ in range(POOL_DEPTH)
        ]
        # last written native (h, w) per (slot, batch position): the padded
        # border only needs re-zeroing when the source resolution changes
        self.written: list[list[Optional[tuple[int, int]]]] = [
            [None] * batch_size for _ in range(POOL_DEPTH)
        ]
        self._next = 0

    def acquire(self):
        slot = self._next
        self._next = (self._next + 1) % POOL_DEPTH
        if _poison_enabled():
            # make stale views of this slot visibly wrong (debug aid);
            # (-1, -1) forces the writer's border re-zero for every sample
            # (None would skip it and leave 0xAB in the padding)
            self.frames[slot].fill(0xAB)
            self.targets[slot].fill(np.float32(-1e9))
            self.written[slot] = [(-1, -1)] * len(self.written[slot])
        return slot, self.frames[slot], self.targets[slot], self.written[slot]


class ClipLoader:
    """Iterable over (frames uint8 (B,T,H,W), targets f32 (B,C)) batches."""

    def __init__(
        self,
        dataset: ClipDataset,
        batch_size: int,
        num_workers: int = 4,
        drop_last: bool = False,
        source_cache_size: int = 4,
        copy_out: bool = False,
        ordered: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.source_cache_size = source_cache_size
        self.copy_out = copy_out
        # ordered=True yields batches in index order regardless of worker
        # completion order → bitwise-reproducible training runs at any
        # worker count (batch CONTENT is always deterministic either way)
        self.ordered = ordered

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # --- worker side ---------------------------------------------------

    def _clip_len(self) -> int:
        return self.dataset.indexes_generator.size

    def _image_hw(self) -> tuple[int, int]:
        if self.dataset.image_size is not None:
            w, h = self.dataset.image_size
            return h, w
        v = self.dataset.videos_data[0]
        return v["height"], v["width"]

    def _worker(self, index_q, result_q, epoch, stop_event):
        ds = self.dataset
        height, width = self._image_hw()
        pool = _BufferPool(
            self.batch_size, self._clip_len(), height, width,
            len(ds.classes) if hasattr(ds, "classes") else ds.target_process_fn(
                ds.get_targets(0, [0])
            ).shape[-1],
        )
        local = collections.OrderedDict()  # video_path -> FrameSource

        def get_source(video_index):
            data = ds.videos_data[video_index]
            path = data["video_path"]
            src = local.get(path)
            if src is None:
                src = ds.source_factory(data)
                local[path] = src
                if len(local) > self.source_cache_size:
                    _, old = local.popitem(last=False)
                    old.close()
            return src

        try:
            while not stop_event.is_set():
                try:
                    batch_id, chunk = index_q.get_nowait()
                except queue.Empty:
                    break
                _, frames_buf, targets_buf, written = pool.acquire()
                for j, index in enumerate(chunk):
                    video_index, frame_indexes = ds.get_video_frame_indexes(
                        index, epoch
                    )
                    src = get_source(video_index)
                    vdata = ds.videos_data[video_index]
                    h, w = vdata["height"], vdata["width"]
                    top = (height - h) // 2
                    left = (width - w) // 2
                    if written[j] != (h, w):
                        if written[j] is not None:
                            frames_buf[j] = 0
                        written[j] = (h, w)
                    view = frames_buf[j][:, top : top + h, left : left + w]
                    src.fetch_frames_into(frame_indexes, view)
                    targets = ds.get_targets(video_index, frame_indexes)
                    targets_buf[j] = ds.target_process_fn(targets)
                k = len(chunk)
                # read-only views: a consumer mutating a pooled buffer
                # would silently corrupt a later batch
                fv, tv = frames_buf[:k], targets_buf[:k]
                fv.flags.writeable = False
                tv.flags.writeable = False
                result_q.put((batch_id, fv, tv))
        except Exception as exc:  # surface worker crashes to the consumer
            result_q.put(exc)
        finally:
            for src in local.values():
                src.close()
            try:
                result_q.put_nowait(None)  # worker-done sentinel
            except queue.Full:
                pass  # consumer already has enough to finish by count

    # --- consumer side ---------------------------------------------------

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        index_q: queue.Queue = queue.Queue()
        num_batches = 0
        for start in range(0, n, self.batch_size):
            chunk = list(range(start, min(start + self.batch_size, n)))
            if self.drop_last and len(chunk) < self.batch_size:
                break
            index_q.put((num_batches, chunk))
            num_batches += 1
        result_q: queue.Queue = queue.Queue(maxsize=RESULT_QUEUE_BATCHES)
        stop_event = threading.Event()
        workers = [
            threading.Thread(
                target=self._worker,
                args=(index_q, result_q, epoch, stop_event),
                daemon=True,
            )
            for _ in range(self.num_workers)
        ]
        for w in workers:
            w.start()

        try:
            done_workers = 0
            received = 0
            next_emit = 0
            held: dict[int, tuple] = {}  # ordered-mode reorder buffer
            while received < num_batches and done_workers < self.num_workers:
                item = result_q.get()
                if item is None:
                    done_workers += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                batch_id, frames, targets = item
                received += 1
                if self.copy_out or (self.ordered and batch_id != next_emit):
                    # held batches outlive their pool slot window → copy
                    frames, targets = frames.copy(), targets.copy()
                if not self.ordered:
                    yield frames, targets
                    continue
                held[batch_id] = (frames, targets)
                while next_emit in held:
                    yield held.pop(next_emit)
                    next_emit += 1
            while self.ordered and next_emit in held:
                yield held.pop(next_emit)
                next_emit += 1
        finally:
            stop_event.set()
            # drain so workers blocked on a full result queue can exit
            for _ in range(self.num_workers * (RESULT_QUEUE_BATCHES + 2)):
                if not any(w.is_alive() for w in workers):
                    break
                try:
                    result_q.get(timeout=0.05)
                except queue.Empty:
                    pass

    def __iter__(self):
        return self.epoch(0)


class _PinnedSlot:
    """One batch's pinned host staging and the event of its copy to the
    card; the staging is reused once that copy is done."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: Optional[tuple[torch.Tensor, ...]] = None
        self.copied: Optional[torch.cuda.Event] = None

    def stage(self, arrays, stream: torch.cuda.Stream):
        if self.copied is not None:
            self.copied.synchronize()
        if self.host is None or any(tuple(h.shape) != a.shape for h, a in zip(self.host, arrays)):
            self.host = tuple(torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype],
                                          pin_memory=True) for a in arrays)
        for h, a in zip(self.host, arrays):
            h.numpy()[...] = a  # the copy out of the loader's pool slot
        with torch.cuda.stream(stream):
            out = tuple(h.to(self.device, non_blocking=True) for h in self.host)
            self.copied = torch.cuda.Event()
            self.copied.record(stream)
        return out, self.copied


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


def prefetch_to_device(iterator: Iterator, device, size: int = 2) -> Iterator:
    """Move (frames, targets) batches to ``device`` ahead of consumption.

    Each batch is copied out of the loader's pool slot when it is taken
    from ``iterator``, so the slot may be reused at once. On a CUDA device
    that copy goes into pinned staging, then a non-blocking transfer on a
    side stream runs ``size`` batches ahead; the consumer's stream waits on
    the transfer's event before it uses the batch. On the CPU batches are
    copied into fresh tensors."""
    device = torch.device(device)
    buf: collections.deque = collections.deque()
    if device.type == "cuda":
        slots = [_PinnedSlot(device) for _ in range(size + 1)]
        side = torch.cuda.Stream(device)

        def put(i, batch):
            return slots[i % len(slots)].stage(batch, side)

        def take(item):
            out, copied = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            for t in out:
                t.record_stream(consumer)  # allocated on the side stream
            return out
    else:
        def put(i, batch):
            return tuple(torch.from_numpy(np.array(a)) for a in batch)

        def take(item):
            return item

    for i, batch in enumerate(iterator):
        buf.append(put(i, batch))
        if len(buf) > size:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())
