"""HTTP serving front end for the multi-stream engines (port of the JAX
package's ``predict/server.py``).

A small stdlib HTTP server that ingests live grayscale frames for many
concurrent streams, batches the device work across streams on one batcher
thread (``MultiStreamPredictor`` or ``DeviceStateMultiStreamPredictor``) and
exposes each stream's spotting results for polling. No extra dependencies:
``http.server`` and threads.

    python -m ball_action_spotting_torch.predict.server --checkpoint PATH \\
        [--device_state] [--tta] [--warmup_streams K] [--device cuda]

API (all JSON unless noted):
  POST /v1/streams/<id>/frames?index=N&height=H&width=W
        body: raw uint8 grayscale bytes (H·W). 202 on accept.
  GET  /v1/streams/<id>/results?since=K
        → {"results": [{"index": i, "probs": [...]}, ...], "next": K'}
        (``since`` is the cursor returned as ``next`` by the previous poll)
  POST /v1/streams/<id>/close   — drop stream state.
  GET  /healthz                 — {"ok": true, "streams": S}
  GET  /v1/stats                — counters (frames in, predictions out,
        ticks) + live observability: tick_latency_ms {p50, p99} over a
        rolling 2048-tick window, mean device batch occupancy, ingest
        queue depth

Design: request handlers only enqueue; one batcher thread drains the queue
and makes the batched device calls (``predict_batch``, which enters
``torch.inference_mode`` itself: the mode is thread-local). Each tick's
predictions are copied to the host in one copy on the batcher thread and
buffered per stream for polling, so a client never waits on the device.

The reference has no serving component (its ``src/predictors.py`` is
offline only).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
)

logger = logging.getLogger(__name__)


class _IngestQueue:
    """FIFO ingest queue with frame-only capacity: frames (each pins a full
    uint8 buffer) are bounded for backpressure; close markers are tiny
    control tuples and are always accepted IN PLACE, keeping their queue
    position relative to surrounding frames. This avoids the two failure
    modes of squeezing markers into a shared bound by eviction: dropping
    already-202-acknowledged frames of healthy streams, and re-enqueueing a
    displaced marker at the tail (reordering the close behind frames
    submitted after it, which would tear down a reopened stream
    mid-session)."""

    def __init__(self, frame_capacity: int):
        self._frame_capacity = int(frame_capacity)
        self._items: "deque[tuple]" = deque()
        self._frames = 0
        self._not_empty = threading.Condition(threading.Lock())

    def put_frame(self, item: tuple) -> bool:
        with self._not_empty:
            if self._frames >= self._frame_capacity:
                return False
            self._items.append(item)
            self._frames += 1
            self._not_empty.notify()
        return True

    def put_marker(self, item: tuple) -> None:
        with self._not_empty:
            self._items.append(item)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None) -> tuple:
        with self._not_empty:
            if not self._items and timeout:
                self._not_empty.wait(timeout)
            if not self._items:
                raise queue.Empty
            item = self._items.popleft()
            if item[1] is not None:  # frame (markers carry frame=None)
                self._frames -= 1
            return item

    def get_nowait(self) -> tuple:
        return self.get(timeout=None)

    def qsize(self) -> int:
        with self._not_empty:
            return len(self._items)


class SpottingService:
    """Batches frames across streams onto the device; thread-safe facade
    over a multi-stream engine."""

    def __init__(self, predictor, max_batch: int = 64,
                 tick_timeout_s: float = 0.005, result_capacity: int = 4096,
                 ingest_capacity: int = 1024):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.tick_timeout_s = float(tick_timeout_s)
        self.result_capacity = int(result_capacity)
        # frame slots bounded: each queued frame pins a full buffer; clients
        # that outrun the device get 503s (backpressure) instead of growing
        # host memory without limit. Close markers bypass the frame bound
        # (see _IngestQueue).
        self._ingest = _IngestQueue(int(ingest_capacity))
        self._results: dict[str, list[tuple[int, list[float]]]] = {}
        # absolute sequence number of each stream's first buffered result:
        # poll cursors are ABSOLUTE, so trimming old results never starves
        # or double-serves a client
        self._results_base: dict[str, int] = {}
        self._results_lock = threading.Lock()
        self._stats = {"frames_in": 0, "predictions_out": 0, "ticks": 0}
        # rolling observability window (batcher thread writes, stats()
        # reads under the lock): per-tick device latency + batch occupancy
        self._tick_lat_s: deque[float] = deque(maxlen=2048)
        self._tick_batch: deque[int] = deque(maxlen=2048)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="spotting-batcher")
        self._thread.start()

    # -- ingest/poll API (called from HTTP handler threads) -------------------

    def submit_frame(self, stream_id: str, frame: np.ndarray, index: int) -> bool:
        """Enqueue for the batcher; False when the ingest queue is full
        (caller should surface backpressure, e.g. HTTP 503)."""
        if not self._ingest.put_frame((stream_id, frame, index)):
            return False
        with self._results_lock:  # handler threads race on +=
            self._stats["frames_in"] += 1
        return True

    def poll_results(self, stream_id: str, since: int) -> tuple[list, int]:
        """``since`` is the absolute cursor returned as ``next`` by the
        previous poll; results older than the retention window are gone
        (a cursor before the window resumes at its start)."""
        with self._results_lock:
            buf = self._results.get(stream_id, [])
            base = self._results_base.get(stream_id, 0)
            out = [
                {"index": idx, "probs": probs}
                for idx, probs in buf[max(0, since - base):]
            ]
            return out, base + len(buf)

    def close_stream(self, stream_id: str) -> None:
        # route through the batcher queue so BOTH predictor state and the
        # result buffers are torn down on the batcher thread, in queue
        # order: purging results on the handler thread left frames already
        # enqueued ahead of the marker to re-create ``_results[sid]`` (a
        # zombie stream in /healthz counts). The marker bypasses the frame
        # capacity bound (it pins no frame buffer), so it lands in its true
        # FIFO position even under backpressure — no eviction of
        # acknowledged frames, no reordering, no blocking put that could
        # wedge the handler thread on a dead batcher.
        self._ingest.put_marker((stream_id, None, -1))

    def stats(self) -> dict:
        with self._results_lock:
            streams = len(self._results)
            lat = list(self._tick_lat_s)
            occ = list(self._tick_batch)
        out = dict(self._stats, streams=streams,
                   queue_depth=self._ingest.qsize())
        if lat:
            q50, q99 = np.percentile(lat, [50, 99])
            out["tick_latency_ms"] = {
                "p50": round(float(q50) * 1e3, 3),
                "p99": round(float(q99) * 1e3, 3),
                "window": len(lat),
            }
            out["tick_batch_mean"] = round(float(np.mean(occ)), 2)
        return out

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # -- batcher thread --------------------------------------------------------

    def _drain(self) -> list[tuple]:
        """Up to ``max_batch`` queued items; blocks briefly for the first."""
        items: list[tuple] = []
        try:
            items.append(self._ingest.get(timeout=self.tick_timeout_s))
        except queue.Empty:
            return items
        while len(items) < self.max_batch:
            try:
                items.append(self._ingest.get_nowait())
            except queue.Empty:
                break
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            raw = self._drain()
            if not raw:
                continue
            batch = []
            for stream_id, frame, index in raw:
                if frame is None:  # close marker — honor queue order:
                    # flush frames enqueued ahead of it, THEN tear down
                    self._predict_and_record(batch)
                    batch = []
                    self.predictor.close_stream(stream_id)
                    with self._results_lock:
                        self._results.pop(stream_id, None)
                        self._results_base.pop(stream_id, None)
                    continue
                batch.append((stream_id, frame, index))
            self._predict_and_record(batch)

    def _predict_and_record(self, batch: list) -> None:
        if not batch:
            return
        t0 = time.perf_counter()
        try:
            results = self.predictor.predict_batch(batch)
        except Exception:
            logger.exception("predict_batch failed; dropping %d frames",
                             len(batch))
            return
        self._stats["ticks"] += 1
        materialized = _to_host(results)
        # the copy to the host waits for the device, so this measures the
        # whole tick (the dispatch alone would read ~0)
        with self._results_lock:
            self._tick_lat_s.append(time.perf_counter() - t0)
            self._tick_batch.append(len(batch))
            for sid, pred, idx in materialized:
                if pred is None:
                    continue
                self._record_result(sid, idx, [float(p) for p in pred])

    def _record_result(self, sid: str, idx: int, probs: list) -> None:
        """Append under ``_results_lock``; trims to ``result_capacity`` and
        advances the stream's absolute base so poll cursors stay valid."""
        buf = self._results.setdefault(sid, [])
        buf.append((idx, probs))
        if len(buf) > self.result_capacity:
            trim = len(buf) - self.result_capacity
            del buf[:trim]
            self._results_base[sid] = self._results_base.get(sid, 0) + trim
        self._stats["predictions_out"] += 1


def _to_host(results: list) -> list:
    """``predict_batch`` results with each prediction as a numpy row: the
    tick's predictions are stacked and copied to the host once (a copy per
    row would wait on the device once per stream)."""
    live = [pred for _, pred, _ in results if pred is not None]
    rows = iter(torch.stack([torch.as_tensor(p) for p in live]).cpu().numpy() if live else ())
    return [(sid, None if pred is None else next(rows), idx) for sid, pred, idx in results]


class _Handler(BaseHTTPRequestHandler):
    service: SpottingService  # set by make_server

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _parse(self):
        parsed = urllib.parse.urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        params = dict(urllib.parse.parse_qsl(parsed.query))
        return parts, params

    def do_GET(self):
        parts, params = self._parse()
        if parts == ["healthz"]:
            stats = self.service.stats()
            return self._json(200, {"ok": True, "streams": stats["streams"]})
        if parts == ["v1", "stats"]:
            return self._json(200, self.service.stats())
        if len(parts) == 4 and parts[:2] == ["v1", "streams"] and parts[3] == "results":
            since = int(params.get("since", 0))
            results, nxt = self.service.poll_results(parts[2], since)
            return self._json(200, {"results": results, "next": nxt})
        return self._json(404, {"error": "not found"})

    def do_POST(self):
        parts, params = self._parse()
        if len(parts) == 4 and parts[:2] == ["v1", "streams"]:
            stream_id = parts[2]
            if parts[3] == "frames":
                try:
                    index = int(params["index"])
                    height = int(params["height"])
                    width = int(params["width"])
                except (KeyError, ValueError):
                    return self._json(400, {"error": "index/height/width required"})
                length = int(self.headers.get("Content-Length", 0))
                if length != height * width:
                    return self._json(
                        400,
                        {"error": f"body must be {height * width} uint8 bytes"},
                    )
                body = self.rfile.read(length)
                frame = np.frombuffer(body, np.uint8).reshape(height, width)
                if not self.service.submit_frame(stream_id, frame, index):
                    return self._json(
                        503, {"error": "ingest queue full, retry later"})
                return self._json(202, {"accepted": True, "index": index})
            if parts[3] == "close":
                self.service.close_stream(stream_id)
                return self._json(200, {"closed": True})
        return self._json(404, {"error": "not found"})


class _Server(ThreadingHTTPServer):
    # The stdlib's listen backlog of 5 is short for clients that open a
    # connection per request: when the accept loop falls behind (it shares
    # the GIL with the batcher and the handlers), further connection
    # attempts are dropped and retried after 1, 3, 7 ... 63 s.
    request_queue_size = 1024


def make_server(predictor, host: str = "127.0.0.1", port: int = 0,
                **service_kwargs) -> tuple[ThreadingHTTPServer, SpottingService]:
    """Build (server, service). ``server.serve_forever()`` to run;
    ``service.stop()`` + ``server.shutdown()`` to tear down. ``port=0``
    binds an ephemeral port (``server.server_address[1]``)."""
    service = SpottingService(predictor, **service_kwargs)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = _Server((host, port), handler)
    return server, service


def build_engine(checkpoint_path=None, *, device_state: bool = False, **engine_kwargs):
    """The engine ``main`` serves: ``DeviceStateMultiStreamPredictor`` with
    ``device_state``, else ``MultiStreamPredictor``. ``engine_kwargs`` go
    to it (``tta``, ``device``, ``bucket_granularity``, ``s2d_stem``, or
    ``weights`` in place of the checkpoint, a ``.ckpt`` or reference
    ``.pth``); on a CUDA device the 3D blocks' depthwise conv runs the
    hand-written kernel, the engines' default."""
    engine_cls = DeviceStateMultiStreamPredictor if device_state else MultiStreamPredictor
    return engine_cls(checkpoint_path, **engine_kwargs)


def warm_engine(predictor, streams: int, max_batch: int) -> list[int]:
    """Run the tick shapes of up to ``streams`` concurrent streams, the
    backlog path too: a backlogged tick batches up to 2 frames per stream,
    capped by ``max_batch``. Returns the warmed buckets."""
    if isinstance(predictor, DeviceStateMultiStreamPredictor):
        # device-state ticks take a backlog as (bucket=K, F=2) ticks, not
        # wider row buckets
        return predictor.warmup(streams, frames_per_tick=2)
    return predictor.warmup(max(streams, min(max_batch, 2 * streams)))


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: serve a checkpoint. ``python -m
    ball_action_spotting_torch.predict.server --checkpoint ... --port 8080``."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--tta", action="store_true")
    parser.add_argument(
        "--max_batch", type=int, default=64,
        help="max frames one batcher tick passes to predict_batch. Set it "
             "above the expected concurrent stream count (ideally 2x, so a "
             "backlogged tick can batch 2 frames per stream): a cap below "
             "the stream count splits each tick into several small-bucket "
             "device calls")
    parser.add_argument(
        "--warmup_streams", type=int, default=0,
        help="run the tick shapes for up to this many concurrent streams "
             "before accepting traffic (the first call at a shape picks "
             "cuDNN's algorithms and grows the allocator)")
    parser.add_argument(
        "--bucket_granularity", type=int, default=8,
        help="tick batch shapes are rounded up to multiples of this above "
             "16 rows (plus one half-step at 12); finer steps matter at the "
             "realtime budget's edge. Cost: more shapes to warm up")
    parser.add_argument(
        "--device_state", action="store_true",
        help="device-resident per-stream state: one tick call per batch "
             "(frame and feature rings on the card). Requires each stream "
             "to feed consecutive frame indexes; the default host-state "
             "engine tolerates gaps")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (cuda, cuda:1, cpu)")
    parser.add_argument("--s2d_stem", action="store_true",
                        help="run the encoder's stem as the space-to-depth stem (exact)")
    args = parser.parse_args(argv)

    predictor = build_engine(args.checkpoint, device_state=args.device_state, tta=args.tta,
                             device=args.device, bucket_granularity=args.bucket_granularity,
                             s2d_stem=args.s2d_stem)
    if args.warmup_streams > 0:
        t0 = time.perf_counter()
        warmed = warm_engine(predictor, args.warmup_streams, args.max_batch)
        logger.info("warmed tick buckets %s in %.1f s", warmed,
                    time.perf_counter() - t0)
    server, service = make_server(
        predictor, args.host, args.port, max_batch=args.max_batch
    )
    logger.info("serving on %s:%d", *server.server_address)
    try:
        server.serve_forever()
    finally:
        service.stop()
        server.server_close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
