"""The port's HTTP serving front end (``predict/server.py``) on the CPU,
after ``tests/test_server.py``: live synthetic streams fed over HTTP to
either engine must yield what the port's per-stream ``StreamingPredictor``
gives (atol 1e-6, float32: the same weights and math, batched otherwise;
the engines are held to the JAX package's in
``tests/test_torch_multistream.py``), and the service's queue, cursors and
close markers behave as the JAX service's."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models.blocks3d import DepthwiseConv3d
from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
)
from ball_action_spotting_torch.predict.server import (
    SpottingService,
    ThreadingHTTPServer,
    _IngestQueue,
    _to_host,
    build_engine,
    main,
    make_server,
    warm_engine,
)
from ball_action_spotting_torch.predict.streaming import StreamingPredictor, get_raw_predictions
from tests.test_torch_predict import make_ckpt

FRAME_COUNT = 24
H, W = 64, 96
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("ckpt") / "model-001-0.500000.ckpt")


def _stream_frames(seed):
    src = SyntheticSource(num_frames=FRAME_COUNT, height=H, width=W, seed=seed,
                          events={10: 0, 18: 1})
    return np.stack([src.fetch_frame(i) for i in range(FRAME_COUNT)])


def _http(method, url, data=None):
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/octet-stream")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize(
    "engine_cls", [MultiStreamPredictor, DeviceStateMultiStreamPredictor],
    ids=["host_state", "device_state"])
def test_server_end_to_end(ckpt_path, engine_cls):
    """Both serving engines (host-state dicts vs device-resident rings —
    the server CLI's --device_state switch) must yield identical results
    through the full HTTP + batcher path."""
    predictor = engine_cls(ckpt_path, tta=False, dtype=torch.float32, device="cpu")
    server, service = make_server(predictor, max_batch=4)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, payload = _http("GET", f"{base}/healthz")
        assert status == 200 and payload["ok"]

        streams = {"a": _stream_frames(1), "b": _stream_frames(2)}
        for i in range(FRAME_COUNT):  # interleave the two streams
            for sid, frames in streams.items():
                status, _ = _http(
                    "POST",
                    f"{base}/v1/streams/{sid}/frames?index={i}&height={H}&width={W}",
                    data=frames[i].tobytes(),
                )
                assert status == 202

        # expected coverage per stream (window 6 / step 2 → lag, see
        # StreamingPredictor): collect ground truth per stream
        expected = {}
        for sid, frames in streams.items():
            sp = StreamingPredictor(ckpt_path, tta=False, dtype=torch.float32, device="cpu")
            src = SyntheticSource(num_frames=FRAME_COUNT, height=H, width=W,
                                  seed={"a": 1, "b": 2}[sid],
                                  events={10: 0, 18: 1})
            idx, raw = get_raw_predictions(sp, src, FRAME_COUNT)
            expected[sid] = (idx, raw)

        # poll until each stream has all expected results (async batcher)
        deadline = time.time() + 60
        got = {}
        while time.time() < deadline:
            done = True
            for sid in streams:
                _, payload = _http("GET",
                                   f"{base}/v1/streams/{sid}/results?since=0")
                got[sid] = payload["results"]
                # server emits every in-range prediction the streaming
                # predictor would (predict indexes ≥ first full window)
                if len([r for r in got[sid]
                        if r["index"] >= expected[sid][0][0]]) < len(expected[sid][0]):
                    done = False
            if done:
                break
            time.sleep(0.2)
        assert done, {k: len(v) for k, v in got.items()}

        for sid in streams:
            exp_idx, exp_raw = expected[sid]
            by_index = {r["index"]: r["probs"] for r in got[sid]}
            for j, idx in enumerate(exp_idx):
                np.testing.assert_allclose(
                    by_index[idx], exp_raw[j], atol=ATOL, rtol=0,
                    err_msg=f"stream {sid} index {idx}",
                )

        # cursor semantics: since=next returns nothing new
        _, payload = _http("GET", f"{base}/v1/streams/a/results?since=0")
        nxt = payload["next"]
        _, payload2 = _http("GET",
                            f"{base}/v1/streams/a/results?since={nxt}")
        assert payload2["results"] == []

        # close + stats
        status, payload = _http("POST", f"{base}/v1/streams/a/close")
        assert status == 200 and payload["closed"]
        # the close marker is queued; wait until the batcher has taken it
        # (stream "a" purged) before reading the drained queue
        deadline = time.time() + 10
        while True:
            _, stats = _http("GET", f"{base}/v1/stats")
            if stats["streams"] == 1 or time.time() > deadline:
                break
            time.sleep(0.01)
        assert stats["streams"] == 1
        assert stats["frames_in"] == 2 * FRAME_COUNT
        assert stats["predictions_out"] >= 2 * len(expected["a"][0])
        # observability: tick latency percentiles + batch occupancy over
        # the rolling window, queue depth (drained by now)
        lat = stats["tick_latency_ms"]
        assert lat["window"] == stats["ticks"] > 0
        assert 0 < lat["p50"] <= lat["p99"]
        assert stats["tick_batch_mean"] >= 1
        assert stats["queue_depth"] == 0
    finally:
        server.shutdown()
        server.server_close()
        service.stop()


def test_server_rejects_bad_requests(ckpt_path):
    predictor = MultiStreamPredictor(ckpt_path, tta=False, dtype=torch.float32, device="cpu")
    server, service = make_server(predictor)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("POST", f"{base}/v1/streams/x/frames?index=0",
                  data=b"\x00" * 10)
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("POST",
                  f"{base}/v1/streams/x/frames?index=0&height=4&width=4",
                  data=b"\x00" * 10)  # wrong length
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("GET", f"{base}/nope")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        service.stop()


def test_result_cursor_survives_retention_trim():
    """Absolute poll cursors: after the buffer trims, a caught-up client
    keeps receiving new results (regression: list-index cursors starved
    forever once len(buf) hit capacity) and never sees duplicates."""
    class _StubPredictor:
        def close_stream(self, sid):
            pass

        def predict_batch(self, batch):
            return []

    svc = SpottingService(_StubPredictor(), result_capacity=4)
    try:
        with svc._results_lock:
            for i in range(4):
                svc._record_result("s", i, [0.1 * i])
        got1, cur = svc.poll_results("s", 0)
        assert [r["index"] for r in got1] == [0, 1, 2, 3] and cur == 4
        # five more results -> buffer trims to the last four
        with svc._results_lock:
            for i in range(4, 9):
                svc._record_result("s", i, [0.1 * i])
        got2, cur2 = svc.poll_results("s", cur)
        assert [r["index"] for r in got2] == [5, 6, 7, 8]  # 4 fell out of window
        assert cur2 == 9
        got3, cur3 = svc.poll_results("s", cur2)
        assert got3 == [] and cur3 == 9
        # a cursor older than the window resumes at the window start
        got4, _ = svc.poll_results("s", 0)
        assert [r["index"] for r in got4] == [5, 6, 7, 8]
    finally:
        svc.stop()


def test_server_backlog_holds_many_pending_connections():
    """Connection attempts wait in the listen backlog while the accept loop
    is busy: 64 clients connect at once with no ``accept`` running (the
    stdlib's backlog of 5 drops the 7th, which then retries for seconds)."""
    class _StubPredictor:
        def close_stream(self, sid):
            pass

        def predict_batch(self, batch):
            return []

    server, service = make_server(_StubPredictor())
    socks = []
    try:
        for _ in range(64):
            socks.append(socket.create_connection(server.server_address, timeout=2))
    finally:
        for sock in socks:
            sock.close()
        server.server_close()
        service.stop()


def test_ingest_backpressure_bounded_queue():
    """ADVICE r2: the ingest queue is bounded; submit_frame returns False
    (-> HTTP 503) instead of growing host memory without limit."""
    release = threading.Event()

    class _SlowPredictor:
        def close_stream(self, sid):
            pass

        def predict_batch(self, batch):
            release.wait(timeout=10)
            return [(sid, None, idx) for sid, _f, idx in batch]

    svc = SpottingService(_SlowPredictor(), max_batch=1, ingest_capacity=2)
    try:
        ok = [svc.submit_frame("s", np.zeros((2, 2), np.uint8), i)
              for i in range(10)]
        # batcher holds at most one item in-flight + 2 queued -> the rest
        # must be rejected, not buffered
        assert sum(ok) <= 4
        assert False in ok
        release.set()
    finally:
        release.set()
        svc.stop()


def test_close_purges_results_on_batcher_thread():
    """ADVICE r2: frames enqueued ahead of the close marker are predicted,
    then the marker purges result buffers ON THE BATCHER THREAD — no zombie
    stream entry survives in /healthz counts."""
    class _P:
        def __init__(self):
            self.closed = []

        def close_stream(self, sid):
            self.closed.append(sid)

        def predict_batch(self, batch):
            return [(sid, np.asarray([0.5]), idx) for sid, _f, idx in batch]

    p = _P()
    svc = SpottingService(p)
    try:
        svc.submit_frame("z", np.zeros((2, 2), np.uint8), 0)
        svc.submit_frame("z", np.zeros((2, 2), np.uint8), 1)
        svc.close_stream("z")
        deadline = time.time() + 10
        while time.time() < deadline and (
            "z" not in p.closed or svc.stats()["streams"] != 0
        ):
            time.sleep(0.01)
        assert p.closed == ["z"]
        stats = svc.stats()
        assert stats["streams"] == 0  # no zombie re-created by earlier frames
        assert stats["predictions_out"] == 2  # pre-close frames still served
    finally:
        svc.stop()


def test_ingest_queue_markers_bypass_frame_capacity():
    """Close markers land in their true FIFO position even under
    backpressure: no acknowledged frame of any stream is evicted and the
    marker is not reordered behind later submissions."""
    q = _IngestQueue(2)
    assert q.put_frame(("a", b"f0", 0))
    assert q.put_frame(("a", b"f1", 1))
    assert not q.put_frame(("a", b"f2", 2))  # frame backpressure
    q.put_marker(("b", None, -1))            # accepted despite full frames
    q.put_marker(("a", None, -1))
    assert q.qsize() == 4
    drained = [q.get_nowait() for _ in range(4)]
    assert drained == [
        ("a", b"f0", 0), ("a", b"f1", 1), ("b", None, -1), ("a", None, -1),
    ]
    # draining frames frees frame capacity; markers never consumed it
    assert q.put_frame(("a", b"f3", 3))


def test_close_under_backpressure_drops_no_acknowledged_frames():
    """A close issued while the ingest queue is frame-full must not evict
    already-202-acknowledged frames: every accepted frame is predicted."""
    release = threading.Event()

    class _SlowPredictor:
        def __init__(self):
            self.closed = []

        def close_stream(self, sid):
            self.closed.append(sid)

        def predict_batch(self, batch):
            release.wait(timeout=10)
            return [(sid, np.asarray([0.5]), idx) for sid, _f, idx in batch]

    p = _SlowPredictor()
    svc = SpottingService(p, max_batch=4, ingest_capacity=2)
    try:
        ok = [svc.submit_frame("s", np.zeros((2, 2), np.uint8), i)
              for i in range(10)]
        accepted = sum(ok)
        assert accepted < 10  # backpressure engaged
        svc.close_stream("s")  # queue is frame-full; marker must still land
        release.set()
        deadline = time.time() + 10
        while time.time() < deadline and (
            "s" not in p.closed
            or svc.stats()["predictions_out"] < accepted
        ):
            time.sleep(0.01)
        stats = svc.stats()
        assert p.closed == ["s"]
        assert stats["predictions_out"] == accepted
    finally:
        release.set()
        svc.stop()


def test_to_host_copies_a_tick_once_in_order():
    """A tick's predictions, tensors or arrays, come back as numpy rows in
    the order of the results, None where a stream had no prediction."""
    preds = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    results = [("a", preds[0], 1), ("b", None, -3), ("a", preds[2], 2), ("c", np.ones(2), 0)]
    host = _to_host(results)
    assert [(sid, idx) for sid, _, idx in host] == [("a", 1), ("b", -3), ("a", 2), ("c", 0)]
    assert host[1][1] is None
    for got, want in zip([host[0][1], host[2][1], host[3][1]], [[0, 1], [4, 5], [1, 1]]):
        assert isinstance(got, np.ndarray) and got.tolist() == want
    assert _to_host([("a", None, 0)]) == [("a", None, 0)]


@pytest.mark.parametrize("device_state", [False, True], ids=["host_state", "device_state"])
def test_server_cli_serves_on_the_cpu(ckpt_path, monkeypatch, device_state):
    """``main`` builds the engine the flags name on ``--device``, warms it
    up and serves; without ``--device cpu`` it needs CUDA."""
    seen = {}
    serve_forever = ThreadingHTTPServer.serve_forever

    def serve_once(server):
        thread = threading.Thread(target=serve_forever, args=(server,), daemon=True)
        thread.start()
        try:
            seen["health"] = _http("GET", f"http://127.0.0.1:{server.server_address[1]}/healthz")
            seen["engine"] = type(server.RequestHandlerClass.service.predictor)
        finally:
            server.shutdown()
            thread.join(timeout=10)
        assert not thread.is_alive()

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", serve_once)
    argv = ["--checkpoint", str(ckpt_path), "--host", "127.0.0.1", "--port", "0",
            "--warmup_streams", "2"] + (["--device_state"] if device_state else [])
    main(argv + ["--device", "cpu"])
    assert seen["health"] == (200, {"ok": True, "streams": 0})
    assert seen["engine"] is (DeviceStateMultiStreamPredictor if device_state
                              else MultiStreamPredictor)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


@pytest.mark.parametrize("device_state", [False, True], ids=["host_state", "device_state"])
def test_build_engine_and_warm_engine(ckpt_path, device_state):
    """``main``'s builder picks the engine by ``device_state``; the 3D
    blocks' depthwise conv follows the device (the grouped conv on the CPU)
    unless the caller names a route; ``warm_engine`` warms the backlog
    shapes of the stream count."""
    engine = build_engine(ckpt_path, device_state=device_state, device="cpu",
                          dtype=torch.float32)
    assert type(engine) is (DeviceStateMultiStreamPredictor if device_state
                            else MultiStreamPredictor)
    convs = [m for m in engine.model.modules() if isinstance(m, DepthwiseConv3d)]
    assert convs and not any(m.use_kernel for m in convs)
    # 3 streams: device-state (bucket ≤ 4, F = 2), host-state 2·3 rows capped at 4
    assert warm_engine(engine, 3, max_batch=4) == [1, 2, 4]
    if device_state:
        assert {key[1:3] for key in engine._shapes if key[0] == "tick"} == {
            (b, f) for b in (1, 2, 4) for f in (1, 2)}
    else:
        assert warm_engine(engine, 3, max_batch=8) == [1, 2, 4, 8]
    routed = build_engine(ckpt_path, device_state=device_state, device="cpu",
                          dtype=torch.float32, dw3d_use_kernel=True)
    assert all(m.use_kernel for m in routed.model.modules() if isinstance(m, DepthwiseConv3d))
