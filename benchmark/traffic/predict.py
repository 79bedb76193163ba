"""Whole-match prediction: ``ChunkedVideoPredictor.predict_video`` over
back-to-back segments of a match.

Each segment is ``segment_frames`` frames of ``video_size`` uint8 gray
frames cycled from a seeded pool of ``pool_frames`` (the segment's start in
the pool drawn from the seed), handed over one by one as a decoder would;
the engine pads, uploads, bootstraps its carry and predicts every frame it
can. The window runs segments until ``--seconds`` have passed and counts
every prediction over all the time. The traced stretch is
``trace_segments`` whole segments.

The check: a sample of the predictions made in the window, drawn from the
seed together with the first and last prediction of the first and last
segment, against the float32 reference over the same frames and the same
served weights (``inputs.served``; hflip TTA: the mean of the two views'
sigmoids). The number compared, ``excess_gap``, sums over the sampled
answers and classes the amount by which each gap exceeds ``tolerance``:
bf16 rounding keeps nearly every answer inside it, an answer made wrong
adds its whole error, and a lower precision or a missing view pushes many
answers past it. (The mean gap lets one wrong answer vanish in the
sample; the largest gap under bf16 comes too near the int8 control's.
Readings in PERF.md.)
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import counts, harness, inputs
from benchmark.reference.model import Reference, float32_exact


class Traffic:
    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.cell, self.p, self.model = cell, cell["params"], cell["model"]
        self.seed, self.device, self.traced = seed, torch.device(device), traced
        self.spans = harness.Spans(torch, traced)
        self.segments: list[tuple[int, np.ndarray]] = []  # (pool offset, predictions)
        self.attempted = self.failed = 0
        self.program_options: dict = {}  # engine options a control run changes
        self.program_hook = None  # a test's change to the engine before its first call

    # --- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor

        m, p, span = self.model, self.p, self.spans.span
        vw, vh = m["video_size"]
        with span("setup.inputs"):
            self.pool = inputs.frame_pool(self.seed, p["pool_frames"], vh, vw, self.device)
            self.weights = inputs.model_weights(m, self.seed, self.device, self.pool)
        self.offsets = inputs.rng(self.seed, 1)
        with span("setup.program"):
            self.predictor = ChunkedVideoPredictor(
                weights=(self.weights, inputs.program_params(m)), device=self.device,
                chunk_size=m["chunk_size"], tta=p["tta"], dtype=inputs.DTYPES[m["dtype"]],
                carry_features=True, **self.program_options)
        pr = self.predictor
        if self.program_hook is not None:
            self.program_hook(pr)
        pr.put_new = self.spans.wrap("bench.upload", pr.put_new)
        pr.chunk_features = self.spans.wrap("bench.chunk", pr.chunk_features)
        # every shape of the window: the carry bootstrap, a chunk, a padded last chunk
        with span("setup.warmup"):
            self._segment(0, pr.overlap + 2 * m["chunk_size"] - 1)
        self.spans.end_setup()

    def _segment(self, offset: int, length: int) -> np.ndarray:
        pool = self.pool
        frames = ((i, pool[(offset + i) % len(pool)]) for i in range(length))
        with self.spans.span("bench.segment"):
            _, raw = self.predictor.predict_video(frames, length)
        return raw

    def _run_segment(self) -> int:
        offset = int(self.offsets.integers(len(self.pool)))
        raw = self._segment(offset, self.p["segment_frames"])
        self.segments.append((offset, raw))
        self.attempted += len(raw)
        return len(raw)

    # --- windows ---------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        predicted = 0
        t0 = time.perf_counter()
        while True:
            predicted += self._run_segment()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"predict_fps": predicted / elapsed}

    def traced_window(self) -> None:
        for _ in range(self.p["trace_segments"]):
            self._run_segment()

    def context(self, trace: harness.Trace) -> SimpleNamespace:
        m, p = self.model, self.p
        kw = m["nn_module_kwargs"]
        w, h = m["image_size"]
        views = 2 if p["tta"] else 1
        stacks = kw["num_frames"] // kw["stack_size"]
        return SimpleNamespace(
            trace=trace, spans=self.spans, cell=self.cell, frames=self.attempted,
            chunks=len(self.spans.seconds.get("bench.chunk", [])),
            frame_flops=counts.predict_frame_flops(kw, h, w, views),
            dwconv3d_bytes=counts.dwconv3d_bytes(
                m["chunk_size"] * views, stacks, -(-h // 32), -(-w // 32),
                kw["num_3d_features"] * kw["expansion_3d_ratio"], m["dtype"]))

    def release(self) -> None:
        del self.predictor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -------------------------------------------------------------

    def sample(self) -> list[tuple[int, int]]:
        """(segment, row) pairs: a seeded sample and the first and last
        predictions of the first and last segments."""
        sizes = [len(raw) for _, raw in self.segments]
        total = sum(sizes)
        picks = inputs.rng(self.seed, 2).choice(total, size=min(self.p["check_samples"], total),
                                                replace=False)
        starts = np.cumsum([0] + sizes)
        out = {(int(np.searchsorted(starts, i, side="right") - 1),
                int(i - starts[np.searchsorted(starts, i, side="right") - 1])) for i in picks}
        for s in {0, len(sizes) - 1}:
            out |= {(s, 0), (s, sizes[s] - 1)}
        return sorted(out)

    def reference_predictions(self, picks: list[tuple[int, int]]) -> np.ndarray:
        m = self.model
        kw = m["nn_module_kwargs"]
        step, t = m["frame_stack_step"], kw["num_frames"]
        behind = (t // 2) * step
        first = behind + 1  # the first prediction keeps a frame's margin at the start
        ref = Reference(self.weights, kw)
        out = []
        with torch.no_grad(), float32_exact():
            for s, row in picks:
                offset = self.segments[s][0]
                center = first + row
                idx = [(offset + center - behind + j * step) % len(self.pool) for j in range(t)]
                clip = inputs.pad_frames(self.pool[idx], m["image_size"])
                x = torch.from_numpy(clip).to(self.device)[None].float() / 255.0
                views = [x, x.flip(-1)] if self.p["tta"] else [x]
                probs = torch.stack([torch.sigmoid(ref.forward(v)) for v in views]).mean(0)
                out.append(probs[0].cpu().numpy())
        return np.stack(out)

    def check(self) -> list[dict]:
        picks = self.sample()
        got = np.stack([self.segments[s][1][row] for s, row in picks])
        want = self.reference_predictions(picks)
        self.compared = {"program": got.tolist(), "reference": want.tolist()}
        return [{"name": "excess_gap", "value": excess_gap(got, want, self.p["tolerance"]),
                 "limit": self.p["limits"]["excess_gap"]}]


def excess_gap(got: np.ndarray, want: np.ndarray, tolerance: float) -> float:
    """Σ max(0, |got − want| − tolerance) over every answer and class."""
    return float(np.clip(np.abs(got - want) - tolerance, 0.0, None).sum())
