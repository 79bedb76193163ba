"""Visualization CLI: overlay per-class target, prediction and peak graphs
on the video and write an annotated video per half (port of the JAX
package's ``scripts/ball_action/visualize.py``).

    python -m ball_action_spotting_torch.cli.visualize --experiment NAME \
        [--folds 0,3] [--format avi|mp4]

Scrolling score graphs under each frame (target spikes, raw sigmoid curve,
detected peaks) from the CV predictions of ``NAME``, MJPG output per half
under ``data/ball_action/visualizations/NAME/<game>``. ``--format mp4``
writes H.264/mp4v MP4 where the local OpenCV build has an encoder, and
falls back per video to MJPG AVI where the writer cannot open. numpy and
``cv2`` only, on the host: it takes no device, and without ``cv2`` it
raises an ``ImportError``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ball_action_spotting_torch.core.annotations import get_videos_data
from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.spotting import load_raw_predictions
from ball_action_spotting_torch.core.targets import VideoTarget
from ball_action_spotting_torch.data.video import open_source
from ball_action_spotting_torch.domains import ball

GRAPH_HEIGHT = 100
HALF_WINDOW = 100  # frames of context either side


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("the visualize CLI draws and writes video with OpenCV: the cv2 "
                          "package (opencv-python) is not installed") from exc
    return cv2


def draw_graph(canvas, values, color, y0, height, thickness=1):
    cv2 = _cv2()

    h, w = canvas.shape[:2]
    xs = np.linspace(0, w - 1, len(values)).astype(int)
    ys = (y0 + height - 1 - values * (height - 1)).astype(int)
    for i in range(1, len(xs)):
        cv2.line(canvas, (xs[i - 1], ys[i - 1]), (xs[i], ys[i]), color, thickness)


def open_writer(out_path, fps, size, fmt: str):
    """VideoWriter for the requested format; mp4 tries avc1 (H.264) then
    mp4v, and falls back to MJPG AVI when no MP4 encoder is available."""
    cv2 = _cv2()

    if fmt == "mp4":
        for fourcc in ("avc1", "mp4v"):
            writer = cv2.VideoWriter(
                str(out_path), cv2.VideoWriter_fourcc(*fourcc), fps, size
            )
            if writer.isOpened():
                return writer, out_path
            writer.release()
        out_path = out_path.with_suffix(".avi")
        print(f"mp4 encoder unavailable; falling back to {out_path}")
    writer = cv2.VideoWriter(
        str(out_path), cv2.VideoWriter_fourcc(*"MJPG"), fps, size
    )
    return writer, out_path


def visualize_video(video_data, prediction_dir, out_path, domain, fmt="avi"):
    cv2 = _cv2()

    half = video_data["half"]
    raw_path = Path(prediction_dir) / f"{half}_raw_predictions.npz"
    frame_indexes, raw = load_raw_predictions(raw_path)
    frame_indexes = np.asarray(frame_indexes)
    class2actions = raw_predictions_to_actions(frame_indexes, raw, domain, verbose=False)
    target = VideoTarget(video_data, list(domain.classes))

    source = open_source(video_data)
    width, height = source.width, source.height
    out_h = height + GRAPH_HEIGHT * domain.num_classes
    writer, out_path = open_writer(
        out_path, video_data["fps"], (width, out_h), fmt
    )
    offset = int(frame_indexes[0])
    peaks_sets = {
        cls: set(frames) for cls, (frames, _) in class2actions.items()
    }
    for index in range(video_data["frame_count"]):
        frame = source.fetch_frame()
        canvas = np.zeros((out_h, width, 3), dtype=np.uint8)
        canvas[:height] = frame[..., None]
        lo = index - HALF_WINDOW
        hi = index + HALF_WINDOW
        for c, cls in enumerate(domain.classes):
            y0 = height + c * GRAPH_HEIGHT
            window = np.arange(lo, hi)
            pred = np.zeros(len(window), dtype=np.float32)
            valid = (window >= offset) & (window < offset + len(raw))
            pred[valid] = raw[window[valid] - offset, c]
            tgt = np.asarray([target.target(i)[c] for i in window])
            peak = np.asarray(
                [1.0 if i in peaks_sets.get(cls, ()) else 0.0 for i in window]
            )
            draw_graph(canvas, tgt, (0, 200, 0), y0, GRAPH_HEIGHT)
            draw_graph(canvas, pred, (0, 165, 255), y0, GRAPH_HEIGHT)
            draw_graph(canvas, peak, (0, 0, 255), y0, GRAPH_HEIGHT)
            cv2.putText(canvas, cls, (8, y0 + 16), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (255, 255, 255), 1)
        cv2.line(canvas, (width // 2, height), (width // 2, out_h), (255, 255, 255), 1)
        writer.write(canvas)
    writer.release()
    source.close()
    print("Visualization saved to", out_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--folds", default="all", type=str)
    parser.add_argument("--format", default="avi", choices=["avi", "mp4"])
    args = parser.parse_args(argv)
    _cv2()

    domain = ball.DOMAIN
    folds = ball.folds if args.folds == "all" else [int(f) for f in args.folds.split(",")]
    for fold in folds:
        for game in ball.fold2games[fold]:
            videos = get_videos_data([game], domain)
            prediction_dir = (
                domain.predictions_dir / args.experiment / "cv" / f"fold_{fold}" / game
            )
            out_dir = domain.visualizations_dir / args.experiment / game
            out_dir.mkdir(parents=True, exist_ok=True)
            ext = "mp4" if args.format == "mp4" else "avi"
            for video_data in videos:
                out_path = out_dir / f"{video_data['half']}_visualization.{ext}"
                visualize_video(video_data, prediction_dir, out_path, domain,
                                fmt=args.format)


if __name__ == "__main__":
    main()
