"""Transcode videos to gray stores, the decode-once setup step (port of the
JAX package's ``scripts/transcode.py``).

Walks a SoccerNet-layout directory, decodes each ``*_<resolution>.mkv`` once
with OpenCV/FFmpeg, and writes the sibling ``.gray`` store and
``.info.json`` sidecar that training and prediction then pick up
(``data/video.py::open_source``). Needs ``cv2`` (OpenCV), which is not a
dependency of the rest of the port.

    python -m ball_action_spotting_torch.cli.transcode --domain ball_action \\
        [--games g1 g2 ...] [--resolution 720p] [--force] [--jobs N]
    python -m ball_action_spotting_torch.cli.transcode --videos a.mkv b.mkv

``--jobs N`` decodes N videos in parallel processes (0 = one per CPU); each
worker owns whole videos, so stores never contend.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ball_action_spotting_torch.data.gray_store import (
    store_path_for_video,
    transcode_video_to_store,
)
from ball_action_spotting_torch.domains import get_domain


def require_cv2() -> None:
    try:
        import cv2  # noqa: F401
    except ImportError as exc:
        raise ImportError("transcoding decodes with OpenCV: the cv2 package "
                          "(opencv-python) is not installed") from exc


def transcode_one(video_path: Path, force: bool = False) -> str:
    store_path = store_path_for_video(video_path)
    if store_path.exists() and not force:
        msg = f"skip (exists): {store_path}"
        print(msg, flush=True)
        return msg
    t0 = time.perf_counter()
    info = transcode_video_to_store(video_path, store_path)
    Path(str(video_path) + ".info.json").write_text(
        json.dumps(dict(info, fps=info.get("fps", 25.0))))
    dt = time.perf_counter() - t0
    msg = f"{video_path} -> {store_path}: {info['frame_count']} frames in {dt:.1f}s"
    print(msg, flush=True)
    return msg


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--domain", default=None, choices=["ball_action", "action"])
    parser.add_argument("--games", nargs="*", default=None)
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--resolution", default="720p")
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--jobs", type=int, default=1,
                        help="videos transcoded in parallel processes (0 = one per CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    require_cv2()
    videos: list[Path] = [Path(v) for v in (args.videos or [])]
    if args.domain:
        root = get_domain(args.domain).soccernet_dir
        if args.games:
            for game in args.games:
                videos += sorted((root / game).glob(f"*_{args.resolution}.mkv"))
        else:
            videos += sorted(root.rglob(f"*_{args.resolution}.mkv"))
    if not videos:
        raise SystemExit("Nothing to transcode: pass --domain and/or --videos")
    jobs = args.jobs or os.cpu_count() or 1
    if jobs <= 1 or len(videos) == 1:
        for video in videos:
            transcode_one(video, force=args.force)
        return
    # whole-video granularity: each worker process owns its decoder and its
    # output store, so there is no shared state to guard
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(jobs, len(videos)), mp_context=context) as pool:
        futures = [pool.submit(transcode_one, v, args.force) for v in videos]
        for f in futures:
            f.result()  # surface worker exceptions


if __name__ == "__main__":
    main()
