"""Video metadata probing (copy of the JAX package's
``core/annotations.py`` probe helpers)."""

from __future__ import annotations

import json
from pathlib import Path


def probe_video_info(video_path: str) -> dict:
    """Probe frame count / fps / size via OpenCV."""
    import cv2

    video = cv2.VideoCapture(str(video_path))
    try:
        return dict(
            frame_count=int(video.get(cv2.CAP_PROP_FRAME_COUNT)),
            fps=float(video.get(cv2.CAP_PROP_FPS)),
            width=int(video.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(video.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
    finally:
        video.release()


def cached_video_info(video_path: str) -> dict:
    """Probe with a sidecar ``<video>.info.json`` cache (videos never
    change)."""
    cache_path = Path(str(video_path) + ".info.json")
    if cache_path.exists():
        return json.loads(cache_path.read_text())
    info = probe_video_info(video_path)
    try:
        cache_path.write_text(json.dumps(info))
    except OSError:
        pass
    return info
