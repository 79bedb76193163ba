"""SoccerNet label parsing → per-half ``video_data`` dicts, and video
metadata probing (copy of the JAX package's ``core/annotations.py``).

A ``video_data`` dict has keys: ``video_path, game, half, frame_count, fps,
width, height, frame_index2action``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Sequence

from ball_action_spotting_torch.domains.base import Domain

VideoInfoFn = Callable[[str], dict]


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


def parse_game_annotations(
    labels: dict,
    domain: Domain,
    fps_by_half: dict[int, float],
) -> dict[int, dict[int, str]]:
    """labels JSON → {half: {frame_index: action}}.

    Millisecond position → frame index via ``round(position * fps / 1000)``
    (reference ``ball_action/annotations.py:43``). Applies the domain's
    visibility filter and class merging (``action/annotations.py:44-52``).
    """
    half2actions: dict[int, dict[int, str]] = {h: {} for h in fps_by_half}
    for annotation in labels["annotations"]:
        if (
            domain.visibility_filter is not None
            and annotation.get("visibility") != domain.visibility_filter
        ):
            continue
        half = int(annotation["gameTime"].split(" - ")[0])
        if half not in half2actions:
            continue
        label = annotation["label"]
        label = domain.merged_classes.get(label, label)
        fps = fps_by_half[half]
        frame_index = round(float(annotation["position"]) * fps * 0.001)
        half2actions[half][frame_index] = label
    return half2actions


def _annotation_halves(labels: dict) -> list[int]:
    return sorted({int(a["gameTime"].split(" - ")[0]) for a in labels["annotations"]})


def add_empty_actions(frame_index2action: dict[int, str]) -> None:
    """Insert synthetic "EMPTY" actions midway between consecutive actions,
    in place — gives validation coverage of backgrounds
    (reference ``ball_action/annotations.py:46-55``)."""
    prev_frame_index = -1
    for frame_index in sorted(frame_index2action):
        if prev_frame_index != -1:
            empty_frame_index = (prev_frame_index + frame_index) // 2
            if empty_frame_index not in frame_index2action:
                frame_index2action[empty_frame_index] = "EMPTY"
        prev_frame_index = frame_index


def get_game_videos_data(
    game: str,
    domain: Domain,
    resolution: str = "720p",
    empty_actions: bool = False,
    video_info_fn: Optional[VideoInfoFn] = None,
    soccernet_dir: Optional[Path] = None,
) -> list[dict]:
    """Parse one game's label JSON into per-half video_data dicts
    (reference ``ball_action/annotations.py:11-57``)."""
    video_info_fn = video_info_fn or cached_video_info
    game_dir = (soccernet_dir or domain.soccernet_dir) / game
    labels = json.loads((game_dir / domain.label_file).read_text())

    halves = _annotation_halves(labels)
    half2video_data = {}
    for half in halves:
        video_path = str(game_dir / f"{half}_{resolution}.mkv")
        half2video_data[half] = dict(
            video_path=video_path,
            game=game,
            half=half,
            **video_info_fn(video_path),
            frame_index2action={},
        )

    fps_by_half = {h: half2video_data[h]["fps"] for h in halves}
    half2actions = parse_game_annotations(labels, domain, fps_by_half)
    for half, actions in half2actions.items():
        half2video_data[half]["frame_index2action"] = actions
        if empty_actions:
            add_empty_actions(half2video_data[half]["frame_index2action"])

    return [half2video_data[h] for h in halves]


def get_videos_data(
    games: Sequence[str],
    domain: Domain,
    resolution: str = "720p",
    empty_actions: bool = False,
    video_info_fn: Optional[VideoInfoFn] = None,
    soccernet_dir: Optional[Path] = None,
) -> list[dict]:
    videos_data: list[dict] = []
    for game in games:
        videos_data += get_game_videos_data(
            game,
            domain,
            resolution=resolution,
            empty_actions=empty_actions,
            video_info_fn=video_info_fn,
            soccernet_dir=soccernet_dir,
        )
    return videos_data
