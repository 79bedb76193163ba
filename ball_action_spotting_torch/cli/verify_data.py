"""Validate a SoccerNet workdir before training (port of the JAX
package's ``scripts/verify_data.py``, with the same checks, issues and exit
codes; the transcode hint names the port's CLI). It checks everything the
training stack assumes about the on-disk layout:

- workdir / soccernet directory resolve (``BAS_TPU_WORKDIR``),
- every expected game directory + label file exists and parses,
- annotation sanity: field formats, labels known to the domain (after
  merge mapping), halves within the domain's range, visibility values,
- per-half videos ``{half}_{resolution}.mkv`` exist; optional OpenCV
  probe checks fps vs the domain's 25.0 and that the annotation frame
  range fits inside the decoded frame count,
- gray-store transcode status (``cli/transcode.py`` output) and a
  disk estimate for the stores still to be written.

Exit code 0 = READY (warnings allowed with ``--strict`` off), 1 = issues.
Without ``cv2`` the OpenCV probe is skipped with a warning, as
``--no-probe`` skips it.

    python -m ball_action_spotting_torch.cli.verify_data --domain ball_action
    python -m ball_action_spotting_torch.cli.verify_data --domain action --no-probe
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Callable, Sequence

from ball_action_spotting_torch import paths
from ball_action_spotting_torch.data.gray_store import store_path_for_video
from ball_action_spotting_torch.domains import get_domain
from ball_action_spotting_torch.domains.base import Domain

ERROR = "ERROR"
WARN = "WARN"
TRANSCODE = "python -m ball_action_spotting_torch.cli.transcode"


@dataclasses.dataclass
class Issue:
    level: str  # ERROR | WARN
    game: str
    message: str

    def __str__(self) -> str:
        return f"[{self.level}] {self.game}: {self.message}"


def default_games(domain: Domain) -> list[str]:
    """Every game the domain's recipes touch (train + challenge)."""
    if domain.name == "ball_action":
        from ball_action_spotting_torch.domains import ball

        return list(ball.fold_games) + list(ball.challenge_games)
    if domain.name == "action":
        from ball_action_spotting_torch.domains import action

        games = list(action.val_games)
        try:
            games = sorted(set(action.load_games_list("train")) | set(games))
        except Exception:
            # train list needs the SoccerNet package or exported split
            # JSONs; val-only coverage is still a meaningful check.
            pass
        return games
    raise ValueError(f"no default game list for domain {domain.name!r}")


def _known_labels(domain: Domain) -> set[str]:
    return set(domain.classes) | set(domain.merged_classes)


def check_annotations(
    labels: dict, domain: Domain, game: str
) -> tuple[list[Issue], dict[int, int]]:
    """Validate one game's parsed label JSON.

    Returns (issues, {half: max_position_ms}) so the caller can check the
    annotation range against each half's decoded duration.
    """
    issues: list[Issue] = []
    max_ms: dict[int, int] = {}
    annotations = labels.get("annotations")
    if not isinstance(annotations, list):
        return [Issue(ERROR, game, "labels JSON has no 'annotations' list")], {}
    if not annotations:
        issues.append(Issue(WARN, game, "annotations list is empty"))
    known = _known_labels(domain)
    unknown: dict[str, int] = {}
    for i, ann in enumerate(annotations):
        try:
            half = int(str(ann["gameTime"]).split(" - ")[0])
            position = int(ann["position"])
        except (KeyError, ValueError, IndexError) as exc:
            issues.append(
                Issue(ERROR, game, f"annotation #{i} malformed: {exc!r} ({ann!r})")
            )
            continue
        if half not in domain.halves:
            issues.append(
                Issue(ERROR, game,
                      f"annotation #{i} half {half} outside {domain.halves}")
            )
            continue
        if position < 0:
            issues.append(Issue(ERROR, game, f"annotation #{i} position {position} < 0"))
        label = ann.get("label")
        if label not in known:
            unknown[label] = unknown.get(label, 0) + 1
        max_ms[half] = max(max_ms.get(half, 0), position)
    if unknown:
        # the action domain legitimately drops non-listed labels (ignore
        # lists, visibility filter); for the ball domain an unknown label
        # means wrong or mismatched label files
        level = ERROR if domain.name == "ball_action" else WARN
        issues.append(
            Issue(level, game, f"labels not in domain classes: {unknown}")
        )
    return issues, max_ms


def _probe_with_cv2(video_path: str) -> dict:
    from ball_action_spotting_torch.core.annotations import cached_video_info

    return cached_video_info(video_path)


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def verify_game(
    game: str,
    domain: Domain,
    soccernet_dir: Path,
    resolution: str = "720p",
    video_info_fn: Callable[[str], dict] | None = _probe_with_cv2,
) -> tuple[list[Issue], int]:
    """Check one game. Returns (issues, bytes_of_gray_store_still_missing)."""
    issues: list[Issue] = []
    missing_store_bytes = 0
    game_dir = soccernet_dir / game
    if not game_dir.is_dir():
        return [Issue(ERROR, game, f"game directory missing: {game_dir}")], 0

    label_path = game_dir / domain.label_file
    max_ms: dict[int, int] = {}
    if not label_path.is_file():
        issues.append(Issue(ERROR, game, f"label file missing: {label_path}"))
    else:
        try:
            labels = json.loads(label_path.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            issues.append(Issue(ERROR, game, f"label file unparsable: {exc}"))
        else:
            ann_issues, max_ms = check_annotations(labels, domain, game)
            issues.extend(ann_issues)

    for half in domain.halves:
        video_path = game_dir / f"{half}_{resolution}.mkv"
        if not video_path.is_file():
            issues.append(Issue(ERROR, game, f"video missing: {video_path}"))
            continue
        info = None
        if video_info_fn is not None:
            try:
                info = video_info_fn(str(video_path))
            except Exception as exc:  # cv2 failures → diagnosable issue
                issues.append(
                    Issue(ERROR, game, f"half {half} video unprobeable: {exc}")
                )
        if info is not None:
            fps = float(info.get("fps") or 0.0)
            frame_count = int(info.get("frame_count") or 0)
            if frame_count <= 0:
                issues.append(
                    Issue(ERROR, game, f"half {half} decodes to 0 frames")
                )
            if fps and abs(fps - domain.video_fps) > 0.51:
                issues.append(
                    Issue(WARN, game,
                          f"half {half} fps {fps:.2f} != domain {domain.video_fps}")
                )
            if half in max_ms and fps and frame_count:
                last_frame = round(max_ms[half] / 1000 * fps)
                if last_frame >= frame_count:
                    issues.append(
                        Issue(ERROR, game,
                              f"half {half} last annotation at frame "
                              f"{last_frame} >= frame_count {frame_count}")
                    )
        store = store_path_for_video(video_path)
        if not store.exists():
            if info is not None and info.get("frame_count"):
                est = (int(info["frame_count"])
                       * int(info.get("height") or 720)
                       * int(info.get("width") or 1280))
            else:
                # 45 min half at 25 fps, 720p grayscale
                est = 45 * 60 * 25 * 720 * 1280
            missing_store_bytes += est
            issues.append(
                Issue(WARN, game,
                      f"half {half} not transcoded yet "
                      f"(run {TRANSCODE}; ~{est / 1e9:.1f} GB)")
            )
    return issues, missing_store_bytes


def verify_workdir(
    domain: Domain,
    games: Sequence[str] | None = None,
    resolution: str = "720p",
    video_info_fn: Callable[[str], dict] | None = _probe_with_cv2,
) -> dict:
    """Full readiness report for a domain's workdir."""
    soccernet_dir = domain.soccernet_dir
    games = list(games) if games is not None else default_games(domain)
    report: dict = {
        "domain": domain.name,
        "workdir": str(paths.work_dir()),
        "soccernet_dir": str(soccernet_dir),
        "games_checked": len(games),
        "issues": [],
        "missing_store_bytes": 0,
    }
    if not soccernet_dir.is_dir():
        report["issues"].append(
            Issue(ERROR, "-", f"soccernet dir missing: {soccernet_dir} "
                  "(set BAS_TPU_WORKDIR or run scripts/download_*_data.py)")
        )
        report["ready"] = False
        return report
    for game in games:
        issues, missing = verify_game(
            game, domain, soccernet_dir, resolution, video_info_fn
        )
        report["issues"].extend(issues)
        report["missing_store_bytes"] += missing
    report["ready"] = not any(i.level == ERROR for i in report["issues"])
    return report


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--domain", default="ball_action",
                        choices=["ball_action", "action"])
    parser.add_argument("--games", nargs="*", default=None,
                        help="override the domain's full game list")
    parser.add_argument("--resolution", default="720p")
    parser.add_argument("--no-probe", action="store_true",
                        help="skip OpenCV video probing (layout checks only)")
    parser.add_argument("--strict", action="store_true",
                        help="treat warnings as failures")
    args = parser.parse_args(argv)

    domain = get_domain(args.domain)
    probe = not args.no_probe
    if probe and not _have_cv2():
        print("WARNING: cv2 (OpenCV) is not installed; skipping the video probe "
              "(layout checks only, as --no-probe)")
        probe = False
    report = verify_workdir(
        domain,
        games=args.games,
        resolution=args.resolution,
        video_info_fn=_probe_with_cv2 if probe else None,
    )
    for issue in report["issues"]:
        print(issue)
    n_err = sum(1 for i in report["issues"] if i.level == ERROR)
    n_warn = len(report["issues"]) - n_err
    print(f"\nchecked {report['games_checked']} games under "
          f"{report['soccernet_dir']}: {n_err} errors, {n_warn} warnings")
    if report["missing_store_bytes"]:
        print(f"gray stores still to transcode: "
              f"~{report['missing_store_bytes'] / 1e9:.1f} GB "
              f"({TRANSCODE} --domain {domain.name} --jobs N)")
    ok = report["ready"] and not (args.strict and n_warn)
    print("READY" if ok else "NOT READY")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
