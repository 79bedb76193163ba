"""Challenge submission packaging (copy of the JAX package's
``eval/submission.py``).

The reference's final workflow step zips the per-game spotting JSONs by
hand from inside the challenge ensemble directory
(reference ``README.md:240-242``::

    cd data/ball_action/predictions/<exp>/challenge/ensemble/
    zip results_spotting.zip ./*/*/*/results_spotting.json

). ``make_submission_zip`` is that step as code: it packages every game's
``results_spotting.json`` under a prediction directory into one archive
whose member paths are the game-relative paths the SoccerNet evaluation
server (and this repo's zip-aware ``evaluate_games``,
``eval/soccernet_map.py::read_game_json``) expect.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Optional, Sequence


def make_submission_zip(
    prediction_dir: Path,
    games: Optional[Sequence[str]] = None,
    out_path: Optional[Path] = None,
    prediction_file: str = "results_spotting.json",
) -> Path:
    """Zip each game's ``prediction_file`` under ``prediction_dir``.

    ``games``: explicit game-relative paths (e.g. the domain's challenge
    list) — every one must exist, so a missing fold/game fails loudly
    instead of shipping a partial submission. Without ``games``, all
    ``prediction_file`` instances found under ``prediction_dir`` are
    packaged (the reference's ``./*/*/*/`` glob, any depth).

    Returns the archive path (default
    ``<prediction_dir>/results_spotting.zip``, mirroring the reference's
    in-place zip).
    """
    prediction_dir = Path(prediction_dir)
    if games is None:
        rels = sorted(
            p.relative_to(prediction_dir).as_posix()
            for p in prediction_dir.rglob(prediction_file)
        )
        if not rels:
            raise FileNotFoundError(
                f"no {prediction_file!r} found under {prediction_dir}"
            )
    else:
        rels = [f"{game}/{prediction_file}" for game in games]
        missing = [r for r in rels if not (prediction_dir / r).is_file()]
        if missing:
            raise FileNotFoundError(
                f"missing prediction files under {prediction_dir}: {missing}"
            )

    out_path = Path(out_path) if out_path else prediction_dir / "results_spotting.zip"
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel in rels:
            zf.write(prediction_dir / rel, arcname=rel)
    return out_path
