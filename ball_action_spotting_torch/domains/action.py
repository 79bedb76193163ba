"""Action domain: 15 merged SoccerNet action classes, fixed splits (copy
of the JAX package's ``domains/action.py``).

The reference derives its train list from the SoccerNet pip package's
``getListGames`` (``action/constants.py:40-46``); that package is optional
here — when it is absent, split lists come from JSON files via
``load_games_list`` / the ``BAS_TPU_ACTION_SPLITS`` env var.
"""

import json
import os
from pathlib import Path

from ball_action_spotting_torch.domains.base import Domain, PostprocessParams

val_games = [
    "england_epl/2015-2016/2016-01-23 - 20-30 West Ham 2 - 2 Manchester City",
    "england_epl/2016-2017/2016-10-01 - 14-30 Swansea 1 - 2 Liverpool",
    "england_epl/2016-2017/2017-04-09 - 18-00 Everton 4 - 2 Leicester",
    "europe_uefa-champions-league/2014-2015/2014-11-05 - 22-45 Manchester City 1 - 2 CSKA Moscow",
    "europe_uefa-champions-league/2016-2017/2016-09-28 - 21-45 Napoli 4 - 2 Benfica",
    "europe_uefa-champions-league/2016-2017/2016-10-19 - 21-45 Paris SG 3 - 0 Basel",
    "france_ligue-1/2016-2017/2016-08-21 - 21-45 Paris SG 3 - 0 Metz",
    "france_ligue-1/2016-2017/2016-09-09 - 21-45 Paris SG 1 - 1 St Etienne",
    "france_ligue-1/2016-2017/2017-04-09 - 22-00 Paris SG 4 - 0 Guingamp",
    "germany_bundesliga/2015-2016/2015-10-04 - 18-30 Bayern Munich 5 - 1 Dortmund",
    "germany_bundesliga/2016-2017/2016-12-03 - 17-30 Dortmund 4 - 1 B. Monchengladbach",
    "germany_bundesliga/2016-2017/2017-02-25 - 17-30 SC Freiburg 0 - 3 Dortmund",
    "italy_serie-a/2016-2017/2016-08-20 - 19-00 AS Roma 4 - 0 Udinese",
    "italy_serie-a/2016-2017/2017-01-22 - 22-45 AS Roma 1 - 0 Cagliari",
    "italy_serie-a/2016-2017/2017-05-06 - 19-00 Napoli 3 - 1 Cagliari",
    "spain_laliga/2014-2015/2015-05-02 - 19-00 Atl. Madrid 0 - 0 Ath Bilbao",
    "spain_laliga/2016-2017/2016-08-21 - 21-15 Real Sociedad 0 - 3 Real Madrid",
    "spain_laliga/2016-2017/2017-05-14 - 21-00 Las Palmas 1 - 4 Barcelona",
]

# Broken games excluded from training (reference action/constants.py:33-39).
train_ignore_games = [
    "france_ligue-1/2016-2017/2017-05-14 - 22-00 St Etienne 0 - 5 Paris SG",
    "italy_serie-a/2016-2017/2016-08-28 - 21-45 Cagliari 2 - 2 AS Roma",
    "italy_serie-a/2016-2017/2016-09-16 - 21-45 Sampdoria 0 - 1 AC Milan",
    "italy_serie-a/2016-2017/2016-09-18 - 21-45 Fiorentina 1 - 0 AS Roma",
    "italy_serie-a/2016-2017/2016-09-21 - 21-45 AS Roma 4 - 0 Crotone",
]

card_classes = ["Yellow card", "Red card", "Yellow->red card"]

DOMAIN = Domain(
    name="action",
    classes=(
        "Penalty",
        "Kick-off",
        "Goal",
        "Substitution",
        "Offside",
        "Shots on target",
        "Shots off target",
        "Clearance",
        "Ball out of play",
        "Throw-in",
        "Foul",
        "Indirect free-kick",
        "Direct free-kick",
        "Corner",
        "Card",
    ),
    label_file="Labels-v2.json",
    soccernet_subdir="action-spotting-2023",
    postprocess=PostprocessParams(gauss_sigma=3.0, height=0.2, distance=15),
    video_fps=25.0,
    merged_classes={cls: "Card" for cls in card_classes},
    output_class_map={"Card": "Yellow card"},
    visibility_filter="visible",
)

classes = list(DOMAIN.classes)
num_classes = DOMAIN.num_classes
class2target = DOMAIN.class2target
target2class = DOMAIN.target2class


def load_games_list(split: str) -> list[str]:
    """Resolve a split's game list.

    Resolution order:
    1. A JSON file ``{split}.json`` in ``$BAS_TPU_ACTION_SPLITS`` (a dir).
    2. The SoccerNet pip package's ``getListGames`` (if installed), with
       the reference's train = train+valid minus val/ignored games
       (reference action/constants.py:40-46).
    """
    splits_dir = os.environ.get("BAS_TPU_ACTION_SPLITS")
    if splits_dir:
        path = Path(splits_dir) / f"{split}.json"
        if path.exists():
            return json.loads(path.read_text())

    try:
        from SoccerNet.utils import getListGames  # type: ignore
    except ImportError as exc:  # pragma: no cover - optional dependency
        raise RuntimeError(
            f"Cannot resolve action split '{split}': SoccerNet package is not "
            "installed and BAS_TPU_ACTION_SPLITS does not provide it. "
            "Install SoccerNet or export split JSONs."
        ) from exc

    if split == "val":
        return list(val_games)
    if split == "train":
        games = sorted(
            set(
                getListGames(split="train", task="spotting", dataset="SoccerNet")
                + getListGames(split="valid", task="spotting", dataset="SoccerNet")
            )
            - set(val_games)
            - set(train_ignore_games)
        )
        return games
    if split in ("test", "challenge"):
        return list(getListGames(split=split, task="spotting", dataset="SoccerNet"))
    raise ValueError(f"Unknown action split: {split!r}")
