"""Ball-action domain: PASS/DRIVE spotting, 7-game 7-fold cross-validation
(copy of the JAX package's ``domains/ball.py``)."""

from ball_action_spotting_torch.domains.base import Domain, PostprocessParams

fold_games = [
    "england_efl/2019-2020/2019-10-01 - Leeds United - West Bromwich",
    "england_efl/2019-2020/2019-10-01 - Hull City - Sheffield Wednesday",
    "england_efl/2019-2020/2019-10-01 - Brentford - Bristol City",
    "england_efl/2019-2020/2019-10-01 - Blackburn Rovers - Nottingham Forest",
    "england_efl/2019-2020/2019-10-01 - Middlesbrough - Preston North End",
    "england_efl/2019-2020/2019-10-01 - Stoke City - Huddersfield Town",
    "england_efl/2019-2020/2019-10-01 - Reading - Fulham",
]
fold2games = {fold: [game] for fold, game in enumerate(fold_games)}
game2fold = {game: fold for fold, games in fold2games.items() for game in games}
folds = sorted(fold2games)

challenge_games = [
    "england_efl/2019-2020/2019-10-02 - Cardiff City - Queens Park Rangers",
    "england_efl/2019-2020/2019-10-01 - Wigan Athletic - Birmingham City",
]

DOMAIN = Domain(
    name="ball_action",
    classes=("PASS", "DRIVE"),
    label_file="Labels-ball.json",
    soccernet_subdir="spotting-ball-2023",
    postprocess=PostprocessParams(gauss_sigma=3.0, height=0.2, distance=15),
    video_fps=25.0,
)

classes = list(DOMAIN.classes)
num_classes = DOMAIN.num_classes
class2target = DOMAIN.class2target
target2class = DOMAIN.target2class
