"""Stage-2 action-domain pretrain recipe: 15 classes, per-class sampling
weights (rarer classes drawn more), 36000-sample epochs, EMA 0.9995.

Parity: reference ``configs/action/action_sampling_weights_002.py``.
"""

from ball_action_spotting_torch.domains import action
from ball_action_spotting_torch.utils.recipe import spotting_recipe

# per-class sampling mass (reference config:21-37); roughly inverse to
# class frequency in the SoccerNet action dataset
action_weights = {
    "Penalty": 0.244,
    "Kick-off": 0.197,
    "Goal": 0.08,
    "Substitution": 0.06,
    "Offside": 0.069,
    "Shots on target": 0.028,
    "Shots off target": 0.03,
    "Clearance": 0.041,
    "Ball out of play": 0.011,
    "Throw-in": 0.015,
    "Foul": 0.017,
    "Indirect free-kick": 0.028,
    "Direct free-kick": 0.077,
    "Corner": 0.035,
    "Card": 0.07,
}

config = spotting_recipe(
    num_classes=action.num_classes,
    ema_decay=0.9995,
    train_epoch_size=36000,
    num_epochs=(4, 20),
    train_sampling_weights=dict(
        action_window_size=9,
        action_prob=0.5,
        action_weights=action_weights,
    ),
)
