"""Stage-3 transfer recipe: init from the action pretrain, out-of-fold
hard-negative sampling weights, focal α=0.4.

Parity: reference ``configs/ball_action/ball_tuning_001.py``.
"""

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.utils.recipe import spotting_recipe

config = spotting_recipe(
    num_classes=ball.num_classes,
    num_epochs=(7, 35),
    pretrained=False,  # weights come from the action experiment instead
    focal_alpha=0.4,
    train_sampling_weights=dict(
        action_window_size=9,
        action_prob=0.5,
        pred_experiment="sampling_weights_001",  # OOF hard negatives
        clear_pred_window_size=27,
    ),
    pretrain_action_experiment="action_sampling_weights_002",
)
