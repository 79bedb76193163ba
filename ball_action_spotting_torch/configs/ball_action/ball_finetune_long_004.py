"""Stage-4 long-sequence fine-tune: frame stack 15→33, frozen 2D encoder,
SGD+Nesterov, init from the stage-3 checkpoint of the same fold.

Parity: reference ``configs/ball_action/ball_finetune_long_004.py``.
"""

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.train.schedules import get_lr
from ball_action_spotting_torch.utils.recipe import spotting_recipe

batch_size = 4
base_lr = 1e-3

config = spotting_recipe(
    num_classes=ball.num_classes,
    batch_size=batch_size,
    base_lr=base_lr,
    min_lr_factor=0.05,
    frame_stack_size=33,
    num_epochs=(2, 7),
    pretrained=False,  # weights come from ball_tuning_001 (same fold)
    focal_alpha=0.4,
    optimizer=(
        "SGD",
        {"lr": get_lr(base_lr, batch_size), "momentum": 0.9, "nesterov": True},
    ),
    freeze_conv2d_encoder=True,
    train_sampling_weights=dict(
        action_window_size=9,
        action_prob=0.5,
        pred_experiment="sampling_weights_001",
        clear_pred_window_size=27,
    ),
    pretrain_ball_experiment="ball_tuning_001",
)
