"""Recipe functions: the 4-stage training configs as base + deltas (copy of
the JAX package's ``utils/recipe.py``). The returned dicts keep the
reference's key structure (``argus_params`` subtree, stage lists,
sampling-weight params), so checkpoints and tooling interoperate.
"""

from __future__ import annotations

from typing import Optional

from ball_action_spotting_torch.train.schedules import get_lr

FLAGSHIP_ENCODER = "tf_efficientnetv2_b0.in1k"


def stacker_params(
    num_classes: int,
    frame_stack_size: int = 15,
    model_name: str = FLAGSHIP_ENCODER,
    pretrained: bool = True,
    drop_rate: float = 0.2,
    drop_path_rate: float = 0.2,
) -> tuple[str, dict]:
    """The flagship MultiDimStacker constructor tuple
    (reference ``configs/ball_action/sampling_weights_001.py:30-45``)."""
    return (
        "multidim_stacker",
        dict(
            model_name=model_name,
            num_classes=num_classes,
            num_frames=frame_stack_size,
            stack_size=3,
            index_2d_features=4,
            pretrained=pretrained,
            num_3d_blocks=4,
            num_3d_features=192,
            expansion_3d_ratio=3,
            se_reduce_3d_ratio=24,
            num_3d_stack_proj=256,
            drop_rate=drop_rate,
            drop_path_rate=drop_path_rate,
            act_layer="silu",
        ),
    )


def spotting_recipe(
    num_classes: int,
    image_size: tuple[int, int] = (1280, 736),
    batch_size: int = 4,
    base_lr: float = 3e-4,
    min_lr_factor: float = 0.01,
    frame_stack_size: int = 15,
    frame_stack_step: int = 2,
    ema_decay: float = 0.999,
    train_epoch_size: int = 6000,
    num_epochs: tuple[int, int] = (6, 30),
    pretrained: bool = True,
    focal_alpha: float = -1.0,
    focal_gamma: float = 1.2,
    optimizer: Optional[tuple[str, dict]] = None,
    freeze_conv2d_encoder: bool = False,
    train_sampling_weights: Optional[dict] = None,
    pretrain_action_experiment: str = "",
    pretrain_ball_experiment: str = "",
    mixup_params: Optional[dict] = None,
    num_decode_workers: int = 4,
) -> dict:
    """Base recipe dict in the reference's config structure."""
    if optimizer is None:
        optimizer = ("AdamW", {"lr": get_lr(base_lr, batch_size)})
    if train_sampling_weights is None:
        train_sampling_weights = dict(
            action_window_size=9,
            action_prob=0.5,
            pred_experiment="",
            clear_pred_window_size=9,
        )
    config = dict(
        image_size=image_size,
        batch_size=batch_size,
        base_lr=base_lr,
        min_base_lr=base_lr * min_lr_factor,
        ema_decay=ema_decay,
        max_targets_window_size=15,
        train_epoch_size=train_epoch_size,
        train_sampling_weights=train_sampling_weights,
        metric_accuracy_threshold=0.5,
        num_decode_workers=num_decode_workers,
        num_epochs=list(num_epochs),
        stages=["warmup", "train"],
        argus_params={
            "nn_module": stacker_params(
                num_classes, frame_stack_size, pretrained=pretrained
            ),
            "loss": (
                "focal_loss",
                {"alpha": focal_alpha, "gamma": focal_gamma, "reduction": "mean"},
            ),
            "optimizer": optimizer,
            "image_size": image_size,
            "frame_stack_size": frame_stack_size,
            "frame_stack_step": frame_stack_step,
            "iter_size": 1,
            "frames_processor": (
                "pad_normalize",
                {"size": image_size, "pad_mode": "constant", "fill_value": 0},
            ),
            "freeze_conv2d_encoder": freeze_conv2d_encoder,
        },
        frame_index_shaker={
            "shifts": [-1, 0, 1],
            "weights": [0.2, 0.6, 0.2],
            "prob": 0.25,
        },
        pretrain_action_experiment=pretrain_action_experiment,
        pretrain_ball_experiment=pretrain_ball_experiment,
    )
    if mixup_params:
        config["mixup_params"] = mixup_params
    return config
