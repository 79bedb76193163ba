from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.postprocess import (
    post_processing,
    raw_predictions_to_actions,
)

__all__ = ["StackIndexesGenerator", "post_processing", "raw_predictions_to_actions"]
