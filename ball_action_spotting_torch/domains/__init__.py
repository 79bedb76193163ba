from ball_action_spotting_torch.domains.base import Domain, PostprocessParams
from ball_action_spotting_torch.domains import action, ball

__all__ = ["Domain", "PostprocessParams", "action", "ball"]
