from ball_action_spotting_torch.domains.base import Domain, PostprocessParams
from ball_action_spotting_torch.domains import ball

__all__ = ["Domain", "PostprocessParams", "ball"]
