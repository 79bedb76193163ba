from ball_action_spotting_torch.domains.base import Domain, PostprocessParams
from ball_action_spotting_torch.domains import action, ball

DOMAINS = {
    "ball_action": ball.DOMAIN,
    "action": action.DOMAIN,
}


def get_domain(name: str) -> Domain:
    return DOMAINS[name]


__all__ = ["DOMAINS", "Domain", "PostprocessParams", "action", "ball", "get_domain"]
