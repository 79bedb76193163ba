"""Multilabel batch mixup / cutmix (port of the JAX package's
``ops/mixup.py``, timm's Mixup in 'batch' mode for multilabel targets).

The batch is mixed with its flipped self using one Beta(α, α) lambda per
batch, and the target vectors are mixed linearly; cutmix replaces a random
box instead. As in ``ops/augment.py`` the draws (``Mixup.sample``) are split
from their application (``Mixup.apply``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def mixup_target(target: torch.Tensor, lam: float, smoothing: float = 0.0) -> torch.Tensor:
    """Mix target vectors with the flipped batch."""
    off = smoothing / target.shape[-1]
    on = 1.0 - smoothing + off
    y1 = (1.0 - target) * off + target * on
    return y1 * lam + torch.flip(y1, dims=(0,)) * (1.0 - lam)


def rand_bbox(height: int, width: int, lam: float, cy: int, cx: int):
    """Cutmix box of area fraction (1-lam) centered at (cy, cx), clipped."""
    ratio = float(np.sqrt(np.float32(1.0 - lam)))
    cut_h = int(np.float32(height * ratio))
    cut_w = int(np.float32(width * ratio))
    y1 = min(max(cy - cut_h // 2, 0), height)
    x1 = min(max(cx - cut_w // 2, 0), width)
    y2 = min(max(cy + cut_h // 2, 0), height)
    x2 = min(max(cx + cut_w // 2, 0), width)
    return y1, x1, y2, x2


@dataclasses.dataclass(frozen=True)
class Mixup:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 0.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.0

    def sample(self, generator: torch.Generator, height: int, width: int) -> dict:
        """One batch's draws, on the host: whether cutmix is used, lambda
        and the box center. ``generator`` is a CPU generator; the Beta draw
        comes from a numpy generator seeded by it (torch's Beta sampler
        takes no generator)."""
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        rng = np.random.default_rng(seed)
        use_cutmix = self.cutmix_alpha > 0.0 and (
            self.mixup_alpha <= 0.0 or rng.random() < self.switch_prob)
        alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
        lam = float(rng.beta(alpha, alpha))
        if not rng.random() < self.prob:
            lam = 1.0
        return dict(use_cutmix=use_cutmix, lam=lam,
                    cy=int(rng.integers(0, height)), cx=int(rng.integers(0, width)))

    def apply(self, x: torch.Tensor, target: torch.Tensor, params: dict):
        """x (B, ..., H, W) batch, target (B, C) → the mixed pair."""
        lam = params["lam"]
        flipped = torch.flip(x, dims=(0,))
        if params["use_cutmix"]:
            h, w = x.shape[-2], x.shape[-1]
            y1, x1, y2, x2 = rand_bbox(h, w, lam, params["cy"], params["cx"])
            mixed = x.clone()
            mixed[..., y1:y2, x1:x2] = flipped[..., y1:y2, x1:x2]
            # lambda corrected to the box's real area
            lam = 1.0 - ((y2 - y1) * (x2 - x1)) / (h * w)
        else:
            # mixed in the image's own dtype, the targets in f32
            lam_x = torch.tensor(lam, dtype=x.dtype, device=x.device)
            mixed = x * lam_x + flipped * (1.0 - lam_x)
        return mixed, mixup_target(target.float(), lam, self.label_smoothing)


def make_mixup_fn(params: dict | None) -> Mixup | None:
    """Build from a config ``mixup_params`` dict (timm's Mixup keys)."""
    if not params:
        return None
    return Mixup(
        mixup_alpha=params.get("mixup_alpha", 0.8),
        cutmix_alpha=params.get("cutmix_alpha", 0.0),
        prob=params.get("prob", 1.0),
        switch_prob=params.get("switch_prob", 0.5),
        label_smoothing=params.get("label_smoothing", 0.0),
    )
