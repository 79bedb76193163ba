"""MultiChanStacker — the multi-channel (e.g. RGB) variant of
``MultiDimStacker`` (port of the JAX package's ``models/multichan_stacker.py``).

Each stack contributes ``stack_size * num_chans`` channels to the shared 2D
encoder; the rest of the network is unchanged. Input is
(B, T, num_chans, H, W).
"""

from __future__ import annotations

import torch

from ball_action_spotting_torch.models.multidim_stacker import MultiDimStacker


class MultiChanStacker(MultiDimStacker):
    def __init__(self, *args, num_chans: int = 3, **kwargs):
        self.num_chans = num_chans  # read by encoder_in_chans in super().__init__
        super().__init__(*args, **kwargs)

    def encoder_in_chans(self) -> int:
        return self.stack_size * self.num_chans

    def forward_2d(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C, H, W) frames → (B, T/stack, h, w, C3d). A stack's
        channels are ordered (frame, chan), the reference's
        ``view(b*S, stack*chans, h, w)``."""
        b, t, c, h, w = x.shape
        if t % self.stack_size or c != self.num_chans:
            raise ValueError(f"input (B, T, C, H, W) = {tuple(x.shape)} needs T a multiple "
                             f"of {self.stack_size} and C = {self.num_chans}")
        num_stacks = t // self.stack_size
        x = x.to(self.dtype).reshape(b * num_stacks, self.stack_size * c, h, w)
        x = self._encode(x)
        return x.reshape((b, num_stacks) + x.shape[1:])
