"""Compute ops with hand-written Hopper kernels (``csrc/``). Each wrapper
launches its kernel on a CUDA tensor (or raises) and runs its plain PyTorch
version on a CPU tensor; ``KERNELS`` lists every kernel of the port."""

from ball_action_spotting_torch.ops import dwconv3d, gem

KERNELS = (gem.KERNEL, dwconv3d.KERNEL)

__all__ = ["KERNELS", "dwconv3d", "gem"]
