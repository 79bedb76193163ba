"""Compute ops. ``gem``, ``dwconv3d`` and ``warp`` hold hand-written Hopper
kernels (``csrc/``): each wrapper launches its kernel on a CUDA tensor (or
raises) and runs its plain PyTorch version on a CPU tensor; ``KERNELS`` lists
every kernel of the port. ``augment``, ``losses`` and ``mixup`` are plain
PyTorch around them."""

from ball_action_spotting_torch.ops import dwconv3d, gem, warp

KERNELS = (gem.KERNEL, dwconv3d.KERNEL, warp.KERNEL)

__all__ = ["KERNELS", "dwconv3d", "gem", "warp"]
